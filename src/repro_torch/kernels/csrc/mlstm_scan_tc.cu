// bf16 chunkwise mLSTM forward for Hopper (sm_90a): two passes on the tensor
// cores (wgmma) fed by TMA, with a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan.py:32 (`_kernel`,
// launched through pl.pallas_call by `mlstm_scan`) for bf16 inputs whose
// chunk is a multiple of 16.  The Python wrapper is
// src/repro_torch/kernels/mlstm_scan.py, which also picks this kernel; the
// plain PyTorch version it is held against is
// src/repro_torch/models/xlstm.py::mlstm_chunkwise.  fp32 inputs go to
// csrc/mlstm_scan_fp32tc.cu, the same two passes in split precision, and
// chunks that are not a multiple of 16 to csrc/mlstm_scan.cu.
//
// Contract.  As csrc/mlstm_scan.cu: q, k, v (B,T,H,D) contiguous bf16,
// 16-byte aligned; log_i, log_f (B,T,H) fp32; T a multiple of `chunk`; D a
// multiple of 16 up to 512; the state (C (D,D), n (D), m) in fp32, given or
// C = 0, n = 0, m = -inf.  Per chunk of L rows, bcum the inclusive sum of
// log_f over the chunk, taken in order as torch.cumsum takes it:
//   e[t,s]   = (bcum[t] - bcum[s]) + li[s]                     (s <= t)
//   m_row[t] = max(max_s e[t,s], bcum[t] + m0, -1e30)
//   p[t,s]   = (q[t].k[s]) scale exp(e[t,s] - m_row[t])       (0 for s > t)
//   c_in[t]  = exp((bcum[t] + m0) - m_row[t])
//   h[t]     = (p v + c_in scale q C0)[t] / max(|rowsum p + c_in scale q.n0|,
//                                             exp(-m_row[t]))
//   m1 = max(btot + m0, max_s (btot - bcum[s]) + li[s])
//   w[s] = exp(((btot - bcum[s]) + li[s]) - m1),  a = exp((btot + m0) - m1)
//   C1 = a C0 + k^T diag(w) v,  n1 = a n0 + k^T w
// with the stabilizers in exactly this expression order (at |bcum| ~ 5e3 a
// reassociation moves m by ~5e-4 and C by as much relatively).  h is bf16;
// the final C, n, m are fp32.
//
// What bounds it on the H100.  At the xlstm-350m serving shape (B4 T512 H4
// D512, chunk 256) a call moves 50.4 MB (q, k, v and h in bf16, the gates,
// the final fp32 state): 0.01505 ms at 3.35 TB/s, above the 8.7 us its
// 4.3 G multiply-adds take at the bf16 tensor-core peak.  On the fp32 pipe,
// where csrc/mlstm_scan.cu computes them, they take 0.1285 ms.  In practice
// the passes are bound by what they stream from L2 into shared memory:
// every tile of k, v, q and the chunk states is read by several blocks.
//
// What the design does about it.  Two launches on one stream, each a grid
// of two-warpgroup (256-thread) blocks; 64 x 64 bf16 tiles arrive by TMA
// (128-byte swizzle) into a two-stage ring signalled by mbarriers, four
// tiles a stage; the products run on wgmma m64n64k16 with fp32
// accumulators.
// (a) The state pass, one block per (128 rows of C, 128 columns of C, batch
//     x head), each warpgroup owning 64 rows: walks the chunks in order,
//     keeps its C tile in the accumulators, scales it by a and adds
//     k^T (w v), and writes the state entering each chunk that the output
//     pass reads (C as scratch in two bf16 terms hi + lo, n and m in fp32,
//     and the chunk's cumulative log_f) and the final state.  k is exactly
//     bf16, so only w v needs more: it is split into three bf16 terms
//     hi + mid + lo that sum to the fp32 product exactly (hi in place of
//     v), and k^T (w v) is three products, each exact term by term in
//     fp32.  That holds C to fp32 rounding, which the final state's
//     tolerance (rtol 5e-4, atol 5e-5) needs; one bf16 rounding of w v
//     misses it by far.  k^T and w v are read M- and N-major through
//     wgmma's transpose bits.  The blocks of column 0 also sum n on the
//     fp32 pipe.  128 x 128 tiles read each k and v tile D/128 times, half
//     as often as 64 x 64 tiles would; registers hold it to two blocks an
//     SM.
// (b) The output pass, one block per (128 rows of a chunk, chunk, batch x
//     head, 128 columns of h), heaviest first, each warpgroup owning 64
//     rows: with the states in place the chunks are independent.  Q's 128
//     rows stay in shared memory (128 KB at D = 512), so that each tile of
//     the carried state C0 serves 128 rows.  O = scale c_in (Q C0) on
//     wgmma, then per key tile up to each warpgroup's diagonal S = Q K^T
//     (fp32), P = S scale exp(e - m_row) masked to s <= t, its row sums in
//     fp32, and O += P V with P in registers as wgmma's A operand.  C0 and
//     P enter their products as two bf16 terms each (hi + lo, 16 bits):
//     rounded once to bf16, the rows whose numerator cancels miss h's
//     tolerance (rtol = atol = 5e-2) at D = 512 (the forget_near_one and
//     many_chunks_d512 hazards of chip_smoke.py).  The scores of a row tile
//     are computed once per 128 columns of h: D/128 = 4 times at D = 512,
//     where csrc/mlstm_scan.cu computed them D/64 = 8 times on the fp32
//     pipe.
// The cumulative log_f is summed in order by one thread (torch.cumsum's
// order on the card and the CPU), once per chunk in every state block; the
// output blocks read it from scratch and spread the row maxima over
// threads.  Tiles past the chunk, T or D are masked: TMA reads zeros past T
// and D, tiles wholly past D are neither loaded nor multiplied, and rows
// past the chunk are neither summed nor stored.
#include "mlstm_scan.cuh"

#include <math.h>
#include <cstring>

namespace {

constexpr int kStageBoxes = 4;            // tiles a stage holds
constexpr int kStateStages = 2;
constexpr int kOutStages = 2;
constexpr int kStateTile = 2 * kT;        // rows and columns of C a state block owns
constexpr int kOutRows = 2 * kT;          // rows of a chunk an output block owns
constexpr int kOutCols = 2 * kT;          // columns of h an output block owns
// bf16 terms of C0 (kernels/mlstm_scan.py's C_PARTS) and of P in the output
// pass's products, each term 8 more bits of the fp32 value.
constexpr int kCParts = 2;
constexpr int kPParts = 2;

// The bf16 term `part` of (x0, x1): x minus the terms before it, rounded.
__device__ __forceinline__ __nv_bfloat162 bf16_term(float x0, float x1, int part) {
  __nv_bfloat162 t = __floats2bfloat162_rn(x0, x1);
  for (int p = 0; p < part; ++p) {
    const float2 f = __bfloat1622float2(t);
    x0 -= f.x;
    x1 -= f.y;
    t = __floats2bfloat162_rn(x0, x1);
  }
  return t;
}

// ---------------------------------------------------------------------------
// (a) The state pass.
// ---------------------------------------------------------------------------

struct StateSmem {
  static __host__ __device__ size_t floats(int chunk) {
    // li, bc, w; n; block_max
    return 3 * chunk + kStateTile + kThreads / 32;
  }
  static __host__ __device__ size_t bytes(int chunk) {
    return 1024 + (kStateStages * kStageBoxes + 4) * kBox + 4 * floats(chunk) +
           8 * kStateStages;
  }
};

__global__ void __launch_bounds__(kThreads, 2)
mlstm_scan_tc_state_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const float* __restrict__ log_i,
                           const float* __restrict__ log_f,
                           const float* __restrict__ c_in,
                           const float* __restrict__ n_in,
                           const float* __restrict__ m_in,
                           __nv_bfloat16* __restrict__ c_bound,
                           float* __restrict__ n_prev, float* __restrict__ m_prev,
                           float* __restrict__ bcum, float* __restrict__ c_out,
                           float* __restrict__ n_out, float* __restrict__ m_out,
                           int t_len, int n_heads, int d, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  // [stage]: k tiles 0-1 (rows of C), v tiles 2-3 (columns of C), which
  // become the hi terms of w v; then the mid and lo terms, 2 tiles each.
  uint8_t* ring = align1024(smem_raw);
  uint8_t* xs = ring + kStateStages * kStageBoxes * kBox;
  float* li_s = reinterpret_cast<float*>(xs + 4 * kBox);
  float* bc_s = li_s + chunk;
  float* w_s = bc_s + chunk;                // log_f, then the weights w
  float* n_s = w_s + chunk;                 // n of this block's rows
  float* red_s = n_s + kStateTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(red_s + kThreads / 32);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int i0 = blockIdx.x * kStateTile, j0 = blockIdx.y * kStateTile;
  const int n_bh = gridDim.z, bh = blockIdx.z;
  const int b = bh / n_heads, hh = bh % n_heads;
  const int nkb = min(2, tiles(d - i0)), nvb = min(2, tiles(d - j0));
  const bool has_state = c_in != nullptr, owns_n = blockIdx.y == 0;
  const bool live = wg < nkb;               // this warpgroup has rows of C
  const int nc = t_len / chunk, nsub = tiles(chunk), jobs = nc * nsub;
  const int r_base = i0 + kT * wg + 16 * (warp % 4) + lane / 4;  // + 8i
  const int c_base = j0 + 2 * (lane % 4);                        // + 64c + 8j + e
  const float* li_g = log_i + (size_t)b * t_len * n_heads + hh;
  const float* lf_g = log_f + (size_t)b * t_len * n_heads + hh;

  float acc[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r_base + 8 * i, col = c_base + kT * c + 8 * j + e;
          acc[c][4 * j + 2 * i + e] = has_state && row < d && col < d
              ? c_in[((size_t)bh * d + row) * d + col] : 0.f;
        }
  if (tid < kStateTile)
    n_s[tid] = n_in != nullptr && i0 + tid < d ? n_in[(size_t)bh * d + i0 + tid] : 0.f;
  float m0 = m_in != nullptr ? m_in[bh] : -INFINITY;

  if (tid == 0) {
    for (int s = 0; s < kStateStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int g) {  // thread 0: the tiles of job g into its stage
    const int stage = g % kStateStages;
    const int row = (g / nsub) * chunk + (g % nsub) * kT;
    uint8_t* dst = ring + stage * kStageBoxes * kBox;
    mbar_expect_tx(&full[stage], (nkb + nvb) * kBox);
    for (int x = 0; x < nkb; ++x)
      tma_load(dst + x * kBox, &k_map, &full[stage], i0 + x * kT, hh, row, b);
    for (int x = 0; x < nvb; ++x)
      tma_load(dst + (2 + x) * kBox, &v_map, &full[stage], j0 + x * kT, hh, row, b);
  };
  if (tid == 0)
    for (int g = 0; g < kStateStages && g < jobs; ++g) issue(g);

  for (int kc = 0; kc < nc; ++kc) {
    // The state entering this chunk, for the output pass.
    // Staged in the (idle) w v tiles, so that each row goes out in 16-byte
    // stores, one term after the other.
    if (kc > 0 || has_state) {
      uint8_t* cb = reinterpret_cast<uint8_t*>(
          c_bound + (((size_t)(kc - !has_state) * n_bh + bh) * kCParts * d + i0) * d + j0);
      for (int part = 0; part < kCParts; ++part) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              *reinterpret_cast<__nv_bfloat162*>(
                  xs + staged(r_base - i0 + 8 * i, 2 * (c_base - j0 + kT * c + 8 * j))) =
                  bf16_term(acc[c][4 * j + 2 * i], acc[c][4 * j + 2 * i + 1], part);
        store_staged(xs, cb + (size_t)part * d * d * 2, (size_t)d * 2, d - i0,
                     2 * (d - j0));
      }
    }
    if (owns_n && tid < kStateTile && i0 + tid < d)
      n_prev[((size_t)kc * n_bh + bh) * d + i0 + tid] = n_s[tid];
    if (owns_n && blockIdx.x == 0 && tid == 0) m_prev[kc * n_bh + bh] = m0;

    // Gates: the chunk-end stabilizer m1, the weights w and the decay a.
    const size_t t0 = (size_t)kc * chunk;
    chunk_gates(li_g + t0 * n_heads, lf_g + t0 * n_heads, n_heads, chunk, li_s,
                bc_s, w_s);
    if (blockIdx.x == 0 && blockIdx.y == 0)
      for (int s = tid; s < chunk; s += kThreads)
        bcum[((size_t)kc * n_bh + bh) * chunk + s] = bc_s[s];
    const float btot = bc_s[chunk - 1];
    float m_loc = -INFINITY;
    for (int s = tid; s < chunk; s += kThreads)
      m_loc = fmaxf(m_loc, (btot - bc_s[s]) + li_s[s]);
    const float m1 = fmaxf(btot + m0, block_max(m_loc, red_s));
    for (int s = tid; s < chunk; s += kThreads)
      w_s[s] = expf(((btot - bc_s[s]) + li_s[s]) - m1);
    const float a = expf((btot + m0) - m1);  // exactly 0 while m0 is -inf
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[c][x] *= a;
    __syncthreads();

    float n_part[8] = {};  // sum of w k, 8 columns, every 16th row
    for (int sub = 0; sub < nsub; ++sub) {
      const int g = kc * nsub + sub, stage = g % kStateStages;
      const int rows = min(kT, chunk - sub * kT);  // a multiple of 16
      uint8_t* st = ring + stage * kStageBoxes * kBox;
      const float* w_sub = w_s + sub * kT;
      mbar_wait(&full[stage], (g / kStateStages) & 1);
      // w v = hi + mid + lo in bf16, each term the top 16 bits of what the
      // terms before it leave (exact: 3 x 8 bits cover the 24 of an fp32
      // product), in v's swizzled layout, hi over v itself.
      for (int u = tid; u < nvb * kT * 8; u += kThreads) {
        const int c = u / (kT * 8), r = u % (kT * 8) / 8;
        if (r >= rows) continue;
        const uint32_t off = c * kBox + r * 128 + (((u % 8) ^ (r & 7)) << 4);
        uint4* v_at = reinterpret_cast<uint4*>(st + 2 * kBox + off);
        const uint4 raw = *v_at;
        const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float wr = w_sub[r];
        uint4 parts[3];
        uint32_t* hi = reinterpret_cast<uint32_t*>(&parts[0]);
        uint32_t* mid = reinterpret_cast<uint32_t*>(&parts[1]);
        uint32_t* lo = reinterpret_cast<uint32_t*>(&parts[2]);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float2 x = __bfloat1622float2(vv[p]);
          float x0 = wr * x.x, x1 = wr * x.y;
          hi[p] = split_bf16(x0, x1);
          mid[p] = split_bf16(x0, x1);
          lo[p] = split_bf16(x0, x1);
        }
        *v_at = parts[0];
        *reinterpret_cast<uint4*>(xs + off) = parts[1];
        *reinterpret_cast<uint4*>(xs + 2 * kBox + off) = parts[2];
      }
      if (owns_n && 8 * (tid % 16) < d - i0) {  // 8 columns a thread
        const int ch = tid % 16;
        const uint8_t* k_box = st + (ch / 8) * kBox;
        for (int r = tid / 16; r < rows; r += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              k_box + r * 128 + (((ch % 8) ^ (r & 7)) << 4));
          const __nv_bfloat162* kk = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float2 kf = __bfloat1622float2(kk[p]);
            n_part[2 * p] = fmaf(w_sub[r], kf.x, n_part[2 * p]);
            n_part[2 * p + 1] = fmaf(w_sub[r], kf.y, n_part[2 * p + 1]);
          }
        }
      }
      fence_proxy_async();
      __syncthreads();
      // C += k^T (hi + mid + lo): A = k (M-major), B = w v (N-major).
      if (live) {
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kT / 16; ++ks) {
          if (ks * 16 < rows) {
            const uint64_t ad = smem_desc(st + wg * kBox + ks * kStep, kGroup, 1);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (c < nvb) {
                wgmma_ss_n64<1, 1>(acc[c], ad, smem_desc(st + (2 + c) * kBox + ks * kStep, kGroup, 1), 1);
                wgmma_ss_n64<1, 1>(acc[c], ad, smem_desc(xs + c * kBox + ks * kStep, kGroup, 1), 1);
                wgmma_ss_n64<1, 1>(acc[c], ad, smem_desc(xs + (2 + c) * kBox + ks * kStep, kGroup, 1), 1);
              }
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
      }
      __syncthreads();  // every warp is done with this stage and with w v
      if (tid == 0 && g + kStateStages < jobs) {
        fence_proxy_async();
        issue(g + kStateStages);
      }
    }
    if (owns_n) {  // the 16 row groups' sums, in the idle w v tiles
      float* parts = reinterpret_cast<float*>(xs);
#pragma unroll
      for (int e = 0; e < 8; ++e) parts[(tid / 16) * kStateTile + 8 * (tid % 16) + e] = n_part[e];
    }
    __syncthreads();
    if (owns_n && tid < kStateTile) {
      const float* parts = reinterpret_cast<const float*>(xs);
      float sum = 0.f;
      for (int rg = 0; rg < 16; ++rg) sum += parts[rg * kStateTile + tid];
      n_s[tid] = a * n_s[tid] + sum;
    }
    m0 = m1;
    __syncthreads();  // the next chunk overwrites the gates
  }

  // The final C, staged 64 columns at a time.
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            xs + staged(r_base - i0 + 8 * i, 4 * (c_base - j0 + 8 * j))) =
            make_float2(acc[c][4 * j + 2 * i], acc[c][4 * j + 2 * i + 1]);
    store_staged(xs, reinterpret_cast<uint8_t*>(c_out + ((size_t)bh * d + i0) * d + j0 + kT * c),
                 (size_t)d * 4, d - i0, 4 * (d - j0 - kT * c));
  }
  if (owns_n && tid < kStateTile && i0 + tid < d)
    n_out[(size_t)bh * d + i0 + tid] = n_s[tid];
  if (owns_n && blockIdx.x == 0 && tid == 0) m_out[bh] = m0;
}

// ---------------------------------------------------------------------------
// (b) The output pass.
// ---------------------------------------------------------------------------

struct OutSmem {
  static __host__ __device__ size_t floats(int d, int chunk) {
    // li, bc; m_row, c_in, scale q.n0 of the block's rows; n0
    return 2 * chunk + 3 * kOutRows + tiles(d) * kT;
  }
  static __host__ __device__ size_t bytes(int d, int chunk) {
    return 1024 + (2 * tiles(d) + kOutStages * kStageBoxes) * kBox +
           4 * floats(d, chunk) + 8 * (kOutStages + 1);
  }
};

__global__ void __launch_bounds__(kThreads)
mlstm_scan_tc_output_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap c_map,
                            const float* __restrict__ log_i,
                            const float* __restrict__ n_prev,
                            const float* __restrict__ m_prev,
                            const float* __restrict__ bcum,
                            __nv_bfloat16* __restrict__ h_out, int t_len,
                            int n_heads, int n_bh, int d, int chunk,
                            int has_state, float scale) {
  const int nslab = tiles(d);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);       // [row tile][slab]: Q, 128 rows x D
  uint8_t* ring = q_s + 2 * nslab * kBox;   // [stage]: kStageBoxes tiles
  float* li_s = reinterpret_cast<float*>(ring + kOutStages * kStageBoxes * kBox);
  float* bc_s = li_s + chunk;
  float* mr_s = bc_s + chunk;               // m_row of the block's rows
  float* ci_s = mr_s + kOutRows;            // c_in
  float* qn_s = ci_s + kOutRows;            // scale q.n0
  float* n0_s = qn_s + kOutRows;            // n0
  uint64_t* full = reinterpret_cast<uint64_t*>(n0_s + nslab * kT);
  uint64_t* q_full = full + kOutStages;

  // Block x: heaviest first.  The chunks that carry a state in (all but the
  // first, or all with an initial state) come first, then the others; in
  // each, the pair of row tiles rp latest first (the causal work grows with
  // it), then chunk, batch x head, 128 columns of h.
  const int nc = t_len / chunk, n_rt = tiles(chunk), n_rp = (n_rt + 1) / 2;
  const int n_vs = (d + kOutCols - 1) / kOutCols;
  const int n_carry = has_state ? nc : nc - 1;  // chunks with a state in
  const int per_chunk = n_bh * n_vs;
  int blk = static_cast<int>(blockIdx.x), kc0 = nc - n_carry, group = n_carry;
  if (blk >= n_rp * n_carry * per_chunk) {
    blk -= n_rp * n_carry * per_chunk;
    kc0 = 0;
    group = nc - n_carry;
  }
  const int rp = n_rp - 1 - blk / (group * per_chunk);
  blk %= group * per_chunk;
  const int kc = kc0 + blk / per_chunk;
  blk %= per_chunk;
  const int bh = blk / n_vs, v0 = blk % n_vs * kOutCols;
  const int b = bh / n_heads, hh = bh % n_heads;
  const int r0 = rp * kOutRows, t0 = kc * chunk;
  const int nvb = min(2, tiles(d - v0));    // 64-column tiles of h
  const bool inter = kc > 0 || has_state;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int rt = 2 * rp + wg;               // this warpgroup's row tile
  const bool live = rt < n_rt;
  const int n_q = min(2, n_rt - 2 * rp);    // row tiles of the block
  const int n_st = min(2 * rp + 2, n_rt);   // key tiles the block reads
  const uint8_t* q_wg = q_s + wg * nslab * kBox;

  // Jobs in order: C0 a slab at a time (hi and lo terms, tiles 0-1 and
  // 2-3); then per key tile its K (kStageBoxes slabs a job) and its V.
  const int n_inter = inter ? nslab : 0;
  const int n_kjobs = (nslab + kStageBoxes - 1) / kStageBoxes;
  const int jobs = n_inter + n_st * (n_kjobs + 1);
  auto issue = [&](int g) {  // thread 0: the tiles of job g into its stage
    const int stage = g % kOutStages;
    uint8_t* dst = ring + stage * kStageBoxes * kBox;
    if (g < n_inter) {
      mbar_expect_tx(&full[stage], kCParts * nvb * kBox);
      for (int p = 0; p < kCParts; ++p) {
        const int row = (((kc - !has_state) * n_bh + bh) * kCParts + p) * d + g * kT;
        for (int c = 0; c < nvb; ++c)
          tma_load_2d(dst + (2 * p + c) * kBox, &c_map, &full[stage], v0 + c * kT, row);
      }
      return;
    }
    const int st = (g - n_inter) / (n_kjobs + 1), kj = (g - n_inter) % (n_kjobs + 1);
    if (kj < n_kjobs) {
      const int n = min(kStageBoxes, nslab - kj * kStageBoxes);
      mbar_expect_tx(&full[stage], n * kBox);
      for (int x = 0; x < n; ++x)
        tma_load(dst + x * kBox, &k_map, &full[stage], (kj * kStageBoxes + x) * kT,
                 hh, t0 + st * kT, b);
    } else {
      mbar_expect_tx(&full[stage], nvb * kBox);
      for (int c = 0; c < nvb; ++c)
        tma_load(dst + c * kBox, &v_map, &full[stage], v0 + c * kT, hh,
                 t0 + st * kT, b);
    }
  };

  // Gates of the chunk up to this block's last row and n0, asked for
  // before the tiles so that they do not queue behind them; then the row
  // statistics, two threads a row.
  const float m0 = m_prev[kc * n_bh + bh];
  const size_t gate0 = ((size_t)b * t_len + t0) * n_heads + hh;
  const float* bc_g = bcum + ((size_t)kc * n_bh + bh) * chunk;
  for (int s = tid; s < min(chunk, r0 + kOutRows); s += kThreads) {
    li_s[s] = log_i[gate0 + (size_t)s * n_heads];
    bc_s[s] = bc_g[s];
  }
  for (int x = tid; x < nslab * kT; x += kThreads)
    n0_s[x] = inter && x < d ? n_prev[((size_t)kc * n_bh + bh) * d + x] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < kOutStages; ++s) mbar_init(&full[s], 1);
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, n_q * nslab * kBox);
    for (int q = 0; q < n_q; ++q)
      for (int sl = 0; sl < nslab; ++sl)
        tma_load(q_s + (q * nslab + sl) * kBox, &q_map, q_full, sl * kT, hh,
                 t0 + r0 + q * kT, b);
    for (int g = 0; g < kOutStages && g < jobs; ++g) issue(g);
  }
  __syncthreads();
  const int row2 = tid / 2, part2 = tid % 2;  // a row of the block, half of it
  {
    const int t = r0 + row2;
    float mx = -INFINITY;
    if (t < chunk) {
      const float bt = bc_s[t];
      for (int s = part2; s <= t; s += 2) mx = fmaxf(mx, (bt - bc_s[s]) + li_s[s]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    if (part2 == 0) {
      float mr = 0.f, ci = 0.f;
      if (t < chunk) {
        const float g = bc_s[t] + m0;
        mr = fmaxf(fmaxf(mx, g), kGuard);
        ci = expf(g - mr);  // exactly 0 while m0 is -inf
      }
      mr_s[row2] = mr;
      ci_s[row2] = ci;
    }
  }
  mbar_wait(q_full, 0);
  {  // scale q.n0, 8 head dims (16 bytes) at a time
    const int row = row2 % kT;
    const uint8_t* q_row = q_s + (row2 / kT) * nslab * kBox + row * 128;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    if (inter && r0 + row2 < chunk)
      for (int ch = part2; ch < d / 8; ch += 2) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            q_row + (ch / 8) * kBox + (((ch % 8) ^ (row & 7)) << 4));
        const __nv_bfloat162* qq = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float2 qf = __bfloat1622float2(qq[p]);
          part[p] = fmaf(qf.x, n0_s[8 * ch + 2 * p], part[p]);
          part[p] = fmaf(qf.y, n0_s[8 * ch + 2 * p + 1], part[p]);
        }
      }
    float dot = (part[0] + part[1]) + (part[2] + part[3]);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (part2 == 0) qn_s[row2] = dot * scale;
  }
  __syncthreads();

  const int lr = kT * wg + 16 * (warp % 4) + lane / 4;  // + 8i: the block's rows
  const int lc = 2 * (lane % 4);                        // + 8j + e: a tile's columns
  float mr[2], ci[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mr[i] = mr_s[lr + 8 * i];
    ci[i] = ci_s[lr + 8 * i];
  }
  float o[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[c][x] = 0.f;

  int g = 0;
  auto wait_job = [&]() {
    const int stage = g % kOutStages;
    mbar_wait(&full[stage], (g / kOutStages) & 1);
    return ring + stage * kStageBoxes * kBox;
  };
  auto release = [&]() {  // every warp is done with job g's stage
    __syncthreads();
    if (tid == 0 && g + kOutStages < jobs) {
      fence_proxy_async();
      issue(g + kOutStages);
    }
    ++g;
  };

  // O = scale c_in (Q C0), C0 = hi + lo: A = Q (K-major), B = C0 (N-major).
  for (int sl = 0; sl < n_inter; ++sl) {
    const uint8_t* c_t = wait_job();
    if (live) {
      const int steps = min(kT, d - sl * kT) / 16;
      fence_regs(o[0]);
      fence_regs(o[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        if (kk < steps) {
          const uint64_t ad = smem_desc(q_wg + sl * kBox + kk * 32, kGroup, 1);
#pragma unroll
          for (int p = 0; p < kCParts; ++p)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (c < nvb)
                wgmma_ss_n64<0, 1>(o[c], ad, smem_desc(c_t + (2 * p + c) * kBox + kk * kStep, kGroup, 1), 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o[0]);
      fence_regs(o[1]);
    }
    release();
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[c][x] *= ci[(x / 2) % 2] * scale;

  float rowsum[2] = {0.f, 0.f};
  for (int st = 0; st < n_st; ++st) {
    const bool sees = live && st <= rt;  // some key of the tile is visible
    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    for (int kj = 0; kj < n_kjobs; ++kj) {  // S = Q K^T, both K-major
      const uint8_t* k_t = wait_job();
      if (sees) {
        fence_regs(s);
        wgmma_fence();
        for (int x = 0; x < kStageBoxes && kj * kStageBoxes + x < nslab; ++x) {
          const int sl = kj * kStageBoxes + x;
          const int steps = min(kT, d - sl * kT) / 16;
#pragma unroll
          for (int kk = 0; kk < kT / 16; ++kk)
            if (kk < steps)
              wgmma_ss_n64<0, 0>(s, smem_desc(q_wg + sl * kBox + kk * 32, kGroup, 1),
                                 smem_desc(k_t + x * kBox + kk * 32, kGroup, 1), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
      }
      release();
    }
    // P in kPParts bf16 terms, as the A fragments of 4 steps of 16 keys.
    uint32_t pa[kPParts][4][4];
    if (sees) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = r0 + lr + 8 * i;
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = st * kT + 8 * j + lc + e;
            p[e] = 0.f;
            if (t < chunk && key <= t)
              p[e] = s[4 * j + 2 * i + e] * scale *
                     expf(((bc_s[t] - bc_s[key]) + li_s[key]) - mr[i]);
            rowsum[i] += p[e];
          }
#pragma unroll
          for (int part = 0; part < kPParts; ++part) {
            const __nv_bfloat162 term = bf16_term(p[0], p[1], part);
            pa[part][j / 2][(j % 2) * 2 + i] = *reinterpret_cast<const uint32_t*>(&term);
          }
        }
    }
    const uint8_t* v_t = wait_job();  // O += P V, V N-major
    if (sees) {
      fence_regs(o[0]);
      fence_regs(o[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (c < nvb) {
            const uint64_t bd = smem_desc(v_t + c * kBox + kk * kStep, kGroup, 1);
#pragma unroll
            for (int part = 0; part < kPParts; ++part) wgmma_rs_n64(o[c], pa[part][kk], bd);
          }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o[0]);
      fence_regs(o[1]);
    }
    release();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = lr + 8 * i, t = r0 + row;
    if (!live || t >= chunk) continue;
    const float dot = rowsum[i] + ci[i] * qn_s[row];
    const float den = fmaxf(fabsf(dot), expf(-mr[i]));
    __nv_bfloat16* out = h_out + (((size_t)b * t_len + t0 + t) * n_heads + hh) * d;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + c * kT + 8 * j + lc;
        if (c < nvb && col < d)
          *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
              o[c][4 * j + 2 * i] / den, o[c][4 * j + 2 * i + 1] / den);
      }
  }
}

}  // namespace

// Returns the cudaError_t of the two launches (0 on success).  c_in, n_in and
// m_in are the initial state, all three null for a zero state; c_out, n_out
// and m_out receive the final state.  Scratch from the caller: c_bound, bf16
// (nc - 1 + has_state, B*H, 2, D, D), the C entering each chunk that needs
// one as hi and lo terms (null when that count is 0); n_prev (nc, B*H, D) and
// m_prev (nc, B*H), fp32, n and m entering every chunk; bcum (nc, B*H,
// chunk), fp32, each chunk's cumulative log_f.  head_dim a multiple of 16 up
// to 512, chunk a multiple of 16 up to 1024, t_len a multiple of chunk.
extern "C" int repro_mlstm_scan_tc(
    const void* q, const void* k, const void* v, const float* log_i,
    const float* log_f, const float* c_in, const float* n_in, const float* m_in,
    void* h, float* c_out, float* n_out, float* m_out, void* c_bound,
    float* n_prev, float* m_prev, float* bcum, int batch, int t_len, int n_heads,
    int head_dim, int chunk, float scale, void* stream) {
  const int d = head_dim;
  if (d % 16 || d <= 0 || d > 512 || chunk <= 0 || chunk % 16 || chunk > 1024 ||
      t_len <= 0 || t_len % chunk || batch <= 0 || n_heads <= 0)
    return cudaErrorInvalidValue;
  const bool has_state = c_in != nullptr;
  const int nc = t_len / chunk, n_bh = batch * n_heads;
  const int n_bound = nc - 1 + has_state;
  CUtensorMap q_map, k_map, v_map, c_map;
  memset(&c_map, 0, sizeof(c_map));
  if (!tensor_map(&q_map, q, batch, t_len, n_heads, d, kT, 1, kT) ||
      !tensor_map(&k_map, k, batch, t_len, n_heads, d, kT, 1, kT) ||
      !tensor_map(&v_map, v, batch, t_len, n_heads, d, kT, 1, kT))
    return cudaErrorInvalidValue;
  if (n_bound > 0) {
    const cuuint64_t dims[2] = {cuuint64_t(d), cuuint64_t(n_bound) * n_bh * kCParts * d};
    const cuuint64_t strides[1] = {cuuint64_t(d) * 2};
    const cuuint32_t box[2] = {kT, kT};
    if (c_bound == nullptr ||
        !tensor_map_bf16(&c_map, c_bound, 2, dims, strides, box))
      return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The largest call's shared memory is allowed once a device; each launch
  // asks for its own.
  static bool allowed_state[64] = {}, allowed_out[64] = {};
  cudaError_t err = allow_smem(mlstm_scan_tc_state_kernel,
                               StateSmem::bytes(1024), allowed_state);
  if (err != cudaSuccess) return err;
  err = allow_smem(mlstm_scan_tc_output_kernel, OutSmem::bytes(512, 1024),
                   allowed_out);
  if (err != cudaSuccess) return err;

  const int ct = (d + kStateTile - 1) / kStateTile;
  mlstm_scan_tc_state_kernel<<<dim3(ct, ct, n_bh), kThreads,
                               StateSmem::bytes(chunk), s>>>(
      k_map, v_map, log_i, log_f, c_in, n_in, m_in,
      static_cast<__nv_bfloat16*>(c_bound), n_prev, m_prev, bcum, c_out, n_out, m_out,
      t_len, n_heads, d, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (tiles(chunk) + 1) / 2 * nc * n_bh * ((d + kOutCols - 1) / kOutCols);
  mlstm_scan_tc_output_kernel<<<blocks, kThreads, OutSmem::bytes(d, chunk), s>>>(
      q_map, k_map, v_map, c_map, log_i, n_prev, m_prev, bcum,
      static_cast<__nv_bfloat16*>(h), t_len, n_heads, n_bh, d, chunk,
      has_state, scale);
  return cudaGetLastError();
}
