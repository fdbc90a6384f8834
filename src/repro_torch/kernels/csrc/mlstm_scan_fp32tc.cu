// fp32 chunkwise mLSTM forward for Hopper (sm_90a) on the bf16 tensor cores
// (wgmma) in split precision: two passes fed by TMA, with a plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan.py:32 (`_kernel`,
// launched through pl.pallas_call by `mlstm_scan`) for fp32 inputs whose
// chunk is a multiple of 16, in place of csrc/mlstm_scan.cu, the fp32 FMA
// kernel, which keeps the other fp32 calls.  The Python wrapper is
// src/repro_torch/kernels/mlstm_scan.py (path "tc_f32"), which also picks
// this kernel; the plain PyTorch version it is held against is
// src/repro_torch/models/xlstm.py::mlstm_chunkwise.
//
// Contract.  As csrc/mlstm_scan_tc.cu, whose expression order for the
// stabilizers, weights and denominator it keeps, with q, k, v (B,T,H,D) and
// h in fp32: q, k, v contiguous and 16-byte aligned; log_i, log_f (B,T,H)
// fp32; T a multiple of `chunk`, itself a multiple of 16 up to 1024; D a
// multiple of 16 up to 512; the state (C (D,D), n (D), m) in fp32, given or
// C = 0, n = 0, m = -inf.  q is scaled by 1/sqrt(D) in fp32 before any
// product, as the plain version scales it.
//
// Split precision.  Every fp32 operand x (q, k, v, w v, P and the carried
// C0) enters its product as three bf16 terms x = x0 + x1 + x2, each the top
// 8 significant bits of what the terms before it leave (truncation: the sum
// is exact, 3 x 8 bits covering fp32's 24).  A product a b is the six term
// products a_i b_j with i + j <= 2, smallest first (hopper.cuh pair_a,
// pair_b); the three left out are below 2^-20 |a b|.  Each step of 16 in a
// reduction takes its six in a fresh accumulator, added on the fp32 pipe
// (hopper.cuh wgmma_chain): the tensor cores' own fp32 accumulation does
// not round to nearest.  Each warpgroup waits for a step's six before it
// issues the next step's (wgmma_chain without overlap): with a second
// accumulator in flight both passes ran no faster on the H100 and the
// output pass spilled.  The chunk's k^T (w v) is summed apart from C0 and
// added to C0 once a chunk, as the plain version adds them.  The row sums
// of P, q.n0, n and the stabilizers stay on the fp32 pipe.
// tests/test_torch_split.py models this kernel's order on the CPU
// (`split_mlstm`).
//
// What bounds it on the H100.  At the xlstm-350m serving shape (B4 T512 H4
// D512, chunk 256) a call does 4.3 G multiply-adds (q k^T and P v over the
// causal half of each chunk, q C0 and k^T w v over D x D): 0.1285 ms on the
// fp32 FMA pipe, where csrc/mlstm_scan.cu computes them, and 0.05224 ms as
// six bf16 products on the tensor cores (the split floor).  It moves 84 MB
// in fp32 (0.025 ms), so the tensor cores bound it.  The split itself costs
// about ten instructions an element of every tile it reads.
//
// What the design does about it.  Two launches on one stream, as the bf16
// kernel.  fp32 tiles of 64 x 64 arrive by TMA (unswizzled) into a staging
// buffer, the block splits them into bf16 term tiles (128-byte swizzle,
// the layout the wgmma descriptors name), and the products run on wgmma
// m64n64k16.  A staging buffer is free once split, so the next tile's copy
// is in flight while the products run.
// (a) The state pass, one two-warpgroup (256-thread) block per (128 rows of
//     C, 128 columns of C, batch x head), each warpgroup owning 64 rows,
//     one block an SM: walks the chunks in order, keeps C0 and the chunk's
//     k^T (w v) in accumulators, and writes the state entering each chunk
//     that the output pass reads (C as scratch in three bf16 terms, so that
//     the output pass needs no split of it; n and m in fp32; the chunk's
//     cumulative log_f) and the final state.  64 positions a step: k and v
//     in fp32 (64 KB), their terms (96 KB).
// (b) The output pass, one warpgroup (128 threads) a block, one block per
//     (64 rows of a chunk, chunk, batch x head, 128 columns of h), heaviest
//     first.  Its 112 KB of shared memory and 236 registers a thread let
//     two blocks share an SM, so that one block's splits overlap the
//     other's products.  64 rows of Q at D = 512 are 128 KB in fp32 and 192
//     KB in terms, so both operands of every product stream through 64
//     columns of the head dim (a slab) at a time: Q's slab (16 KB fp32, 24
//     KB terms) and, per product, C0's terms (48 KB, by TMA), K's slab (16
//     KB fp32, 24 KB terms) or V's tile, 64 columns at a time through the
//     same 16 KB staging (48 KB terms).  O = c_in (Q C0), then per key tile
//     up to the diagonal S = Q K^T, P = S exp(e - m_row) masked to s <= t,
//     its row sums, and O += P V with P's terms in registers as wgmma's A
//     operand.  Q is split once for C0 and once a key tile: at D = 512 the
//     scores are computed D/128 = 4 times, where csrc/mlstm_scan.cu
//     computed them D/64 = 8 times on the fp32 pipe.
// Tiles past the chunk, T or D are masked as in the bf16 kernel: TMA reads
// zeros past T and D, steps wholly past D or the chunk are not multiplied,
// and rows past the chunk are neither summed nor stored.
//
// Measured on the H100 (PERF.md): within a block the splits and the
// products take turns.  Two output blocks an SM, where one was, made the
// scan faster; a second Q staging buffer, pairing key tiles so that Q
// is split once a pair, reading C0 back from the scratch to free
// registers, and a one-warpgroup state pass (it spilled) made none faster.  Left for later: splitting on a producer
// warpgroup so that the split overlaps the products (at 384 threads a
// block, 168 registers a thread hold too little for O, S and P), and
// computing the scores once for all columns of h.
#include "mlstm_scan.cuh"

#include <math.h>
#include <cstring>

namespace {

constexpr int kTerms = 3;                      // bf16 terms of an fp32 operand
constexpr int kTile = 2 * kT;                  // rows, columns of C or h a block owns
constexpr uint32_t kF32Box = kT * kT * 4;      // one fp32 tile of 64 x 64, 256-byte rows
constexpr uint32_t kPair = 2 * kBox;           // two bf16 tiles: one term of 128 rows

// Splits ROWS rows of 64 fp32 values at `src` (256-byte rows; rows 64 c to
// 64 c + 63 are tile c) into kTerms term tiles of 128-byte swizzled rows at
// dst + t * term, row r at byte r * 128.  Each value is multiplied first,
// by row_mul[r % 64] when row_mul is given, else by `mul`; rows with
// r % 64 >= valid are zeros.  Each thread takes 8 columns (one 16-byte
// chunk of every term) at a time.
template <int ROWS, int THREADS = kThreads>
__device__ __forceinline__ void split_rows(const float* src, uint8_t* dst,
                                           uint32_t term, const float* row_mul,
                                           float mul, int valid) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int u = threadIdx.x + i * THREADS, r = u / 8, x = u % 8;
    float f[8];
    if ((r & (kT - 1)) < valid) {
      const float4 a = *reinterpret_cast<const float4*>(src + r * kT + 8 * x);
      const float4 b = *reinterpret_cast<const float4*>(src + r * kT + 8 * x + 4);
      const float s = row_mul != nullptr ? row_mul[r & (kT - 1)] : mul;
      f[0] = a.x * s; f[1] = a.y * s; f[2] = a.z * s; f[3] = a.w * s;
      f[4] = b.x * s; f[5] = b.y * s; f[6] = b.z * s; f[7] = b.w * s;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    uint8_t* at = dst + r * 128 + ((x ^ (r & 7)) << 4);
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      uint4 w;
      w.x = split_bf16(f[0], f[1]);
      w.y = split_bf16(f[2], f[3]);
      w.z = split_bf16(f[4], f[5]);
      w.w = split_bf16(f[6], f[7]);
      *reinterpret_cast<uint4*>(at + t * term) = w;
    }
  }
}

// Waits for the next completion of barrier bar[i], whose completions this
// thread counts in bit i of `phases`.
__device__ __forceinline__ void wait_next(uint64_t* bar, int i, uint32_t& phases) {
  mbar_wait(&bar[i], (phases >> i) & 1u);
  phases ^= 1u << i;
}

// ---------------------------------------------------------------------------
// (a) The state pass.
// ---------------------------------------------------------------------------

struct StateSmem {
  // k's terms and w v's terms (kTerms x 2 tiles each), the fp32 staging (k
  // tiles 0-1, v tiles 2-3), the barrier; then li, bc, w of the chunk, n of
  // the block's rows, block_max's scratch.
  static constexpr uint32_t kTermBytes = 2 * kTerms * kPair;
  static constexpr uint32_t kStage = 4 * kF32Box;
  static __host__ __device__ size_t floats(int chunk) {
    return 3 * chunk + kTile + kThreads / 32;
  }
  static __host__ __device__ size_t bytes(int chunk) {
    return 1024 + kTermBytes + kStage + 8 + 4 * floats(chunk);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
mlstm_scan_fp32tc_state_kernel(const __grid_constant__ CUtensorMap k_map,
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
  uint8_t* k_terms = align1024(smem_raw);          // [term][tile]: k, 64 positions x 64 rows of C
  uint8_t* wv_terms = k_terms + kTerms * kPair;    // [term][tile]: w v, 64 positions x 64 columns
  float* stage = reinterpret_cast<float*>(wv_terms + kTerms * kPair);
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + 4 * kT * kT);
  float* li_s = reinterpret_cast<float*>(full + 1);
  float* bc_s = li_s + chunk;
  float* w_s = bc_s + chunk;                // log_f, then the weights w
  float* n_s = w_s + chunk;                 // n of this block's rows
  float* red_s = n_s + kTile;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
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

  float acc[2][32];  // C entering the chunk, held at its start and end only
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
  if (tid < kTile)
    n_s[tid] = n_in != nullptr && i0 + tid < d ? n_in[(size_t)bh * d + i0 + tid] : 0.f;
  float m0 = m_in != nullptr ? m_in[bh] : -INFINITY;

  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int g) {  // thread 0: k and v of job g into the staging
    const int row = (g / nsub) * chunk + (g % nsub) * kT;
    mbar_expect_tx(full, (nkb + nvb) * kF32Box);
    for (int x = 0; x < nkb; ++x)
      tma_load(stage + x * kT * kT, &k_map, full, i0 + x * kT, hh, row, b);
    for (int x = 0; x < nvb; ++x)
      tma_load(stage + (2 + x) * kT * kT, &v_map, full, j0 + x * kT, hh, row, b);
  };
  if (tid == 0 && jobs > 0) issue(0);
  uint32_t phase = 0;

  for (int kc = 0; kc < nc; ++kc) {
    // The state entering this chunk, for the output pass: kTerms bf16
    // terms, term p staged in 32 KB of the term tiles (idle here).
    if (kc > 0 || has_state) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float x0 = acc[c][4 * j + 2 * i], x1 = acc[c][4 * j + 2 * i + 1];
            const uint32_t at = staged(r_base - i0 + 8 * i, 2 * (c_base - j0 + kT * c + 8 * j));
#pragma unroll
            for (int p = 0; p < kTerms; ++p)
              *reinterpret_cast<uint32_t*>(k_terms + p * 2 * kPair + at) = split_bf16(x0, x1);
          }
      uint8_t* cb = reinterpret_cast<uint8_t*>(
          c_bound + (((size_t)(kc - !has_state) * n_bh + bh) * kTerms * d + i0) * d + j0);
      __syncthreads();
      for (int p = 0; p < kTerms; ++p) {
        const uint8_t* tile = k_terms + p * 2 * kPair;
        uint8_t* dst = cb + (size_t)p * d * d * 2;
        for (int x = tid; x < 128 * 16; x += kThreads) {
          const int r = x / 16, ch = x % 16;
          if (r < d - i0 && ch * 16 < 2 * (d - j0))
            *reinterpret_cast<uint4*>(dst + (size_t)r * d * 2 + ch * 16) =
                *reinterpret_cast<const uint4*>(tile + staged(r, ch * 16));
        }
      }
      __syncthreads();
    }
    if (owns_n && tid < kTile && i0 + tid < d)
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
    __syncthreads();

    float cs[2][32];  // this chunk's k^T (w v)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) cs[c][x] = 0.f;
    float n_part[8] = {};  // sum of w k, 8 columns, every 16th row
    for (int sub = 0; sub < nsub; ++sub) {
      const int g = kc * nsub + sub;
      const int rows = min(kT, chunk - sub * kT);  // a multiple of 16
      const float* w_sub = w_s + sub * kT;
      wait_next(full, 0, phase);
      split_rows<2 * kT>(stage, k_terms, kPair, nullptr, 1.f, rows);
      split_rows<2 * kT>(stage + 2 * kT * kT, wv_terms, kPair, w_sub, 1.f, rows);
      if (owns_n && 8 * (tid % 16) < d - i0) {  // 8 columns a thread
        const int ch = tid % 16;
        const float* k_col = stage + (ch / 8) * kT * kT + 8 * (ch % 8);
        for (int r = tid / 16; r < rows; r += 16) {
          const float4 lo = *reinterpret_cast<const float4*>(k_col + r * kT);
          const float4 hi = *reinterpret_cast<const float4*>(k_col + r * kT + 4);
          const float kf[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) n_part[e] = fmaf(w_sub[r], kf[e], n_part[e]);
        }
      }
      fence_proxy_async();
      __syncthreads();  // the staging is read, the terms are written
      if (tid == 0 && g + 1 < jobs) {
        fence_proxy_async();
        issue(g + 1);
      }
      // cs += k^T (w v): A = k (M-major), B = w v (N-major); per step of 16
      // positions and 64 columns, six term products in a fresh accumulator.
      if (live) {
        const uint64_t kd = desc_base(k_terms + wg * kBox, kGroup, 1);
        const uint64_t vd = desc_base(wv_terms, kGroup, 1);
        wgmma_chain<32, 2 * kT / 16, false>(
            [&](int q, float (&t)[32]) {
              const int ks = q / 2, c = q % 2;
              if (ks * 16 < rows && c < nvb) {
#pragma unroll
                for (int pr = 0; pr < 6; ++pr)
                  wgmma_ss_n64<1, 1>(t, desc_at(kd, pair_a(pr) * kPair + ks * kStep),
                                     desc_at(vd, pair_b(pr) * kPair + c * kBox + ks * kStep),
                                     pr > 0);
              }
            },
            [&](int q, float (&t)[32]) {
              const int ks = q / 2, c = q % 2;
              if (ks * 16 < rows && c < nvb) {
#pragma unroll
                for (int x = 0; x < 32; ++x) cs[c][x] += t[x];
              }
            });
      }
      __syncthreads();  // every warpgroup is done with the terms
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[c][x] = a * acc[c][x] + cs[c][x];
    if (owns_n) {  // the 16 row groups' sums, in the idle term tiles
      float* parts = reinterpret_cast<float*>(k_terms);
#pragma unroll
      for (int e = 0; e < 8; ++e) parts[(tid / 16) * kTile + 8 * (tid % 16) + e] = n_part[e];
    }
    __syncthreads();
    if (owns_n && tid < kTile) {
      const float* parts = reinterpret_cast<const float*>(k_terms);
      float sum = 0.f;
      for (int rg = 0; rg < 16; ++rg) sum += parts[rg * kTile + tid];
      n_s[tid] = a * n_s[tid] + sum;
    }
    m0 = m1;
    __syncthreads();  // the next chunk overwrites the gates and the term tiles
  }

  // The final C, staged 64 columns at a time.
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            k_terms + staged(r_base - i0 + 8 * i, 4 * (c_base - j0 + 8 * j))) =
            make_float2(acc[c][4 * j + 2 * i], acc[c][4 * j + 2 * i + 1]);
    store_staged(k_terms, reinterpret_cast<uint8_t*>(c_out + ((size_t)bh * d + i0) * d + j0 + kT * c),
                 (size_t)d * 4, d - i0, 4 * (d - j0 - kT * c));
  }
  if (owns_n && tid < kTile && i0 + tid < d)
    n_out[(size_t)bh * d + i0 + tid] = n_s[tid];
  if (owns_n && blockIdx.x == 0 && tid == 0) m_out[bh] = m0;
}

// ---------------------------------------------------------------------------
// (b) The output pass.
// ---------------------------------------------------------------------------

constexpr int kOutThreads = 128;  // one warpgroup a block, two blocks an SM

struct OutSmem {
  // Q's terms (kTerms x 64 rows), the B operand's terms (C0's, by TMA; or
  // K's or V's), Q's fp32 staging (64 x 64), the B operand's fp32 staging
  // (a K slab or 64 columns of V), three barriers; li, bc of the chunk;
  // m_row, c_in, q.n0 of the block's rows; n0.
  static constexpr uint32_t kBBuf = kTerms * kPair;
  static constexpr uint32_t kFixed = kTerms * kBox + kBBuf + 2 * kF32Box + 8 * 3;
  static __host__ __device__ size_t floats(int d, int chunk) {
    return 2 * chunk + 3 * kT + tiles(d) * kT;
  }
  static __host__ __device__ size_t bytes(int d, int chunk) {
    return 1024 + kFixed + 4 * floats(d, chunk);
  }
};

__global__ void __launch_bounds__(kOutThreads, 2)
mlstm_scan_fp32tc_output_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap c_map,
                                const float* __restrict__ log_i,
                                const float* __restrict__ n_prev,
                                const float* __restrict__ m_prev,
                                const float* __restrict__ bcum,
                                float* __restrict__ h_out, int t_len,
                                int n_heads, int n_bh, int d, int chunk,
                                int has_state, float scale) {
  const int nslab = tiles(d);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_terms = align1024(smem_raw);           // [term]: Q's slab, 64 rows
  uint8_t* b_terms = q_terms + kTerms * kBox;       // [term][tile]
  float* q_stage = reinterpret_cast<float*>(b_terms + OutSmem::kBBuf);
  float* b_stage = q_stage + kT * kT;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_stage + kT * kT);  // Q, C0, B staging
  float* li_s = reinterpret_cast<float*>(bar + 3);
  float* bc_s = li_s + chunk;
  float* mr_s = bc_s + chunk;               // m_row of the block's rows
  float* ci_s = mr_s + kT;                  // c_in
  float* qn_s = ci_s + kT;                  // q.n0, q scaled
  float* n0_s = qn_s + kT;                  // n0

  // Block x: heaviest first.  The chunks that carry a state in (all but the
  // first, or all with an initial state) come first, then the others; in
  // each, the row tile rt latest first (the causal work grows with it),
  // then chunk, batch x head, 128 columns of h.
  const int nc = t_len / chunk, n_rt = tiles(chunk);
  const int n_vs = (d + kTile - 1) / kTile;
  const int n_carry = has_state ? nc : nc - 1;  // chunks with a state in
  const int per_chunk = n_bh * n_vs;
  int blk = static_cast<int>(blockIdx.x), kc0 = nc - n_carry, group = n_carry;
  if (blk >= n_rt * n_carry * per_chunk) {
    blk -= n_rt * n_carry * per_chunk;
    kc0 = 0;
    group = nc - n_carry;
  }
  const int rt = n_rt - 1 - blk / (group * per_chunk);
  blk %= group * per_chunk;
  const int kc = kc0 + blk / per_chunk;
  blk %= per_chunk;
  const int bh = blk / n_vs, v0 = blk % n_vs * kTile;
  const int b = bh / n_heads, hh = bh % n_heads;
  const int r0 = rt * kT, t0 = kc * chunk;
  const int nvb = min(2, tiles(d - v0));    // 64-column tiles of h
  const bool inter = kc > 0 || has_state;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_st = rt + 1;                  // key tiles up to the diagonal
  const int n_inter = inter ? nslab : 0;

  // The copies, each issued by thread 0 once its buffer is free.  Q's
  // slabs in order, C0's (n_inter) and then each key tile's (nslab): copy
  // i, none past the last.  The B staging takes each key tile's K slabs,
  // then its V 64 columns at a time.
  const int n_q = n_inter + n_st * nslab;
  auto load_q = [&](int i) {
    if (i >= n_q) return;
    const int sl = i < n_inter ? i : (i - n_inter) % nslab;
    mbar_expect_tx(&bar[0], kF32Box);
    tma_load(q_stage, &q_map, &bar[0], sl * kT, hh, t0 + r0, b);
  };
  auto load_c0 = [&](int sl) {  // C0's terms, slab sl
    mbar_expect_tx(&bar[1], kTerms * nvb * kBox);
    for (int p = 0; p < kTerms; ++p) {
      const int row = (((kc - !has_state) * n_bh + bh) * kTerms + p) * d + sl * kT;
      for (int c = 0; c < nvb; ++c)
        tma_load_2d(b_terms + (2 * p + c) * kBox, &c_map, &bar[1], v0 + c * kT, row);
    }
  };
  auto load_k = [&](int st, int sl) {  // K's slab sl of key tile st
    mbar_expect_tx(&bar[2], kF32Box);
    tma_load(b_stage, &k_map, &bar[2], sl * kT, hh, t0 + st * kT, b);
  };
  auto load_v = [&](int st, int c) {  // V's 64 columns c of key tile st
    mbar_expect_tx(&bar[2], kF32Box);
    tma_load(b_stage, &v_map, &bar[2], v0 + c * kT, hh, t0 + st * kT, b);
  };

  // Gates of the chunk up to this block's last row and n0, asked for
  // before the tiles so that they do not queue behind them; then the row
  // statistics, two threads a row.
  const float m0 = m_prev[kc * n_bh + bh];
  const size_t gate0 = ((size_t)b * t_len + t0) * n_heads + hh;
  const float* bc_g = bcum + ((size_t)kc * n_bh + bh) * chunk;
  for (int s = tid; s < min(chunk, r0 + kT); s += kOutThreads) {
    li_s[s] = log_i[gate0 + (size_t)s * n_heads];
    bc_s[s] = bc_g[s];
  }
  for (int x = tid; x < nslab * kT; x += kOutThreads)
    n0_s[x] = inter && x < d ? n_prev[((size_t)kc * n_bh + bh) * d + x] : 0.f;
  if (tid == 0) {
    for (int x = 0; x < 3; ++x) mbar_init(&bar[x], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_q(0);
    if (inter) load_c0(0);
    load_k(0, 0);
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

  uint32_t phases = 0;  // bit x: the next completion of bar[x] to wait for
  int qi = 0;           // the next copy of Q to split
  const int lr = 16 * warp + lane / 4;  // + 8i: the block's rows
  const int lc = 2 * (lane % 4);        // + 8j + e: a tile's columns
  float o[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[c][x] = 0.f;

  // O = Q C0, C0 in kTerms terms: A = Q (K-major), B = C0 (N-major); and
  // q.n0 on the fp32 pipe from Q's fp32 slabs, two threads a row.
  float qn = 0.f;
  for (int sl = 0; sl < n_inter; ++sl) {
    const int steps = min(kT, d - sl * kT) / 16;
    wait_next(bar, 0, phases);
    split_rows<kT, kOutThreads>(q_stage, q_terms, kBox, nullptr, scale, kT);
    {
      const float* q_row = q_stage + row2 * kT;
      const float* n0 = n0_s + sl * kT;
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // rotated by row: no bank conflicts
        const int ch = (2 * k + part2 + 2 * row2) & 15;
        const float4 qv = *reinterpret_cast<const float4*>(q_row + 4 * ch);
        qn = fmaf(qv.x * scale, n0[4 * ch], qn);
        qn = fmaf(qv.y * scale, n0[4 * ch + 1], qn);
        qn = fmaf(qv.z * scale, n0[4 * ch + 2], qn);
        qn = fmaf(qv.w * scale, n0[4 * ch + 3], qn);
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      fence_proxy_async();
      load_q(qi + 1);
    }
    ++qi;
    wait_next(bar, 1, phases);
    {
      const uint64_t qd = desc_base(q_terms, kGroup, 1);
      const uint64_t cd = desc_base(b_terms, kGroup, 1);
      wgmma_chain<32, 2 * kT / 16, false>(
          [&](int q, float (&t)[32]) {
            const int kk = q / 2, c = q % 2;
            if (kk < steps && c < nvb) {
#pragma unroll
              for (int pr = 0; pr < 6; ++pr)
                wgmma_ss_n64<0, 1>(t, desc_at(qd, pair_a(pr) * kBox + kk * 32),
                                   desc_at(cd, pair_b(pr) * kPair + c * kBox + kk * kStep),
                                   pr > 0);
            }
          },
          [&](int q, float (&t)[32]) {
            const int kk = q / 2, c = q % 2;
            if (kk < steps && c < nvb) {
#pragma unroll
              for (int x = 0; x < 32; ++x) o[c][x] += t[x];
            }
          });
    }
    __syncthreads();  // the warpgroup is done with Q's and C0's terms
    if (tid == 0 && sl + 1 < nslab) {
      fence_proxy_async();
      load_c0(sl + 1);
    }
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if (part2 == 0) qn_s[row2] = qn;
  __syncthreads();

  float mr[2], ci[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mr[i] = mr_s[lr + 8 * i];
    ci[i] = ci_s[lr + 8 * i];
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[c][x] *= ci[(x / 2) % 2];

  float rowsum[2] = {0.f, 0.f};
  for (int st = 0; st < n_st; ++st) {
    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    // S = Q K^T over the head dim, a slab at a time: both K-major.
    for (int sl = 0; sl < nslab; ++sl) {
      const int steps = min(kT, d - sl * kT) / 16;
      wait_next(bar, 0, phases);
      split_rows<kT, kOutThreads>(q_stage, q_terms, kBox, nullptr, scale, kT);
      wait_next(bar, 2, phases);
      split_rows<kT, kOutThreads>(b_stage, b_terms, kBox, nullptr, 1.f, kT);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        fence_proxy_async();
        load_q(qi + 1);
        if (sl + 1 < nslab) load_k(st, sl + 1);
        else load_v(st, 0);
      }
      ++qi;
      {
        const uint64_t qd = desc_base(q_terms, kGroup, 1);
        const uint64_t kd = desc_base(b_terms, kGroup, 1);
        wgmma_chain<32, kT / 16, false>(
            [&](int kk, float (&t)[32]) {
              if (kk < steps) {
#pragma unroll
                for (int pr = 0; pr < 6; ++pr)
                  wgmma_ss_n64<0, 0>(t, desc_at(qd, pair_a(pr) * kBox + kk * 32),
                                     desc_at(kd, pair_b(pr) * kBox + kk * 32), pr > 0);
              }
            },
            [&](int kk, float (&t)[32]) {
              if (kk < steps) {
#pragma unroll
                for (int x = 0; x < 32; ++x) s[x] += t[x];
              }
            });
      }
      __syncthreads();  // the warpgroup is done with Q's and K's terms
    }
    // P = S exp(e - m_row), masked to s <= t, in kTerms bf16 terms as the
    // A fragments of 4 steps of 16 keys; its row sums on the fp32 pipe.
    uint32_t pa[kTerms][4][4];
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
            p[e] = s[4 * j + 2 * i + e] *
                   expf(((bc_s[t] - bc_s[key]) + li_s[key]) - mr[i]);
          rowsum[i] += p[e];
        }
#pragma unroll
        for (int term = 0; term < kTerms; ++term)
          pa[term][j / 2][(j % 2) * 2 + i] = split_bf16(p[0], p[1]);
      }
    // V's terms, 64 columns at a time through the staging, then O += P V,
    // V N-major.
    for (int c = 0; c < nvb; ++c) {
      wait_next(bar, 2, phases);
      split_rows<kT, kOutThreads>(b_stage, b_terms + c * kBox, kPair, nullptr, 1.f, kT);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        fence_proxy_async();
        if (c + 1 < nvb) load_v(st, c + 1);
        else if (st + 1 < n_st) load_k(st + 1, 0);
      }
    }
    {
      const uint64_t vd = desc_base(b_terms, kGroup, 1);
      wgmma_chain<32, 2 * kT / 16, false>(
          [&](int q, float (&t)[32]) {
            const int kk = q / 2, c = q % 2;
            if (c < nvb) {
#pragma unroll
              for (int pr = 0; pr < 6; ++pr)
                wgmma_rs_n64(t, pa[pair_a(pr)][kk],
                             desc_at(vd, pair_b(pr) * kPair + c * kBox + kk * kStep), pr > 0);
            }
          },
          [&](int q, float (&t)[32]) {
            const int c = q % 2;
            if (c < nvb) {
#pragma unroll
              for (int x = 0; x < 32; ++x) o[c][x] += t[x];
            }
          });
    }
    __syncthreads();  // the warpgroup is done with V's terms
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
    rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = lr + 8 * i, t = r0 + row;
    if (t >= chunk) continue;
    const float dot = rowsum[i] + ci[i] * qn_s[row];
    const float den = fmaxf(fabsf(dot), expf(-mr[i]));
    float* out = h_out + (((size_t)b * t_len + t0 + t) * n_heads + hh) * d;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + c * kT + 8 * j + lc;
        if (c < nvb && col < d)
          *reinterpret_cast<float2*>(out + col) =
              make_float2(o[c][4 * j + 2 * i] / den, o[c][4 * j + 2 * i + 1] / den);
      }
  }
}

// A tensor map over a contiguous (B, len, heads, D) fp32 tensor read in
// unswizzled boxes of 64 columns x 1 head x 64 rows of one batch; rows and
// columns past the tensor read as zeros.
bool tensor_map_tiles_f32(CUtensorMap* map, const void* base, int batch, int len,
                          int heads, int d) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(len), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 4, cuuint64_t(heads) * d * 4,
                                 cuuint64_t(len) * heads * d * 4};
  const cuuint32_t box[4] = {kT, 1, kT, 1};
  return tensor_map_f32(map, base, 4, dims, strides, box);
}

}  // namespace

// Returns the cudaError_t of the two launches (0 on success).  c_in, n_in and
// m_in are the initial state, all three null for a zero state; c_out, n_out
// and m_out receive the final state.  Scratch from the caller: c_bound, bf16
// (nc - 1 + has_state, B*H, 3, D, D), the C entering each chunk that needs
// one as three terms (null when that count is 0); n_prev (nc, B*H, D) and
// m_prev (nc, B*H), fp32, n and m entering every chunk; bcum (nc, B*H,
// chunk), fp32, each chunk's cumulative log_f.  q, k, v and h fp32;
// head_dim a multiple of 16 up to 512, chunk a multiple of 16 up to 1024,
// t_len a multiple of chunk.
extern "C" int repro_mlstm_scan_fp32tc(
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
  if (!tensor_map_tiles_f32(&q_map, q, batch, t_len, n_heads, d) ||
      !tensor_map_tiles_f32(&k_map, k, batch, t_len, n_heads, d) ||
      !tensor_map_tiles_f32(&v_map, v, batch, t_len, n_heads, d))
    return cudaErrorInvalidValue;
  if (n_bound > 0) {
    const cuuint64_t dims[2] = {cuuint64_t(d), cuuint64_t(n_bound) * n_bh * kTerms * d};
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
  cudaError_t err = allow_smem(mlstm_scan_fp32tc_state_kernel,
                               StateSmem::bytes(1024), allowed_state);
  if (err != cudaSuccess) return err;
  err = allow_smem(mlstm_scan_fp32tc_output_kernel, OutSmem::bytes(512, 1024),
                   allowed_out);
  if (err != cudaSuccess) return err;

  const int ct = (d + kTile - 1) / kTile;
  mlstm_scan_fp32tc_state_kernel<<<dim3(ct, ct, n_bh), kThreads,
                                   StateSmem::bytes(chunk), s>>>(
      k_map, v_map, log_i, log_f, c_in, n_in, m_in,
      static_cast<__nv_bfloat16*>(c_bound), n_prev, m_prev, bcum, c_out, n_out, m_out,
      t_len, n_heads, d, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = tiles(chunk) * nc * n_bh * ((d + kTile - 1) / kTile);
  mlstm_scan_fp32tc_output_kernel<<<blocks, kOutThreads, OutSmem::bytes(d, chunk), s>>>(
      q_map, k_map, v_map, c_map, log_i, n_prev, m_prev, bcum,
      static_cast<float*>(h), t_len, n_heads, n_bh, d, chunk, has_state, scale);
  return cudaGetLastError();
}
