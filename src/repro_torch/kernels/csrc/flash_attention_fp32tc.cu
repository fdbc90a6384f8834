// fp32 GQA flash-attention forward for Hopper (sm_90a) on the bf16 tensor
// cores (wgmma) in split precision, fed by TMA, with a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:39 (`_kernel`,
// launched through pl.pallas_call by `flash_attention`) for fp32 inputs, in
// place of csrc/flash_attention.cu, the fp32 FMA kernel, which it beat at
// every fp32 shape measured, decode steps included (PERF.md).  The Python
// wrapper is src/repro_torch/kernels/flash_attention.py, which also picks
// this kernel; the plain PyTorch version it is held against is
// src/repro_torch/kernels/ref.py::reference_attention.
//
// Contract.  As csrc/flash_attention.cu: q (B,T,H,D), k/v (B,S,KV,D),
// contiguous fp32, 16-byte aligned, D in {16, 32, 64, 128, 256}, G = H/KV at
// most 128 (64 at D = 256); output (B,T,H,D) fp32.  Query head h reads KV
// head h / G.  q is scaled by 1/sqrt(D) in fp32 before q.k.  Key s is visible
// to query t iff kv_pos[s] >= 0, and (causal) kv_pos[s] <= q_pos[t], and
// (window > 0) q_pos[t] - kv_pos[s] < window.  Online softmax in fp32; a row
// that sees no key is zeros.  T and S are padded here: TMA fills the rows
// past T and S with zeros, and a key past S has position -1.  With a
// non-null `lse` the kernel also writes each row's log-sum-exp of the scaled
// scores, m + log(l), fp32 (B,H,T), and 1e30 for a row that sees no key.
//
// Split precision.  Every fp32 operand x is split into three bf16 terms
// x = x0 + x1 + x2, each the top 8 significant bits of what the terms before
// it leave (truncation: the sum is exact, 3 x 8 bits covering fp32's 24).  A
// product a b is the sum of the six term products a_i b_j with i + j <= 2,
// each exact in the tensor cores; the three left out are below 2^-20 |a b|.
// The products go in order of size, smallest first (i + j = 2, then 1, then
// 0), and each step of 16 in the reduction takes its six in a fresh
// accumulator that is added on the fp32 pipe (hopper.cuh wgmma_chain): the
// tensor cores' own accumulation does not round to nearest (at D = 256, P V
// goes straight into O: see there).  P is split the same way in registers,
// as the A operand of P V.  tests/test_torch_split.py models this split on
// the CPU and holds it to float64 within a quarter of the fp32 tolerance
// (2e-5) on the hazard inputs (kernels/flash_attention.py's FP32_TERMS is
// the term count both read).
//
// What bounds it on the H100.  At the llama3.2-3b shape (B4, T = S = 512,
// H24, KV8, D128, causal) a call does 6.4 GFLOP of causal work: 0.096 ms on
// the fp32 FMA pipe (67 TFLOP/s), where csrc/flash_attention.cu computes it,
// and 0.039 ms as six bf16 products on the tensor cores (989 TFLOP/s over 6,
// about 165 TFLOP/s of fp32 work).  It moves 67 MB (0.020 ms at 3.35 TB/s), so
// the tensor cores' rate bounds it.  The split itself is about 10
// instructions an element of each K/V tile, once per tile per block.  It
// runs at 0.16 ms there (PERF.md), 4x the split's floor.
//
// What the design does about it.  One block per (batch, KV head, tile of
// positions), latest tile first (causal work grows with the position); its
// rows are the (position, head) pairs of the tile, row p G + g, so that one
// K/V tile feeds all G query heads of the group: 128 rows, two warpgroups of
// 64, up to D = 128; 64 rows, one warpgroup, at D = 256, where a
// warpgroup's O (64 x 256 fp32) is 128 registers a thread.  Every thread
// both splits and multiplies (no warp specialization): per visible tile, the
// fp32 K tile arrives by TMA in a staging buffer, the block splits it into
// three bf16 term tiles (128-byte swizzle, the layout the wgmma descriptors
// name), S = Q K^T runs as wgmma m64nNk16 (N = the tile's keys) over the
// term pairs, the online softmax works on the fp32 accumulators, then the V
// tile is split into the same term buffer and O += P V runs with P's terms
// in registers.  K and V have a staging buffer each, so the next tile's K
// (and V) copy is in flight while this one's products run.  Q arrives by TMA
// into the staging buffers before the first tile and is scaled and split
// once.  Head dims below 64 are padded to 64 columns (zero terms), so that
// every tile has 128-byte rows.  Tiles are 64 keys, 32 at D = 256: there Q's
// terms (96 KB), one tile's terms (48 KB) and the two fp32 staging buffers
// (64 KB) fill the shared memory.  A tile that no row can see (from the
// block's least and greatest query position and the window's lower edge:
// exact, decided on the device) is never loaded; a tile every row sees whole
// is not masked.  One warp finds the next visible tile while the products
// run and publishes its key positions beside it.
//
// Left for later: splitting on a producer warpgroup so that the split
// overlaps the products, and more than one block an SM.
#include "hopper.cuh"

#include <climits>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTerms = 3;  // bf16 terms of each fp32 operand (FP32_TERMS)

template <int D>
struct Layout {
  static constexpr int kDP = D < 64 ? 64 : D;        // head dim padded to 64
  static constexpr int kWarpgroups = D == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kWarpgroups;      // (position, head) rows
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kKeys = D == 256 ? 32 : 64;   // keys a tile
  static constexpr int kBlocks = kDP / 64;            // 64-column swizzled blocks
  static constexpr uint32_t kQBlock = kRows * 128;    // a column block of Q
  static constexpr uint32_t kQTerm = kBlocks * kQBlock;
  static constexpr uint32_t kKVBlock = kKeys * 128;   // a column block of K or V
  static constexpr uint32_t kKVTerm = kBlocks * kKVBlock;
  static constexpr uint32_t kStage = kKeys * D * 4;   // one fp32 K or V tile
  static_assert(kRows * D * 4 <= 2 * kStage, "Q's fp32 rows fill the staging");
  // Q's terms, the tile's terms, two staging buffers, then the barriers
  // (q_full, full[2]) and two slots of tile metadata (index, full, key
  // positions); 1024 bytes of slack to align the start.
  static constexpr size_t kSmem = 1024 + kTerms * (kQTerm + kKVTerm) +
                                  2 * kStage + 8 * 3 + 4 * 2 * (2 + kKeys);
  static_assert(kSmem <= 232448, "a block's shared memory exceeds the H100's");
};

// The byte of 16-byte chunk x of row r in a tile of 128-byte rows stored
// with TMA's 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int x) {
  return r * 128 + ((x ^ (r & 7)) << 4);
}

// Splits `rows` fp32 rows of D values (`src`, row-major, times `scale`) into
// kTerms term tiles at `dst`, each kBlocks column blocks of `block` bytes,
// padded to kDP columns; rows at or past `live` are zeros.  Each thread takes
// 8 columns (one 16-byte chunk of every term) at a time, one chunk after
// another at D = 256, where O's 128 registers leave no room for more.
template <int D, int kThreadsT>
__device__ __forceinline__ void split_rows(const float* src, uint8_t* dst,
                                           int rows, int live, uint32_t block,
                                           uint32_t term, float scale) {
  constexpr int kChunks = Layout<D>::kDP / 8;
  constexpr int kUnroll = D == 256 ? 1 : 4;
#pragma unroll (kUnroll)
  for (int u = threadIdx.x; u < rows * kChunks; u += kThreadsT) {
    const int r = u / kChunks, x = u % kChunks;
    float f[8];
    if (r < live && x * 8 < D) {
      const float4 a = *reinterpret_cast<const float4*>(src + r * D + 8 * x);
      const float4 b = *reinterpret_cast<const float4*>(src + r * D + 8 * x + 4);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    uint8_t* at = dst + (x / 8) * block + swz(r, x % 8);
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

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// S (64 x N) = A B^T (+ S with scale_d), both K-major.
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&s)[N / 2], uint64_t a, uint64_t b,
                                             int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64<0, 0>(s, a, b, scale_d);
  else wgmma_ss_n32<0, 0>(s, a, b, scale_d);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_attention_fp32tc_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const int* __restrict__ q_pos,
                              const int* __restrict__ kv_pos,
                              float* __restrict__ out, float* __restrict__ lse,
                              int t_len, int s_len, int n_heads,
                              int n_kv_heads, int n_bkv, int positions,
                              int causal, int window, float scale) {
  using L = Layout<D>;
  constexpr int kKeys = L::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_t = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kv_t = q_t + kTerms * L::kQTerm;          // the tile's terms
  float* stage = reinterpret_cast<float*>(kv_t + kTerms * L::kKVTerm);
  float* stage_k = stage;                             // K, and first Q
  float* stage_v = stage + L::kStage / 4;             // V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stage + L::kStage / 2);
  uint64_t* full = q_full + 1;                        // [0]: K, [1]: V
  int* meta = reinterpret_cast<int*>(full + 2);       // [slot]: tile, full, kpos

  const int group = n_heads / n_kv_heads;
  const int n_q_tiles = (t_len + positions - 1) / positions;
  const int t0 = (n_q_tiles - 1 - static_cast<int>(blockIdx.x) / n_bkv) * positions;
  const int b = static_cast<int>(blockIdx.x) % n_bkv / n_kv_heads;
  const int kvh = static_cast<int>(blockIdx.x) % n_kv_heads;
  const int used_rows = group * positions;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int n_k_tiles = (s_len + kKeys - 1) / kKeys;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0 keeps the least and greatest query position of the block, which
  // bound what any of its rows can see.
  int q_lo = INT_MAX, q_hi = INT_MIN;
  if (warp == 0) {
    for (int p = lane; p < positions && t0 + p < t_len; p += 32) {
      q_lo = min(q_lo, q_pos[t0 + p]);
      q_hi = max(q_hi, q_pos[t0 + p]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      q_lo = min(q_lo, __shfl_xor_sync(0xffffffffu, q_lo, o));
      q_hi = max(q_hi, __shfl_xor_sync(0xffffffffu, q_hi, o));
    }
    if (lane == 0) {
      mbar_expect_tx(q_full, used_rows * D * 4);
      tma_load(stage, &q_map, q_full, 0, kvh * group, t0, b);
    }
  }
  // Warp 0: the first visible tile at or after kt into metadata slot `slot`
  // (index -1: none left), and its K (and V) copies, or the arrival that
  // tells the block there is none.  Returns its index (n_k_tiles: none).
  auto publish = [&](int kt, int slot, bool with_v) {
    int* m = meta + slot * (2 + kKeys);
    for (; kt < n_k_tiles; ++kt) {
      bool any = false;
      int kp[kKeys / 32], kp_lo = INT_MAX, kp_hi = INT_MIN;
#pragma unroll
      for (int j = 0; j < kKeys / 32; ++j) {
        const int s = kt * kKeys + 32 * j + lane;
        kp[j] = s < s_len ? kv_pos[s] : -1;
        any = any || (kp[j] >= 0 && (!causal || kp[j] <= q_hi) &&
                      (window <= 0 || static_cast<long long>(kp[j]) >
                                          static_cast<long long>(q_lo) - window));
        kp_lo = min(kp_lo, kp[j]);
        kp_hi = max(kp_hi, kp[j]);
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        kp_lo = min(kp_lo, __shfl_xor_sync(0xffffffffu, kp_lo, o));
        kp_hi = max(kp_hi, __shfl_xor_sync(0xffffffffu, kp_hi, o));
      }
#pragma unroll
      for (int j = 0; j < kKeys / 32; ++j) m[2 + 32 * j + lane] = kp[j];
      if (lane == 0) {
        m[0] = kt;
        m[1] = kp_lo >= 0 && (!causal || kp_hi <= q_lo) &&
               (window <= 0 || static_cast<long long>(q_hi) - kp_lo < window);
      }
      __syncwarp();  // lane 0's arrive below releases the warp's stores
      if (lane == 0) {
        fence_proxy_async();
        mbar_expect_tx(&full[0], L::kStage);
        tma_load(stage_k, &k_map, &full[0], 0, kvh, kt * kKeys, b);
        if (with_v) {
          mbar_expect_tx(&full[1], L::kStage);
          tma_load(stage_v, &v_map, &full[1], 0, kvh, kt * kKeys, b);
        }
      }
      __syncwarp();
      return kt;
    }
    if (lane == 0) {
      m[0] = -1;
      mbar_arrive(&full[0]);
    }
    __syncwarp();
    return n_k_tiles;
  };

  // This thread's rows of the block: row0 and row0 + 8 (row r is position
  // r / G, head r % G of the group).
  const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  int qp[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i, t = t0 + r / group;
    live[i] = r < used_rows && t < t_len;
    qp[i] = live[i] ? q_pos[t] : 0;
  }

  // Q, scaled and split once; then the first tile's copies.
  mbar_wait(q_full, 0);
  split_rows<D, L::kThreads>(stage, q_t, L::kRows, used_rows, L::kQBlock,
                             L::kQTerm, scale);
  fence_proxy_async();
  __syncthreads();
  int next_v = 0;  // warp 0: the tile whose V copy goes next
  if (warp == 0) next_v = publish(0, 0, true);

  constexpr int kOBlocks = L::kBlocks;  // 64-column blocks of O
  float o[kOBlocks][32];
#pragma unroll
  for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint8_t* q_wg = q_t + 64 * wg * 128;

  for (int it = 0;; ++it) {
    const int slot = it & 1;
    const int* mt = meta + slot * (2 + kKeys);
    mbar_wait(&full[0], slot);
    const int kt = mt[0];
    if (kt < 0) break;
    const bool full_tile = mt[1] != 0;
    split_rows<D, L::kThreads>(stage_k, kv_t, kKeys, kKeys, L::kKVBlock,
                               L::kKVTerm, 1.f);
    fence_proxy_async();
    __syncthreads();
    // Warp 0: the next visible tile's K copy into the free K buffer.
    if (warp == 0) {
      const int nt = publish(kt + 1, slot ^ 1, false);
      next_v = nt;
    }

    // S = Q K^T over the padded head dim in steps of 16: each step's six
    // term products, smallest first, in a fresh accumulator, added to S on
    // the fp32 pipe.
    float s[kKeys / 2];
#pragma unroll
    for (int j = 0; j < kKeys / 2; ++j) s[j] = 0.f;
    const uint64_t qd = desc_base(q_wg, 1024, 1), kd = desc_base(kv_t, 1024, 1);
    // (At D = 256 one accumulator in turn: O's 128 registers leave no room
    // for two.)
    wgmma_chain<kKeys / 2, L::kDP / 16, D != 256>(
        [&](int kk, float (&acc)[kKeys / 2]) {
          const uint32_t off = (kk / 4) * L::kQBlock + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * L::kKVBlock + (kk % 4) * 32;
#pragma unroll
          for (int pr = 0; pr < 6; ++pr)
            wgmma_scores<kKeys>(acc, desc_at(qd, pair_a(pr) * L::kQTerm + off),
                                desc_at(kd, pair_b(pr) * L::kKVTerm + koff), pr > 0);
        },
        [&](int, float (&acc)[kKeys / 2]) {
#pragma unroll
          for (int j = 0; j < kKeys / 2; ++j) s[j] += acc[j];
        });

    // The mask (bit idx of vis for s[idx]; all set in a full tile) and the
    // running max.
    uint32_t vis = ~0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = mt[2 + 8 * j + 2 * (lane % 4) + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          bool ok = true;
          if (!full_tile) {
            ok = kp >= 0;
            if (causal) ok = ok && kp <= qp[i];
            if (window > 0) ok = ok && qp[i] - kp < window;
          }
          if (ok) mx[i] = fmaxf(mx[i], s[idx]);
          else vis &= ~(1u << idx);
        }
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P in kTerms bf16 terms, as the A fragments of kKeys / 16 steps of 16
    // keys.  Masked after the exp: in a row with nothing visible yet m is
    // -1e30 and the exp would be 1, not 0.
    uint32_t pa[kTerms][kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * j + 2 * i;
        float p0 = (vis >> idx) & 1u ? expf(s[idx] - m[i]) : 0.f;
        float p1 = (vis >> (idx + 1)) & 1u ? expf(s[idx + 1] - m[i]) : 0.f;
        l[i] += p0 + p1;
#pragma unroll
        for (int t = 0; t < kTerms; ++t)
          pa[t][j / 2][(j % 2) * 2 + i] = split_bf16(p0, p1);
      }
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] *= alpha[(j / 2) % 2];
    __syncthreads();  // every warpgroup is done with K's terms

    // V's terms in the same buffer, then O += P V, term pairs smallest first.
    mbar_wait(&full[1], slot);
    split_rows<D, L::kThreads>(stage_v, kv_t, kKeys, kKeys, L::kKVBlock,
                               L::kKVTerm, 1.f);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && next_v < n_k_tiles) {
      fence_proxy_async();
      mbar_expect_tx(&full[1], L::kStage);
      tma_load(stage_v, &v_map, &full[1], 0, kvh, next_v * kKeys, b);
    }
    // Per 64 columns of O and step of 16 keys, the six term products in a
    // fresh accumulator, added to O on the fp32 pipe.
    constexpr int kSteps = kKeys / 16;
    const uint64_t vd = desc_base(kv_t, 1024, 1);
    auto pv = [&](int g, float (&acc)[32], bool fresh) {
      const int c = g / kSteps, kk = g % kSteps;
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
        wgmma_rs_n64(acc, pa[pair_a(pr)][kk],
                     desc_at(vd, pair_b(pr) * L::kKVTerm + c * L::kKVBlock + kk * 16 * 128),
                     !fresh || pr > 0);
    };
    if constexpr (D == 256) {
      // O's 128 registers leave none for a fresh accumulator: the products
      // go into O, each step's six smallest first (so chained, the largest
      // error on the H100 hazards at D = 256 was 5.3e-6, a quarter of the
      // fp32 tolerance).
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < kOBlocks * kSteps; ++g) pv(g, o[g / kSteps], false);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c) fence_regs(o[c]);
    } else {
      wgmma_chain<32, kOBlocks * kSteps>(
          [&](int g, float (&acc)[32]) { pv(g, acc, true); },
          [&](int g, float (&acc)[32]) {
#pragma unroll
            for (int j = 0; j < 32; ++j) o[g / kSteps][j] += acc[j];
          });
    }
    __syncthreads();  // every warpgroup is done with V's terms
  }

  // Each of the 4 lanes of a row holds part of its sum.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int r = row0 + 8 * i, t = t0 + r / group;
    const int h = kvh * group + r % group;
    float* orow = out + ((size_t)(b * t_len + t) * n_heads + h) * D;
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)b * n_heads + h) * t_len + t] = l[i] > 0.f ? m[i] + logf(l[i]) : 1e30f;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[c][4 * j + 2 * i] * inv, o[c][4 * j + 2 * i + 1] * inv);
      }
  }
}

// A tensor map over a contiguous (B, len, heads, D) fp32 tensor whose box is
// D columns x `box_heads` heads x `box_rows` rows of one batch, unswizzled;
// rows and heads past the tensor read as zeros.
bool tensor_map_rows_f32(CUtensorMap* map, const void* base, int batch, int len,
                         int heads, int d, int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(len), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 4, cuuint64_t(heads) * d * 4,
                                 cuuint64_t(len) * heads * d * 4};
  const cuuint32_t box[4] = {cuuint32_t(d), cuuint32_t(box_heads),
                             cuuint32_t(box_rows), 1};
  return tensor_map_f32(map, base, 4, dims, strides, box);
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* out;
  float* lse;
  int batch, t_len, s_len, n_heads, n_kv_heads, positions, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  using L = Layout<D>;
  const int group = a.n_heads / a.n_kv_heads;
  if (a.positions * group > L::kRows) return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map_rows_f32(&q_map, a.q, a.batch, a.t_len, a.n_heads, D, group,
                           a.positions) ||
      !tensor_map_rows_f32(&k_map, a.k, a.batch, a.s_len, a.n_kv_heads, D, 1,
                           L::kKeys) ||
      !tensor_map_rows_f32(&v_map, a.v, a.batch, a.s_len, a.n_kv_heads, D, 1,
                           L::kKeys))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_fp32tc_kernel<D>;
  static bool allowed[64] = {};
  const cudaError_t err = allow_smem(kernel, L::kSmem, allowed);
  if (err != cudaSuccess) return err;
  const int n_bkv = a.batch * a.n_kv_heads;
  const int n_q_tiles = (a.t_len + a.positions - 1) / a.positions;
  kernel<<<n_bkv * n_q_tiles, L::kThreads, L::kSmem, a.stream>>>(
      q_map, k_map, v_map, a.q_pos, a.kv_pos, static_cast<float*>(a.out), a.lse,
      a.t_len, a.s_len, a.n_heads, a.n_kv_heads, n_bkv, a.positions, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  q_pos holds T
// entries and kv_pos S; `positions` query positions per block, with
// positions x (n_heads / n_kv_heads) <= 128 (64 at head_dim 256); head_dim
// 16, 32, 64, 128 or 256; q, k, v and out fp32; lse null or fp32 (B,H,T).
extern "C" int repro_flash_attention_fp32tc(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, float* lse, int batch, int t_len, int s_len,
    int n_heads, int n_kv_heads, int head_dim, int positions, int causal,
    int window, float scale, void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads || positions <= 0 ||
      positions > 128 || batch <= 0 || t_len <= 0 || s_len <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, q_pos, kv_pos, out, lse, batch, t_len, s_len, n_heads,
               n_kv_heads, positions, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16: return launch<16>(a);
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    case 128: return launch<128>(a);
    case 256: return launch<256>(a);
    default: return cudaErrorInvalidValue;
  }
}
