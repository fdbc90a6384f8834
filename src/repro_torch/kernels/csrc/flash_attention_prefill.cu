// bf16 GQA flash-attention prefill for Hopper (sm_90a): wgmma and TMA, with a
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:39 (`_kernel`,
// launched through pl.pallas_call by `flash_attention`) for bf16 inputs with
// more than 16 query positions.  The Python wrapper is
// src/repro_torch/kernels/flash_attention.py, which also picks this kernel;
// the plain PyTorch version it is held against is
// src/repro_torch/kernels/ref.py::reference_attention.
//
// Contract.  q (B,T,H,D), k/v (B,S,KV,D), contiguous bf16, 16-byte aligned,
// D in {16, 32, 64, 128, 256}, G = H/KV at most 192 (64 at D = 256);
// output (B,T,H,D) bf16.
// Query head h reads KV head h / G.  Scores q.k are fp32 and scaled by
// 1/sqrt(D) there.  Key s is visible to query t iff kv_pos[s] >= 0, and
// (causal) kv_pos[s] <= q_pos[t], and (window > 0) q_pos[t] - kv_pos[s] <
// window.  Online softmax in fp32; P is rounded to bf16 for P.V; a row that
// sees no key is exactly zero.  T and S are padded here: TMA fills the rows
// past T and S with zeros, and a key past S has position -1.  With a
// non-null `lse` the kernel also writes each row's log-sum-exp of the scaled
// scores, fp32 (B,H,T): m/sqrt(D) + log(l) from the online softmax it keeps
// (l summed from the fp32 P, before P is rounded to bf16), and 1e30 for a
// row that sees no key.  Training saves it for the backward, which
// recomputes P = exp(s - lse); serving passes null.
//
// What bounds it on the H100.  At the llama3.2-3b serving shape (B4, T = S =
// 512, H24, KV8, D128, causal) one launch moves 33.6 MB and does 6.4 GFLOP
// of causal work: at the bf16 tensor-core peak (989 TFLOP/s) that is 6.5 us
// against 10 us for the bytes at 3.35 TB/s, so the bound is the bytes, and
// only if each K/V tile is read once for all G query heads of its group.
//
// What the design does about it.  One block per (batch, KV head, tile of P =
// 192 / G query positions), launched latest tile first because causal work
// grows with the position.  Its 192 rows are the (position, head) pairs of
// the tile, row p*G + g, so that one K/V tile in shared memory feeds all G
// heads; at G = 3 that is 64 positions x 3 heads.  Three consumer
// warpgroups own 64 rows each.  One warp of a fourth, producer warpgroup
// walks the KV tiles of 64 keys, skips a tile no row can see (from the
// block's least and greatest query position and the window's lower edge:
// exact, decided on the device), marks a tile every row sees whole as
// full, and loads the others by TMA into a 3-stage ring signalled by
// mbarriers.  The producer gives up registers (setmaxnreg) so that each
// consumer thread holds its O (64 x D fp32 a warpgroup) and S tile without
// spilling.  S = Q.K^T runs as wgmma m64n64k16 with Q and K from shared
// memory; the fp32 online softmax works on the accumulator registers, with
// the mask only on tiles that are not full and the 1/sqrt(D) scale folded
// into the exponent; P goes to bf16 in registers as the A operand of O +=
// P.V (wgmma m64nNk16, N = min(D, 64), V read transposed from shared
// memory).  Q, K and V tiles are stored with the TMA swizzle that the wgmma
// descriptors name (128, 64 or 32 bytes wide by D).
//
// At D = 256 (gemma3-1b) a warpgroup's O of 64 rows x 256 columns is 128
// fp32 registers a thread, and with S, P and the rest beside it ptxas does
// not fit the consumer code of a three-warpgroup block into the registers
// it gives that region, though setmaxnreg grants 232: O spills and the
// wgmma serialize (ptxas C7512).  So at D = 256 (Layout<D>) the two consumer
// warpgroups share the same 64 rows (P = 64 / G positions) and split O's
// columns: each holds 128 of them (64 registers) and computes the same S
// and softmax for its half of P.V.  Q.K^T runs 16 k16 steps across the K
// tile's four 64-column swizzled blocks.  Q is 32 KB and the 3-stage K/V
// ring 192 KB.  At gemma3-1b's serving shape (B4, T = S = 512, H4, KV1,
// D256) one launch moves 10.5 MB (3.1 us at 3.35 TB/s, against 2.2 us for
// its 2.15 GFLOP), and at G = 4 a block holds 16 positions: 128 blocks on
// the 132 SMs.
//
// Left for later: overlapping one warpgroup's softmax with another's
// products (ping-pong), and a persistent grid that packs the uneven causal
// blocks onto the SMs.
#include "hopper.cuh"

#include <climits>

namespace {

constexpr int kBN = 64;                      // keys per K/V tile
constexpr int kStages = 3;                   // K/V tiles in flight
// Registers a thread: the producer warpgroup gives most of its share to the
// consumers, whose accumulators (O and S, 96 fp32 at D = 128) need more
// than the 128 an even split of the SM's 65,536 leaves.
constexpr int kProducerRegs = 40;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit, one instruction (exp2f adds a
// denormal fix-up that this softmax does not need).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Layout {
  // Consumer warpgroups, and how many of them share a row, each holding
  // 1 / kColSplit of O's columns: three with a row each up to D = 128,
  // two sharing 64 rows at D = 256.
  static constexpr int kWarpgroups = D == 256 ? 2 : 3;
  static constexpr int kColSplit = D == 256 ? 2 : 1;
  static constexpr int kRows = 64 * kWarpgroups / kColSplit;  // (position, head)
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  static constexpr int kConsumerRegs =
      (65536 - 128 * kProducerRegs) / kConsumers / 8 * 8;
  static constexpr int kCol = D < 64 ? D : 64;   // columns of a swizzled block
  static constexpr int kColBlocks = D / kCol;
  static constexpr int kOBlocks = kColBlocks / kColSplit;  // of O, a warpgroup
  static constexpr uint32_t kRowBytes = kCol * 2;
  static constexpr uint32_t kGroup = 8 * kRowBytes;       // one 8-row group
  static constexpr uint64_t kSwizzle =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kQBlock = kRows * kRowBytes;  // Q, one col block
  static constexpr uint32_t kKVBlock = kBN * kRowBytes;   // K or V, one col block
  static constexpr uint32_t kTile = kBN * D * 2;          // K or V tile
  static constexpr uint32_t kQBytes = kColBlocks * kQBlock;
  // Q, the K ring, the V ring, then full, empty and q barriers, the tile
  // code and the key positions of each stage; 1024 bytes of slack to align
  // the start.
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTile +
                                  8 * (2 * kStages + 1) + 4 * kStages * (1 + kBN);
  static_assert(kSmem <= 232448, "a block's shared memory exceeds the H100's");
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_attention_prefill_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const int* __restrict__ q_pos,
                               const int* __restrict__ kv_pos,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, int batch,
                               int t_len, int s_len, int n_heads,
                               int n_kv_heads, int positions, int causal,
                               int window, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* k_s = q_s + L::kQBytes;             // [stage][col block][64 keys]
  uint8_t* v_s = k_s + kStages * L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * L::kTile);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  int* tile_s = reinterpret_cast<int*>(q_full + 1);  // kStages: its kind
  int* kpos_s = tile_s + kStages;                     // kStages x kBN

  const int group = n_heads / n_kv_heads;
  const int n_bkv = batch * n_kv_heads;
  const int n_q_tiles = (t_len + positions - 1) / positions;
  const int t0 = (n_q_tiles - 1 - static_cast<int>(blockIdx.x) / n_bkv) *
                 positions;
  const int b = static_cast<int>(blockIdx.x) % n_bkv / n_kv_heads;
  const int kvh = static_cast<int>(blockIdx.x) % n_kv_heads;
  const int used_rows = group * positions;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], L::kConsumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= L::kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp != L::kConsumers / 32) return;  // one warp of it does the work
    // Producer.  The least and greatest query position of the block bound
    // what any of its rows can see.
    int q_lo = INT_MAX, q_hi = INT_MIN;
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
      mbar_expect_tx(q_full, used_rows * D * 2);
      for (int c = 0; c < L::kColBlocks; ++c)
        tma_load(q_s + c * L::kQBlock, &q_map, q_full, c * L::kCol,
                 kvh * group, t0, b);
    }
    const int n_k_tiles = (s_len + kBN - 1) / kBN;
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_k_tiles; ++kt) {
      // A tile with no key in [q_lo - window + 1, q_hi] (or no key at all)
      // is seen by no row: skipping it is exact.  A tile whose every key
      // every row sees needs no mask: it goes as "full".
      bool any = false;
      int kp[2], kp_lo = INT_MAX, kp_hi = INT_MIN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = kt * kBN + 32 * j + lane;
        kp[j] = s < s_len ? kv_pos[s] : -1;
        any = any || (kp[j] >= 0 && (!causal || kp[j] <= q_hi) &&
                      (window <= 0 ||
                       static_cast<long long>(kp[j]) >
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
      const bool full_tile =
          kp_lo >= 0 && (!causal || kp_hi <= q_lo) &&
          (window <= 0 || static_cast<long long>(q_hi) - kp_lo < window);
      mbar_wait(&empty[stage], phase ^ 1);
      // The key positions go with the tile, for the mask; lane 0's arrive
      // below releases the whole warp's stores (ordered by the __syncwarp).
      kpos_s[stage * kBN + lane] = kp[0];
      kpos_s[stage * kBN + 32 + lane] = kp[1];
      __syncwarp();
      if (lane == 0) {
        tile_s[stage] = full_tile;
        mbar_expect_tx(&full[stage], 2 * L::kTile);
        for (int c = 0; c < L::kColBlocks; ++c) {
          const uint32_t off = stage * L::kTile + c * L::kKVBlock;
          tma_load(k_s + off, &k_map, &full[stage], c * L::kCol, kvh,
                   kt * kBN, b);
          tma_load(v_s + off, &v_map, &full[stage], c * L::kCol, kvh,
                   kt * kBN, b);
        }
      }
      __syncwarp();
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) {
      tile_s[stage] = -1;  // no more tiles
      mbar_arrive(&full[stage]);
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 rg .. 64 rg + 63 (rg = wg /
  // kColSplit) and O's column blocks kOBlocks cg .. (cg = wg % kColSplit);
  // this thread rows row0 and row0 + 8 (row r is position r / G, head r % G
  // of the group).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(L::kConsumerRegs));
  const int wg = warp / 4;
  const int rg = wg / L::kColSplit, cg = wg % L::kColSplit;
  const int row0 = 64 * rg + 16 * (warp % 4) + lane / 4;
  int qp[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i, t = t0 + r / group;
    live[i] = r < used_rows && t < t_len;
    qp[i] = live[i] ? q_pos[t] : 0;
  }
  float o[L::kOBlocks][L::kCol / 2];
#pragma unroll
  for (int c = 0; c < L::kOBlocks; ++c)
#pragma unroll
    for (int j = 0; j < L::kCol / 2; ++j) o[c][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint8_t* q_wg = q_s + 64 * rg * L::kRowBytes;

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(&full[stage], phase);
    const int code = tile_s[stage];  // 1: full tile, 0: masked, -1: done
    if (code < 0) break;
    const bool full_tile = code == 1;
    const uint8_t* kt_s = k_s + stage * L::kTile;
    const uint8_t* vt_s = v_s + stage * L::kTile;

    // S = Q.K^T over D in steps of 16.
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / L::kCol, off = (kk * 16 % L::kCol) * 2;
      wgmma_ss_n64<0, 0>(s,
                   smem_desc(q_wg + c * L::kQBlock + off, L::kGroup, L::kSwizzle),
                   smem_desc(kt_s + c * L::kKVBlock + off, L::kGroup, L::kSwizzle),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // The mask (bit 4j + 2i + e of vis for s[4j + 2i + e]; all set in a
    // full tile) and the running max, on the unscaled scores.
    uint32_t vis = ~0u;
    float mx[2] = {kNegInf, kNegInf};
    if (full_tile) {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx)
        mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], s[idx]);
    } else {
      vis = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kpos_s[stage * kBN + 8 * j + 2 * (lane % 4) + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bool ok = kp >= 0;
            if (causal) ok = ok && kp <= qp[i];
            if (window > 0) ok = ok && qp[i] - kp < window;
            const int idx = 4 * j + 2 * i + e;
            if (ok) {
              vis |= 1u << idx;
              mx[i] = fmaxf(mx[i], s[idx]);
            }
          }
        }
    }
    // Scores are scaled by 1/sqrt(D), in log2 units, inside the exponent:
    // p = 2^(s scale_log2 - m scale_log2).
    float alpha[2], m_scaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = ex2((m[i] - m_new) * scale_log2);
      m[i] = m_new;
      m_scaled[i] = m_new * scale_log2;
      l[i] *= alpha[i];
    }
    // P in bf16, as the A fragments of 4 steps of 16 keys.  Masked after
    // the exp: in a row with nothing visible yet m is -1e30 and the exp
    // would not be 0.
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * j + 2 * i;
        float p0 = ex2(fmaf(s[idx], scale_log2, -m_scaled[i]));
        float p1 = ex2(fmaf(s[idx + 1], scale_log2, -m_scaled[i]));
        if (!full_tile) {
          p0 = (vis >> idx) & 1u ? p0 : 0.f;
          p1 = (vis >> (idx + 1)) & 1u ? p1 : 0.f;
        }
        l[i] += p0 + p1;
        pa[j / 2][(j % 2) * 2 + i] = pack_bf16(p0, p1);
      }
    // Rescale O where the max moved in some row of the warp.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < L::kOBlocks; ++c)
#pragma unroll
        for (int j = 0; j < L::kCol / 2; ++j) o[c][j] *= alpha[(j / 2) % 2];
    }

    // O += P.V over the 64 keys in steps of 16, this warpgroup's columns.
#pragma unroll
    for (int c = 0; c < L::kOBlocks; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kOBlocks; ++c)
        wgmma_rs<L::kCol>(o[c], pa[kk],
                          smem_desc(vt_s + (cg * L::kOBlocks + c) * L::kKVBlock +
                                        kk * 16 * L::kRowBytes,
                                    L::kGroup, L::kSwizzle));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < L::kOBlocks; ++c) fence_regs(o[c]);

    mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
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
    __nv_bfloat16* orow = out + ((size_t)(b * t_len + t) * n_heads + h) * D;
    if (lse != nullptr && cg == 0 && lane % 4 == 0)
      lse[((size_t)b * n_heads + h) * t_len + t] =
          l[i] > 0.f ? (m[i] * scale_log2 + log2f(l[i])) * kLn2 : 1e30f;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < L::kOBlocks; ++c)
#pragma unroll
      for (int j = 0; j < L::kCol / 8; ++j) {
        const int col = (cg * L::kOBlocks + c) * L::kCol + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[c][4 * j + 2 * i] * inv, o[c][4 * j + 2 * i + 1] * inv);
      }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* out;
  float* lse;
  int batch, t_len, s_len, n_heads, n_kv_heads, positions, causal, window;
  float scale_log2;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  using L = Layout<D>;
  const int group = a.n_heads / a.n_kv_heads;
  if (a.positions * group > L::kRows) return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, a.q, a.batch, a.t_len, a.n_heads, D, L::kCol, group,
                  a.positions) ||
      !tensor_map(&k_map, a.k, a.batch, a.s_len, a.n_kv_heads, D, L::kCol, 1,
                  kBN) ||
      !tensor_map(&v_map, a.v, a.batch, a.s_len, a.n_kv_heads, D, L::kCol, 1,
                  kBN))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_prefill_kernel<D>;
  // Allowing the kernel its shared memory is a driver call: once a device.
  static bool allowed[64] = {};
  const cudaError_t err = allow_smem(kernel, L::kSmem, allowed);
  if (err != cudaSuccess) return err;
  const int n_q_tiles = (a.t_len + a.positions - 1) / a.positions;
  kernel<<<a.batch * a.n_kv_heads * n_q_tiles, L::kThreads, L::kSmem,
           a.stream>>>(
      q_map, k_map, v_map, a.q_pos, a.kv_pos,
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.batch, a.t_len, a.s_len,
      a.n_heads, a.n_kv_heads, a.positions, a.causal, a.window, a.scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  q_pos holds T
// entries and kv_pos S; `positions` query positions per block, with
// positions x (n_heads / n_kv_heads) <= 192 (64 at head_dim 256); head_dim
// 16, 32, 64, 128 or 256; lse is null or fp32 (B,H,T).
extern "C" int repro_flash_attention_prefill(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, float* lse, int batch, int t_len, int s_len,
    int n_heads, int n_kv_heads, int head_dim, int positions, int causal,
    int window, float scale, void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads || positions <= 0 ||
      positions > 256)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, q_pos, kv_pos, out, lse, batch, t_len, s_len, n_heads,
               n_kv_heads, positions, causal, window,
               scale * 1.4426950408889634f, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16: return launch<16>(a);
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    case 128: return launch<128>(a);
    case 256: return launch<256>(a);
    default: return cudaErrorInvalidValue;
  }
}
