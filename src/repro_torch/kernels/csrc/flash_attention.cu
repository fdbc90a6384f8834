// fp32 GQA flash-attention forward for Hopper (sm_90a), with a plain C
// interface.
//
// Replaced the TPU kernel src/repro/kernels/flash_attention.py:39
// (`_kernel`, launched through pl.pallas_call by `flash_attention`) for fp32
// inputs until flash_attention_fp32tc.cu, the same function on the tensor
// cores in split precision, took every fp32 call: the Python wrapper
// src/repro_torch/kernels/flash_attention.py sends this kernel none, and
// chip_smoke.py calls its entry point to time it beside that one.  bf16
// inputs take flash_attention_prefill.cu (T > 16) or
// flash_attention_decode.cu (T <= 16).  The plain PyTorch version all of
// them are held against is src/repro_torch/kernels/ref.py::
// reference_attention.
//
// Contract.  q (B,T,H,D), k/v (B,S,KV,D), contiguous fp32, D in {16, 32, 64,
// 128, 256}; output (B,T,H,D) fp32.  Query head h reads KV head h / (H/KV).
// q is scaled by 1/sqrt(D) in fp32 before q.k.  Key s is visible to query t iff kv_pos[s] >= 0, and
// (causal) kv_pos[s] <= q_pos[t], and (window > 0) q_pos[t] - kv_pos[s] <
// window.  Online softmax in fp32; a row that sees no key is zeros.  q_pos
// holds T entries and kv_pos S: the last tiles are padded here, not by the
// caller, with zero rows of q, k and v, query position 0 and key position
// -1, so a padded key is masked as in the reference's padding.  With a
// non-null `lse` the kernel also writes each row's log-sum-exp of the scaled
// scores, m + log(l) from the online softmax, fp32 (B,H,T), and 1e30 for a
// row that sees no key: what the training backward recomputes P from.
//
// What bounds it on the H100.  It computes on the fp32 FMA pipe (67
// TFLOP/s) and is bound by operations there.  One rounding of each operand
// to TF32 or bf16 would not hold the fp32 tolerance (2e-5); a split of each
// operand into bf16 terms that sum to it does, and runs on the tensor cores
// (flash_attention_fp32tc.cu).
//
// What the design does about it.  One block of 128 threads per (batch x
// q-head, tile of BQ query rows); a loop over KV tiles of 64 keys staged in
// shared memory; fp32 running max, sum and accumulator in registers.  The
// (BQ x 64) score tile never leaves the SM.  A KV tile that no query of the
// block can see (above the causal diagonal, outside the window, or a decode
// cache slot past the fill position) is skipped before it is loaded, which is
// exact: a fully masked tile changes neither max, sum nor accumulator.
// Decode (T <= 16) uses BQ = 16 so that a one-row query wastes less work.
// At D = 256 (gemma3-1b) a prefill block takes BQ = 32 rows, not 64: its
// acc would be 8 x 16 = 128 fp32 registers a thread at BQ 64 beside the
// scores and operands; at 32 it is 64 (shared memory 107,392 bytes).  The
// wrapper's plan() picks BQ by the same rule.
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 128;  // 8 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

// Reductions over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int BQ, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + kBK * (D + 1) + BQ * (kBK + 1)) +
         sizeof(int) * (BQ + kBK);
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 8 i, key
// columns tx + 16 j of the score tile, and output dims tx + 16 j.
template <int BQ, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos, float* __restrict__ out,
                           float* __restrict__ lse, int t_len, int s_len,
                           int n_heads, int n_kv_heads,
                           int n_k_tiles, int causal, int window, float scale) {
  constexpr int RI = BQ / 8;    // rows per thread
  constexpr int CJ = kBK / 16;  // key columns per thread
  constexpr int DJ = D / 16;    // output dims per thread
  constexpr int DP = D + 1;     // odd pitch: 16 rows read in one column hit 16 banks
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x DP, q tile, pre-scaled
  float* kv_s = q_s + BQ * DP;    // kBK x DP, the K tile, then the V tile
  float* p_s = kv_s + kBK * DP;   // BQ x PP, probabilities of the tile
  int* qp_s = reinterpret_cast<int*>(p_s + BQ * PP);  // BQ
  int* kp_s = qp_s + BQ;                              // kBK

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = blockIdx.x * BQ;
  const size_t q_stride = (size_t)n_heads * D, kv_stride = (size_t)n_kv_heads * D;
  const float* qb = q + (size_t)b * t_len * q_stride + (size_t)h * D;
  const float* kb = k + (size_t)b * s_len * kv_stride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * s_len * kv_stride + (size_t)kvh * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    q_s[r * DP + d] = t < t_len ? qb[t * q_stride + d] * scale : 0.f;
  }
  for (int i = tid; i < BQ; i += kThreads)
    qp_s[i] = q0 + i < t_len ? q_pos[q0 + i] : 0;

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of kv_s, p_s and kp_s are done
    if (tid < kBK) kp_s[tid] = k0 + tid < s_len ? kv_pos[k0 + tid] : -1;
    __syncthreads();

    unsigned ok[RI];
    bool any = false;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = qp_s[ty + 8 * i];
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kp = kp_s[tx + 16 * j];
        bool vis = kp >= 0;
        if (causal) vis = vis && kp <= qp;
        if (window > 0) vis = vis && qp - kp < window;
        bits |= static_cast<unsigned>(vis) << j;
      }
      ok[i] = bits;
      any = any || bits != 0;
    }
    if (!__syncthreads_or(any)) continue;  // nothing visible: skipping is exact

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      kv_s[r * DP + d] = s < s_len ? kb[s * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = q_s[(ty + 8 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = kv_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (!((ok[i] >> j) & 1u)) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        // Masked after the exp: in a row with nothing visible yet m_new is
        // -1e30 and exp(s - m_new) would be 1, not 0.
        const float p = ((ok[i] >> j) & 1u) ? expf(sc[i][j] - m_new) : 0.f;
        p_s[(ty + 8 * i) * PP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every read of the K tile is done

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      kv_s[r * DP + d] = s < s_len ? vb[s * kv_stride + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = p_s[(ty + 8 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kv_s[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 8 * i;
    if (t >= t_len) continue;
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * n_heads + h) * t_len + t] =
          l[i] > 0.f ? m[i] + logf(l[i]) : 1e30f;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* o = out + ((size_t)b * t_len + t) * q_stride + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = acc[i][j] / denom;
  }
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* out;
  float* lse;
  int batch, t_len, s_len, n_heads, n_kv_heads, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int BQ, int D>
cudaError_t launch(const Args& a) {
  auto kernel = flash_attention_fwd_kernel<BQ, D>;
  constexpr size_t smem = smem_bytes<BQ, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_k_tiles = (a.s_len + kBK - 1) / kBK;
  const dim3 grid((a.t_len + BQ - 1) / BQ, a.batch * a.n_heads);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.q_pos, a.kv_pos, static_cast<float*>(a.out),
      a.lse, a.t_len, a.s_len, a.n_heads, a.n_kv_heads, n_k_tiles, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

// The instances at head dim D: BQ 16, and BQ 64 (32 at D = 256).
template <int D>
cudaError_t dispatch_block_q(int block_q, const Args& a) {
  constexpr int kBQ = D == 256 ? 32 : 64;
  if (block_q == 16) return launch<16, D>(a);
  if (block_q == kBQ) return launch<kBQ, D>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int block_q, int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return dispatch_block_q<16>(block_q, a);
    case 32: return dispatch_block_q<32>(block_q, a);
    case 64: return dispatch_block_q<64>(block_q, a);
    case 128: return dispatch_block_q<128>(block_q, a);
    case 256: return dispatch_block_q<256>(block_q, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  q_pos holds T
// entries and kv_pos S.  head_dim 16, 32, 64 or 128 with block_q 16 or 64;
// head_dim 256 with block_q 16 or 32;
// q, k, v and out are fp32; lse is null or fp32 (B,H,T).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, float* lse, int batch, int t_len, int s_len,
    int n_heads, int n_kv_heads, int head_dim, int block_q, int causal,
    int window, float scale, void* stream) {
  const Args a{q, k, v, q_pos, kv_pos, out, lse, batch, t_len, s_len, n_heads,
               n_kv_heads, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(block_q, head_dim, a);
}
