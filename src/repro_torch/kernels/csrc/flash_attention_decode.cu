// bf16 GQA flash-attention decode for Hopper (sm_90a): split keys and a
// combine pass, with a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:39 (`_kernel`,
// launched through pl.pallas_call by `flash_attention`) for bf16 inputs with
// at most 16 query positions: the decode steps of serving.  The Python
// wrapper is src/repro_torch/kernels/flash_attention.py, which also picks
// this kernel, sizes the splits and allocates their fp32 scratch; the plain
// PyTorch version it is held against is
// src/repro_torch/kernels/ref.py::reference_attention.
//
// Contract.  As the prefill kernel (flash_attention_prefill.cu): q (B,T,H,D),
// k/v (B,S,KV,D), contiguous bf16, 16-byte aligned, D in {16, 32, 64, 128,
// 256}; masks by kv_pos >= 0, causal and window on absolute positions; fp32
// scores scaled by 1/sqrt(D) and fp32 online softmax; a row that sees no key
// is exactly zero; output bf16.  S is padded here: keys past S are zero rows at
// position -1.
//
// What bounds it on the H100.  A decode step of llama3.2-3b (B4, T1, a
// 1024-slot cache filled to 527, H24, KV8, D128) must read the K/V rows up
// to the fill position once: 8.65 MB, 2.6 us at 3.35 TB/s, against a few
// MFLOP.  It is bound by bytes, and by how many loads are in flight: one
// block per (batch, query head) walking the cache in order, as a prefill
// kernel would, keeps 96 blocks busy on 132 SMs, each waiting on its loads.
//
// What the design does about it.  One block of 128 threads per (batch, KV
// head, split of the keys, chunk of at most 64 query rows): the rows are the
// G x T (position, head) pairs of the KV group, so each K/V tile is read
// once for all of them.  The wrapper picks the splits (one 64-key tile each
// at the serving shape: 4 x 8 x 16 = 512 blocks) so that the card holds a
// few blocks per SM.  Tiles arrive by 16-byte cp.async, double-buffered
// where a split has more than one; a tile that no row can see is skipped
// before it is loaded (exact), so a split past the fill position exits at
// once with l = 0.  Each split leaves its fp32 (acc, m, l) per row in the
// scratch; the combine kernel merges the splits of each row, and a row whose
// splits all have l = 0 is zeros.  The arithmetic (a few rows against 64
// keys) runs on the fp32 pipe from shared memory.
//
// At D = 256 (gemma3-1b) a block holds at most 32 query rows, not 64: two
// stages of K and V tiles are 135 KB there, and with 64 rows q, acc and
// scores take the block to 251,648 bytes, over the 227 KB a block may use;
// 32 rows need 193,664.  The wrapper's plan() chunks the G x T rows of a
// group by the same rule (flash_attention.py, D256_DECODE_ROWS).  The
// combine pass runs D = 256 threads a row.  A decode step of gemma3-1b (B4, T1, a
// 1024-slot cache filled to 527, H4, KV1) reads 2.2 MB: 0.65 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBN = 64;         // keys per tile
constexpr int kThreads = 128;
// Query rows of a block at most: 64, or 32 at D = 256 (shared memory).
template <int D>
constexpr int kMaxRows = D == 256 ? 32 : 64;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <int D>
struct Layout {
  static constexpr int kPitch = D + 8;   // bf16 per K/V row: +16 bytes
  static constexpr int kTile = kBN * kPitch;
  static constexpr int kSP = kBN + 1;    // fp32 pitch of a score row
  // `stages` x (K, V) tiles and q (rows x D bf16), 16-byte aligned; then the
  // key positions of each stage, acc (rows x D fp32), scores (rows x kSP),
  // and m, l, alpha and the position of each row.
  static constexpr size_t smem(int rows, int stages) {
    return 2 * (size_t(stages) * 2 * kTile + size_t(rows) * D) +
           4 * (size_t(stages) * kBN + size_t(rows) * (D + kSP + 4));
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 4)  // several blocks an SM
flash_attention_decode_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const int* __restrict__ q_pos,
                              const int* __restrict__ kv_pos,
                              float* __restrict__ part, int batch, int t_len,
                              int s_len, int n_heads, int n_kv_heads,
                              int n_splits, int tiles_per_split, int n_chunks,
                              int causal, int window, float scale_log2) {
  using L = Layout<D>;
  const int tid = threadIdx.x;
  int idx = blockIdx.x;
  const int chunk = idx % n_chunks;
  idx /= n_chunks;
  const int split = idx % n_splits;
  idx /= n_splits;
  const int kvh = idx % n_kv_heads, b = idx / n_kv_heads;
  const int group = n_heads / n_kv_heads;
  const int r0 = chunk * kMaxRows<D>;
  const int rows = min(kMaxRows<D>, group * t_len - r0);
  const int stages = tiles_per_split > 1 ? 2 : 1;
  // Row r of the block is query row r0 + r of the group, position t, head
  // g: row (b T + t) H + kvh G + g of q, of the output and of the scratch.
  auto row_of = [&](int r) {
    const int qr = r0 + r;
    return (size_t(b) * t_len + qr / group) * n_heads + kvh * group +
           qr % group;
  };
  auto part_row = [&](int r) {
    return part + (size_t(split) * batch * t_len * n_heads + row_of(r)) * (D + 2);
  };

  extern __shared__ uint4 smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);  // stages x (K, V)
  __nv_bfloat16* q_s = kv_s + stages * 2 * L::kTile;             // rows x D
  int* kp_s = reinterpret_cast<int*>(q_s + rows * D);             // stages x kBN
  float* o_s = reinterpret_cast<float*>(kp_s + stages * kBN);     // rows x D
  float* s_s = o_s + rows * D;                                     // rows x kSP
  float* m_s = s_s + rows * L::kSP;
  float* l_s = m_s + rows;
  float* a_s = l_s + rows;
  int* qp_s = reinterpret_cast<int*>(a_s + rows);

  const int n_k_tiles = (s_len + kBN - 1) / kBN;
  const int kt_begin = split * tiles_per_split;
  const int kt_end = min(n_k_tiles, kt_begin + tiles_per_split);
  // Key positions of tile kt (tid < kBN; -1 past S).
  auto tile_pos = [&](int kt) {
    const int s = kt * kBN + tid;
    return tid < kBN && s < s_len ? kv_pos[s] : -1;
  };
  // The least and greatest query position of the block's rows.
  int q_lo = INT_MAX, q_hi = INT_MIN;
  for (int t = r0 / group; t <= (r0 + rows - 1) / group; ++t) {
    q_lo = min(q_lo, q_pos[t]);
    q_hi = max(q_hi, q_pos[t]);
  }
  // A key outside [q_lo - window + 1, q_hi] is seen by no row, so skipping a
  // tile without any other key is exact.
  auto seen = [&](int kpos) {
    return kpos >= 0 && (!causal || kpos <= q_hi) &&
           (window <= 0 || static_cast<long long>(kpos) >
                               static_cast<long long>(q_lo) - window);
  };
  // The first tile from kt on that some row may see (kt_end if none), and
  // its key positions.
  auto next_tile = [&](int kt) {
    int kp = -1;
    for (; kt < kt_end; ++kt) {
      kp = tile_pos(kt);
      if (__syncthreads_or(seen(kp))) break;
    }
    return make_int2(kt, kp);
  };
  auto load_tile = [&](int2 tile, int buf) {
    const int kt = tile.x;
    __nv_bfloat16* ks = kv_s + buf * 2 * L::kTile;
    __nv_bfloat16* vs = ks + L::kTile;
    constexpr int kChunks = D / 8;            // 16-byte pieces of a row
    const size_t kv_stride = size_t(n_kv_heads) * D;
    for (int i = tid; i < kBN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks, s = kt * kBN + r;
      const bool ok = s < s_len;
      const size_t off = ok ? (size_t(b) * s_len + s) * kv_stride + kvh * D + c * 8 : 0;
      cp_async16(ks + r * L::kPitch + c * 8, k + off, ok);
      cp_async16(vs + r * L::kPitch + c * 8, v + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid < kBN) kp_s[buf * kBN + tid] = tile.y;
  };

  int2 tile = next_tile(kt_begin);
  if (tile.x >= kt_end) {  // no row sees a key of this split
    for (int r = tid; r < rows; r += kThreads) {
      part_row(r)[D] = kNegInf;
      part_row(r)[D + 1] = 0.f;
    }
    return;
  }
  // q rides in the first tile's group of copies.
  for (int i = tid; i < rows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    cp_async16(q_s + r * D + c * 8, q + row_of(r) * D + c * 8, true);
  }
  int buf = 0;
  load_tile(tile, buf);
  for (int i = tid; i < rows * D; i += kThreads) o_s[i] = 0.f;
  for (int r = tid; r < rows; r += kThreads) {
    qp_s[r] = q_pos[(r0 + r) / group];
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  while (tile.x < kt_end) {
    const int2 nxt = next_tile(tile.x + 1);
    if (nxt.x < kt_end) {
      load_tile(nxt, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + buf * 2 * L::kTile;
    const __nv_bfloat16* vs = ks + L::kTile;
    const int* kps = kp_s + buf * kBN;

    // Scores: thread (key c, row pair) takes rows r and r + 1, with even and
    // odd terms in separate sums.
    {
      const int c = tid % kBN;
      const __nv_bfloat16* krow = ks + c * L::kPitch;
      for (int r = 2 * (tid / kBN); r < rows; r += 2 * (kThreads / kBN)) {
        const __nv_bfloat16* q0 = q_s + r * D;
        const __nv_bfloat16* q1 = q_s + min(r + 1, rows - 1) * D;
        float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 8) {
          const uint4 kr = *reinterpret_cast<const uint4*>(krow + d);
          const uint4 x0 = *reinterpret_cast<const uint4*>(q0 + d);
          const uint4 x1 = *reinterpret_cast<const uint4*>(q1 + d);
          const __nv_bfloat162* kk = reinterpret_cast<const __nv_bfloat162*>(&kr);
          const __nv_bfloat162* y0 = reinterpret_cast<const __nv_bfloat162*>(&x0);
          const __nv_bfloat162* y1 = reinterpret_cast<const __nv_bfloat162*>(&x1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 kf = __bfloat1622float2(kk[e]);
            const float2 f0 = __bfloat1622float2(y0[e]);
            const float2 f1 = __bfloat1622float2(y1[e]);
            a0 = fmaf(f0.x, kf.x, a0);
            b0 = fmaf(f0.y, kf.y, b0);
            a1 = fmaf(f1.x, kf.x, a1);
            b1 = fmaf(f1.y, kf.y, b1);
          }
        }
        s_s[r * L::kSP + c] = (a0 + b0) * scale_log2;
        if (r + 1 < rows) s_s[(r + 1) * L::kSP + c] = (a1 + b1) * scale_log2;
      }
    }
    __syncthreads();

    // Online softmax: warp w takes rows w, w + 4, ...; lane the keys lane
    // and lane + 32.
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < rows; r += kThreads / 32) {
        const int qp = qp_s[r];
        float x[2];
        bool ok[2];
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = lane + 32 * e, kpc = kps[c];
          ok[e] = kpc >= 0;
          if (causal) ok[e] = ok[e] && kpc <= qp;
          if (window > 0) ok[e] = ok[e] && qp - kpc < window;
          x[e] = s_s[r * L::kSP + c];
          if (ok[e]) mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // masked after the exp: with nothing visible yet m_new is -1e30
          const float p = ok[e] ? exp2f(x[e] - m_new) : 0.f;
          s_s[r * L::kSP + lane + 32 * e] = p;
          sum += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = alpha acc + P.V: thread (column pair, row pair) keeps four sums.
    {
      constexpr int kPairs = D / 2, kGroups = kThreads / kPairs;
      const int col = 2 * (tid % kPairs);
      for (int r = 2 * (tid / kPairs); r < rows; r += 2 * kGroups) {
        const int r1 = min(r + 1, rows - 1);
        const float* p0 = s_s + r * L::kSP;
        const float* p1 = s_s + r1 * L::kSP;
        float2 acc0 = *reinterpret_cast<const float2*>(o_s + r * D + col);
        float2 acc1 = *reinterpret_cast<const float2*>(o_s + r1 * D + col);
        acc0.x *= a_s[r];
        acc0.y *= a_s[r];
        acc1.x *= a_s[r1];
        acc1.y *= a_s[r1];
#pragma unroll 8
        for (int c = 0; c < kBN; ++c) {
          const float2 vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vs + c * L::kPitch + col));
          const float w0 = p0[c], w1 = p1[c];
          acc0.x = fmaf(w0, vf.x, acc0.x);
          acc0.y = fmaf(w0, vf.y, acc0.y);
          acc1.x = fmaf(w1, vf.x, acc1.x);
          acc1.y = fmaf(w1, vf.y, acc1.y);
        }
        *reinterpret_cast<float2*>(o_s + r * D + col) = acc0;
        if (r + 1 < rows) *reinterpret_cast<float2*>(o_s + r1 * D + col) = acc1;
      }
    }
    __syncthreads();  // this buffer is free for the load after next
    tile = nxt;
    buf ^= 1;
  }

  // (acc, m, l) of each row for this split; acc only where l > 0.
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    if (l_s[r] > 0.f) part_row(r)[i % D] = o_s[i];
  }
  for (int r = tid; r < rows; r += kThreads) {
    part_row(r)[D] = m_s[r];
    part_row(r)[D + 1] = l_s[r];
  }
}

// out[row] = sum_i 2^(m_i - M) acc_i / sum_i 2^(m_i - M) l_i over the splits
// i with l_i > 0 (M their largest m), in one pass with a running M; zeros
// where there is none.  One block of D threads per output row.  The acc of
// a split with l = 0 was never written: it is read but not used.
__global__ void flash_attention_combine_kernel(const float* __restrict__ part,
                                               __nv_bfloat16* __restrict__ out,
                                               int n_rows, int n_splits,
                                               int head_dim) {
  const int row = blockIdx.x, d = threadIdx.x;
  const size_t pitch = size_t(head_dim) + 2, split_stride = n_rows * pitch;
  const float* pr = part + row * pitch;
  float m_run = kNegInf, num = 0.f, den = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_splits; ++i, pr += split_stride) {
    const float acc = pr[d], m = pr[head_dim], l = pr[head_dim + 1];
    if (l > 0.f) {
      const float m_new = fmaxf(m_run, m);
      const float keep = exp2f(m_run - m_new), w = exp2f(m - m_new);
      num = num * keep + w * acc;
      den = den * keep + w * l;
      m_run = m_new;
    }
  }
  out[size_t(row) * head_dim + d] = __float2bfloat16(den > 0.f ? num / den : 0.f);
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* out;
  float* part;
  int batch, t_len, s_len, n_heads, n_kv_heads, n_splits, tiles_per_split,
      causal, window;
  float scale_log2;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  using L = Layout<D>;
  const int group_rows = a.n_heads / a.n_kv_heads * a.t_len;
  const int n_chunks = (group_rows + kMaxRows<D> - 1) / kMaxRows<D>;
  const int rows = group_rows < kMaxRows<D> ? group_rows : kMaxRows<D>;
  const size_t smem = L::smem(rows, a.tiles_per_split > 1 ? 2 : 1);
  static_assert(Layout<D>::smem(kMaxRows<D>, 2) <= 232448,
                "a block's shared memory exceeds the H100's");
  auto kernel = flash_attention_decode_kernel<D>;
  // The shared memory the kernel may use so far, per device: raising it is
  // a driver call, too slow for every decode step.
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  kernel<<<a.batch * a.n_kv_heads * a.n_splits * n_chunks, kThreads, smem,
           a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.q_pos, a.kv_pos, a.part,
      a.batch, a.t_len, a.s_len, a.n_heads, a.n_kv_heads, a.n_splits,
      a.tiles_per_split, n_chunks, a.causal, a.window, a.scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_rows = a.batch * a.t_len * a.n_heads;
  flash_attention_combine_kernel<<<n_rows, D, 0, a.stream>>>(
      a.part, static_cast<__nv_bfloat16*>(a.out), n_rows, a.n_splits, D);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  q_pos holds T
// entries and kv_pos S; the keys go in n_splits splits of tiles_per_split
// tiles of 64; part is fp32 scratch of n_splits x (B T H) x (head_dim + 2);
// head_dim 16, 32, 64, 128 or 256.
extern "C" int repro_flash_attention_decode(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, float* part, int batch, int t_len,
    int s_len, int n_heads, int n_kv_heads, int head_dim, int n_splits,
    int tiles_per_split, int causal, int window, float scale, void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads || n_splits <= 0 ||
      tiles_per_split <= 0 ||
      (long long)n_splits * tiles_per_split * kBN < s_len)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, q_pos, kv_pos, out, part, batch, t_len, s_len,
               n_heads, n_kv_heads, n_splits, tiles_per_split, causal, window,
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
