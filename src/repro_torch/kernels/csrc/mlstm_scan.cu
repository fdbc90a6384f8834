// Chunkwise mLSTM forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan.py (`_kernel`,
// launched through pl.pallas_call by `mlstm_scan`) for the calls whose chunk
// is not a multiple of 16, in either dtype; the others take the tensor-core
// kernels, mlstm_scan_tc.cu (bf16) and mlstm_scan_fp32tc.cu (fp32, in split
// precision), which kernels/mlstm_scan.py's plan() picks.
// The Python wrapper is src/repro_torch/kernels/mlstm_scan.py; the plain
// PyTorch version it is held against is
// src/repro_torch/models/xlstm.py::mlstm_chunkwise.
//
// Contract.  q, k, v (B,T,H,D) contiguous, fp32 or bf16; log_i, log_f
// (B,T,H) contiguous fp32; T a multiple of `chunk`; D a multiple of 16, at
// most 512.  Per (batch, head) the stabilized mLSTM recurrence runs over the
// chunks in order, from the given state (C (D,D), n (D), m) or, where the
// state pointers are null, from C = 0, n = 0, m = -inf.  Per chunk of L rows,
// with bcum the inclusive cumulative sum of log_f over the chunk:
//   e[t,s]   = (bcum[t] - bcum[s]) + li[s]              (s <= t)
//   m_row[t] = max(max_s e[t,s], bcum[t] + m0, -1e30)
//   p[t,s]   = (q[t].k[s]) exp(e[t,s] - m_row[t])       (0 for s > t)
//   c_in[t]  = exp(bcum[t] + m0 - m_row[t])
//   h[t]     = (p v + c_in q C0)[t] / max(|rowsum p + c_in q.n0|, exp(-m_row))
// and at the chunk end m1 = max(btot + m0, max_s (btot - bcum[s]) + li[s]),
// w[s] = exp((btot - bcum[s]) + li[s] - m1), C1 = exp(btot + m0 - m1) C0 +
// sum_s w[s] k[s] v[s]^T, n1 likewise with v = 1.  q is scaled by 1/sqrt(D)
// as it is loaded; all arithmetic is fp32; h is stored in q's type, and the
// final C, n, m in fp32.
//
// What bounds it on the H100.  At the serving shape of xlstm-350m (B4 T512
// H4 D512, chunk 256, bf16) one launch moves about 50 MB (q, k, v, h and the
// final C) and does about 4.3 G multiply-adds (q k^T and p v over the causal
// half of each chunk, q C0 and k^T w v over the head dim squared).  On the
// fp32 FMA pipe (67 TFLOP/s) that is at least 0.13 ms, against 0.015 ms
// for the bytes: it is bound by operations.
//
// What the design does about it.  The TPU kernel keeps all of C (D x D fp32,
// 1 MiB at D = 512) in VMEM; a Hopper block has 227 KB of shared memory.  So
// the value dimension is split: block (x, b*H + h) owns the DV = 64 columns
// C[:, 64x : 64x + 64] in shared memory (128 KB at D = 512) and writes only
// h[..., those columns].  That also fills the card: the serving shape has
// only B*H = 16 (batch, head) pairs, and D/DV = 8 blocks each makes 128 for
// 132 SMs.  The price is redundant work: every block of a (batch, head)
// recomputes the gate statistics, the score tile q k^T, its row sums and n.
// At D = 512 the q k^T tiles are done 8 times over, so a launch does about
// 6.5 G multiply-adds where 4.3 G would do; removing that (one pass for the
// scores, or tensor cores) is left for later.  Within a chunk, rows go in
// tiles of 64 and keys in tiles of 64 up to the diagonal; a 256-thread block
// computes a 64 x 64 tile with 4 x 4 (or 4 x DV/16) values a thread,
// reading shared memory as float4 along rows and columns.  The stabilizers
// depend on the gates alone, so they are computed before any score, and
// each score tile is turned into p and multiplied into the output at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups (ty) x 16 column lanes (tx)
constexpr int kBT = 64;        // chunk rows per output tile
constexpr int kBS = 64;        // chunk keys per score tile
constexpr int kDS = 32;        // depth of a head-dim slab
constexpr int kDT = 64;        // rows of C per tile of the state update
constexpr int kTP = 64 + 4;    // pitch of the transposed tiles (float4-aligned)
constexpr float kGuard = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive floats of shared memory, N-float aligned.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = p[j];
  }
}

// Sum over the 16 lanes that share a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float lane16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Max over the block of one value per thread; `red` holds kThreads/32 floats.
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__host__ __device__ __forceinline__ int up4(int x) { return (x + 3) & ~3; }

// Offsets, in floats, of the shared-memory arrays.
struct Layout {
  int n, li, bc, mr, ci, w, red, scratch, total;
};

__host__ __device__ __forceinline__ Layout layout(int d, int dv, int chunk) {
  Layout l;
  l.n = d * dv;                 // C[:, cols] comes first, d x dv
  l.li = l.n + up4(d);
  l.bc = l.li + up4(chunk);
  l.mr = l.bc + up4(chunk);
  l.ci = l.mr + up4(chunk);
  l.w = l.ci + up4(chunk);
  l.red = l.w + up4(chunk);
  l.scratch = l.red + kThreads / 32;
  const int outputs = 2 * kDS * kTP + kBS * kTP + kBS * dv;  // q^T, k^T, p^T, v
  const int update = kBS * kTP + kBS * dv;                   // (k w), v
  l.total = l.scratch + (outputs > update ? outputs : update);
  return l;
}

// dst[dd * kTP + r] = src[(row0 + r) * stride + d0 + dd] * mul for the
// kBT x kDS slab; rows past `rows` and columns past `d` are zeros.
template <typename T>
__device__ __forceinline__ void load_slab_t(const T* src, int row0, int rows,
                                            int d0, int d, size_t stride,
                                            float mul, float* dst) {
  for (int i = threadIdx.x; i < kBT * kDS; i += kThreads) {
    const int r = i / kDS, dd = i % kDS;
    float x = 0.f;
    if (r < rows && d0 + dd < d) x = load_f(src + (size_t)(row0 + r) * stride + d0 + dd) * mul;
    dst[dd * kTP + r] = x;
  }
}

// dst[s * DV + c] = v[(row0 + s) * stride + col0 + c] for kBS rows; rows
// past `rows` are zeros.
template <typename T, int DV>
__device__ __forceinline__ void load_v(const T* src, int row0, int rows,
                                       int col0, size_t stride, float* dst) {
  for (int i = threadIdx.x; i < kBS * DV; i += kThreads) {
    const int s = i / DV, c = i % DV;
    dst[i] = s < rows ? load_f(src + (size_t)(row0 + s) * stride + col0 + c) : 0.f;
  }
}

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ log_i,
                  const float* __restrict__ log_f, const float* __restrict__ c_in,
                  const float* __restrict__ n_in, const float* __restrict__ m_in,
                  T* __restrict__ h, float* __restrict__ c_out,
                  float* __restrict__ n_out, float* __restrict__ m_out,
                  int t_len, int n_heads, int d, int chunk, float scale) {
  constexpr int CJ = DV / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(d, DV, chunk);
  float* c_s = smem;               // d x DV, this block's columns of C
  float* n_s = smem + lay.n;       // d
  float* li_s = smem + lay.li;     // chunk: log_i
  float* bc_s = smem + lay.bc;     // chunk: inclusive cumsum of log_f
  float* mr_s = smem + lay.mr;     // chunk: row stabilizer m_row
  float* ci_s = smem + lay.ci;     // chunk: weight of the carried state, c_in
  float* w_s = smem + lay.w;       // chunk: log_f, then the update weights w
  float* red_s = smem + lay.red;
  float* q_t = smem + lay.scratch;  // kDS x kTP, q slab transposed, scaled
  float* k_t = q_t + kDS * kTP;     // kDS x kTP, k slab transposed
  float* p_t = k_t + kDS * kTP;     // kBS x kTP, p tile transposed
  float* v_s = p_t + kBS * kTP;     // kBS x DV, v tile
  float* kw_s = smem + lay.scratch;  // kBS x kTP, k * w (state update)
  float* vu_s = kw_s + kBS * kTP;    // kBS x DV, v tile (state update)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / n_heads, hh = bh % n_heads;
  const int col0 = blockIdx.x * DV;
  const size_t stride = (size_t)n_heads * d;  // between time steps of q, k, v, h
  const size_t base = (size_t)b * t_len * stride + (size_t)hh * d;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  T* hb = h + base;
  const float* lib = log_i + (size_t)b * t_len * n_heads + hh;  // stride n_heads
  const float* lfb = log_f + (size_t)b * t_len * n_heads + hh;
  const size_t c_off = (size_t)bh * d * d;

  for (int i = tid; i < d * DV; i += kThreads) {
    const int r = i / DV, c = i % DV;
    c_s[i] = c_in ? c_in[c_off + (size_t)r * d + col0 + c] : 0.f;
  }
  for (int i = tid; i < d; i += kThreads) n_s[i] = n_in ? n_in[(size_t)bh * d + i] : 0.f;
  float m0 = m_in ? m_in[bh] : -INFINITY;
  __syncthreads();

  for (int t0 = 0; t0 < t_len; t0 += chunk) {
    // ---- 1. gates: log_i and the cumulative log_f of this chunk --------
    for (int s = tid; s < chunk; s += kThreads) {
      li_s[s] = lib[(size_t)(t0 + s) * n_heads];
      w_s[s] = lfb[(size_t)(t0 + s) * n_heads];
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int s = 0; s < chunk; ++s) {
        run += w_s[s];
        bc_s[s] = run;
      }
    }
    __syncthreads();
    const float btot = bc_s[chunk - 1];

    // ---- 2. stabilizers: they depend on the gates alone ----------------
    float m_loc = -INFINITY;
    for (int t = tid; t < chunk; t += kThreads) {
      const float bt = bc_s[t];
      float mx = -INFINITY;
      for (int s = 0; s <= t; ++s) mx = fmaxf(mx, (bt - bc_s[s]) + li_s[s]);
      const float g = bt + m0;
      const float mr = fmaxf(fmaxf(mx, g), kGuard);
      mr_s[t] = mr;
      ci_s[t] = expf(g - mr);  // exactly 0 while m0 is -inf
      m_loc = fmaxf(m_loc, (btot - bt) + li_s[t]);
    }
    const float m1 = fmaxf(btot + m0, block_max(m_loc, red_s));  // syncs
    for (int s = tid; s < chunk; s += kThreads)
      w_s[s] = expf(((btot - bc_s[s]) + li_s[s]) - m1);
    const float scale0 = expf((btot + m0) - m1);

    // ---- 3. outputs, a tile of kBT rows at a time ----------------------
    for (int r0 = 0; r0 < chunk; r0 += kBT) {
      const int rows = min(kBT, chunk - r0);
      float acc[4][CJ], qn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qn[i] = 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
      }
      // the carried state: q C0[:, cols] and q . n0
      for (int d0 = 0; d0 < d; d0 += kDS) {
        __syncthreads();  // earlier readers of the scratch are done
        load_slab_t(qb, t0 + r0, rows, d0, d, stride, scale, q_t);
        __syncthreads();
        const int ds = min(kDS, d - d0);
#pragma unroll 4
        for (int dd = 0; dd < ds; ++dd) {
          float qv[4], cv[CJ];
          load_vec<4>(q_t + dd * kTP + ty * 4, qv);
          load_vec<CJ>(c_s + (d0 + dd) * DV + tx * CJ, cv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
        }
        for (int u = tx; u < ds; u += 16) {  // lane tx takes slab columns tx, tx + 16
          float qv[4];
          load_vec<4>(q_t + u * kTP + ty * 4, qv);
          const float nv = n_s[d0 + u];
#pragma unroll
          for (int i = 0; i < 4; ++i) qn[i] = fmaf(qv[i], nv, qn[i]);
        }
      }
      float ci[4], mr[4], dotp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + ty * 4 + i;
        ci[i] = t < chunk ? ci_s[t] : 0.f;
        mr[i] = t < chunk ? mr_s[t] : 0.f;
        qn[i] = lane16_sum(qn[i]);
        dotp[i] = 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] *= ci[i];
      }

      // the chunk itself: key tiles up to the diagonal
      const int s_end = min(chunk, r0 + kBT);
      for (int s0 = 0; s0 < s_end; s0 += kBS) {
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int d0 = 0; d0 < d; d0 += kDS) {
          __syncthreads();
          load_slab_t(qb, t0 + r0, rows, d0, d, stride, scale, q_t);
          load_slab_t(kb, t0 + s0, chunk - s0, d0, d, stride, 1.f, k_t);
          __syncthreads();
          const int ds = min(kDS, d - d0);
#pragma unroll 4
          for (int dd = 0; dd < ds; ++dd) {
            float qv[4], kv[4];
            load_vec<4>(q_t + dd * kTP + ty * 4, qv);
            load_vec<4>(k_t + dd * kTP + tx * 4, kv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx * 4 + j;
            float p = 0.f;
            if (t < chunk && s <= t)
              p = sc[i][j] * expf(((bc_s[t] - bc_s[s]) + li_s[s]) - mr[i]);
            p_t[(tx * 4 + j) * kTP + ty * 4 + i] = p;
            dotp[i] += p;
          }
        }
        load_v<T, DV>(vb, t0 + s0, chunk - s0, col0, stride, v_s);
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < kBS; ++s) {
          float pv[4], vv[CJ];
          load_vec<4>(p_t + s * kTP + ty * 4, pv);
          load_vec<CJ>(v_s + s * DV + tx * CJ, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + ty * 4 + i;
        const float dot = lane16_sum(dotp[i]) + ci[i] * qn[i];
        if (t >= chunk) continue;
        const float den = fmaxf(fabsf(dot), expf(-mr[i]));
        T* o = hb + (size_t)(t0 + t) * stride + col0 + tx * CJ;
#pragma unroll
        for (int j = 0; j < CJ; ++j) store_f(o + j, acc[i][j] / den);
      }
    }

    // ---- 4. chunk-end state: C[:, cols] and n --------------------------
    for (int r0 = 0; r0 < d; r0 += kDT) {
      float cacc[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) cacc[i][j] = 0.f;
      for (int s0 = 0; s0 < chunk; s0 += kBS) {
        __syncthreads();  // earlier readers of the scratch are done
        for (int i = tid; i < kBS * kDT; i += kThreads) {
          const int s = i / kDT, dd = i % kDT;
          float x = 0.f;
          if (s0 + s < chunk && r0 + dd < d)
            x = load_f(kb + (size_t)(t0 + s0 + s) * stride + r0 + dd) * w_s[s0 + s];
          kw_s[s * kTP + dd] = x;
        }
        load_v<T, DV>(vb, t0 + s0, chunk - s0, col0, stride, vu_s);
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < kBS; ++s) {
          float kv[4], vv[CJ];
          load_vec<4>(kw_s + s * kTP + ty * 4, kv);
          load_vec<CJ>(vu_s + s * DV + tx * CJ, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) cacc[i][j] = fmaf(kv[i], vv[j], cacc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        if (row >= d) continue;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          float* c = c_s + row * DV + tx * CJ + j;
          *c = scale0 * *c + cacc[i][j];  // each entry has one owner
        }
      }
    }
    for (int dd = tid; dd < d; dd += kThreads) {
      float acc = 0.f;
      for (int s = 0; s < chunk; ++s)
        acc = fmaf(w_s[s], load_f(kb + (size_t)(t0 + s) * stride + dd), acc);
      n_s[dd] = scale0 * n_s[dd] + acc;
    }
    m0 = m1;
    __syncthreads();  // the next chunk overwrites the gate arrays
  }

  for (int i = tid; i < d * DV; i += kThreads) {
    const int r = i / DV, c = i % DV;
    c_out[c_off + (size_t)r * d + col0 + c] = c_s[i];
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < d; i += kThreads) n_out[(size_t)bh * d + i] = n_s[i];
    if (tid == 0) m_out[bh] = m0;
  }
}

struct Args {
  const void *q, *k, *v;
  const float *log_i, *log_f, *c_in, *n_in, *m_in;
  void* h;
  float *c_out, *n_out, *m_out;
  int batch, t_len, n_heads, d, chunk;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DV>
cudaError_t launch(const Args& a) {
  auto kernel = mlstm_scan_kernel<T, DV>;
  const size_t smem = sizeof(float) * layout(a.d, DV, a.chunk).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.d / DV, a.batch * a.n_heads);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.log_i, a.log_f, a.c_in, a.n_in, a.m_in,
      static_cast<T*>(a.h), a.c_out, a.n_out, a.m_out, a.t_len, a.n_heads, a.d,
      a.chunk, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (a.d % 64 == 0) return launch<T, 64>(a);
  if (a.d % 32 == 0) return launch<T, 32>(a);
  return launch<T, 16>(a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  c_in, n_in and m_in
// are the initial state, all three null for a zero state; c_out, n_out and
// m_out receive the final state and must not alias them.  head_dim is a
// multiple of 16 up to 512, t_len a multiple of chunk; is_bf16 selects bf16
// (else fp32) for q, k, v and h.
extern "C" int repro_mlstm_scan_fwd(
    const void* q, const void* k, const void* v, const float* log_i,
    const float* log_f, const float* c_in, const float* n_in, const float* m_in,
    void* h, float* c_out, float* n_out, float* m_out, int batch, int t_len,
    int n_heads, int head_dim, int chunk, float scale, int is_bf16,
    void* stream) {
  if (head_dim % 16 || head_dim <= 0 || head_dim > 512 || chunk <= 0 ||
      t_len <= 0 || t_len % chunk)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, log_i, log_f, c_in, n_in, m_in, h, c_out, n_out, m_out,
               batch, t_len, n_heads, head_dim, chunk, scale,
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<__nv_bfloat16>(a) : dispatch<float>(a);
}
