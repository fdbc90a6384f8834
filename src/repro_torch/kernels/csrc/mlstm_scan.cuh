// Building blocks shared by the two-pass tensor-core mLSTM scans,
// csrc/mlstm_scan_tc.cu (bf16) and csrc/mlstm_scan_fp32tc.cu (fp32 in split
// precision): tile sizes, the gates of a chunk, a block-wide max and the
// staging of a 128-row tile for 16-byte stores.  Both kernels run blocks of
// kThreads threads.  Everything is in an anonymous namespace: each source
// that includes this file gets its own copy.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;             // two warpgroups a block
constexpr int kT = 64;                    // rows and columns of a tile
constexpr uint32_t kBox = kT * kT * 2;    // one bf16 tile, 128-byte rows
constexpr uint32_t kStep = 16 * 128;      // 16 rows of a tile
constexpr uint32_t kGroup = 8 * 128;      // 8 rows of a tile
constexpr float kGuard = -1e30f;

// Tiles are stored with TMA's 128-byte swizzle: the 16-byte chunk x of row r
// of a 64 x 64 bf16 tile sits at byte r * 128 + ((x ^ (r % 8)) << 4).

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__host__ __device__ __forceinline__ int tiles(int n) { return (n + kT - 1) / kT; }

// Max over the block of one value per thread; `red` holds kThreads/32
// floats.  Syncs the block.
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

// A 128-row tile of 256-byte rows staged in shared memory, its 16-byte
// chunk x of row r at chunk x ^ (r % 16) (no bank conflicts either way).
__device__ __forceinline__ uint32_t staged(int r, int byte) {
  return r * 256 + ((((byte >> 4) ^ (r & 15)) << 4) | (byte & 15));
}

// Writes the staged tile to `dst`, a row-major matrix with `pitch` bytes a
// row, clipped to `rows` rows and `row_bytes` bytes a row.  Syncs the block
// before and after.
__device__ __forceinline__ void store_staged(const uint8_t* tile, uint8_t* dst,
                                             size_t pitch, int rows, int row_bytes) {
  __syncthreads();
  for (int x = threadIdx.x; x < 128 * 16; x += kThreads) {
    const int r = x / 16, ch = x % 16;
    if (r < rows && ch * 16 < row_bytes)
      *reinterpret_cast<uint4*>(dst + r * pitch + ch * 16) =
          *reinterpret_cast<const uint4*>(tile + staged(r, ch * 16));
  }
  __syncthreads();
}

// log_i and the inclusive cumulative log_f of `len` rows of a chunk into
// shared memory (`lf` is scratch for log_f); thread 0 sums in order, 16
// values loaded ahead at a time.  Syncs the block.
__device__ __forceinline__ void chunk_gates(const float* li_g, const float* lf_g,
                                            int stride, int len, float* li,
                                            float* bc, float* lf) {
  for (int s = threadIdx.x; s < len; s += kThreads) {
    li[s] = li_g[(size_t)s * stride];
    lf[s] = lf_g[(size_t)s * stride];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int s0 = 0; s0 < len; s0 += 16) {
      float x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = lf[s0 + j];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        run += x[j];
        bc[s0 + j] = run;
      }
    }
  }
  __syncthreads();
}

}  // namespace
