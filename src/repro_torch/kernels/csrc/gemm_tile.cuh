// The output tile of a GEMM that one thread block computes, shared by the
// tiled GEMM K1 (matmul.cu) and the grouped GEMM K5 (moe_gemm.cu).
//
// One block of THREADS threads owns a bm x bn output tile.  The tile sizes
// are runtime values (any 1..MAX_TILE that divides its dimension), so
// nothing is instantiated per tile.  A bm x bn f32 accumulator of 256 x 256
// would be a whole SM's register file, so the block walks its tile in
// sub-tiles of at most SUB x SUB (8 x 8 accumulators per thread), each with
// its own K loop.  Shared memory holds A[sub_m, bk] and B[bk, sub_n] in the
// input dtype: smem_bytes(bm, bn, bk, sizeof(T)) bytes, which the
// profiler's estimate (core/profiler.py `variant_smem_bytes`) repeats.  A
// and B are read through strides, so transposed views need no copy.  f32
// tiles use IEEE f32 FMA on the CUDA cores, never TF32; bf16 tiles are
// loaded as bf16, multiplied and summed in f32 and rounded once at the
// store.

#pragma once

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace gemm_tile {

constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int SUB = 128;      // largest sub-tile side walked at once
constexpr int MAX_TILE = 256;
constexpr int MAX_DEVICES = 64;

// One GEMM O[M, N] = A[M, K] @ B[K, N]: the sizes, the tile and A's and B's
// strides in elements.  O is written contiguous [M, N].
struct Shape {
  int M, N, K;
  int bm, bn, bk;
  long long sa_m, sa_k, sb_k, sb_n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

inline size_t smem_bytes(int bm, int bn, int bk, size_t item) {
  return (size_t(bm < SUB ? bm : SUB) + size_t(bn < SUB ? bn : SUB)) *
         size_t(bk) * item;
}

// Computes O[row_blk : row_blk+bm, col_blk : col_blk+bn] and stores
// epilogue(row, col, acc) there.  Thread (tx, ty) = (tid % 16, tid / 16)
// owns, in each sub-tile, rows ty + 16*i and columns tx + 16*j (i, j < 8).
// A is staged k-major (sA[k * sub_m + m]) so that a warp's A reads hit two
// addresses and its B reads sixteen consecutive ones: no bank conflicts in
// the inner loop.
template <typename T, typename Epilogue>
__device__ __forceinline__ void block_tile(const Shape& p, const T* a,
                                           const T* b, T* o, int row_blk,
                                           int col_blk, Epilogue epilogue) {
  extern __shared__ unsigned char smem_raw[];
  const int sub_m = min(p.bm, SUB);
  const int sub_n = min(p.bn, SUB);
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sB = sA + sub_m * p.bk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int sm0 = 0; sm0 < p.bm; sm0 += sub_m) {
    const int cur_m = min(sub_m, p.bm - sm0);
    const int row0 = row_blk + sm0;
    for (int sn0 = 0; sn0 < p.bn; sn0 += sub_n) {
      const int cur_n = min(sub_n, p.bn - sn0);
      const int col0 = col_blk + sn0;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < p.K; k0 += p.bk) {
        __syncthreads();  // the previous tiles are no longer read
        // Stage A[row0 : row0+cur_m, k0 : k0+bk], walking the contiguous
        // dimension of the source fastest.
        const int na = cur_m * p.bk;
        if (p.sa_k == 1) {
          for (int idx = tid; idx < na; idx += THREADS) {
            const int m = idx / p.bk, k = idx - m * p.bk;
            sA[k * sub_m + m] = a[(row0 + m) * p.sa_m + (k0 + k)];
          }
        } else {
          for (int idx = tid; idx < na; idx += THREADS) {
            const int k = idx / cur_m, m = idx - k * cur_m;
            sA[k * sub_m + m] = a[(row0 + m) * p.sa_m + (k0 + k) * p.sa_k];
          }
        }
        const int nb = cur_n * p.bk;
        if (p.sb_n == 1) {
          for (int idx = tid; idx < nb; idx += THREADS) {
            const int k = idx / cur_n, n = idx - k * cur_n;
            sB[k * sub_n + n] = b[(k0 + k) * p.sb_k + (col0 + n)];
          }
        } else {
          for (int idx = tid; idx < nb; idx += THREADS) {
            const int n = idx / p.bk, k = idx - n * p.bk;
            sB[k * sub_n + n] = b[(k0 + k) * p.sb_k + (col0 + n) * p.sb_n];
          }
        }
        __syncthreads();

        for (int k = 0; k < p.bk; ++k) {
          float av[8], bv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int m = ty + 16 * i;
            av[i] = m < cur_m ? to_f32(sA[k * sub_m + m]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            bv[j] = n < cur_n ? to_f32(sB[k * sub_n + n]) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        if (m >= cur_m) continue;
        const int row = row0 + m;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n >= cur_n) continue;
          const int col = col0 + n;
          store(o + (long long)row * p.N + col, epilogue(row, col, acc[i][j]));
        }
      }
    }
  }
}

// Past 48 KB of dynamic shared memory a launch needs this attribute.  It
// belongs to the function on one device: raise it once per device to the
// most a block may opt into, so that every later tile launches.  `done`
// holds one flag per device for this kernel.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, int device,
                           std::atomic<bool>* done) {
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES) done[device].store(true);
  return cudaSuccess;
}

}  // namespace gemm_tile
