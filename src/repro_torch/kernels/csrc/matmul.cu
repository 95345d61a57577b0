// Tiled GEMM with a fused epilogue for NVIDIA Hopper (sm_90a):
// O = epilogue(A @ B [, C]).
//
// Replaces the Pallas TPU kernel `matmul_pallas` / `_mm_kernel`
// (src/repro/kernels/suites/pallas_lib.py:46, pallas_call at :70).  Same
// function: an f32 accumulator over the K dimension, then the epilogue
// (none, alpha*AB + beta*C, or relu) and one store in A's dtype.  Written
// for this card rather than carried over block by block:
//   * one thread block owns one bm x bn output tile; the Pallas grid's
//     sequential ("arbitrary") K axis becomes a loop inside the block;
//   * the tile sizes are runtime values (any 1..256 that divides its
//     dimension: `_fit` turns 256 into 192 at 384, and automatic error
//     repair halves blocks down to 8), so nothing is instantiated per tile;
//   * a bm x bn f32 accumulator of 256 x 256 would be a whole SM's register
//     file, so the block walks its tile in sub-tiles of at most 128 x 128
//     (8 x 8 accumulators per thread), each with its own K loop.  Shared
//     memory holds A[sub_m, bk] and B[bk, sub_n] in the input dtype:
//     (min(bm,128) + min(bn,128)) * bk * sizeof(T) bytes, which the
//     profiler's estimate (core/profiler.py `variant_smem_bytes`) repeats;
//     a tile above the card's 232,448 bytes per block is refused by the
//     wrapper before launch, with the bytes named, for automatic repair;
//   * A and B are read through strides, so the transposed views that
//     syrk/syr2k pass need no copy;
//   * f32 tiles use IEEE f32 FMA on the CUDA cores, never TF32 (the
//     functional-equivalence tolerance in f32 is 2e-4); bf16 tiles are
//     loaded as bf16, multiplied and summed in f32 and rounded once at the
//     store, as the Pallas kernel does.
//
// Bound on the H100 (SXM: 67 TFLOP/s f32 on the CUDA cores, 989 TFLOP/s
// dense bf16 on the tensor cores, 3.35 TB/s HBM): a square GEMM of n does
// 2n^3 FLOPs on 3 n^2 elements.  In f32 that is n/6 FLOPs per byte against
// a ridge of 20, so at the cases' n of 256-1024 it is bound by operations;
// in bf16, n/3 against the tensor cores' ridge of 295, so bytes bound it up
// to n ~ 900.  This first kernel runs both dtypes on the CUDA cores, so its
// bf16 floor is the f32 rate; moving bf16 tiles to wgmma with TMA-fed
// shared memory is the next step (ROADMAP queue 2, K1).

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int SUB = 128;      // largest sub-tile side walked at once
constexpr int MAX_TILE = 256;
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* a;
  const void* b;
  const float* c;
  void* o;
  int M, N, K;
  int bm, bn, bk;
  long long sa_m, sa_k, sb_k, sb_n, sc_m, sc_n;
  int epilogue;  // 0 none, 1 alpha_beta, 2 relu
  float alpha, beta;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int bm, int bn, int bk, size_t item) {
  return (size_t(bm < SUB ? bm : SUB) + size_t(bn < SUB ? bn : SUB)) *
         size_t(bk) * item;
}

// Thread (tx, ty) = (tid % 16, tid / 16) owns, in each sub-tile, rows
// ty + 16*i and columns tx + 16*j (i, j < 8).  A is staged k-major
// (sA[k * sub_m + m]) so that a warp's A reads hit two addresses and its B
// reads sixteen consecutive ones: no bank conflicts in the inner loop.
template <typename T>
__global__ void __launch_bounds__(THREADS) mm_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const int sub_m = min(p.bm, SUB);
  const int sub_n = min(p.bn, SUB);
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sB = sA + sub_m * p.bk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  T* o = static_cast<T*>(p.o);
  const int row_blk = blockIdx.y * p.bm;
  const int col_blk = blockIdx.x * p.bn;

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
          float x = acc[i][j];
          if (p.epilogue == 1)
            x = p.alpha * x + p.beta * p.c[row * p.sc_m + col * p.sc_n];
          else if (p.epilogue == 2)
            x = fmaxf(x, 0.f);
          store(o + (long long)row * p.N + col, x);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  // Past 48 KB of dynamic shared memory a launch needs this attribute.  It
  // belongs to the function on one device: raise it once per device to the
  // most a block may opt into, so that every later tile launches.
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device >= MAX_DEVICES || !smem_set[device].load()) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(mm_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) smem_set[device].store(true);
  }
  const dim3 grid(p.N / p.bn, p.M / p.bm);
  mm_kernel<T><<<grid, THREADS, smem_bytes(p.bm, p.bn, p.bk, sizeof(T)),
                 stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B and O; C is float32).  Strides are
// in elements; O is contiguous [M, N].  The tiles must divide M, N and K.
// Returns a cudaError_t.
extern "C" int mm_forward(const void* a, const void* b, const float* c,
                          void* o, int dtype, int device, int M, int N,
                          int K, int bm, int bn, int bk, long long sa_m,
                          long long sa_k, long long sb_k, long long sb_n,
                          long long sc_m, long long sc_n, int epilogue,
                          float alpha, float beta, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      bm > MAX_TILE || bn > MAX_TILE || bk > MAX_TILE || M % bm || N % bn ||
      K % bk || epilogue < 0 || epilogue > 2 || (epilogue == 1 && !c))
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const Params p{a,    b,    c,    o,    M,    N,        K,     bm,   bn,
                 bk,   sa_m, sa_k, sb_k, sb_n, sc_m,     sc_n,  epilogue,
                 alpha, beta};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(p, device, st); break;
    case 1: err = launch<__nv_bfloat16>(p, device, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
