// Tiled GEMM with a fused epilogue for NVIDIA Hopper (sm_90a):
// O = epilogue(A @ B [, C]).
//
// Replaces the Pallas TPU kernel `matmul_pallas` / `_mm_kernel`
// (src/repro/kernels/suites/pallas_lib.py:46, pallas_call at :70).  Same
// function: an f32 accumulator over the K dimension, then the epilogue
// (none, alpha*AB + beta*C, or relu) and one store in A's dtype.  Written
// for this card rather than carried over block by block:
//   * one thread block owns one bm x bn output tile; the Pallas grid's
//     sequential ("arbitrary") K axis becomes a loop inside the block.  The
//     tile itself is gemm_tile.cuh's `block_tile`, shared with the grouped
//     GEMM K5: runtime tile sizes 1..256 (`_fit` turns 256 into 192 at 384,
//     and automatic error repair halves blocks down to 8), walked in
//     sub-tiles of at most 128 x 128, A[sub_m, bk] and B[bk, sub_n] staged
//     in shared memory, (min(bm,128) + min(bn,128)) * bk * sizeof(T) bytes,
//     which the profiler's estimate (core/profiler.py `variant_smem_bytes`)
//     repeats; a tile above the card's 232,448 bytes per block is refused
//     by the wrapper before launch, with the bytes named, for automatic
//     repair;
//   * A and B are read through strides, so the transposed views that
//     syrk/syr2k pass need no copy;
//   * f32 tiles use IEEE f32 FMA on the CUDA cores, never TF32 (the
//     functional-equivalence tolerance in f32 is 2e-4); bf16 tiles are
//     loaded as bf16, multiplied and summed in f32 and rounded once at the
//     store, as the Pallas kernel does; the epilogue reads C in f32.
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

#include "gemm_tile.cuh"

namespace {

using gemm_tile::MAX_TILE;
using gemm_tile::THREADS;

struct Params {
  const void* a;
  const void* b;
  const float* c;
  void* o;
  gemm_tile::Shape s;
  long long sc_m, sc_n;
  int epilogue;  // 0 none, 1 alpha_beta, 2 relu
  float alpha, beta;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) mm_kernel(const Params p) {
  gemm_tile::block_tile(
      p.s, static_cast<const T*>(p.a), static_cast<const T*>(p.b),
      static_cast<T*>(p.o), blockIdx.y * p.s.bm, blockIdx.x * p.s.bn,
      [&p](int row, int col, float x) {
        if (p.epilogue == 1)
          return p.alpha * x + p.beta * p.c[row * p.sc_m + col * p.sc_n];
        if (p.epilogue == 2) return fmaxf(x, 0.f);
        return x;
      });
}

template <typename T>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[gemm_tile::MAX_DEVICES];
  cudaError_t err = gemm_tile::allow_max_smem(mm_kernel<T>, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.s.N / p.s.bn, p.s.M / p.s.bm);
  mm_kernel<T><<<grid, THREADS,
                 gemm_tile::smem_bytes(p.s.bm, p.s.bn, p.s.bk, sizeof(T)),
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
  const Params p{a,
                 b,
                 c,
                 o,
                 {M, N, K, bm, bn, bk, sa_m, sa_k, sb_k, sb_n},
                 sc_m,
                 sc_n,
                 epilogue,
                 alpha,
                 beta};
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
