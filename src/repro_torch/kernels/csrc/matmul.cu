// Tiled GEMM with a fused epilogue for NVIDIA Hopper (sm_90a):
// O = epilogue(A @ B [, C]).
//
// Replaces the Pallas TPU kernel `matmul_pallas` / `_mm_kernel`
// (src/repro/kernels/suites/pallas_lib.py:46, pallas_call at :70).  Same
// function: an f32 accumulator over the K dimension, then the epilogue
// (none, alpha*AB + beta*C, or relu) and one store in A's dtype.  Written
// for this card rather than carried over block by block:
//   * one thread block owns one bm x bn output tile; the Pallas grid's
//     sequential ("arbitrary") K axis becomes a loop inside the block.  Tile
//     sizes are runtime values 1..256 (`_fit` turns 256 into 192 at 384,
//     and automatic error repair halves blocks down to 8), walked in
//     sub-tiles of at most 128 x 128.  Shared memory holds
//     (min(bm,128) + min(bn,128)) * bk * sizeof(T) bytes, which the
//     profiler's estimate (core/profiler.py `variant_smem_bytes`) repeats;
//     a tile above the card's 232,448 bytes per block is refused by the
//     wrapper before launch, with the bytes named, for automatic repair;
//   * two bodies, chosen before launch by one rule (matmul.path_for, which
//     `mma_tile::mma_path` mirrors; a launch whose path disagrees with it
//     is refused):
//       - "mma" (mma_tile.cuh), every tile in multiples of 16 on aligned
//         operands: the tensor cores through `mma.sync`, fed by a ring of
//         `cp.async` stages.  f32 runs as three TF32 passes (hi*hi + hi*lo
//         + lo*hi), within f32 rounding of the plain product; bf16 as one
//         bf16 pass with an f32 accumulator;
//       - "simt" (gemm_tile.cuh's `block_tile`, shared with the grouped
//         GEMM K5), every other tile: IEEE f32 FMA on the CUDA cores;
//   * A and B are read through strides, so the transposed views that
//     syrk/syr2k pass need no copy; the epilogue reads C in f32.
//
// Bound on the H100 (SXM: 495 TFLOP/s TF32 and 989 bf16 on the tensor
// cores, 3.35 TB/s HBM): a square GEMM of n does 2n^3 FLOPs on 3 n^2
// elements.  An f32-accurate product costs three TF32 passes, 165 TFLOP/s
// of result: n/6 FLOPs per byte against a ridge of 49, so the cases' n of
// 256-1024 are bound by operations (1024^3: 0.013 ms).  In bf16, n/3
// against a ridge of 295: bytes bound it up to n ~ 900.  This body issues
// `mma.sync` from eight warps a block, which reaches a part of the tensor
// cores' rate that `wgmma` with TMA-fed stages would raise (ROADMAP
// queue 2, K1).

#include <atomic>

#include "gemm_tile.cuh"
#include "mma_tile.cuh"

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

template <typename T, int SL, bool AK, bool BK>
__global__ void __launch_bounds__(mma_tile::THREADS)
    mm_mma_kernel(const Params p) {
  mma_tile::block_tile<T, SL, AK, BK>(
      p.s, static_cast<const T*>(p.a), static_cast<const T*>(p.b),
      static_cast<T*>(p.o), blockIdx.y * p.s.bm, blockIdx.x * p.s.bn,
      [&p](int row, int col, float x) {
        if (p.epilogue == 1)
          return p.alpha * x + p.beta * p.c[row * p.sc_m + col * p.sc_n];
        if (p.epilogue == 2) return fmaxf(x, 0.f);
        return x;
      });
}

// Each kernel raises its own shared-memory attribute once per device.
template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, std::atomic<bool>* smem_set,
                          int threads, const Params& p, size_t item,
                          int device, cudaStream_t stream) {
  cudaError_t err = gemm_tile::allow_max_smem(kernel, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.s.N / p.s.bn, p.s.M / p.s.bm);
  kernel<<<grid, threads,
           gemm_tile::smem_bytes(p.s.bm, p.s.bn, p.s.bk, item), stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core kernel for one slice depth and operand layout, each with
// its own shared-memory flag.
template <typename T, int SL, bool AK, bool BK>
cudaError_t launch_mma(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[gemm_tile::MAX_DEVICES];
  return launch_kernel(mm_mma_kernel<T, SL, AK, BK>, smem_set,
                       mma_tile::THREADS, p, sizeof(T), device, stream);
}

template <typename T>
cudaError_t launch(const Params& p, int path, int device,
                   cudaStream_t stream) {
  static std::atomic<bool> simt_set[gemm_tile::MAX_DEVICES];
  if (path == 0)
    return launch_kernel(mm_kernel<T>, simt_set, THREADS, p, sizeof(T),
                         device, stream);
  return mma_tile::dispatch<T>(p.s, [&](auto v) {
    using V = decltype(v);
    return launch_mma<T, V::SL, V::AK, V::BK>(p, device, stream);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B and O; C is float32).  Strides are
// in elements; O is contiguous [M, N].  The tiles must divide M, N and K.
// path: 0 = simt, 1 = mma, as matmul.path_for chose; a path that the
// mirrored rule (mma_tile::mma_path) does not give is refused.  Returns a
// cudaError_t.
extern "C" int mm_forward(const void* a, const void* b, const float* c,
                          void* o, int dtype, int device, int M, int N,
                          int K, int bm, int bn, int bk, long long sa_m,
                          long long sa_k, long long sb_k, long long sb_n,
                          long long sc_m, long long sc_n, int epilogue,
                          float alpha, float beta, int path,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      bm > MAX_TILE || bn > MAX_TILE || bk > MAX_TILE || M % bm || N % bn ||
      K % bk || epilogue < 0 || epilogue > 2 || (epilogue == 1 && !c) ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const gemm_tile::Shape shape{M, N, K, bm, bn, bk, sa_m, sa_k, sb_k, sb_n};
  if (path != mma_tile::mma_path(shape, a, b, dtype == 0 ? 4 : 2))
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
                 shape,
                 sc_m,
                 sc_n,
                 epilogue,
                 alpha,
                 beta};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(p, path, device, st); break;
    default: err = launch<__nv_bfloat16>(p, path, device, st);
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
