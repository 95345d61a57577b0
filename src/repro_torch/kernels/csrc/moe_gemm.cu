// Grouped (per-expert) GEMM for NVIDIA Hopper (sm_90a):
// O[e] = X[e] @ W[e] for every expert e, X [E, M, K], W [E, K, N].
//
// Replaces the Pallas TPU kernel `grouped_matmul` / `_gmm_kernel`
// (src/repro/kernels/moe_gemm.py:19, pallas_call at :49).  Same function:
// an f32 accumulator over the K dimension and one store in X's dtype.  The
// Pallas grid (E, M/bm, N/bn, K/bk) becomes a CUDA grid (N/bn, M/bm, E):
// blockIdx.z is the expert, whose X, W and O the block offsets to, and the
// sequential K axis is a loop inside the block.  The output tile is
// gemm_tile.cuh's `block_tile`, the tile of K1: runtime tiles 1..256 that
// divide their dimension, walked in sub-tiles of at most 128 x 128, f32 FMA
// on the CUDA cores (never TF32), bf16 loaded as bf16 and rounded once at
// the store.  Its shared memory per block, (min(bm,128) + min(bn,128)) * bk
// * sizeof(T), is K1's for the same tile, which the profiler's estimate
// (core/profiler.py `variant_smem_bytes`, at the case's (M, N, K)) repeats;
// a tile above 232,448 bytes is refused by the wrapper before launch.
//
// Bound on the H100 (SXM: 67 TFLOP/s f32 on the CUDA cores, 989 TFLOP/s
// dense bf16, 3.35 TB/s HBM): the moe_grouped_gemm case at E 8, M 512,
// K 256, N 512 does 2*E*M*K*N = 1.07 GFLOP on 16.8 MB of f32 operands and
// output, 64 FLOPs a byte, above the f32 ridge of 20: bound by operations
// (16 us at the f32 rate, against 5 us of bytes).  In bf16 the tensor
// cores' ridge is 295, so bytes would bound it; this first kernel runs
// both dtypes on the CUDA cores, so its floor is the f32 rate.  The
// tensor-core tile planned for K1 (wgmma, TMA-fed shared memory) is the
// next step for both.

#include <atomic>

#include "gemm_tile.cuh"

namespace {

using gemm_tile::MAX_TILE;
using gemm_tile::THREADS;

struct Params {
  const void* x;
  const void* w;
  void* o;
  gemm_tile::Shape s;
  long long sx_e, sw_e;  // expert strides of X and W, in elements
};

template <typename T>
__global__ void __launch_bounds__(THREADS) gmm_kernel(const Params p) {
  const long long e = blockIdx.z;
  gemm_tile::block_tile(
      p.s, static_cast<const T*>(p.x) + e * p.sx_e,
      static_cast<const T*>(p.w) + e * p.sw_e,
      static_cast<T*>(p.o) + e * p.s.M * p.s.N, blockIdx.y * p.s.bm,
      blockIdx.x * p.s.bn, [](int, int, float acc) { return acc; });
}

template <typename T>
cudaError_t launch(const Params& p, int E, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[gemm_tile::MAX_DEVICES];
  cudaError_t err = gemm_tile::allow_max_smem(gmm_kernel<T>, device,
                                              smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.s.N / p.s.bn, p.s.M / p.s.bm, E);
  gmm_kernel<T><<<grid, THREADS,
                  gemm_tile::smem_bytes(p.s.bm, p.s.bn, p.s.bk, sizeof(T)),
                  stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (X, W and O).  Strides are in elements
// (expert, row, column); O is contiguous [E, M, N].  The tiles must divide
// M, N and K.  Returns a cudaError_t.
extern "C" int gmm_forward(const void* x, const void* w, void* o, int dtype,
                           int device, int E, int M, int N, int K, int bm,
                           int bn, int bk, long long sx_e, long long sx_m,
                           long long sx_k, long long sw_e, long long sw_k,
                           long long sw_n, void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || K <= 0 || bm <= 0 ||
      bn <= 0 || bk <= 0 || bm > MAX_TILE || bn > MAX_TILE ||
      bk > MAX_TILE || M % bm || N % bn || K % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const Params p{x, w, o, {M, N, K, bm, bn, bk, sx_m, sx_k, sw_k, sw_n},
                 sx_e, sw_e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(p, E, device, st); break;
    case 1: err = launch<__nv_bfloat16>(p, E, device, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
