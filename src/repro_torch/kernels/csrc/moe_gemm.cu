// Grouped (per-expert) GEMM for NVIDIA Hopper (sm_90a):
// O[e] = X[e] @ W[e] for every expert e, X [E, M, K], W [E, K, N].
//
// Replaces the Pallas TPU kernel `grouped_matmul` / `_gmm_kernel`
// (src/repro/kernels/moe_gemm.py:19, pallas_call at :49).  Same function:
// an f32 accumulator over the K dimension and one store in X's dtype.  The
// Pallas grid (E, M/bm, N/bn, K/bk) becomes a CUDA grid (N/bn, M/bm, E):
// blockIdx.z is the expert, whose X, W and O the block offsets to, and the
// sequential K axis is a loop inside the block.  The output tile is K1's,
// in its two bodies, chosen before launch by one rule (moe_gemm.path_for,
// which `gmm_path` below mirrors):
//   * "mma" (mma_tile.cuh's `block_tile`), every tile in multiples of 16 on
//     operands that suit 16-byte `cp.async` copies in every expert: the
//     rule of K1 (matmul.path_for) plus the expert strides of X and W in
//     multiples of 16 bytes.  The tensor cores through `mma.sync` fed by a
//     `cp.async` ring; f32 as three TF32 passes (hi*hi + hi*lo + lo*hi),
//     within f32 rounding of the plain product; bf16 as one pass with an
//     f32 accumulator.  The instantiation (slice depth, operand layouts) is
//     chosen by `mma_tile::dispatch`, the helper K1 calls too;
//   * "simt" (gemm_tile.cuh's `block_tile`), every other tile (automatic
//     error repair's tiles below 16) and misaligned operands: IEEE f32 FMA
//     on the CUDA cores.
// An "mma" launch that the rule does not give is refused; "simt" runs any
// input, so the two bodies can be timed on the same operands.  Both bodies
// take (min(bm,128) + min(bn,128)) * bk * sizeof(T) bytes of shared memory
// per block, K1's for the same tile, which the profiler's estimate
// (core/profiler.py `variant_smem_bytes`) repeats; a tile above 232,448
// bytes is refused by the wrapper before launch.
//
// Bound on the H100 (SXM: 495 TFLOP/s TF32 and 989 bf16 on the tensor
// cores, 3.35 TB/s HBM): the moe_grouped_gemm case at E 8, M 512, K 256,
// N 512 does 2*E*M*K*N = 1.07 GFLOP on 16.8 MB of f32 operands and output.
// An f32-accurate product costs three TF32 passes, 165 TFLOP/s of result:
// 64 FLOPs a byte against a ridge of 49, bound by operations (6.5 us).  In
// bf16 (8.4 MB) bytes bound it (2.5 us against 1.1 us of operations).  At
// 128^3 the shape is 4 x 4 x 8 = 128 blocks of K = 256, one wave on 132
// SMs; `mma.sync` from eight warps a block reaches a part of the tensor
// cores' rate that `wgmma` with TMA-fed stages would raise (ROADMAP queue
// 2, K1).
//
// The wrapper packs the launch's arguments into one struct of 8-byte
// fields (`Args`), so a call converts one Python argument, not twenty.

#include <atomic>
#include <cstring>

#include "gemm_tile.cuh"
#include "mma_tile.cuh"

namespace {

using gemm_tile::MAX_TILE;

struct Params {
  const void* x;
  const void* w;
  void* o;
  gemm_tile::Shape s;
  long long sx_e, sw_e;  // expert strides of X and W, in elements
};

template <typename T>
__global__ void __launch_bounds__(gemm_tile::THREADS)
    gmm_kernel(const Params p) {
  const long long e = blockIdx.z;
  gemm_tile::block_tile(
      p.s, static_cast<const T*>(p.x) + e * p.sx_e,
      static_cast<const T*>(p.w) + e * p.sw_e,
      static_cast<T*>(p.o) + e * p.s.M * p.s.N, blockIdx.y * p.s.bm,
      blockIdx.x * p.s.bn, [](int, int, float acc) { return acc; });
}

template <typename T, int SL, bool AK, bool BK>
__global__ void __launch_bounds__(mma_tile::THREADS)
    gmm_mma_kernel(const Params p) {
  const long long e = blockIdx.z;
  mma_tile::block_tile<T, SL, AK, BK>(
      p.s, static_cast<const T*>(p.x) + e * p.sx_e,
      static_cast<const T*>(p.w) + e * p.sw_e,
      static_cast<T*>(p.o) + e * p.s.M * p.s.N, blockIdx.y * p.s.bm,
      blockIdx.x * p.s.bn, [](int, int, float acc) { return acc; });
}

// The rule of moe_gemm.path_for: K1's (mma_tile::mma_path) for the first
// expert, and expert strides in multiples of 16 bytes, so that every
// expert's operands are as aligned as the first's.  1 = "mma".
int gmm_path(const Params& p, size_t item) {
  return (p.sx_e * (long long)item) % 16 == 0 &&
         (p.sw_e * (long long)item) % 16 == 0 &&
         mma_tile::mma_path(p.s, p.x, p.w, item);
}

// Each kernel raises its own shared-memory attribute once per device.
template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, std::atomic<bool>* smem_set,
                          int threads, const Params& p, int E, size_t item,
                          int device, cudaStream_t stream) {
  cudaError_t err = gemm_tile::allow_max_smem(kernel, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.s.N / p.s.bn, p.s.M / p.s.bm, E);
  kernel<<<grid, threads,
           gemm_tile::smem_bytes(p.s.bm, p.s.bn, p.s.bk, item), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int SL, bool AK, bool BK>
cudaError_t launch_mma(const Params& p, int E, int device,
                       cudaStream_t stream) {
  static std::atomic<bool> smem_set[gemm_tile::MAX_DEVICES];
  return launch_kernel(gmm_mma_kernel<T, SL, AK, BK>, smem_set,
                       mma_tile::THREADS, p, E, sizeof(T), device, stream);
}

template <typename T>
cudaError_t launch(const Params& p, int path, int E, int device,
                   cudaStream_t stream) {
  static std::atomic<bool> simt_set[gemm_tile::MAX_DEVICES];
  if (path == 0)
    return launch_kernel(gmm_kernel<T>, simt_set, gemm_tile::THREADS, p, E,
                         sizeof(T), device, stream);
  return mma_tile::dispatch<T>(p.s, [&](auto v) {
    using V = decltype(v);
    return launch_mma<T, V::SL, V::AK, V::BK>(p, E, device, stream);
  });
}

// The launch as kernels/moe_gemm.py packs it (struct.Struct "=4Q16q").
// dtype: 0 = float32, 1 = bfloat16 (X, W and O); path: 0 = simt, 1 = mma.
// Strides are in elements: X's (expert, row, column), W's (expert, row,
// column); O is contiguous [E, M, N].
struct Args {
  const void* x;
  const void* w;
  void* o;
  void* stream;
  long long dtype, device, path, E, M, N, K, bm, bn, bk;
  long long sx_e, sx_m, sx_k, sw_e, sw_k, sw_n;
};
static_assert(sizeof(Args) == 20 * 8, "Args is twenty 8-byte fields");

}  // namespace

// Launches one grouped GEMM from the packed `Args` at `packed`.  The tiles
// must divide M, N and K; a path that the mirrored rule does not allow is
// refused.  Returns a cudaError_t.
extern "C" int gmm_launch(const void* packed) {
  Args a;
  std::memcpy(&a, packed, sizeof a);
  if (a.E <= 0 || a.E > 65535 || a.M <= 0 || a.N <= 0 || a.K <= 0 ||
      a.M > 0x7fffffff || a.N > 0x7fffffff || a.K > 0x7fffffff ||
      a.bm <= 0 || a.bn <= 0 || a.bk <= 0 || a.bm > MAX_TILE ||
      a.bn > MAX_TILE || a.bk > MAX_TILE || a.M % a.bm || a.N % a.bn ||
      a.K % a.bk || a.dtype < 0 || a.dtype > 1 || a.path < 0 || a.path > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{a.x,
                 a.w,
                 a.o,
                 {int(a.M), int(a.N), int(a.K), int(a.bm), int(a.bn),
                  int(a.bk), a.sx_m, a.sx_k, a.sw_k, a.sw_n},
                 a.sx_e,
                 a.sw_e};
  const size_t item = a.dtype == 0 ? 4 : 2;
  if (a.path == 1 && !gmm_path(p, item))
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  const int device = int(a.device);
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int path = int(a.path), E = int(a.E);
  err = a.dtype == 0 ? launch<float>(p, path, E, device, st)
                     : launch<__nv_bfloat16>(p, path, E, device, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
