// Blocked sum of a 1-D array for NVIDIA Hopper (sm_90a): out[0] = sum(x).
//
// Replaces the Pallas TPU kernel `reduce_sum_pallas` / `_reduce_kernel`
// (src/repro/kernels/suites/pallas_lib.py:80, pallas_call at :101).  Same
// function: x is cut into blocks of `blk` elements (the variant's block
// after `_fit`), each block is summed in f32, the block sums are added in
// f32, and the total is stored once in x's dtype.  The Pallas grid runs its
// blocks in order on one core and carries one f32 scratch sum from step to
// step; on this card blocks run in no order on 132 SMs and nothing carries
// over between them, so the sum takes two passes:
//   * pass 1, one thread block per `blk` elements: each thread adds its
//     strided elements in order (neighbouring threads on neighbouring
//     addresses), then a warp-shuffle tree and a tree over the block's
//     eight warp sums give the block's partial, written to partial[block];
//   * pass 2, one thread block: the same walk and trees over the partials.
// No atomics: the order of every addition is fixed by n and blk alone, so
// the same input gives a bit-identical sum on every call, which replayed
// functional-equivalence verdicts and eval-cache entries depend on.
//
// Bound on the H100 (SXM, 3.35 TB/s HBM, 67 TFLOP/s f32): n additions on
// n elements read once, a quarter of an operation a byte in f32: bound by
// bytes, 5.0 us for the reduction case's n = 4,194,304 f32 (16.8 MB).
// Pass 2 and the launch of two kernels are a fixed cost of a few us that
// the single pass would not pay; 16-byte vector loads in pass 1 are the
// next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The sum of `v` over the block's threads, in a fixed order; valid in
// thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Pass 1: block b sums x[b * blk : (b + 1) * blk] into partial[b].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    partial_sums(const T* __restrict__ x, long long blk,
                 float* __restrict__ partial) {
  const T* xb = x + blockIdx.x * blk;
  float acc = 0.f;
  for (long long i = threadIdx.x; i < blk; i += THREADS) acc += to_f32(xb[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// Pass 2: one block sums the n_blocks partials into out[0].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    total_sum(const float* __restrict__ partial, long long n_blocks,
              T* __restrict__ out) {
  float acc = 0.f;
  for (long long i = threadIdx.x; i < n_blocks; i += THREADS)
    acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) store(out, acc);
}

template <typename T>
cudaError_t launch(const void* x, float* partial, void* out, long long n,
                   long long blk, cudaStream_t stream) {
  const long long n_blocks = n / blk;
  partial_sums<T><<<static_cast<unsigned>(n_blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), blk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  total_sum<T><<<1, THREADS, 0, stream>>>(partial, n_blocks,
                                          static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16.  x is contiguous [n],
// blk divides n, partial holds n / blk floats, out one element.  Returns a
// cudaError_t.
extern "C" int reduce_sum_forward(const void* x, void* partial, void* out,
                                  int dtype, int device, long long n,
                                  long long blk, void* stream) {
  if (n <= 0 || blk <= 0 || n % blk || n / blk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  switch (dtype) {
    case 0: err = launch<float>(x, part, out, n, blk, st); break;
    case 1: err = launch<__nv_bfloat16>(x, part, out, n, blk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* reduce_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
