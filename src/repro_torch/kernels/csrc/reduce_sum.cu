// Blocked sum of a 1-D array for NVIDIA Hopper (sm_90a): out = sum(x).
//
// Replaces the Pallas TPU kernel `reduce_sum_pallas` / `_reduce_kernel`
// (src/repro/kernels/suites/pallas_lib.py:80, pallas_call at :101).  Same
// function: x is cut into blocks of `blk` elements (the variant's block
// after `_fit`), each block is summed in f32, the block sums are added in
// f32, and the total is stored once in x's dtype.  The Pallas grid runs its
// blocks in order on one core and carries one f32 scratch sum from step to
// step; on this card blocks run in no order on 132 SMs and nothing carries
// over between them.  One launch does both passes:
//   * every `blk` elements are summed by 256 threads: thread t adds, in
//     order, the 16-byte chunks t, t + 256, t + 512, ... of the block (4
//     f32 or 8 bf16 elements a chunk, each chunk's elements in order); a
//     warp-shuffle tree and a tree over the eight warp sums give the
//     block's partial, written to partial[block].  A CUDA block takes G of
//     these blocks at once (G = 16 for blocks of up to 4 KB, 4 up to 16 KB,
//     else 1), each thread playing thread t of all G with their loads in
//     flight together, so a small block costs no ticket, start and end of
//     its own; G changes no addition;
//   * a ticket counter picks the last CUDA block to finish (the threads
//     that wrote its partials `__threadfence`, then its thread 0
//     `atomicAdd`s the ticket), and that block sums the partials with the
//     same walk and trees, in index order, stores the total and sets the
//     ticket back to 0.
// No atomic adds a value: the order of every addition is fixed by n and
// blk alone, so the same values give a bit-identical sum on every call,
// which replayed functional-equivalence verdicts and eval-cache entries
// depend on.  The chunks are read by one 16-byte load where every block
// starts on a 16-byte boundary (x aligned, blk a multiple of a chunk) and
// element by element otherwise, with the same grouping, so an equal array
// at another address sums to the same bits.
//
// The ticket and the partials live in a workspace that the wrapper keeps
// per (device, stream): the ticket is zeroed once, when the workspace is
// allocated, and every launch leaves it at 0.  Two streams never share a
// ticket; launches on one stream run one after another.
//
// Bound on the H100 (SXM, 3.35 TB/s HBM, 67 TFLOP/s f32): n additions on
// n elements read once, a quarter of an operation a byte in f32: bound by
// bytes, 5.0 us for the reduction case's n = 4,194,304 f32 (16.8 MB).

#include <cstring>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // 16-byte loads in flight a thread

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

// Adds the V elements of one 16-byte chunk to acc, in order.
template <typename T>
__device__ __forceinline__ float add_chunk(float acc, const uint4& u) {
  constexpr int V = 16 / sizeof(T);
  T v[V];
  memcpy(v, &u, 16);
#pragma unroll
  for (int j = 0; j < V; ++j) acc += to_f32(v[j]);
  return acc;
}

// This thread's sum of the block at xb: chunks t, t + THREADS, ... in
// order.  VEC: every chunk is whole and 16-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ float thread_sum(const T* __restrict__ xb,
                                            long long blk) {
  constexpr int V = 16 / sizeof(T);
  const long long chunks = (blk + V - 1) / V;
  float acc = 0.f;
  long long c = threadIdx.x;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xb);
    for (; c + (UNROLL - 1) * THREADS < chunks; c += UNROLL * THREADS) {
      uint4 u[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) u[k] = __ldg(xv + c + k * THREADS);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) acc = add_chunk<T>(acc, u[k]);
    }
    for (; c < chunks; c += THREADS) acc = add_chunk<T>(acc, __ldg(xv + c));
  } else {
    for (; c < chunks; c += THREADS) {
      const long long i0 = c * V;
      const int m = blk - i0 < V ? int(blk - i0) : V;
      for (int j = 0; j < m; ++j) acc += to_f32(xb[i0 + j]);
    }
  }
  return acc;
}

// This thread's sums of the ng <= G blocks at xb, xb + blk, ...: for each,
// chunks t, t + THREADS, ... in order, as thread_sum adds them; the loads
// of CU chunk indices of all G blocks go out together (16 a thread).
template <typename T, bool VEC, int G>
__device__ __forceinline__ void thread_sums(const T* __restrict__ xb,
                                            long long blk, int ng,
                                            float (&acc)[G]) {
  if constexpr (G == 1) {
    acc[0] = thread_sum<T, VEC>(xb, blk);
  } else {
    constexpr int V = 16 / sizeof(T);
    constexpr int CU = 16 / G;
    const long long chunks = (blk + V - 1) / V;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (long long c = threadIdx.x; c < chunks; c += CU * THREADS) {
      if constexpr (VEC) {
        uint4 u[CU][G];
#pragma unroll
        for (int k = 0; k < CU; ++k)
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (g < ng && c + k * THREADS < chunks)
              u[k][g] = __ldg(reinterpret_cast<const uint4*>(xb + g * blk) +
                              c + k * THREADS);
#pragma unroll
        for (int k = 0; k < CU; ++k)
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (g < ng && c + k * THREADS < chunks)
              acc[g] = add_chunk<T>(acc[g], u[k][g]);
      } else {
#pragma unroll
        for (int k = 0; k < CU; ++k) {
          const long long i0 = (c + k * THREADS) * V;
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (g < ng && i0 + j < blk)
                acc[g] += to_f32(xb[g * blk + i0 + j]);
        }
      }
    }
  }
}

// One CUDA block sums G consecutive blocks of blk elements, each into its
// partial with block_sum's trees (per warp, then over the eight warp sums
// by eight lanes), so a partial's bits do not depend on G.
template <typename T, bool VEC, int G>
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const T* __restrict__ x, long long blk, unsigned n_blocks,
                  unsigned* __restrict__ ticket, float* __restrict__ partial,
                  T* __restrict__ out) {
  __shared__ float warp_sums[G][WARPS];
  __shared__ bool last;
  const unsigned b0 = blockIdx.x * G;
  const int ng = n_blocks - b0 < G ? int(n_blocks - b0) : G;
  float acc[G];
  thread_sums<T, VEC, G>(x + b0 * blk, blk, ng, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = acc[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[g][warp] = v;
  }
  __syncthreads();
  if (warp < (8 * G + 31) / 32) {  // lanes 8g .. 8g + 7 take block g
    const int g = threadIdx.x >> 3, r = threadIdx.x & 7;
    float v = g < G ? warp_sums[g][r] : 0.f;
    v += __shfl_down_sync(0xffffffffu, v, 4, 8);
    v += __shfl_down_sync(0xffffffffu, v, 2, 8);
    v += __shfl_down_sync(0xffffffffu, v, 1, 8);
    if (r == 0 && g < ng) {
      partial[b0 + g] = v;
      __threadfence();  // the partial is visible before the ticket counts it
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The last block: every other partial was written before its ticket.
  __threadfence();
  float total = 0.f;
  for (unsigned i = threadIdx.x; i < n_blocks; i += THREADS)
    total += __ldcg(partial + i);  // from L2: written by other SMs
  total = block_sum(total);
  if (threadIdx.x == 0) {
    store(out, total);
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

template <typename T, bool VEC, int G>
void launch_g(const void* x, long long blk, unsigned n_blocks,
              unsigned* ticket, float* partial, void* out,
              cudaStream_t stream) {
  reduce_kernel<T, VEC, G><<<(n_blocks + G - 1) / G, THREADS, 0, stream>>>(
      static_cast<const T*>(x), blk, n_blocks, ticket, partial,
      static_cast<T*>(out));
}

// G by the bytes of a block (n = 4,194,304 f32: 256 CUDA blocks at each of
// the reduction case's blocks 1024, 4096 and 16384, against 4096 and 1024
// tickets at one block each).
template <typename T, bool VEC>
void launch_vec(const void* x, long long blk, unsigned n_blocks,
                unsigned* ticket, float* partial, void* out,
                cudaStream_t stream) {
  const long long bytes = blk * (long long)sizeof(T);
  if (bytes <= 4096)
    launch_g<T, VEC, 16>(x, blk, n_blocks, ticket, partial, out, stream);
  else if (bytes <= 16384)
    launch_g<T, VEC, 4>(x, blk, n_blocks, ticket, partial, out, stream);
  else
    launch_g<T, VEC, 1>(x, blk, n_blocks, ticket, partial, out, stream);
}

template <typename T>
cudaError_t launch(const void* x, long long n, long long blk, void* ws,
                   void* out, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const unsigned n_blocks = static_cast<unsigned>(n / blk);
  unsigned* ticket = static_cast<unsigned*>(ws);
  float* partial = static_cast<float*>(ws) + 1;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && blk % V == 0)
    launch_vec<T, true>(x, blk, n_blocks, ticket, partial, out, stream);
  else
    launch_vec<T, false>(x, blk, n_blocks, ticket, partial, out, stream);
  return cudaGetLastError();
}

// The launch as kernels/reduce_sum.py packs it (struct.Struct "=4Q4q").
// dtype (of x and out): 0 = float32, 1 = bfloat16.  x is contiguous [n],
// blk divides n; ws holds the ticket (one 32-bit word, 0) and then n / blk
// floats.
struct Args {
  const void* x;
  void* out;
  void* ws;
  void* stream;
  long long dtype, device, n, blk;
};
static_assert(sizeof(Args) == 8 * 8, "Args is eight 8-byte fields");

}  // namespace

// Launches one sum from the packed `Args` at `packed`.  Returns a
// cudaError_t.
extern "C" int reduce_sum_launch(const void* packed) {
  Args a;
  std::memcpy(&a, packed, sizeof a);
  if (a.n <= 0 || a.blk <= 0 || a.n % a.blk || a.n / a.blk > 0x7fffffffLL ||
      a.dtype < 0 || a.dtype > 1)
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
  err = a.dtype == 0 ? launch<float>(a.x, a.n, a.blk, a.ws, a.out, st)
                     : launch<__nv_bfloat16>(a.x, a.n, a.blk, a.ws, a.out,
                                             st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* reduce_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
