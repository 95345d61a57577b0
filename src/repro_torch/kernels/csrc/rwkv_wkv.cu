// RWKV6 WKV recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv_pallas` / `_wkv_kernel`
// (src/repro/kernels/rwkv_wkv.py:65).  Same function, per (batch, head):
//   o_t = r_t . (S + u (x) k_t v_t^T),   S <- diag(exp lw_t) S + k_t v_t^T
// with the state S [K, V] on chip for the whole sequence.  Written for this
// card rather than carried over block by block:
//   * one block per (batch, head) and one thread per value column j; thread
//     j keeps the state column S[:, j] (K floats) in registers, so the state
//     never touches shared or device memory until the final write;
//   * the Pallas grid's sequential chunk axis is a loop inside the block:
//     each stage loads `chunk` time steps of r, k, exp(lw) [chunk, K] and v
//     [chunk, V] into shared memory (coalesced rows, all threads), then
//     walks them step by step.  r, k and exp(lw) of a step are read by every
//     thread at one address (a broadcast);
//   * the bonus term r_t . (u (x) k_t) is the same for every column: it is
//     computed once per step at staging, not V times;
//   * any S: the last stage is masked (the Pallas wrapper shrinks chunk
//     until it divides S);
//   * the final state is written out ([B, H, K, V], f32), which the Pallas
//     kernel does not return.
//
// Bound on the H100 (SXM, 67 TFLOP/s f32, 3.35 TB/s HBM): a call does
// 5*K*V + O(K) flops per (token, head) and moves r, k, v, o once in bf16
// and lw in f32, about 12*K bytes per (token, head): ~27 flops a byte at
// K = V = 64, above the card's f32 ridge of 20, so the f32 rate bounds it,
// about 5 us at the rwkv6-7b serving shape B=1, S=256, H=64 (20 us at
// B=4).  But the recurrence is sequential in S: a block's S steps run one
// after another, each a dependent chain of K FMAs (split over four
// accumulators), so at serving sizes (B*H = 64..256 blocks of 64 threads
// on 132 SMs) the latency of that chain, not bytes or flops, sets the time.  Staging a chunk at a time
// keeps device-memory latency out of the chain; splitting the K reduction
// across a warp and keeping the state in a warpgroup layout is the next
// step (ROADMAP).

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int MAX_DEVICES = 64;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const void* u;
  void* o;
  float* state;
  int S, H, V, chunk;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int chunk, int K, int V) {
  // r, k, exp(lw) [chunk][K], v [chunk][V], bonus [chunk], u [K]
  return sizeof(float) *
         (size_t(chunk) * (3 * K + V + 1) + size_t(K));
}

template <typename T, int K>
__global__ void wkv_kernel(const Params p) {
  extern __shared__ float smem[];
  const int chunk = p.chunk;
  const int V = p.V;
  float* sr = smem;
  float* sk = sr + chunk * K;
  float* sw = sk + chunk * K;
  float* sv = sw + chunk * K;
  float* sbonus = sv + chunk * V;
  float* su = sbonus + chunk;

  const int j = threadIdx.x;
  const int nt = blockDim.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;

  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* lw = p.lw + b * p.w_sb + h * p.w_sh;
  const T* u = static_cast<const T*>(p.u) + h * K;
  T* o = static_cast<T*>(p.o) + (size_t(b) * p.S * p.H + h) * V;
  const long long o_ss = static_cast<long long>(p.H) * V;

  for (int c = j; c < K; c += nt) su[c] = to_f32(u[c]);

  float s[K];
#pragma unroll
  for (int c = 0; c < K; ++c) s[c] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += chunk) {
    const int n = min(chunk, p.S - t0);
    __syncthreads();  // the previous stage is no longer read
    for (int idx = j; idx < n * K; idx += nt) {
      const int t = idx / K, c = idx - t * K;
      const long long tt = t0 + t;
      sr[idx] = to_f32(r[tt * p.r_ss + c]);
      sk[idx] = to_f32(k[tt * p.k_ss + c]);
      sw[idx] = expf(lw[tt * p.w_ss + c]);
    }
    for (int idx = j; idx < n * V; idx += nt) {
      const int t = idx / V, c = idx - t * V;
      sv[idx] = to_f32(v[(t0 + t) * p.v_ss + c]);
    }
    __syncthreads();
    for (int t = j; t < n; t += nt) {
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < K; ++c)
        acc = fmaf(sr[t * K + c], su[c] * sk[t * K + c], acc);
      sbonus[t] = acc;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float* rt = sr + t * K;
      const float* kt = sk + t * K;
      const float* wt = sw + t * K;
      const float vj = sv[t * V + j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < K; c += 4) {
        a0 = fmaf(rt[c], s[c], a0);
        a1 = fmaf(rt[c + 1], s[c + 1], a1);
        a2 = fmaf(rt[c + 2], s[c + 2], a2);
        a3 = fmaf(rt[c + 3], s[c + 3], a3);
      }
      const float out = fmaf(sbonus[t], vj, (a0 + a1) + (a2 + a3));
#pragma unroll
      for (int c = 0; c < K; ++c) s[c] = fmaf(wt[c], s[c], kt[c] * vj);
      store(o + (t0 + t) * o_ss + j, out);
    }
  }

  float* st = p.state + (size_t(b) * p.H + h) * K * V;
#pragma unroll
  for (int c = 0; c < K; ++c) st[c * V + j] = s[c];
}

template <typename T, int K>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t stream) {
  // Past 48 KB of dynamic shared memory the launch needs this attribute.  It
  // belongs to the function on one device: set it at the first launch on
  // each device, to the most a block may opt in to.
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const size_t need = smem_bytes(p.chunk, K, p.V);
  if (device >= MAX_DEVICES || !smem_set[device].load()) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wkv_kernel<T, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) smem_set[device].store(true);
  }
  const dim3 grid(p.H, B);
  wkv_kernel<T, K><<<grid, p.V, need, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int K, int device,
                     cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, 16>(p, B, device, stream);
    case 32: return launch<T, 32>(p, B, device, stream);
    case 64: return launch<T, 64>(p, B, device, stream);
    case 128: return launch<T, 128>(p, B, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v, u and o): 0 = float32, 1 = bfloat16; lw and the state
// are float32.  Strides (batch, seq, head) are in elements; the last
// dimension of r, k, v and lw must be contiguous, u is [H, K] contiguous,
// o [B, S, H, V] and the state [B, H, K, V] are written contiguous.
// Returns a cudaError_t.
extern "C" int wkv_forward(const void* r, const void* k, const void* v,
                           const void* lw, const void* u, void* o,
                           void* state, int dtype, int device, int B, int S,
                           int H, int K, int V, int chunk, long long r_sb,
                           long long r_ss, long long r_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, long long w_sb,
                           long long w_ss, long long w_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || V <= 0 || V > 1024 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const Params p{r,    k,    v,    static_cast<const float*>(lw),
                 u,    o,    static_cast<float*>(state),
                 S,    H,    V,    chunk,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, w_sb, w_ss, w_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = dispatch<float>(p, B, K, device, st); break;
    case 1: err = dispatch<__nv_bfloat16>(p, B, K, device, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
