// RWKV6 WKV recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv_pallas` / `_wkv_kernel`
// (src/repro/kernels/rwkv_wkv.py:65).  Same function, per (batch, head):
//   o_t = r_t . (S + u (x) k_t v_t^T),   S <- diag(exp lw_t) S + k_t v_t^T
// with the state S [K, V] on chip for the whole sequence, and the final
// state written out ([B, H, K, V], f32), which the Pallas kernel does not
// return.  Any S: the last stage is masked (the Pallas wrapper shrinks
// chunk until it divides S).
//
// Bound on the H100 (SXM, 67 TFLOP/s f32, 3.35 TB/s HBM): per (token,
// head) the function does 5*K*V + 3*K + 2*V f32 operations and moves r, k,
// v, o once (bf16 or f32) and lw once in f32, plus the final state once.
// At the rwkv6-7b serving shape B=1 S=256 H=64 K=V=64 in bf16 that is
// 5.09 us of operations against about 4.1 us of bytes: operations bound it.
//
// Where the time goes.  Column j of the state depends only on column j and
// v_t[j], and within a column each element s[c][j] is its own recurrence:
// s <- exp(lw_t[c]) * s + k_t[c] * v_t[j] is one FMA a step on the critical
// path.  The output's sum over c reads the state but feeds nothing back,
// so it is off that path.  A step is therefore bounded by how fast its
// 5*K*V operations issue, not by a chain of K dependent FMAs.  A body with
// one thread a column (a K-long column in registers) issues ~5K
// instructions a step on one thread, with 2 warps a block and 64 blocks at
// B=1: half the SMs idle and the busy ones can hide no latency.
// This body spreads the same work:
//   * a block takes one (batch, head) and a slice of VB value columns: the
//     grid is (H, B, ceil(V / VB)), the last slice masked.  The wrapper
//     chooses VB (`geometry` in kernels/rwkv_wkv.py) for about two blocks
//     an SM, in whole warps of columns, and this entry refuses what it
//     cannot run;
//   * each column's K state rows are split across G = K / 8 adjacent lanes,
//     8 rows a lane, kept in registers: two runs of 4, K / 2 apart, so that
//     a 16-byte load of the G lanes of a column reads one contiguous span of
//     f32 shared memory (runs of 8 read 32 bytes a lane, two lanes to a bank
//     group).  A step, per lane: its partial sum_c r[c] * (s[c] + u[c] *
//     k[c] * v_j) (the bonus folded in, as the JAX kernel's
//     `r_t @ (s + u * kv)`), the 8 state updates, then log2(G)
//     `__shfl_xor_sync` steps add the G partials and lane 0 stores o.
//     About 40 arithmetic instructions a lane a step where a thread issued
//     ~5K.  Steps go in pairs, the stores after both, so that no store
//     lies between two steps' loads and the two shuffle trees overlap;
//   * the state update is s = fmaf(expf(lw), s, k * v) element by element
//     and the split reorders none of it, so the final state is the same
//     bits at any slice, lane count or chunk (and as a thread-a-column
//     body's);
//   * a stage is `chunk` time steps of the raw rows, r, k (bf16 or f32), lw
//     (f32) and the slice's v columns, copied by `cp.async` (16, 8 or 4
//     bytes a copy, the widest that the addresses and strides allow;
//     element copies for bf16 views off 4 bytes).  One stage at a time:
//     the next is copied after the block has walked the current one, so a
//     stage's shared memory is all a block takes (a ring of two was timed
//     within 2.3% at chunks 16-64 and 1.65x slower at rwkv6-7b's chunk
//     128, where two bf16 stages leave one block an SM).  After a stage
//     lands the block takes
//     exp(lw) in place, each element once (a lane taking it at use would
//     repeat it for every column of the slice), and the lanes convert r, k
//     and v at use.
//
// Runs of 4 rows against 8, pairs of steps against 1, 4 or 8, the exp
// pass against exp at use, and the pair loop's moving pointers and unroll
// were chosen by timing patched copies side by side on the H100, each the
// faster at the served shape (PERF.md).

#include <atomic>
#include <cstring>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int ROWS = 8;           // state rows a lane keeps
constexpr int RUN = 4;            // of them consecutive (row_of)
constexpr int MAX_THREADS = 256;  // a block's lanes, G * VB
constexpr int STEPS = 2;          // time steps walked between stores

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const void* u;
  void* o;
  float* state;
  int S, H, V, chunk, VB;
  // bytes a cp.async copies, per tensor (16, 8 or 4; 0: element copies)
  int gran_r, gran_k, gran_v, gran_w;
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

// N consecutive elements of shared memory in f32 (16 bytes a load for
// f32; N * 2 bytes for bf16, aligned to that).
template <int N>
__device__ __forceinline__ void load_run(const float* p, float* out) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 a = reinterpret_cast<const float4*>(p)[c];
    out[4 * c] = a.x; out[4 * c + 1] = a.y;
    out[4 * c + 2] = a.z; out[4 * c + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float* out) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
    static_assert(N == 4, "runs of 4 or 8 bf16");
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {  // bf16 is the high half of an f32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A lane's state rows: ROWS / RUN runs of RUN consecutive rows, K / (ROWS /
// RUN) apart, so that the lanes of a column read one contiguous span of a
// step's row per load.
template <int K>
__device__ __forceinline__ int row_of(int lane, int i) {
  constexpr int RUNS = ROWS / RUN;
  return (i / RUN) * (K / RUNS) + lane * RUN + i % RUN;
}
template <typename T, int K>
__device__ __forceinline__ void load_rows(const T* row, int lane,
                                          float* out) {
  constexpr int RUNS = ROWS / RUN;
#pragma unroll
  for (int c = 0; c < RUNS; ++c)
    load_run<RUN>(row + c * (K / RUNS) + lane * RUN, out + c * RUN);
}

// The sum of `x` over the G adjacent lanes of a column, in every lane.
template <int G>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One time step of the lane's rows: its partial of o_t[j] (the bonus folded
// in) and the update of its state rows.
template <typename T, int K>
__device__ __forceinline__ float step(const float* w_s, const T* r_s,
                                      const T* k_s, const T* v_s, int t,
                                      int VB, int col, int lane,
                                      const float* u, float* s) {
  float rr[ROWS], kk[ROWS], ww[ROWS];
  load_rows<T, K>(r_s + t * K, lane, rr);
  load_rows<T, K>(k_s + t * K, lane, kk);
  load_rows<float, K>(w_s + t * K, lane, ww);
  const float vj = to_f32(v_s[t * VB + col]);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float kv = kk[i] * vj;
    acc = fmaf(rr[i], fmaf(u[i], kv, s[i]), acc);
    s[i] = fmaf(ww[i], s[i], kv);
  }
  return acc;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst)), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       smem_addr(dst)), "l"(src) : "memory");
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst)), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies `n` rows of `row_bytes` from `src` (rows `stride` bytes apart) to
// `dst` (rows `dst_row` bytes apart), `gran` bytes a cp.async; with gran 0,
// two bytes at a time by plain loads and stores.
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_row,
                                          const unsigned char* src,
                                          long long stride, int row_bytes,
                                          int n, int gran) {
  const int step = gran ? gran : 2;
  const int per = row_bytes / step;
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int row = i / per, c = (i - row * per) * step;
    unsigned char* d = dst + row * dst_row + c;
    const unsigned char* s = src + row * stride + c;
    if (gran)
      cp_async(d, s, gran);
    else
      *reinterpret_cast<uint16_t*>(d) =
          *reinterpret_cast<const uint16_t*>(s);
  }
}

// Shared memory of one stage: exp(lw) [chunk][K] f32, r and k [chunk][K]
// and v [chunk][VB] in the input type.  kernels/rwkv_wkv.py's
// `smem_bytes` is the same sum.
template <typename T>
__host__ __device__ size_t stage_bytes(int chunk, int K, int VB) {
  return size_t(chunk) * (K * (sizeof(float) + 2 * sizeof(T)) +
                          VB * sizeof(T));
}

template <typename T, int K>
__global__ void __launch_bounds__(MAX_THREADS) wkv_kernel(const Params p) {
  constexpr int G = K / ROWS;  // lanes a column
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = p.chunk, VB = p.VB, V = p.V;
  const int lane = threadIdx.x % G, col = threadIdx.x / G;
  const int h = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * VB;
  const int j = j0 + col;
  const int ncols = min(VB, V - j0);  // the slice's columns in V

  const unsigned char* r = static_cast<const unsigned char*>(p.r) +
                           (b * p.r_sb + h * p.r_sh) * sizeof(T);
  const unsigned char* k = static_cast<const unsigned char*>(p.k) +
                           (b * p.k_sb + h * p.k_sh) * sizeof(T);
  const unsigned char* v = static_cast<const unsigned char*>(p.v) +
                           (b * p.v_sb + h * p.v_sh + j0) * sizeof(T);
  const unsigned char* lw = reinterpret_cast<const unsigned char*>(p.lw) +
                            (b * p.w_sb + h * p.w_sh) * sizeof(float);
  const long long o_ss = static_cast<long long>(p.H) * V;
  T* o = static_cast<T*>(p.o) + size_t(b) * p.S * o_ss + h * V + j;
  const bool stores = lane == 0 && col < ncols;

  // Stage `st` (time steps st*chunk ...) into shared memory.
  auto issue = [&](int st) {
    const long long t0 = static_cast<long long>(st) * chunk;
    const int n = min(chunk, p.S - static_cast<int>(t0));
    unsigned char* w_s = smem;
    unsigned char* r_s = w_s + chunk * K * sizeof(float);
    unsigned char* k_s = r_s + chunk * K * sizeof(T);
    unsigned char* v_s = k_s + chunk * K * sizeof(T);
    copy_rows(w_s, K * sizeof(float), lw + t0 * p.w_ss * sizeof(float),
              p.w_ss * sizeof(float), K * sizeof(float), n, p.gran_w);
    copy_rows(r_s, K * sizeof(T), r + t0 * p.r_ss * sizeof(T),
              p.r_ss * sizeof(T), K * sizeof(T), n, p.gran_r);
    copy_rows(k_s, K * sizeof(T), k + t0 * p.k_ss * sizeof(T),
              p.k_ss * sizeof(T), K * sizeof(T), n, p.gran_k);
    copy_rows(v_s, VB * sizeof(T), v + t0 * p.v_ss * sizeof(T),
              p.v_ss * sizeof(T), ncols * sizeof(T), n, p.gran_v);
    cp_async_commit();
  };

  float u[ROWS], s[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    u[i] = to_f32(static_cast<const T*>(p.u)[h * K + row_of<K>(lane, i)]);
    s[i] = 0.f;
  }

  const int stages = (p.S + chunk - 1) / chunk;
  issue(0);
  for (int st = 0; st < stages; ++st) {
    const int t0 = st * chunk, n = min(chunk, p.S - t0);
    cp_async_wait<0>();
    __syncthreads();  // every thread's copies of stage st have landed
    float* w_s = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < n * K; i += blockDim.x)
      w_s[i] = expf(w_s[i]);
    __syncthreads();
    const T* r_s = reinterpret_cast<const T*>(w_s + chunk * K);
    const T* k_s = r_s + chunk * K;
    const T* v_s = k_s + chunk * K;
    T* ot = o + t0 * o_ss;
    // STEPS steps, then their lane sums and stores: no store lies between
    // two steps' loads, so the loads of a group issue together and the
    // shuffle trees of its steps overlap.  The rows' pointers move by a
    // group of steps at a time and the loop is unrolled twice: indexed by
    // t and not unrolled, the same loop ran 8% slower on the H100 once
    // the stage loop around it lost the two-stage ring (the compiler
    // scheduled it otherwise; PERF.md).
    const float* wt = w_s;
    const T *rt = r_s, *kt = k_s, *vt = v_s;
    int t = 0;
#pragma unroll 2
    for (; t + STEPS <= n; t += STEPS) {
      float acc[STEPS];
#pragma unroll
      for (int q = 0; q < STEPS; ++q)
        acc[q] = step<T, K>(wt, rt, kt, vt, q, VB, col, lane, u, s);
#pragma unroll
      for (int q = 0; q < STEPS; ++q) acc[q] = lane_sum<G>(acc[q]);
      if (stores) {
#pragma unroll
        for (int q = 0; q < STEPS; ++q) store(ot + q * o_ss, acc[q]);
      }
      wt += STEPS * K;
      rt += STEPS * K;
      kt += STEPS * K;
      vt += STEPS * VB;
      ot += STEPS * o_ss;
    }
    for (; t < n; ++t) {
      const float acc = lane_sum<G>(
          step<T, K>(wt, rt, kt, vt, 0, VB, col, lane, u, s));
      if (stores) store(ot, acc);
      wt += K;
      rt += K;
      kt += K;
      vt += VB;
      ot += o_ss;
    }
    __syncthreads();  // the stage is free again
    if (st + 1 < stages) issue(st + 1);
  }

  if (col < ncols) {
    float* out = p.state + (size_t(b) * p.H + h) * K * V + j;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) out[row_of<K>(lane, i) * V] = s[i];
  }
}

template <typename T, int K>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t stream) {
  // Past 48 KB of dynamic shared memory the launch needs this attribute.  It
  // belongs to the function on one device: set it at the first launch on
  // each device, to the most a block may opt in to, which is kept.
  static std::atomic<int> most_set[MAX_DEVICES];
  int most = device < MAX_DEVICES ? most_set[device].load() : 0;
  if (most == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wkv_kernel<T, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) most_set[device].store(most);
  }
  const size_t need = stage_bytes<T>(p.chunk, K, p.VB);
  if (need > size_t(most)) return cudaErrorInvalidValue;
  const dim3 grid(p.H, B, (p.V + p.VB - 1) / p.VB);
  wkv_kernel<T, K><<<grid, K / ROWS * p.VB, need, stream>>>(p);
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

// The widest cp.async (16, 8 or 4 bytes) that every row of a tensor takes:
// its address, strides, row length and `extra` (the column slice's start)
// are all multiples of it; 0 where 4 bytes do not divide them (bf16 views
// off 4 bytes), for element copies.
int granule(const void* ptr, long long item, long long sb, long long ss,
            long long sh, long long row_bytes, long long extra) {
  const long long parts[] = {static_cast<long long>(
                                 reinterpret_cast<uintptr_t>(ptr)),
                             sb * item, ss * item, sh * item, row_bytes,
                             extra};
  for (int g = 16; g >= 4; g /= 2) {
    bool ok = true;
    for (long long x : parts) ok = ok && x % g == 0;
    if (ok) return g;
  }
  return 0;
}

// The launch as kernels/rwkv_wkv.py packs it (struct.Struct "=8Q21q").
// dtype (of r, k, v, u and o): 0 = float32, 1 = bfloat16; lw and the state
// are float32.  Strides (batch, seq, head) are in elements; the last
// dimension of r, k, v and lw must be contiguous, u is [H, K] contiguous,
// o [B, S, H, V] and the state [B, H, K, V] are written contiguous.  VB is
// the column slice (a multiple of 32 / G columns, so every warp is whole,
// with G * VB <= MAX_THREADS).
struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* lw;
  const void* u;
  void* o;
  void* state;
  void* stream;
  long long dtype, device, B, S, H, K, V, chunk, VB;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, w_sb, w_ss, w_sh;
};
static_assert(sizeof(Args) == 29 * 8, "Args is 29 8-byte fields");

}  // namespace

// Launches one recurrence from the packed `Args` at `packed`.  Returns a
// cudaError_t; cudaErrorInvalidValue for a geometry the kernel cannot run.
extern "C" int wkv_launch(const void* packed) {
  Args a;
  std::memcpy(&a, packed, sizeof a);
  const long long G = a.K / ROWS;
  const long long item = a.dtype == 0 ? 4 : 2;
  const bool k_ok = a.K == 16 || a.K == 32 || a.K == 64 || a.K == 128;
  if (!k_ok || a.B <= 0 || a.B > 65535 || a.S <= 0 || a.S > 0x7fffffffLL ||
      a.H <= 0 || a.H > 0x7fffffffLL || a.V <= 0 || a.V > 1024 ||
      a.chunk <= 0 || a.chunk > a.S || a.VB <= 0 || (G * a.VB) % 32 ||
      G * a.VB > MAX_THREADS || (a.V + a.VB - 1) / a.VB > 65535 ||
      a.dtype < 0 || a.dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{a.r, a.k, a.v, static_cast<const float*>(a.lw), a.u, a.o,
                 static_cast<float*>(a.state), int(a.S), int(a.H), int(a.V),
                 int(a.chunk), int(a.VB),
                 granule(a.r, item, a.r_sb, a.r_ss, a.r_sh, a.K * item, 0),
                 granule(a.k, item, a.k_sb, a.k_ss, a.k_sh, a.K * item, 0),
                 granule(a.v, item, a.v_sb, a.v_ss, a.v_sh, a.V * item,
                         a.VB * item),
                 granule(a.lw, 4, a.w_sb, a.w_ss, a.w_sh, a.K * 4, 0),
                 a.r_sb, a.r_ss, a.r_sh, a.k_sb, a.k_ss, a.k_sh,
                 a.v_sb, a.v_ss, a.v_sh, a.w_sb, a.w_ss, a.w_sh};
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  const int device = int(a.device);
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  err = a.dtype == 0 ? dispatch<float>(p, int(a.B), int(a.K), device, st)
                     : dispatch<__nv_bfloat16>(p, int(a.B), int(a.K), device,
                                               st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
