// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py:73).  Same function, per (batch, head),
// chunk by chunk with the state S [P, N] on chip:
//   la  = inclusive cumsum of -exp(a_log) * dt over the chunk,  u = dt * xh
//   y_t = sum_{s<=t} (C_t . B_s) exp(la_t - la_s) u_s + exp(la_t) C_t . S
//   S  <- exp(la_end) S + sum_s exp(la_end - la_s) u_s (x) B_s
// the closed-form SSD block, not a token-by-token selective scan, so the
// chunk length is a real algorithmic choice.  Written for this card rather
// than carried over block by block:
//   * one block (256 threads) per (batch, head) walks its chunks in order;
//     the Pallas grid's sequential chunk axis is that loop, and the state
//     lives in shared memory across it;
//   * the preamble the JAX wrapper computes outside its pallas_call (u and
//     the log decay) is fused into the chunk's load;
//   * the pairwise decay is exp(la_t - la_s) for s <= t, always <= 1, never
//     the factored exp(la_t) * exp(-la_s), which overflows in f32 within a
//     128-token chunk;
//   * the decay-weighted C.B^T is built ROWS = 32 query rows at a time
//     ([32, chunk] in shared memory), so shared memory grows linearly in the
//     chunk: 72.6 KB at chunk 128, 140.7 KB at 256 (a full [256, 256] f32
//     C.B^T alone would be 256 KB, above the 227 KB of a block);
//   * any S: the last chunk is masked (the Pallas wrapper shrinks chunk
//     until it divides S);
//   * the final state is written out ([B, H, P, N], f32), which the Pallas
//     kernel does not return.
//
// Bound on the H100 (SXM, 67 TFLOP/s f32, 3.35 TB/s HBM): the function
// needs 5 P N + P flops per (token, head) in its sequential form (u = dt x,
// the state update exp(la) S + u (x) B, then C . S) and must move xh, dt
// and y once, and B, C once per batch row.  At the hymba serving shape (H
// 50, P 64, N 16, bf16) that is ~5.2 K flops against ~260 bytes per
// (token, head), about 20 flops a byte: the card's f32 ridge, so both
// floors are ~1 us at B=1, S=256.  The chunked form runs more: the causal
// half of each chunk's C.B^T and intra product, c / 2 pairs a token at
// 2 (N + P) flops each, brings it to ~16 K per (token, head) at c = 128,
// three times the function's: the price of a parallel chunk, growing with
// the chunk.  The intra-chunk products run as f32 FMA on the CUDA cores, each thread an
// output micro-tile of 2 rows by P/16 columns; moving C.B^T and the
// intra-chunk product onto the tensor cores is the next step (ROADMAP).

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;   // a 16 x 16 thread grid
constexpr int ROWS = 32;       // query rows per decay-weighted C.B^T tile
constexpr int MAX_NJ = 8;      // P / 16 <= 8
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* xh;
  const float* dt;
  const float* a_log;
  const void* B;
  const void* C;
  void* y;
  float* state;
  int S, H, P, N, chunk;
  long long x_sb, x_ss, x_sh;
  long long d_sb, d_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int chunk, int P, int N) {
  // la, exp(la), exp(la_end - la) [c]; B, C [c][N+1]; u [c][P];
  // the C.B^T tile [ROWS][c+1]; the state [P][N+1]
  return sizeof(float) *
         (3 * size_t(chunk) + 2 * size_t(chunk) * (N + 1) +
          size_t(chunk) * P + size_t(ROWS) * (chunk + 1) +
          size_t(P) * (N + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int c = p.chunk;
  const int P = p.P, N = p.N;
  const int NS = N + 1;        // padded row stride of B, C and the state
  const int GS = c + 1;        // padded row stride of the C.B^T tile
  float* la = smem;
  float* ela = la + c;
  float* dend = ela + c;
  float* sB = dend + c;
  float* sC = sB + c * NS;
  float* su = sC + c * NS;
  float* sG = su + c * P;
  float* sS = sG + ROWS * GS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nj = P >> 4;

  const T* xh = static_cast<const T*>(p.xh) + b * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + b * p.d_sb + h;
  const T* Bm = static_cast<const T*>(p.B) + b * p.b_sb;
  const T* Cm = static_cast<const T*>(p.C) + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + (size_t(b) * p.S * p.H + h) * P;
  const long long y_ss = static_cast<long long>(p.H) * P;
  const float neg_a = -expf(p.a_log[h]);

  for (int i = tid; i < P * NS; i += THREADS) sS[i] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += c) {
    const int n = min(c, p.S - t0);
    __syncthreads();  // the previous chunk's buffers are no longer read
    for (int i = tid; i < n * N; i += THREADS) {
      const int t = i / N, q = i - t * N;
      sB[t * NS + q] = to_f32(Bm[(t0 + t) * p.b_ss + q]);
      sC[t * NS + q] = to_f32(Cm[(t0 + t) * p.c_ss + q]);
    }
    for (int i = tid; i < n * P; i += THREADS) {
      const int t = i / P, q = i - t * P;
      su[i] = dt[(t0 + t) * p.d_ss] * to_f32(xh[(t0 + t) * p.x_ss + q]);
    }
    if (tid < 32) {
      // inclusive cumsum of the log decay: each lane sums a run of steps,
      // a warp scan adds the runs before it
      const int per = (n + 31) / 32;
      const int lo = lane * per, hi = min(n, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += neg_a * dt[(t0 + t) * p.d_ss];
        la[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += x;
      }
      const float before = incl - run;
      for (int t = lo; t < hi; ++t) la[t] += before;
    }
    __syncthreads();
    const float la_end = la[n - 1];
    for (int t = tid; t < n; t += THREADS) {
      ela[t] = expf(la[t]);
      dend[t] = expf(la_end - la[t]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < n; r0 += ROWS) {
      const int ncol = min(n, r0 + ROWS);    // keys s < ncol can be kept
      for (int i = tid; i < ROWS * ncol; i += THREADS) {
        const int row = i / ncol, s = i - row * ncol;
        const int t = r0 + row;
        float g = 0.f;
        if (t < n && s <= t) {
          float dot = 0.f;
          for (int q = 0; q < N; ++q)
            dot = fmaf(sC[t * NS + q], sB[s * NS + q], dot);
          g = dot * expf(la[t] - la[s]);
        }
        sG[row * GS + s] = g;
      }
      __syncthreads();

      float acc[2][MAX_NJ];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < MAX_NJ; ++jj) acc[i][jj] = 0.f;
      for (int s = 0; s < ncol; ++s) {
        const float g0 = sG[ty * GS + s];
        const float g1 = sG[(ty + 16) * GS + s];
#pragma unroll
        for (int jj = 0; jj < MAX_NJ; ++jj) {
          if (jj < nj) {
            const float uv = su[s * P + tx + 16 * jj];
            acc[0][jj] = fmaf(g0, uv, acc[0][jj]);
            acc[1][jj] = fmaf(g1, uv, acc[1][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = r0 + ty + 16 * i;
        if (t < n) {
#pragma unroll
          for (int jj = 0; jj < MAX_NJ; ++jj) {
            if (jj < nj) {
              const int col = tx + 16 * jj;
              float cross = 0.f;
              for (int q = 0; q < N; ++q)
                cross = fmaf(sC[t * NS + q], sS[col * NS + q], cross);
              store(y + (t0 + t) * y_ss + col,
                    fmaf(ela[t], cross, acc[i][jj]));
            }
          }
        }
      }
      __syncthreads();  // the tile is rewritten by the next row block
    }

    // the state at the chunk's end; every read of the old state is done
    const float a_end = expf(la_end);
    for (int i = tid; i < P * N; i += THREADS) {
      const int col = i / N, q = i - col * N;
      float upd = 0.f;
      for (int s = 0; s < n; ++s)
        upd = fmaf(dend[s] * su[s * P + col], sB[s * NS + q], upd);
      sS[col * NS + q] = fmaf(a_end, sS[col * NS + q], upd);
    }
  }
  __syncthreads();
  float* st = p.state + (size_t(b) * p.H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS) {
    const int col = i / N, q = i - col * N;
    st[i] = sS[col * NS + q];
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t stream) {
  // Past 48 KB of dynamic shared memory the launch needs this attribute.  It
  // belongs to the function on one device: set it at the first launch on
  // each device, to the most a block may opt in to.
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device >= MAX_DEVICES || !smem_set[device].load()) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) smem_set[device].store(true);
  }
  const dim3 grid(p.H, B);
  ssd_kernel<T><<<grid, THREADS, smem_bytes(p.chunk, p.P, p.N), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of xh, B, C and y): 0 = float32, 1 = bfloat16; dt, a_log and the
// state are float32.  Strides are in elements: xh (batch, seq, head), dt,
// B and C (batch, seq); the last dimension of each must be contiguous.  y
// [B, S, H, P] and the state [B, H, P, N] are written contiguous.  Returns
// a cudaError_t.
extern "C" int ssd_forward(const void* xh, const void* dt, const void* a_log,
                           const void* B_t, const void* C_t, void* y,
                           void* state, int dtype, int device, int B, int S,
                           int H, int P, int N, int chunk, long long x_sb,
                           long long x_ss, long long x_sh, long long d_sb,
                           long long d_ss, long long b_sb, long long b_ss,
                           long long c_sb, long long c_ss, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 != 0 ||
      P > 16 * MAX_NJ || N <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const Params p{xh,   static_cast<const float*>(dt),
                 static_cast<const float*>(a_log),
                 B_t,  C_t,  y,    static_cast<float*>(state),
                 S,    H,    P,    N,    chunk,
                 x_sb, x_ss, x_sh, d_sb, d_ss,
                 b_sb, b_ss, c_sb, c_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(p, B, device, st); break;
    case 1: err = launch<__nv_bfloat16>(p, B, device, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
