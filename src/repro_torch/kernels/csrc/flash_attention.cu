// Flash attention forward for NVIDIA Hopper (sm_90a), causal or not, GQA.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` / `_fa_kernel`
// (src/repro/kernels/flash_attention.py:82, entry `flash_attention` :103).
// Same function: o = softmax(q k^T / sqrt(hd) [causal mask]) v with the
// running max, denominator and accumulator in f32 on chip across the loop
// over K/V tiles, and tiles wholly above the diagonal skipped.  Written for
// this card rather than carried over block by block:
//   * one block owns BQ=64 query rows of one (batch, head); the Pallas grid's
//     sequential K axis becomes a loop inside the block;
//   * it reads the model's [B,S,H,hd] / [B,T,KV,hd] layout through strides
//     (last dim contiguous) and indexes KV head h / (H/KV) instead of
//     repeating K/V in device memory;
//   * the ragged edge (S or T not a multiple of the tile) is masked here,
//     where the Pallas kernel asserts divisibility;
//   * the causal mask counts query and key positions both from 0, as the
//     Pallas kernel does (the wrapper requires S == T when causal).
//
// Bound on the H100 (SXM, 989 TFLOP/s dense bf16, 3.35 TB/s HBM): a causal
// call does 2*hd*B*H*S(S+1) FLOPs (QK^T and PV over the kept pairs) and must
// move q, k, v and o once.  Under glm4's GQA (H 32, KV 2) the K/V bytes are
// small, so in bf16 the call does about 0.47*S FLOPs per byte: below the
// card's ridge of ~295 at every serving shape (S <= 256).  The bound is the
// bytes: about 5 us at B=4, S=256.
//
// What this design does about it: Q is read once per block and each K/V
// tile once per query block, with no K/V repeat; P never leaves shared
// memory; fully masked tiles are skipped.  The arithmetic is f32 FMA on the
// CUDA cores (a 4x4 score tile and a 4 x hd/16 output tile per thread), which
// keeps P in f32 for the PV product as the Pallas kernel does.  Its floor at
// the 67 TFLOP/s f32 rate (about 32 us at B=4, S=256) lies above the byte
// bound: moving QK^T and PV onto the tensor cores (mma/wgmma, TMA tiles) is
// the next step (ROADMAP).

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per staged K/V tile
constexpr int THREADS = 256;    // a 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KV, hd;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int hd) {
  // Q and K tiles padded to hd+1 floats per row (conflict-free column reads),
  // V tile unpadded, P tile padded to BK+1.
  return sizeof(float) *
         (size_t(BQ) * (hd + 1) + size_t(BK) * (hd + 1) + size_t(BK) * hd +
          size_t(BQ) * (BK + 1));
}

// Thread (tx, ty) = (tid % 16, tid / 16) owns query rows ty + 16*i (i < 4)
// and, in the score tile, key columns tx + 16*j (j < 4); in the output it
// owns head-dim columns tx + 16*j (j < hd/16 <= NJ).  The 16 threads of one
// row group are the 16 lanes of one half-warp, so row reductions are
// shuffles.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd;
  const int nj = hd >> 4;
  const int rs = hd + 1;  // padded row stride of the Q and K tiles
  float* sQ = smem;
  float* sK = sQ + BQ * rs;
  float* sV = sK + BK * rs;
  float* sP = sV + BK * hd;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, c = idx - r * hd;
    const int s = q0 + r;
    sQ[r * rs + c] = s < p.S ? to_f32(q[s * p.q_ss + c]) : 0.f;
  }

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Causal: keys past the block's last query row are masked for every row,
  // so the tiles that hold only such keys are never loaded.
  const int kv_end = p.causal ? min(p.T, q0 + BQ) : p.T;
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * hd; idx += THREADS) {
      const int r = idx / hd, c = idx - r * hd;
      const int kk = k0 + r;
      const bool ok = kk < p.T;
      sK[r * rs + c] = ok ? to_f32(k[kk * p.k_st + c]) : 0.f;
      sV[r * hd + c] = ok ? to_f32(v[kk * p.v_st + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * rs + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * rs + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (kpos >= p.T || (p.causal && kpos > qpos)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float vv = sV[c * hd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < p.S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < nj) store(o + s * p.o_ss + tx + 16 * j, acc[i][j] / l[i]);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t stream) {
  // Past 48 KB of dynamic shared memory the launch needs this attribute.  It
  // belongs to the function on one device: set it at the first launch on
  // each device, at the most this instantiation's head_dim can ask for.
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device >= MAX_DEVICES || !smem_set[device].load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(16 * NJ)));
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) smem_set[device].store(true);
  }
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  fa_fwd_kernel<T, NJ><<<grid, THREADS, smem_bytes(p.hd), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int device, cudaStream_t stream) {
  // Fewer accumulator registers for the common head_dim <= 128.
  return p.hd <= 128 ? launch<T, 8>(p, B, device, stream)
                     : launch<T, 16>(p, B, device, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor must be contiguous.  Returns a cudaError_t.
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int dtype, int device, int B, int S, int T,
                          int H, int KV, int hd, long long q_sb,
                          long long q_ss, long long q_sh, long long k_sb,
                          long long k_st, long long k_sh, long long v_sb,
                          long long v_st, long long v_sh, long long o_sb,
                          long long o_ss, long long o_sh, int causal,
                          float scale, void* stream) {
  if (hd <= 0 || hd % 16 != 0 || hd > 256 || KV <= 0 || H % KV != 0 ||
      B <= 0 || S <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const Params p{q,    k,    v,    o,    S,    T,    H,    KV,     hd,
                 q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st,   v_sh,
                 o_sb, o_ss, o_sh, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = dispatch<float>(p, B, device, st); break;
    case 1: err = dispatch<__nv_bfloat16>(p, B, device, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
