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
//   * the causal mask counts key positions from 0 and query positions from
//     q_off: query row i sees key t iff t <= q_off + i.  With q_off 0 this
//     is the Pallas kernel's mask (the wrapper requires S == T then); a
//     context-parallel shard passes its first row's place in the sequence,
//     and key tiles wholly above its shifted diagonal are never loaded.
//
// Bound on the H100 (SXM, 989 TFLOP/s dense bf16, 3.35 TB/s HBM): a causal
// call does 2*hd*B*H*S(S+1) FLOPs (QK^T and PV over the kept pairs) and must
// move q, k, v and o once.  Under glm4's GQA (H 32, KV 2) the K/V bytes are
// small, so in bf16 the call does about 0.47*S FLOPs per byte: below the
// card's ridge of ~295 at every serving shape (S <= 256).  The bound is the
// bytes: 2.7 us at B=2, S=256.
//
// Two bodies, chosen before launch by flash_attention.path_for; `mma_path`
// below repeats its rule.
//
// `mma` (bf16, head_dim a multiple of 16 up to 128, every row of q, k and v
// 16-byte aligned): the tensor cores.  4 warps, 16 query rows each.  Q's
// 64 x hd tile comes in once by cp.async and stays in registers as m16k16
// A fragments (ldmatrix).  K and V come in 64-row tiles, double-buffered by
// cp.async (zero-filled past T): tile t+1 loads while tile t is computed.
// S = Q K^T is mma.sync.m16n8k16 bf16 with an f32 accumulator (the bf16
// products are exact in f32), a 16 x 64 score tile per warp in registers;
// the causal mask and the ragged T edge are applied there, on the diagonal
// and last tiles only.  The online softmax reduces each row over the 4
// lanes that hold it, with scale*log2(e) folded into one multiply before
// exp2f.  P never leaves registers: its C fragments are the A fragments of
// the PV product (two n8 tiles make one k16 step).  A one-pass bf16 P errs
// by ~2^-9 of each weight, ~100x the kernel's gate, so each f32 p is split
// into hi = bf16(p) and lo = bf16(p - hi) and PV runs as two mma passes,
// hi*V + lo*V, into the f32 output accumulator (V by ldmatrix.trans): P
// keeps ~2^-17 of its f32 value, as the f32 PV of the Pallas kernel does.
// A row of hd bf16 is hd/8 chunks of 16 bytes.  Where that is a multiple of
// 8 (hd 64, 128) chunk c of row r is stored at c ^ (r & 7); otherwise (hd
// 16-48, 80, 96, 112) the row is padded to an odd number of chunks.  Either
// way the 8 rows one ldmatrix reads at one chunk fall in 8 different
// 16-byte bank groups.  Shared memory: Q and two K and V stages, 80 KB at
// hd 128, so two blocks share an SM.  Causal blocks start with the longest
// (the q blocks are walked in reverse).
//
// `simt` (f32, head_dim 144-256, or rows off 16 bytes): f32 FMA on the CUDA
// cores, P in f32 through shared memory (a 4x4 score tile and a 4 x hd/16
// output tile per thread), the first design of this port.

#include <stdint.h>

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_tile.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per staged K/V tile
constexpr int SIMT_THREADS = 256;  // a 16 x 16 thread grid
constexpr int MMA_THREADS = 128;   // 4 warps of 16 query rows
constexpr int MMA_MAX_HD = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using gemm_tile::MAX_DEVICES;
using gemm_tile::store;
using gemm_tile::to_f32;

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
  int q_off;  // sequence position of query row 0 (causal only)
  float scale;
};

// The rule of flash_attention.path_for: bf16, hd a multiple of 16 up to
// 128, each of q, k, v 16-byte aligned with its batch, row and head strides
// multiples of 16 bytes (8 elements).  1 = mma, 0 = simt.
inline bool rows16(const void* base, long long sb, long long ss,
                   long long sh) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}
inline int mma_path(const Params& p, int dtype) {
  return dtype == 1 && p.hd % 16 == 0 && p.hd <= MMA_MAX_HD &&
         rows16(p.q, p.q_sb, p.q_ss, p.q_sh) &&
         rows16(p.k, p.k_sb, p.k_st, p.k_sh) &&
         rows16(p.v, p.v_sb, p.v_st, p.v_sh);
}

// Sets the kernel's dynamic shared memory limit and asks for the largest
// shared-memory carveout, once per device.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int device,
                    std::atomic<bool>* done) {
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device < MAX_DEVICES) done[device].store(true);
  return err;
}

// ---- simt -------------------------------------------------------------------
size_t simt_smem_bytes(int hd) {
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
__global__ void __launch_bounds__(SIMT_THREADS)
fa_simt_kernel(const Params p) {
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

  for (int idx = tid; idx < BQ * hd; idx += SIMT_THREADS) {
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

  // Causal: keys past the block's last query position are masked for every
  // row, so the tiles that hold only such keys are never loaded.
  const int kv_end = p.causal ? min(p.T, p.q_off + q0 + BQ) : p.T;
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * hd; idx += SIMT_THREADS) {
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
      const int qpos = p.q_off + q0 + ty + 16 * i;
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
  // at the most this instantiation's head_dim can ask for
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err = prepare(fa_simt_kernel<T, NJ>,
                                  simt_smem_bytes(16 * NJ), device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  fa_simt_kernel<T, NJ>
      <<<grid, SIMT_THREADS, simt_smem_bytes(p.hd), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int device, cudaStream_t stream) {
  // Fewer accumulator registers for the common head_dim <= 128.
  return p.hd <= 128 ? launch<T, 8>(p, B, device, stream)
                     : launch<T, 16>(p, B, device, stream);
}

// ---- mma --------------------------------------------------------------------
// A 64-row tile of hd bf16 in shared memory: a row is CPR chunks of 16 bytes,
// stored XOR-swizzled (CPR a multiple of 8) or in rows of RC = CPR | 1
// chunks (see the header).
template <int HD>
struct Tile {
  static constexpr int CPR = HD / 8;
  static constexpr bool SWIZZLE = CPR % 8 == 0;
  static constexpr int RC = SWIZZLE ? CPR : (CPR | 1);
  static constexpr int ELEMS = 64 * RC * 8;
  // element offset of chunk c of row r
  static __device__ __forceinline__ int at(int r, int c) {
    return (r * RC + (SWIZZLE ? (c ^ (r & 7)) : c)) * 8;
  }
};

// Q, then two stages of K and two of V
template <int HD>
constexpr size_t mma_smem_bytes() {
  return 5 * size_t(Tile<HD>::ELEMS) * sizeof(__nv_bfloat16);
}

// 16 bytes by cp.async, or 16 zero bytes when `full` is false (no byte of
// src is read then).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   mma_tile::smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// Rows row0 .. row0+63 of src (row stride `stride`) into a tile; rows at or
// past n_rows are zero-filled.  64 * CPR chunks over 128 threads: CPR / 2
// each (hd is a multiple of 16, so CPR is even).
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int n_rows) {
  using TL = Tile<HD>;
#pragma unroll
  for (int u = 0; u < TL::CPR / 2; ++u) {
    const int idx = threadIdx.x + u * MMA_THREADS;
    const int r = idx / TL::CPR, c = idx % TL::CPR;
    const bool ok = row0 + r < n_rows;
    cp_async16_zfill(dst + TL::at(r, c),
                     src + (ok ? row0 + r : row0) * stride + c * 8, ok);
  }
}

// (hi, lo) of two f32 values as bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Fragment layouts (mma.m16n8k16, lane = 4g + t): the C fragment of an n8
// tile holds rows g, g+8 at columns 2t, 2t+1; ldmatrix lane l gives the
// address of row l & 7 of matrix l >> 3.  The launch bound asks for two
// blocks an SM: with no minimum, ptxas held some instantiations to 168
// registers (three blocks) and spilled (hd 32 and 80 with the query
// offset).
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 2)
fa_mma_kernel(const Params p) {
  using TL = Tile<HD>;
  constexpr int KS = HD / 16;  // k16 steps of QK^T; pairs of n8 tiles of O
  constexpr int NF = BK / 8;   // n8 tiles of a warp's scores
  constexpr int DF = HD / 8;   // n8 tiles of a warp's output
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* sK = sQ + TL::ELEMS;      // two stages
  __nv_bfloat16* sV = sK + 2 * TL::ELEMS;  // two stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qblk = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qblk * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                     h * p.o_sh;

  // Causal: keys past the block's last query position are masked for every
  // row, so the tiles that hold only such keys are never loaded.
  const int kv_end = p.causal ? min(p.T, p.q_off + q0 + BQ) : p.T;
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_tile<HD>(sQ, q, p.q_ss, q0, p.S);
  mma_tile::cp_async_commit();
  load_tile<HD>(sK, k, p.k_st, 0, p.T);
  load_tile<HD>(sV, v, p.v_st, 0, p.T);
  mma_tile::cp_async_commit();
  mma_tile::cp_async_wait<1>();  // Q has landed (this thread's part) ...
  __syncthreads();               // ... and everyone's

  uint32_t qf[KS][4];  // the warp's 16 rows of Q as A fragments
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_tile::ldsm_x4(qf[kk], sQ + TL::at(r, 2 * kk + (lane >> 4)));
  }
  // ldmatrix rows and chunks: K (keys n0.., non-transposed: two n8 tiles of
  // one k16 step) and V (keys j0.., transposed: two n8 tiles of O)
  const int k_r = (lane & 7) + ((lane >> 4) & 1) * 8, k_c = (lane >> 3) & 1;
  const int v_r = (lane & 7) + ((lane >> 3) & 1) * 8, v_c = lane >> 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = p.scale * LOG2E;

  float acc[DF][4];
#pragma unroll
  for (int j = 0; j < DF; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, in the exp2 domain
  float l[2] = {0.f, 0.f};          // this lane's share of the row sum

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {  // into the stage tile it-1 used
      const int nb = (it + 1) & 1;
      load_tile<HD>(sK + nb * TL::ELEMS, k, p.k_st, k0 + BK, p.T);
      load_tile<HD>(sV + nb * TL::ELEMS, v, p.v_st, k0 + BK, p.T);
    }
    mma_tile::cp_async_commit();
    mma_tile::cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const __nv_bfloat16* cK = sK + (it & 1) * TL::ELEMS;
    const __nv_bfloat16* cV = sV + (it & 1) * TL::ELEMS;

    float s[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        uint32_t bk[4];
        mma_tile::ldsm_x4(bk, cK + TL::at(16 * np + k_r, 2 * kk + k_c));
        mma_tile::mma_bf16(s[2 * np], qf[kk], bk);
        mma_tile::mma_bf16(s[2 * np + 1], qf[kk], bk + 2);
      }

#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] *= sl2;
    // only the diagonal tile and the ragged last one hold masked pairs
    if (k0 + BK > p.T || (p.causal && k0 + BK - 1 > p.q_off + q0)) {
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + 8 * n + 2 * t + (r & 1);
          const int row = row0 + 8 * (r >> 1);  // at position q_off + row
          if (key >= p.T || (p.causal && key > row + p.q_off))
            s[n][r] = NEG_INF;
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) mx[r >> 1] = fmaxf(mx[r >> 1], s[n][r]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < DF; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[n][r] = exp2f(s[n][r] - m[r >> 1]);
        l[r >> 1] += s[n][r];
      }

    // O += P V: the C fragments of score tiles 2kk and 2kk+1 are the A
    // fragment of k16 step kk, applied as hi and lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t bv[4];
        mma_tile::ldsm_x4_t(bv, cV + TL::at(16 * kk + v_r, 2 * dp + v_c));
        mma_tile::mma_bf16(acc[2 * dp], ph, bv);
        mma_tile::mma_bf16(acc[2 * dp + 1], ph, bv + 2);
        mma_tile::mma_bf16(acc[2 * dp], pl, bv);
        mma_tile::mma_bf16(acc[2 * dp + 1], pl, bv + 2);
      }
    }
    __syncthreads();  // this stage is free for the load of tile it+2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row < p.S) {
      const float inv = 1.f / l[i];
      __nv_bfloat16* orow = o + row * p.o_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < DF; ++j)
        mma_tile::store2(orow + 8 * j, acc[j][2 * i] * inv,
                         acc[j][2 * i + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const Params& p, int B, int device,
                       cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err =
      prepare(fa_mma_kernel<HD>, mma_smem_bytes<HD>(), device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  fa_mma_kernel<HD><<<grid, MMA_THREADS, mma_smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const Params& p, int B, int device,
                         cudaStream_t stream) {
  switch (p.hd) {
    case 16: return launch_mma<16>(p, B, device, stream);
    case 32: return launch_mma<32>(p, B, device, stream);
    case 48: return launch_mma<48>(p, B, device, stream);
    case 64: return launch_mma<64>(p, B, device, stream);
    case 80: return launch_mma<80>(p, B, device, stream);
    case 96: return launch_mma<96>(p, B, device, stream);
    case 112: return launch_mma<112>(p, B, device, stream);
    case 128: return launch_mma<128>(p, B, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor must be contiguous.  q_off >= 0: the sequence
// position of query row 0 under the causal mask (ignored when not causal).
// path: 0 = simt, 1 = mma, as flash_attention.path_for chose; mma where the
// mirrored rule (mma_path) does not give it is refused, simt runs any
// input.  Returns a cudaError_t.
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int dtype, int device, int B, int S, int T,
                          int H, int KV, int hd, long long q_sb,
                          long long q_ss, long long q_sh, long long k_sb,
                          long long k_st, long long k_sh, long long v_sb,
                          long long v_st, long long v_sh, long long o_sb,
                          long long o_ss, long long o_sh, int causal,
                          int q_off, float scale, int path, void* stream) {
  if (hd <= 0 || hd % 16 != 0 || hd > 256 || KV <= 0 || H % KV != 0 ||
      B <= 0 || S <= 0 || T <= 0 || dtype < 0 || dtype > 1 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    S,    T,    H,    KV,     hd,
                 q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st,   v_sh,
                 o_sb, o_ss, o_sh, causal, causal ? q_off : 0, scale};
  if (path != 0 && (path != 1 || !mma_path(p, dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to `device`, the stream's; the caller's current device
  // is restored before returning.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1)
    err = dispatch_mma(p, B, device, st);
  else if (dtype == 0)
    err = dispatch<float>(p, B, device, st);
  else
    err = dispatch<__nv_bfloat16>(p, B, device, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
