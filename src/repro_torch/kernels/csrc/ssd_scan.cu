// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py:73).  Same function, per (batch, head),
// chunk by chunk with the state S [P, N] on chip:
//   la  = inclusive cumsum of -exp(a_log) * dt over the chunk
//   y_t = sum_{s<=t} (C_t . B_s) exp(la_t - la_s) dt_s xh_s
//         + exp(la_t) C_t . S
//   S  <- exp(la_end) S + sum_s xh_s (x) (dt_s exp(la_end - la_s) B_s)
// the closed-form SSD block, not a token-by-token selective scan, so the
// chunk length is a real algorithmic choice.  Written for this card rather
// than carried over block by block:
//   * the Pallas grid's sequential chunk axis is a loop inside the block,
//     and the state lives in shared memory across it;
//   * the preamble the JAX wrapper computes outside its pallas_call (u and
//     the log decay) is fused into the chunk's work;
//   * the pairwise decay is exp(la_t - la_s) for s <= t, always <= 1, never
//     the factored exp(la_t) * exp(-la_s), which overflows in f32 within a
//     128-token chunk;
//   * any S: the last chunk is masked (the Pallas wrapper shrinks chunk
//     until it divides S);
//   * the final state is written out ([B, H, P, N], f32), which the Pallas
//     kernel does not return.
//
// Bound on the H100 (SXM, 3.35 TB/s HBM): the function needs 5 P N + P
// flops per (token, head) in its sequential form and must move xh, dt and
// y once, and B, C once per batch row.  At the hymba serving shape (H 50,
// P 64, N 16, bf16) that is ~5.2 K flops against ~260 bytes per (token,
// head): the bytes bound it, ~1 us at B=1, S=256.  The chunked form runs
// more (the causal half of each chunk's C.B^T and intra product, c / 2
// pairs a token), three times the function's at c = 128: the price of a
// parallel chunk.
//
// Two bodies, chosen before launch by ssd_scan.path_for; `mma_path` below
// repeats its rule.
//
// `mma` (xh's rows 16-byte aligned, its shared memory within a block's):
// the tensor cores.  y's column p depends only on column p of xh and row p
// of the state, so a block owns one (head, batch, slice of PB = 16 or 32
// columns of P) and the grid is (H, B, P / PB): at hymba's B=1 that is 100
// or 200 blocks where one block a head gave 50.  Each block recomputes its
// chunk's C.B^T and the decay of each pair, so ssd_scan.geometry takes the
// widest slice that still leaves 100 blocks (on the H100 slices of 32 beat
// slices of 16 at hymba's B=1; PERF.md).  4 warps; a chunk's rows are
// 16-row blocks, dealt to the warps back and forth (0 1 2 3 3 2 1 0 ...)
// so that the causal work evens out.  Per row block a warp reads the
// chunk as attention with a decay in place of the softmax, as K2's `mma`
// body does:
//   * cross: exp(la_t) C_t . S[p, :], C as the A operand, the state as B;
//   * intra: for each 16-key block s <= t, the score C_t . B_s (k = N,
//     zero-padded to 16), scaled in registers to G'[t, s] = score *
//     exp(la_t - la_s) * dt_s (0 above the diagonal), re-packed from C
//     fragments into A fragments and multiplied by xh[s, slice] (B by
//     ldmatrix.trans); dt is folded into the f32 side, so xh stays exact;
//   * state (a warp per 16 x 16 unit of the slice's state): xh^T as the A
//     operand (ldmatrix.trans) times dt_s exp(la_end - la_s) B[s, n],
//     scaled in registers, plus exp(la_end) S, into the other of two state
//     buffers (the cross term of the chunk reads the first).
// Accuracy is the plain version's: in bf16 the raw C, B and xh are exact
// operands and every f32 operand (G', the state, the scaled B) goes in as
// a bf16 hi + lo pair, two passes; in f32 every product is three TF32
// passes (lo*hi + hi*lo + hi*hi), as K1's, each pair of a k8 step taken
// from adjacent columns (k = t and t + 4 of the fragment are columns 2t and
// 2t + 1), so a C fragment is an A fragment without shuffles.  A chunk's
// xh slice (16-byte copies), B and C (the widest copy their rows allow:
// the model's two halves of one projection take 16 bytes) and dt are
// copied by cp.async into one of two stages, the next chunk while the
// block computes this one; rows past the end of S are zero-filled.  Two
// barriers a chunk: the stage has landed, then the cumsum (one warp) is
// in shared memory.
//
// `simt` (any other input): the first design of this port, one block (256
// threads) per (batch, head), f32 FMA on the CUDA cores, the decay-weighted
// C.B^T built 32 query rows at a time in shared memory.
//
// The wrapper packs the launch's arguments into one struct of 8-byte
// fields (`Args`), so a call converts one Python argument, not twenty.

#include <stdint.h>

#include <atomic>
#include <cstring>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_tile.cuh"

namespace {

using gemm_tile::MAX_DEVICES;
using gemm_tile::store;
using gemm_tile::to_f32;
using mma_tile::store2;

constexpr int THREADS = 256;     // simt: a 16 x 16 thread grid
constexpr int ROWS = 32;         // simt: query rows per C.B^T tile
constexpr int MAX_NJ = 8;        // P / 16 <= 8
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory (hw.py)

struct Params {
  const void* xh;
  const float* dt;
  const float* a_log;
  const void* B;
  const void* C;
  void* y;
  float* state;
  int S, H, P, N, chunk;
  int gran_b, gran_c;  // mma: bytes a copy of a B / C row (16, 8, 4; 2)
  long long x_sb, x_ss, x_sh;
  long long d_sb, d_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

// ---- simt ------------------------------------------------------------------
size_t simt_smem_bytes(int chunk, int P, int N) {
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

// ---- mma -------------------------------------------------------------------
// Shared memory, as kernels/ssd_scan.py's `mma_smem_bytes` sums it: two
// stages of xh [CP][PB + E], B and C [CP][NK + E] (E = 16 bytes of the
// input type: a row of an odd number of 16-byte chunks, so the 8 rows one
// ldmatrix reads fall in 8 bank groups) and dt [CP] f32; la, exp(la) and
// dt exp(la_end - la) [CP] f32; two state buffers [PB][NK + 4] f32 and, in
// bf16, their hi and lo halves [PB][NK + 8].  CP is the chunk and NK the
// state size, each rounded up to 16.
struct Layout {
  int CP, NK, XS, BS, SS, HS;
  size_t stage;
  __host__ __device__ Layout(int chunk, int PB, int N, int item)
      : CP((chunk + 15) & ~15), NK((N + 15) & ~15),
        XS(PB + 16 / item), BS(NK + 16 / item), SS(NK + 4), HS(NK + 8),
        stage(size_t(CP) * ((XS + 2 * BS) * item + sizeof(float))) {}
  __host__ __device__ size_t bytes(int PB, int item) const {
    return 2 * stage + 3 * size_t(CP) * sizeof(float) +
           2 * size_t(PB) * SS * sizeof(float) +
           (item == 2 ? 4 * size_t(PB) * HS * 2 : 0);
  }
};

size_t mma_smem_bytes(int chunk, int PB, int N, int item) {
  return Layout(chunk, PB, N, item).bytes(PB, item);
}

__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int bytes, bool full) {
  const uint32_t d = mma_tile::smem_addr(dst);
  const int n = full ? bytes : 0;
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(n) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(src), "r"(n) : "memory");
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(n) : "memory");
  }
}

// `rows` rows of `row_bytes` from `src` (rows `stride` bytes apart) to
// `dst` (rows `dst_row` bytes apart), `gran` bytes a cp.async; rows at or
// past `n` are zero-filled.  With gran 2, element copies by plain loads.
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_row,
                                          const unsigned char* src,
                                          long long stride, int row_bytes,
                                          int n, int rows, int gran) {
  const int per = row_bytes / gran;
  for (int i = threadIdx.x; i < rows * per; i += MMA_THREADS) {
    const int r = i / per, cb = (i - r * per) * gran;
    const bool ok = r < n;
    unsigned char* d = dst + r * dst_row + cb;
    const unsigned char* s = src + (ok ? r * stride : 0) + cb;
    if (gran >= 4)
      cp_async_zfill(d, s, gran, ok);
    else
      *reinterpret_cast<uint16_t*>(d) =
          ok ? *reinterpret_cast<const uint16_t*>(s) : uint16_t(0);
  }
}

// Fragments of one mma k step (bf16: m16n8k16; f32: m16n8k8 TF32, whose
// k = t and t + 4 are read from columns 2t and 2t + 1 of the step's 8).
// Lane = 4g + t.  `tile` is a row-major tile with `stride` elements a row.
//
// A [16 rows][k] from rows r0.., columns k0..
template <typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* tile,
                                       int stride, int r0, int k0,
                                       int lane) {
  if constexpr (sizeof(T) == 2) {
    mma_tile::ldsm_x4(a, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    stride + k0 + (lane >> 4) * 8);
  } else {
    const int g = lane >> 2, t = lane & 3;
    const float2 u = *reinterpret_cast<const float2*>(
        tile + (r0 + g) * stride + k0 + 2 * t);
    const float2 v = *reinterpret_cast<const float2*>(
        tile + (r0 + g + 8) * stride + k0 + 2 * t);
    a[0] = __float_as_uint(u.x);
    a[2] = __float_as_uint(u.y);
    a[1] = __float_as_uint(v.x);
    a[3] = __float_as_uint(v.y);
  }
}
// A [16 rows][k] stored transposed, as [k][rows]: k0.. and rows m0..
template <typename T>
__device__ __forceinline__ void load_a_t(uint32_t* a, const T* tile,
                                         int stride, int k0, int m0,
                                         int lane) {
  if constexpr (sizeof(T) == 2) {
    mma_tile::ldsm_x4_t(a, tile + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                      stride + m0 + ((lane >> 3) & 1) * 8);
  } else {
    const int g = lane >> 2, t = lane & 3;
    const float* p0 = tile + (k0 + 2 * t) * stride + m0 + g;
    a[0] = __float_as_uint(p0[0]);
    a[1] = __float_as_uint(p0[8]);
    a[2] = __float_as_uint(p0[stride]);
    a[3] = __float_as_uint(p0[stride + 8]);
  }
}
// B of two n8 tiles (b[0..1] columns n0.., b[2..3] n0 + 8..) from a tile
// stored [n][k] (k contiguous), k0..
template <typename T>
__device__ __forceinline__ void load_b_nk(uint32_t* b, const T* tile,
                                          int stride, int n0, int k0,
                                          int lane) {
  if constexpr (sizeof(T) == 2) {
    mma_tile::ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                    stride + k0 + ((lane >> 3) & 1) * 8);
  } else {
    const int g = lane >> 2, t = lane & 3;
    const float2 u = *reinterpret_cast<const float2*>(
        tile + (n0 + g) * stride + k0 + 2 * t);
    const float2 v = *reinterpret_cast<const float2*>(
        tile + (n0 + g + 8) * stride + k0 + 2 * t);
    b[0] = __float_as_uint(u.x);
    b[1] = __float_as_uint(u.y);
    b[2] = __float_as_uint(v.x);
    b[3] = __float_as_uint(v.y);
  }
}
// The same from a tile stored [k][n] (n contiguous).
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const T* tile,
                                          int stride, int k0, int n0,
                                          int lane) {
  if constexpr (sizeof(T) == 2) {
    mma_tile::ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      stride + n0 + (lane >> 4) * 8);
  } else {
    const int g = lane >> 2, t = lane & 3;
    const float* p0 = tile + (k0 + 2 * t) * stride + n0 + g;
    b[0] = __float_as_uint(p0[0]);
    b[1] = __float_as_uint(p0[stride]);
    b[2] = __float_as_uint(p0[8]);
    b[3] = __float_as_uint(p0[stride + 8]);
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
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// TF32 hi and lo of n f32 fragment registers
template <int n>
__device__ __forceinline__ void split_all(const uint32_t* x, uint32_t* hi,
                                          uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < n; ++i) mma_tile::split_tf32(x[i], hi[i], lo[i]);
}
// d += a b as three TF32 passes, small terms first; a already split
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* b) {
  uint32_t bh[2], bl[2];
  split_all<2>(b, bh, bl);
  mma_tile::mma_tf32(d, al, bh);
  mma_tile::mma_tf32(d, ah, bl);
  mma_tile::mma_tf32(d, ah, bh);
}

// d[0..1] += a b[0..1], d[2..3]... of two n8 tiles, for an exact A (bf16
// C or xh) or an A already split (f32): bf16 takes B as given, f32 splits.
template <typename T>
__device__ __forceinline__ void mma_pair(float (*d)[4], const uint32_t* a,
                                         const uint32_t* al,
                                         const uint32_t* b) {
  if constexpr (sizeof(T) == 2) {
    mma_tile::mma_bf16(d[0], a, b);
    mma_tile::mma_bf16(d[1], a, b + 2);
  } else {
    mma3(d[0], a, al, b);
    mma3(d[1], a, al, b + 2);
  }
}

// Chunk k's rows of the block's xh slice, B, C and dt into stage k & 1 by
// cp.async (one commit group); rows past the end of S are zero-filled.
template <typename T, int PB>
__device__ __forceinline__ void stage_chunk(unsigned char* smem,
                                            const Layout& L,
                                            const Params& p, const T* xh,
                                            const float* dt,
                                            const unsigned char* Bm,
                                            const unsigned char* Cm, int k) {
  constexpr int item = sizeof(T), EPC = 16 / item;
  constexpr int XCH = PB * item / 16;  // 16-byte chunks of a slice row
  const int t0 = k * p.chunk, n = min(p.chunk, p.S - t0);
  const int CP = L.CP;
  T* sX = reinterpret_cast<T*>(smem + (k & 1) * L.stage);
  T* sB = sX + CP * L.XS;
  T* sC = sB + CP * L.BS;
  float* sD = reinterpret_cast<float*>(sC + CP * L.BS);
  for (int i = threadIdx.x; i < CP * XCH; i += MMA_THREADS) {
    const int r = i / XCH, ch = i - r * XCH;
    const bool ok = r < n;
    cp_async_zfill(sX + r * L.XS + ch * EPC,
                   xh + (t0 + (ok ? r : 0)) * p.x_ss + ch * EPC, 16, ok);
  }
  copy_rows(reinterpret_cast<unsigned char*>(sB), L.BS * item,
            Bm + t0 * p.b_ss * item, p.b_ss * item, p.N * item, n, CP,
            p.gran_b);
  copy_rows(reinterpret_cast<unsigned char*>(sC), L.BS * item,
            Cm + t0 * p.c_ss * item, p.c_ss * item, p.N * item, n, CP,
            p.gran_c);
  for (int r = threadIdx.x; r < CP; r += MMA_THREADS)
    cp_async_zfill(sD + r, dt + (t0 + (r < n ? r : 0)) * p.d_ss, 4, r < n);
  mma_tile::cp_async_commit();
}

template <typename T, int PB>
__global__ void __launch_bounds__(MMA_THREADS)
ssd_mma_kernel(const Params p) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KS = F32 ? 8 : 16;   // k of one mma
  constexpr int NJ = PB / 8;         // n8 tiles of a row block's output
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int c = p.chunk, N = p.N;
  const Layout L(c, PB, N, sizeof(T));
  const int CP = L.CP, NK = L.NK, XS = L.XS, BS = L.BS, SS = L.SS,
            HS = L.HS;
  float* la = reinterpret_cast<float*>(ssd_smem + 2 * L.stage);
  float* ela = la + CP;
  float* dend = ela + CP;
  float* sS = dend + CP;  // two state buffers [PB][SS]
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(sS + 2 * PB * SS);
  __nv_bfloat16* sL = sH + 2 * PB * HS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * PB;
  constexpr int item = sizeof(T);
  const T* xh = static_cast<const T*>(p.xh) + b * p.x_sb + h * p.x_sh + p0;
  const float* dt = p.dt + b * p.d_sb + h;
  const unsigned char* Bm =
      static_cast<const unsigned char*>(p.B) + b * p.b_sb * item;
  const unsigned char* Cm =
      static_cast<const unsigned char*>(p.C) + b * p.c_sb * item;
  T* y = static_cast<T*>(p.y) + (size_t(b) * p.S * p.H + h) * p.P + p0;
  const long long y_ss = static_cast<long long>(p.H) * p.P;
  const float neg_a = -expf(p.a_log[h]);

  // zero everything once: the pad columns of B and C (N .. NK) and the
  // first state stay zero, since no copy writes them
  {
    uint4* z = reinterpret_cast<uint4*>(ssd_smem);
    const int n16 = static_cast<int>(L.bytes(PB, item) / 16);
    for (int i = threadIdx.x; i < n16; i += MMA_THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int nch = (p.S + c - 1) / c;
  stage_chunk<T, PB>(ssd_smem, L, p, xh, dt, Bm, Cm, 0);
  for (int k = 0; k < nch; ++k) {
    const int t0 = k * c, n = min(c, p.S - t0);
    const T* sX = reinterpret_cast<const T*>(ssd_smem + (k & 1) * L.stage);
    const T* sB = sX + CP * XS;
    const T* sC = sB + CP * BS;
    const float* sD = reinterpret_cast<const float*>(sC + CP * BS);
    const float* cS = sS + (k & 1) * PB * SS;        // S at the chunk start
    float* nS = sS + ((k + 1) & 1) * PB * SS;        // S at its end
    const __nv_bfloat16* cH = sH + (k & 1) * PB * HS;
    const __nv_bfloat16* cL = sL + (k & 1) * PB * HS;
    __nv_bfloat16* nH = sH + ((k + 1) & 1) * PB * HS;
    __nv_bfloat16* nL = sL + ((k + 1) & 1) * PB * HS;

    mma_tile::cp_async_wait<0>();
    __syncthreads();  // chunk k has landed; chunk k - 1 is done with
    if (k + 1 < nch)
      stage_chunk<T, PB>(ssd_smem, L, p, xh, dt, Bm, Cm, k + 1);
    if (warp == 0) {
      // inclusive cumsum of the log decay over the stage (dt is 0 past n,
      // so la stays at la_end there): each lane sums a run of steps, a
      // warp scan adds the runs before it
      const int per = (CP + 31) / 32;
      const int lo = lane * per, hi = min(CP, lo + per);
      float run = 0.f;
      for (int r = lo; r < hi; ++r) {
        run += neg_a * sD[r];
        la[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += x;
      }
      const float before = incl - run;
      for (int r = lo; r < hi; ++r) la[r] += before;
      __syncwarp();
      const float la_end = la[n - 1];
      for (int r = lo; r < hi; ++r) {
        ela[r] = expf(la[r]);
        dend[r] = sD[r] * expf(la_end - la[r]);
      }
    }
    __syncthreads();

    // y, row block by row block
    const int nrb = (n + 15) / 16;
    for (int turn = 0;; ++turn) {
      const int rb = turn * MMA_WARPS +
                     ((turn & 1) ? MMA_WARPS - 1 - warp : warp);
      if (rb >= nrb) break;
      const int r0 = rb * 16;
      float acc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

      // cross: C_t . S[p, :], then times exp(la_t)
#pragma unroll 1
      for (int k0 = 0; k0 < NK; k0 += KS) {
        uint32_t a[4], ah[4], al[4];
        load_a<T>(a, sC, BS, r0, k0, lane);
        if constexpr (F32) split_all<4>(a, ah, al);
#pragma unroll
        for (int jp = 0; jp < PB / 16; ++jp) {
          uint32_t bs[4];
          if constexpr (F32) {
            load_b_nk<float>(bs, cS, SS, 16 * jp, k0, lane);
            mma_pair<T>(acc + 2 * jp, ah, al, bs);
          } else {
            load_b_nk<__nv_bfloat16>(bs, cH, HS, 16 * jp, k0, lane);
            mma_pair<T>(acc + 2 * jp, a, nullptr, bs);
            load_b_nk<__nv_bfloat16>(bs, cL, HS, 16 * jp, k0, lane);
            mma_pair<T>(acc + 2 * jp, a, nullptr, bs);
          }
        }
      }
      const float la0 = la[r0 + g], la1 = la[r0 + g + 8];
      {
        const float e0 = ela[r0 + g], e1 = ela[r0 + g + 8];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }

      // intra: the key blocks s0 <= r0
#pragma unroll 1
      for (int kb = 0; kb <= rb; ++kb) {
        const int s0 = kb * 16;
        float sc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 1
        for (int k0 = 0; k0 < NK; k0 += KS) {
          uint32_t a[4], ah[4], al[4], bb[4];
          load_a<T>(a, sC, BS, r0, k0, lane);
          load_b_nk<T>(bb, sB, BS, s0, k0, lane);
          if constexpr (F32) {
            split_all<4>(a, ah, al);
            mma_pair<T>(sc, ah, al, bb);
          } else {
            mma_pair<T>(sc, a, nullptr, bb);
          }
        }
        // G' = score * exp(la_t - la_s) * dt_s, 0 above the diagonal
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = s0 + 8 * j + 2 * t + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            const float v =
                sc[j][e] * (expf((e >> 1 ? la1 : la0) - la[s]) * sD[s]);
            sc[j][e] = (kb == rb && s > row) ? 0.f : v;
          }
        if constexpr (F32) {
          // k8 step j holds keys s0 + 8j ..: C tile j read as an A
          // fragment (columns 2t, 2t + 1 are its k = t, t + 4)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t ga[4] = {__float_as_uint(sc[j][0]),
                                    __float_as_uint(sc[j][2]),
                                    __float_as_uint(sc[j][1]),
                                    __float_as_uint(sc[j][3])};
            uint32_t gh[4], gl[4];
            split_all<4>(ga, gh, gl);
#pragma unroll
            for (int jp = 0; jp < PB / 16; ++jp) {
              uint32_t bx[4];
              load_b_kn<float>(bx, reinterpret_cast<const float*>(sX), XS,
                               s0 + 8 * j, 16 * jp, lane);
              mma_pair<T>(acc + 2 * jp, gh, gl, bx);
            }
          }
        } else {
          // the C tiles of keys s0.. and s0 + 8.. make one k16 A fragment,
          // applied as hi and lo
          uint32_t ph[4], pl[4];
          split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
          split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
          split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
          split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
          for (int jp = 0; jp < PB / 16; ++jp) {
            uint32_t bx[4];
            load_b_kn<__nv_bfloat16>(
                bx, reinterpret_cast<const __nv_bfloat16*>(sX), XS, s0,
                16 * jp, lane);
            mma_pair<T>(acc + 2 * jp, ph, nullptr, bx);
            mma_pair<T>(acc + 2 * jp, pl, nullptr, bx);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + g + 8 * i;
        if (row < n) {
          T* yr = y + (t0 + row) * y_ss + 2 * t;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            store2(yr + 8 * j, acc[j][2 * i], acc[j][2 * i + 1]);
        }
      }
    }

    // the state at the chunk's end, one 16 x 16 unit a warp:
    // S[p, n] <- exp(la_end) S[p, n] + sum_s xh[s, p] (dend_s B[s, n])
    const int nu = NK / 16, units = (PB / 16) * nu;
    const float a_end = expf(la[n - 1]);
    for (int u = MMA_WARPS - 1 - warp; u < units; u += MMA_WARPS) {
      const int m0 = (u / nu) * 16, n0 = (u % nu) * 16;
      float sa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
      const int kend = nrb * 16;  // rows past n are zero
      for (int s0 = 0; s0 < kend; s0 += KS) {
        uint32_t a[4], bb[4];
        load_a_t<T>(a, sX, XS, s0, m0, lane);
        load_b_kn<T>(bb, sB, BS, s0, n0, lane);
        if constexpr (F32) {
          // bb[0], bb[2] hold key s0 + 2t; bb[1], bb[3] key s0 + 2t + 1
          const float d0 = dend[s0 + 2 * t], d1 = dend[s0 + 2 * t + 1];
          const uint32_t sb[4] = {
              __float_as_uint(__uint_as_float(bb[0]) * d0),
              __float_as_uint(__uint_as_float(bb[1]) * d1),
              __float_as_uint(__uint_as_float(bb[2]) * d0),
              __float_as_uint(__uint_as_float(bb[3]) * d1)};
          uint32_t ah[4], al[4];
          split_all<4>(a, ah, al);
          mma_pair<T>(sa, ah, al, sb);
        } else {
          // bb[0], bb[2] hold keys s0 + 2t, + 1; bb[1], bb[3] keys
          // s0 + 8 + 2t, + 1
          const float2 d01 =
              *reinterpret_cast<const float2*>(dend + s0 + 2 * t);
          const float2 d89 =
              *reinterpret_cast<const float2*>(dend + s0 + 8 + 2 * t);
          uint32_t bh[4], bl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 v = bf16x2_to_f32(bb[i]);
            const float2 d = (i & 1) ? d89 : d01;
            split_bf16(v.x * d.x, v.y * d.y, bh[i], bl[i]);
          }
          mma_pair<T>(sa, a, nullptr, bh);
          mma_pair<T>(sa, a, nullptr, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + g + 8 * i, col = n0 + 8 * j + 2 * t;
          const float2 old =
              *reinterpret_cast<const float2*>(cS + row * SS + col);
          const float v0 = fmaf(a_end, old.x, sa[j][2 * i]);
          const float v1 = fmaf(a_end, old.y, sa[j][2 * i + 1]);
          *reinterpret_cast<float2*>(nS + row * SS + col) =
              make_float2(v0, v1);
          if constexpr (!F32) {
            uint32_t hi, lo;
            split_bf16(v0, v1, hi, lo);
            *reinterpret_cast<uint32_t*>(nH + row * HS + col) = hi;
            *reinterpret_cast<uint32_t*>(nL + row * HS + col) = lo;
          }
        }
    }
  }
  __syncthreads();
  const float* fS = sS + (nch & 1) * PB * SS;
  float* st = p.state + ((size_t(b) * p.H + h) * p.P + p0) * N;
  for (int i = threadIdx.x; i < PB * N; i += MMA_THREADS) {
    const int row = i / N, q = i - row * N;
    st[i] = fS[row * SS + q];
  }
}

// ---- launch ----------------------------------------------------------------
// The rule of ssd_scan.path_for: xh's base and its batch, sequence and
// head strides in multiples of 16 bytes (its slices are copied 16 bytes at
// a time), and the body's shared memory at the widest slice within a
// block's.  B, C and dt take any layout the wrapper accepts.  1 = mma.
int mma_path(const Params& p, int item) {
  return reinterpret_cast<uintptr_t>(p.xh) % 16 == 0 &&
         (p.x_sb * item) % 16 == 0 && (p.x_ss * item) % 16 == 0 &&
         (p.x_sh * item) % 16 == 0 &&
         mma_smem_bytes(p.chunk, 32, p.N, item) <= MAX_SMEM;
}

template <typename T>
cudaError_t launch_simt(const Params& p, int B, int device,
                        cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err =
      gemm_tile::allow_max_smem(ssd_kernel<T>, device, smem_set);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(p.H, B), THREADS,
                  simt_smem_bytes(p.chunk, p.P, p.N), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int PB>
cudaError_t launch_mma(const Params& p, int B, int device,
                       cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err =
      gemm_tile::allow_max_smem(ssd_mma_kernel<T, PB>, device, smem_set);
  if (err != cudaSuccess) return err;
  ssd_mma_kernel<T, PB>
      <<<dim3(p.H, B, p.P / PB), MMA_THREADS,
         mma_smem_bytes(p.chunk, PB, p.N, sizeof(T)), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int path, int PB, int B, int device,
                     cudaStream_t stream) {
  if (path == 0) return launch_simt<T>(p, B, device, stream);
  return PB == 16 ? launch_mma<T, 16>(p, B, device, stream)
                  : launch_mma<T, 32>(p, B, device, stream);
}

// The widest cp.async (16, 8 or 4 bytes) that every row of B or C takes:
// its address, strides and row length are all multiples of it; 2 (element
// copies) where 4 bytes do not divide them (bf16 views off 4 bytes).
int granule(const void* ptr, long long item, long long sb, long long ss,
            long long row_bytes) {
  const long long parts[] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(ptr)), sb * item,
      ss * item, row_bytes};
  for (int g = 16; g >= 4; g /= 2) {
    bool ok = true;
    for (long long x : parts) ok = ok && x % g == 0;
    if (ok) return g;
  }
  return 2;
}

// The launch as kernels/ssd_scan.py packs it (struct.Struct "=8Q19q").
// dtype (of xh, B, C and y): 0 = float32, 1 = bfloat16; dt, a_log and the
// state are float32.  path: 0 = simt, 1 = mma, as ssd_scan.path_for chose;
// mma where the mirrored rule (mma_path) does not give it is refused, simt
// runs any input.  PB: the mma body's column slice (16 or 32, dividing P;
// ssd_scan.geometry).  Strides are in elements: xh (batch, seq, head), dt,
// B and C (batch, seq); the last dimension of each must be contiguous.  y
// [B, S, H, P] and the state [B, H, P, N] are written contiguous.
struct Args {
  const void* xh;
  const void* dt;
  const void* a_log;
  const void* B;
  const void* C;
  void* y;
  void* state;
  void* stream;
  long long dtype, device, path, B_, S, H, P, N, chunk, PB;
  long long x_sb, x_ss, x_sh, d_sb, d_ss, b_sb, b_ss, c_sb, c_ss;
};
static_assert(sizeof(Args) == 27 * 8, "Args is 27 8-byte fields");

}  // namespace

// Launches one scan from the packed `Args` at `packed`.  Returns a
// cudaError_t; cudaErrorInvalidValue for a shape or body the kernel cannot
// run.
extern "C" int ssd_launch(const void* packed) {
  Args a;
  std::memcpy(&a, packed, sizeof a);
  if (a.B_ <= 0 || a.B_ > 65535 || a.S <= 0 || a.S > 0x7fffffffLL ||
      a.H <= 0 || a.H > 0x7fffffffLL || a.P <= 0 || a.P % 16 != 0 ||
      a.P > 16 * MAX_NJ || a.N <= 0 || a.N > 128 || a.chunk <= 0 ||
      a.chunk > a.S || a.dtype < 0 || a.dtype > 1 || a.path < 0 ||
      a.path > 1 || (a.path == 1 && ((a.PB != 16 && a.PB != 32) ||
                                     a.P % a.PB != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = a.dtype == 0 ? 4 : 2;
  const Params p{a.xh,
                 static_cast<const float*>(a.dt),
                 static_cast<const float*>(a.a_log),
                 a.B,
                 a.C,
                 a.y,
                 static_cast<float*>(a.state),
                 int(a.S),
                 int(a.H),
                 int(a.P),
                 int(a.N),
                 int(a.chunk),
                 granule(a.B, item, a.b_sb, a.b_ss, a.N * item),
                 granule(a.C, item, a.c_sb, a.c_ss, a.N * item),
                 a.x_sb, a.x_ss, a.x_sh, a.d_sb, a.d_ss,
                 a.b_sb, a.b_ss, a.c_sb, a.c_ss};
  if (a.path == 1 && !mma_path(p, item))
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
  err = a.dtype == 0 ? dispatch<float>(p, int(a.path), int(a.PB), int(a.B_),
                                       device, st)
                     : dispatch<__nv_bfloat16>(p, int(a.path), int(a.PB),
                                               int(a.B_), device, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
