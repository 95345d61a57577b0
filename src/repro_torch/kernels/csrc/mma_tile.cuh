// The output tile of the tiled GEMM K1 (matmul.cu) on Hopper's tensor
// cores: `mma.sync` fed by a `cp.async` ring in shared memory.
//
// One block of THREADS threads (8 warps, a 2 x 4 grid) owns a bm x bn
// output tile and walks it in sub-tiles of at most SUB x SUB, as
// gemm_tile.cuh's `block_tile` does; the tile sizes are runtime values,
// multiples of 16 (matmul.path_for states the rule and `mma_path` below
// repeats it).  A sub-tile's m16 row blocks are dealt to the two warp rows
// in turn and its n8 column blocks to the four warp columns in turn, so a
// warp holds at most 4 x 4 fragments (64 f32 accumulators a thread).
//
// f32: `mma.sync.m16n8k8` TF32 with an f32 accumulator, three passes per
// k step.  Each operand leaves shared memory as f32 and is split into a
// TF32 high part (`cvt.rna`) and the TF32 rounding of its remainder, taken
// in f32; the product is lo*hi + hi*lo + hi*hi, which errs by ~2^-21 per
// term (one pass would err by ~2^-11).  The three passes of one k step sum
// into zeroed fragments that are then added to the accumulator in f32, so
// the tensor core's own accumulation rounds 3 x 8 products' worth, never
// the running sum.  bf16: `mma.sync.m16n8k16` with an f32 accumulator, one
// pass (the products are exact in f32).
//
// The bk slab is a ring of S = bk / SL stages of SL k (32, or 16 where bk
// is an odd multiple of 16), filled by 16-byte `cp.async.cg` copies: stage
// s + S - 1 loads while stage s is multiplied.  Each stage holds
// A[sub_m, SL] and B[SL, sub_n], so the ring takes exactly
// (min(bm,128) + min(bn,128)) * bk * sizeof(T) bytes, gemm_tile's
// `smem_bytes` (and the profiler's estimate).  Each operand is stored as
// it lies in memory: k-contiguous ("K-major", rows of SL) or m/n-contiguous
// (rows of the sub-tile's extent E), its 16-byte chunks XOR-swizzled by row
// so that the cp.async writes and the fragment reads of a warp touch every
// bank once.  Fragments come in by `ldmatrix` (`.trans` for a bf16 operand
// stored m/n-contiguous), or by 32-bit loads for an f32 operand stored
// m/n-contiguous, whose 32-bit elements `ldmatrix.trans` would cut.  The
// layouts are template arguments and every address is a per-thread offset
// fixed for the sub-tile plus a constant: the loop issues loads and MMAs.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "gemm_tile.cuh"

namespace mma_tile {

constexpr int THREADS = 256;  // 8 warps: 2 along m, 4 along n
constexpr int WARPS_N = 4;
constexpr int SUB = 128;
constexpr int FM = 4;  // most m16 fragments a warp holds (SUB / 16 / 2)
constexpr int FN = 4;  // most n8 fragments a warp holds (SUB / 8 / 4)

// The rule of matmul.path_for: tiles in multiples of 16, each operand
// contiguous along one dimension with the other stride a multiple of 16
// bytes, base pointers 16-byte aligned.  1 = this tile, 0 = gemm_tile's.
inline bool operand_ok(const void* p, long long s_mn, long long s_k,
                       size_t item) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  if (s_k == 1) return (s_mn * (long long)item) % 16 == 0;
  if (s_mn == 1) return (s_k * (long long)item) % 16 == 0;
  return false;
}
// An operand that operand_ok passes is K-major when this holds, else
// m/n-major.
inline bool k_major(long long s_mn, long long s_k, size_t item) {
  return s_k == 1 && (s_mn * (long long)item) % 16 == 0;
}
inline int mma_path(const gemm_tile::Shape& s, const void* a, const void* b,
                    size_t item) {
  return s.bm % 16 == 0 && s.bn % 16 == 0 && s.bk % 16 == 0 &&
         operand_ok(a, s.sa_m, s.sa_k, item) &&
         operand_ok(b, s.sb_n, s.sb_k, item);
}

// The tensor-core instantiation a launch needs, as template arguments: the
// slice depth SL (32 k where bk allows it, else 16) and whether A and B are
// K-major.
template <int SL_, bool AK_, bool BK_>
struct Variant {
  static constexpr int SL = SL_;
  static constexpr bool AK = AK_, BK = BK_;
};

template <int SL, typename Launch>
inline cudaError_t by_layout(bool ak, bool bk, Launch& launch) {
  if (ak)
    return bk ? launch(Variant<SL, true, true>{})
              : launch(Variant<SL, true, false>{});
  return bk ? launch(Variant<SL, false, true>{})
            : launch(Variant<SL, false, false>{});
}

// Calls launch(Variant<SL, AK, BK>{}) for the one of the eight
// instantiations that a tile and operand layout passing mma_path() takes,
// and returns its cudaError_t.  K1 (matmul.cu) and K5 (moe_gemm.cu) both
// choose through here, so the two cannot drift apart.
template <typename T, typename Launch>
inline cudaError_t dispatch(const gemm_tile::Shape& s, Launch&& launch) {
  const bool ak = k_major(s.sa_m, s.sa_k, sizeof(T));
  const bool bk = k_major(s.sb_n, s.sb_k, sizeof(T));
  return s.bk % 32 == 0 ? by_layout<32>(ak, bk, launch)
                        : by_layout<16>(ak, bk, launch);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait_group takes an immediate; the ring's depth is a runtime value.
// Waiting for fewer pending groups than asked is always safe.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>();
  }
}

// The XOR applied to a 16-byte chunk's index in a row of `cpr` chunks.
// `sw_rows`: conflict-free when eight consecutive rows are read at one
// chunk (ldmatrix): rows of 128 bytes or more (cpr % 8 == 0) take row & 7;
// rows of 64 (mod 128) bytes, two to a 128-byte line, take (row >> 1) & 3;
// rows of 32 (mod 64) take (row >> 2) & 1.  `sw_f32mn`: the 32-bit reads
// of an f32 m/n-contiguous operand, four rows (k) by two chunks:
// (k & 3) << 1, or k & 2 for rows of 64 (mod 128) bytes.  Each keeps the
// chunk inside its row and depends on the row's low three bits only.
__device__ __forceinline__ int sw_rows(int row, int cpr) {
  return (cpr & 7) == 0 ? (row & 7)
         : (cpr & 3) == 0 ? ((row >> 1) & 3)
                          : ((row >> 2) & 1);
}
__device__ __forceinline__ int sw_f32mn(int k, int cpr) {
  return (cpr & 7) == 0 ? ((k & 3) << 1) : (k & 2);
}
template <typename T>
__device__ __forceinline__ int sw_mn(int k, int cpr) {
  return sizeof(T) == 4 ? sw_f32mn(k, cpr) : sw_rows(k, cpr);
}

// Element offsets in a stage: K-major [E][SL] or m/n-major [SL][E].
template <typename T, int SL>
__device__ __forceinline__ int at_kmaj(int r, int k) {
  constexpr int EPC = 16 / sizeof(T), CPR = SL / EPC;
  return r * SL + (((k / EPC) ^ sw_rows(r, CPR)) * EPC) + (k % EPC);
}
template <typename T>
__device__ __forceinline__ int at_mnmaj(int k, int r, int E) {
  constexpr int EPC = 16 / sizeof(T);
  return k * E + (((r / EPC) ^ sw_mn<T>(k, E / EPC)) * EPC) + (r % EPC);
}

// The cp.async copies of one operand's slice that this thread issues, for
// an operand tile of E rows with strides (s_mn, s_k).  Where THREADS is a
// multiple of the chunks in a row, the thread's u-th chunk lies u * R rows
// below its first (R = THREADS / chunks a row, a multiple of 8, so the
// swizzle is the same): stage offset soff + u * R * (row length), source
// src + u * R * (row stride), moving by a slice's k each slice.  Rows of
// other lengths (an m/n-major operand of 48, 80, 96 or 112) take the
// general loop.  Only the thread's first chunk is kept; the rest comes from
// the kernel's parameters.
template <typename T>
struct Copies {
  const T* src;  // this thread's first chunk at slice 0
  int soff;
};

template <typename T, int SL, bool KMAJ>
__device__ __forceinline__ Copies<T> plan_copies(const T* tile, int E,
                                                 long long s_mn,
                                                 long long s_k) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = KMAJ ? SL / EPC : E / EPC;
  const int row = threadIdx.x / cpr, ch = threadIdx.x % cpr;
  if constexpr (KMAJ)
    return {tile + row * s_mn + ch * EPC, at_kmaj<T, SL>(row, ch * EPC)};
  else
    return {tile + row * s_k + ch * EPC, at_mnmaj<T>(row, ch * EPC, E)};
}

template <typename T, int SL, bool KMAJ>
__device__ __forceinline__ void issue_copies(T* stage, const T* tile,
                                             const Copies<T>& c, int E,
                                             long long s_mn, long long s_k,
                                             int kt) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = KMAJ ? SL / EPC : E / EPC;
  const int n = KMAJ ? E * cpr : SL * cpr;
  if (KMAJ || THREADS % cpr == 0) {
    const int rows = THREADS / cpr;
    const T* src = c.src + (KMAJ ? kt * SL : kt * SL * s_k);
    const long long gstep = rows * (KMAJ ? s_mn : s_k);
    const int sstep = rows * (KMAJ ? SL : E);
#pragma unroll 4
    for (int idx = threadIdx.x, u = 0; idx < n; idx += THREADS, ++u)
      cp_async16(stage + c.soff + u * sstep, src + u * gstep);
  } else {
    for (int idx = threadIdx.x; idx < n; idx += THREADS) {
      const int k = idx / cpr, ch = idx - k * cpr;
      cp_async16(stage + at_mnmaj<T>(k, ch * EPC, E),
                 tile + (kt * SL + k) * s_k + ch * EPC);
    }
  }
}

// ---- fragments -------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Where a warp's fragments lie in a stage.  The m16 block of A fragment i
// starts at row 32i + 16wm, the n8 block of B fragment j at column
// 32j + 8wn.  For ldmatrix, lane l names row l & 7 of matrix l >> 3.
// The offsets below hold for fragment 0 and k step 0 of a slice; fragment
// i (j) and k step kk add the terms in `load_a` (`load_b`).
template <typename T, int SL, bool AK, bool BK>
struct Frags {
  int a0, b0;        // element offsets of this thread's first read
  int a_col[2];      // chunk terms of an m/n-major A by fragment parity
  int b_col[2];
  int a_ksw, b_ksw;  // the swizzled chunk of a K-major operand at k step 0
  int em4, en4;      // 4 E: four rows of an m/n-major stage
};

// ---- f32: three TF32 passes ------------------------------------------------
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(x);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(f));
  const float rest = f - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Per-thread offsets, fixed for a sub-tile of extents (em, en).
template <typename T, int SL, bool AK, bool BK>
__device__ __forceinline__ Frags<T, SL, AK, BK> plan_frags(int wm, int wn,
                                                           int lane, int em,
                                                           int en) {
  constexpr int EPC = 16 / sizeof(T), CPR = SL / EPC;
  constexpr bool F32 = sizeof(T) == 4;
  Frags<T, SL, AK, BK> f;
  const int q = lane >> 3, rr = lane & 7, qb = (lane >> 3) & 1;
  const int g = lane >> 2, t = lane & 3;
  f.em4 = 4 * em;
  f.en4 = 4 * en;
  if constexpr (AK) {
    // ldmatrix x4: rows 16wm + rr + 8(q & 1), chunk 2kk + (q >> 1)
    f.a0 = (16 * wm + rr + (q & 1) * 8) * SL;
    f.a_ksw = (q >> 1) ^ sw_rows(rr, CPR);
  } else if constexpr (F32) {
    // 32-bit loads: row k = t (+4), column 16wm + g (+8)
    const int sw = sw_f32mn(t, em / EPC);
    f.a0 = t * em + (g & 3);
    f.a_col[0] = (((4 * wm + (g >> 2)) ^ sw) << 2);
    f.a_col[1] = (((4 * wm + 2 + (g >> 2)) ^ sw) << 2);
  } else {
    // ldmatrix x4 .trans: rows k = 8(q >> 1) + rr, chunk 4i + 2wm + (q & 1)
    const int sw = sw_rows(rr, em / EPC);
    f.a0 = ((q >> 1) * 8 + rr) * em;
    f.a_col[0] = ((2 * wm + (q & 1)) ^ sw) * EPC;
    f.a_col[1] = ((4 + 2 * wm + (q & 1)) ^ sw) * EPC;
  }
  if constexpr (BK) {  // ldmatrix x2: rows 8wn + rr, chunk 2kk + qb
    f.b0 = (8 * wn + rr) * SL;
    f.b_ksw = qb ^ sw_rows(rr, CPR);
  } else if constexpr (F32) {  // 32-bit loads: row k = t (+4), column 8wn + g
    const int sw = sw_f32mn(t, en / EPC);
    f.b0 = t * en + (g & 3);
    f.b_col[0] = (((2 * wn + (g >> 2)) ^ sw) << 2);
    f.b_col[1] = f.b_col[0];
  } else {  // ldmatrix x2 .trans: rows k = 8qb + rr, chunk 4j + wn
    const int sw = sw_rows(rr, en / EPC);
    f.b0 = (qb * 8 + rr) * en;
    f.b_col[0] = (wn ^ sw) * EPC;
    f.b_col[1] = ((4 + wn) ^ sw) * EPC;
  }
  return f;
}

// The A fragment i at k step kk: four registers (f32: TF32-ready words).
template <typename T, int SL, bool AK, bool BK>
__device__ __forceinline__ void load_a(const T* sA,
                                       const Frags<T, SL, AK, BK>& f, int i,
                                       int kk, uint32_t* r) {
  constexpr int EPC = 16 / sizeof(T);
  if constexpr (AK) {
    // chunk 2kk + (q >> 1), swizzled: the XOR touches the low bits only
    const int ch = (2 * kk) ^ f.a_ksw;
    ldsm_x4(r, sA + f.a0 + i * 32 * SL + ch * EPC);
  } else if constexpr (sizeof(T) == 4) {
    // k = 8kk + t (+4); column block 8i + 4wm (+2 for rows + 8)
    const uint32_t* s = reinterpret_cast<const uint32_t*>(sA) + f.a0 +
                        2 * kk * f.em4 + i * 32;
    r[0] = s[f.a_col[0]];
    r[1] = s[f.a_col[1]];
    r[2] = s[f.em4 + f.a_col[0]];
    r[3] = s[f.em4 + f.a_col[1]];
  } else {
    ldsm_x4_t(r, sA + f.a0 + kk * 16 * (f.em4 / 4) + (i >> 1) * 64 +
                     f.a_col[i & 1]);
  }
}

// The B fragment j at k step kk: two registers.
template <typename T, int SL, bool AK, bool BK>
__device__ __forceinline__ void load_b(const T* sB,
                                       const Frags<T, SL, AK, BK>& f, int j,
                                       int kk, uint32_t* r) {
  constexpr int EPC = 16 / sizeof(T);
  if constexpr (BK) {
    const int ch = (2 * kk) ^ f.b_ksw;
    ldsm_x2(r, sB + f.b0 + j * 32 * SL + ch * EPC);
  } else if constexpr (sizeof(T) == 4) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(sB) + f.b0 +
                        2 * kk * f.en4 + j * 32 + f.b_col[0];
    r[0] = s[0];
    r[1] = s[f.en4];
  } else {
    ldsm_x2_t(r, sB + f.b0 + kk * 16 * (f.en4 / 4) + (j >> 1) * 64 +
                     f.b_col[j & 1]);
  }
}

// One stage: SL / KSTEP k steps over the warp's fragments; FULL when the
// warp holds all FM x FN of them (every warp of a 128 x 128 sub-tile), which
// drops the predicates.  In f32, the three passes over A fragment i sweep
// its FN fragments in turn, so no mma waits on the one before it, into a
// zeroed partial that is added to the accumulator after the k step.
template <typename T, int SL, bool AK, bool BK, bool FULL>
__device__ __forceinline__ void stage_mma(const T* sA, const T* sB,
                                          const Frags<T, SL, AK, BK>& f,
                                          int fm, int fn,
                                          float (&acc)[FM][FN][4]) {
  if constexpr (FULL) fm = FM, fn = FN;
  if constexpr (sizeof(T) == 4) {
    // Unrolled, the k steps of the predicated path and of two m/n-major
    // operands spill (ptxas): those roll them.
    constexpr int UNROLL = FULL && (AK || BK) ? SL / 8 : 1;
#pragma unroll (UNROLL)
    for (int kk = 0; kk < SL / 8; ++kk) {
      uint32_t b[FN][2], bh[FN][2], bl[FN][2], a[2][4];
#pragma unroll
      for (int j = 0; j < FN; ++j)
        if (j < fn) load_b(sB, f, j, kk, b[j]);
      if (fm > 0) load_a(sA, f, 0, kk, a[0]);
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (j < fn) split_tf32(b[j][r], bh[j][r], bl[j][r]);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if (i >= fm) continue;
        if (i + 1 < FM && i + 1 < fm)  // the next row's loads go out first
          load_a(sA, f, i + 1, kk, a[(i + 1) & 1]);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(a[i & 1][r], ah[r], al[r]);
        float part[FN][4];
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[j][r] = 0.f;
#pragma unroll
        for (int j = 0; j < FN; ++j)
          if (j < fn) mma_tf32(part[j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          if (j < fn) mma_tf32(part[j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          if (j < fn) mma_tf32(part[j], ah, bh[j]);
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += part[j][r];
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < SL / 16; ++kk) {
      uint32_t a[FM][4], b[FN][2];
#pragma unroll
      for (int j = 0; j < FN; ++j)
        if (j < fn) load_b(sB, f, j, kk, b[j]);
#pragma unroll
      for (int i = 0; i < FM; ++i)
        if (i < fm) load_a(sA, f, i, kk, a[i]);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          if (i < fm && j < fn) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Computes O[row_blk : row_blk+bm, col_blk : col_blk+bn] and stores
// epilogue(row, col, acc) there.  The caller guarantees mma_path() and
// passes AK = A is K-major, BK = B is K-major (k_major()).
template <typename T, int SL, bool AK, bool BK, typename Epilogue>
__device__ __forceinline__ void block_tile(const gemm_tile::Shape& p,
                                           const T* a, const T* b, T* o,
                                           int row_blk, int col_blk,
                                           Epilogue epilogue) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* smem = reinterpret_cast<T*>(mma_smem);
  const int sub_m = min(p.bm, SUB), sub_n = min(p.bn, SUB);
  const int S = p.bk / SL;                 // stages in the ring
  const int stage = (sub_m + sub_n) * SL;  // elements a stage holds
  const int nk = p.K / SL;
  const int lane = threadIdx.x & 31;
  const int wm = (threadIdx.x >> 5) / WARPS_N;
  const int wn = (threadIdx.x >> 5) % WARPS_N;
  const int g = lane >> 2, t = lane & 3;

  for (int sm0 = 0; sm0 < p.bm; sm0 += sub_m) {
    const int row0 = row_blk + sm0;
    const int em = min(sub_m, p.bm - sm0);
    const int fm = (em / 16 - wm + 1) / 2;
    for (int sn0 = 0; sn0 < p.bn; sn0 += sub_n) {
      const int col0 = col_blk + sn0;
      const int en = min(sub_n, p.bn - sn0);
      const int fn = (en / 8 - wn + WARPS_N - 1) / WARPS_N;
      const T* a_tile = a + row0 * p.sa_m;
      const T* b_tile = b + col0 * p.sb_n;
      const Copies<T> ca = plan_copies<T, SL, AK>(a_tile, em, p.sa_m, p.sa_k);
      const Copies<T> cb = plan_copies<T, SL, BK>(b_tile, en, p.sb_n, p.sb_k);
      const Frags<T, SL, AK, BK> f =
          plan_frags<T, SL, AK, BK>(wm, wn, lane, em, en);
      auto load = [&](int kt) {
        T* st = smem + (kt % S) * stage;
        issue_copies<T, SL, AK>(st, a_tile, ca, em, p.sa_m, p.sa_k, kt);
        issue_copies<T, SL, BK>(st + sub_m * SL, b_tile, cb, en, p.sb_n,
                                p.sb_k, kt);
      };
      float acc[FM][FN][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

      __syncthreads();  // the last sub-tile's reads of the ring are done
      for (int s = 0; s < S - 1; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
      }
      for (int kt = 0; kt < nk; ++kt) {
        if (S == 1) {
          load(kt);
          cp_async_commit();
        }
        cp_async_wait_dyn(S - 2);  // slice kt has landed (this thread's part)
        __syncthreads();           // ... everyone's; slice kt-1 is read
        if (S > 1) {
          if (kt + S - 1 < nk) load(kt + S - 1);  // into slice kt-1's stage
          cp_async_commit();
        }
        const T* st = smem + (kt % S) * stage;
        if (fm == FM && fn == FN)
          stage_mma<T, SL, AK, BK, true>(st, st + sub_m * SL, f, fm, fn, acc);
        else
          stage_mma<T, SL, AK, BK, false>(st, st + sub_m * SL, f, fm, fn, acc);
        if (S == 1) __syncthreads();
      }

      // The epilogue reads C for every fragment before the first store to
      // O, which the compiler must assume may alias C: the reads overlap.
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = row0 + 32 * i + 16 * wm + g + 8 * (r >> 1);
            const int col = col0 + 32 * j + 8 * wn + 2 * t + (r & 1);
            if (i < fm && j < fn)
              acc[i][j][r] = epilogue(row, col, acc[i][j][r]);
          }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          if (i >= fm || j >= fn) continue;
          const int row = row0 + 32 * i + 16 * wm + g;
          const int col = col0 + 32 * j + 8 * wn + 2 * t;
          store2(o + (long long)row * p.N + col, acc[i][j][0], acc[i][j][1]);
          store2(o + (long long)(row + 8) * p.N + col, acc[i][j][2],
                 acc[i][j][3]);
        }
    }
  }
}

}  // namespace mma_tile
