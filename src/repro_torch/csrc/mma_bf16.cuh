// Building blocks of the bf16 tensor-core kernels (blockwise_causal_attn.cu,
// linformer_attn.cu, seq_projection.cu): inline PTX for cp.async 16-byte
// (and 4-byte) copies, ldmatrix
// (plain and transposed), mma.sync m16n8k16 with fp32 accumulators, packing
// two fp32 values to a bf16x2, and a tile loader that takes any layout.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4·g + t, g = lane / 4,
// t = lane % 4; each register holds two bf16, the lower column in the low
// half):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, fp32):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// The C layout of two neighbouring n-tiles is the A layout of one k-step,
// so a product's fp32 result packs straight into the next product's A.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i (16 bytes each), and register i of lane (g, t) gets
// matrix i's (row g, cols 2t..2t+1), or with .trans (rows 2t..2t+1, col g).
// A shared-memory pitch of (cols + 8) bf16 puts the 8 rows of a matrix in 8
// different 16-byte bank groups: no bank conflicts.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory that bypasses L1 (cp.async.cg);
// both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// The same through L1 (cp.async.ca): blocks on one SM that copy the same rows
// share them in L1.
__device__ __forceinline__ void cp_async_16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// A 4-byte copy (cp.async.ca: the 4-byte size exists only through L1), for
// per-row fp32 scales; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a · b on the tensor cores (bf16 operands, fp32 accumulators).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, far below a bf16 rounding; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to nearest even as one bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// True when rows of an operand at `p` (ElemBytes-byte elements, bf16 by
// default) with element strides `s...` can be copied in 16-byte pieces: the
// base and every stride a multiple of 16 bytes.
template <int ElemBytes = 2, typename... S>
__host__ __device__ inline bool aligned16(const void* p, S... s) {
  bool ok = reinterpret_cast<uintptr_t>(p) % 16 == 0;
  ((ok = ok && static_cast<long long>(s) * ElemBytes % 16 == 0), ...);
  return ok;
}

// Stage a Rows x Cols bf16 tile (row stride `rs` elements) into shared memory
// with pitch Pitch: rows >= valid_rows and columns >= valid_cols become zeros.
// With `vec` (see aligned16) whole 16-byte pieces go by cp.async, to be
// waited for with cp_async_wait; a piece that crosses valid_cols, and every
// piece without `vec`, is read element by element and stored at once. All
// Threads threads of the block take part; Cols is a multiple of 8.
template <int Threads, int Rows, int Cols, int Pitch, bool ViaL1 = false>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int valid_rows, int valid_cols,
                                          bool vec) {
  static_assert(Cols % 8 == 0 && Pitch % 8 == 0, "16-byte pieces");
  constexpr int kPieces = Cols / 8;
  for (int idx = threadIdx.x; idx < Rows * kPieces; idx += Threads) {
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    __nv_bfloat16* d = dst + r * Pitch + c;
    const int n = r < valid_rows ? valid_cols - c : 0;  // valid elements of the piece
    if (vec && n >= 8) {
      if (ViaL1)
        cp_async_16_ca(d, src + r * rs + c);
      else
        cp_async_16(d, src + r * rs + c);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src + r * rs + c);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = 2 * j < n ? s[2 * j] : 0u;
        const uint32_t hi = 2 * j + 1 < n ? s[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace mma
}  // namespace repro_torch
