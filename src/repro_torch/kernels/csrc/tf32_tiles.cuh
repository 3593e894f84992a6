// Float32 products on Hopper's tensor cores (3xTF32 on mma.sync), shared by
// the chunk-parallel scans (mamba2_ssd.cu, rwkv6_scan.cu) and the float32
// flash-attention kernel (flash_attention_tf32.cu).
//
// 3xTF32: each float32 operand is split into a TF32 hi and a TF32 lo, and
// mma.sync.m16n8k8 sums lo.hi + hi.lo + hi.hi in float32, which keeps
// float32 accuracy (plain TF32 keeps about three digits, past the scans'
// 2e-4 gate).  A warp owns 16 rows and NT n8 column tiles of an
// output tile; operands are read from shared memory through accessors.
//
// Included by the .cu files of each library; kernels/_build.py hashes this
// directory into every library that names it, so an edited header rebuilds
// them.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32_tiles {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x = hi + lo, both TF32 (hi rounded to nearest, lo the exact remainder
// rounded again).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// The same split done on the bits, for every x but NaN: adding half the
// unit of the 13 dropped bits to the magnitude carries into the kept ones
// (to nearest, ties away from zero, as cvt.rna rounds).  Five integer and
// float instructions; the flash kernel runs 1.2-1.3x faster with it than
// with split_tf32 on an H100 (scripts/sweep_flash_tf32.py, variant cvt).
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] (rows r0 .. r0 + 15, columns c0 + 8 j .. c0 + 8 j + 7) += A B
// over k < 8 ksteps, in 3xTF32.  a_at(row, k) and b_at(k, col) read
// shared memory (or compute the operand from it).  exact_b: B is exact in
// TF32 (widened bf16), so hi.lo is zero and is not taken.
template <int NT, typename AAt, typename BAt>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NT][4], int r0,
                                           int c0, int ksteps, AAt a_at,
                                           BAt b_at, bool exact_b = false) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ah[4], al[4];
    split_tf32(a_at(r0 + g, k0 + t), ah[0], al[0]);
    split_tf32(a_at(r0 + g + 8, k0 + t), ah[1], al[1]);
    split_tf32(a_at(r0 + g, k0 + t + 4), ah[2], al[2]);
    split_tf32(a_at(r0 + g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      split_tf32(b_at(k0 + t, c0 + 8 * j + g), bh[0], bl[0]);
      split_tf32(b_at(k0 + t + 4, c0 + 8 * j + g), bh[1], bl[1]);
      mma_tf32(acc[j], al, bh);
      if (!exact_b) mma_tf32(acc[j], ah, bl);
      mma_tf32(acc[j], ah, bh);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Writes this warp's 16 x 8 NT piece of the tile (adds it to dst's values
// when add): rows r < nr, columns col < nw of dst (row stride ld), two
// columns a store where both lie in the row and the rows are 8-byte
// aligned.
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], int r0,
                                           int c0, float* dst, int64_t ld,
                                           int nr, int nw, bool add = false) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool pairs =
      ld % 2 == 0 && reinterpret_cast<uintptr_t>(dst) % 8 == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half, col = c0 + 8 * j + 2 * t;
      if (r >= nr || col >= nw) continue;
      float* out = dst + r * ld + col;
      float x = acc[j][2 * half], y = acc[j][2 * half + 1];
      if (pairs && col + 1 < nw) {
        if (add) {
          const float2 was = *reinterpret_cast<const float2*>(out);
          x += was.x;
          y += was.y;
        }
        *reinterpret_cast<float2*>(out) = make_float2(x, y);
      } else {
        out[0] = add ? out[0] + x : x;
        if (col + 1 < nw) out[1] = add ? out[1] + y : y;
      }
    }
}

// Four consecutive elements as float32, the last `left` of which lie in
// the row (none if left <= 0); one 16- (float) or 8-byte (bf16) load when
// vec and the quad is whole.
__device__ __forceinline__ float4 load_quad(const float* p, bool vec,
                                            int left) {
  if (vec && left >= 4) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = p[0];
  if (left > 1) v.y = p[1];
  if (left > 2) v.z = p[2];
  if (left > 3) v.w = p[3];
  return v;
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p, bool vec,
                                            int left) {
  if (vec && left >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = __bfloat162float(p[0]);
  if (left > 1) v.y = __bfloat162float(p[1]);
  if (left > 2) v.z = __bfloat162float(p[2]);
  if (left > 3) v.w = __bfloat162float(p[3]);
  return v;
}

}  // namespace tf32_tiles
