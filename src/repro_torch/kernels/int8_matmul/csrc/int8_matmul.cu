// int8 x int8 -> int32 products on Hopper's tensor cores (sm_90a), and the
// int8 depth network's dense and pointwise convolutions fused around them.
//
// What it replaces: src/repro/kernels/int8_matmul/kernel.py
//   int8_matmul_launch -> int8_matmul_pallas (body _int8_matmul_kernel)
// Contract (the op's, ref.py): C = A B with A (M, K) int8 and B (K, N) int8,
// both row-major and contiguous, C (M, N) int32 row-major, exact: no
// saturation.  |a|, |b| <= 128, so |C| <= K * 2^14 fits int32 for K < 2^17;
// the wrapper refuses larger K.  Any M, K, N >= 1.
//
// qconv_int8_launch -> qconv_int8_pallas (kernels/int8_matmul/qconv.py) is
// the same main loop behind another staging and epilogue: one launch of
// what the JAX package's _qconv + bias + ReLU (src/repro/core/depth.py)
// computes for a dense 3x3 or pointwise layer, from the float32 NHWC
// activation x to the float32 NHWC output:
//   sx = max(xscale, 1e-8) * float32(1/127)      (xscale read on the card:
//                                                 one per tensor, or one per
//                                                 image for the slot-batched
//                                                 serving step)
//   q  = clamp(rint(x / sx), -127, 127)           (IEEE division, ties even)
//   y  = relu(((float(sum_k q w) * sx) * wscale[c]) + b[c])
// The im2col row of each output pixel is formed in the staging's
// addressing, with JAX's SAME padding (at stride 2 an even input pads
// (0, 1)): the quantised activation and its im2col matrix never reach
// device memory.  Every float step is rounded once, in the plain path's
// order (__fdiv_rn, __fmul_rn, __fadd_rn: nvcc contracts nothing into an
// FMA, and nothing is built with --use_fast_math), and the int32 sums are
// exact, so the launch is bitwise equal to its plain version.  The
// decoder's nearest x2 upsample is not read through this addressing: in
// the network every upsampled tensor feeds a depthwise half, which stays
// plain PyTorch.
//
// Design.  The shapes are small and varied: M = 64 .. 4096 output pixels,
// K = 16 .. 144 (27 for the RGB input layer), N = 1 .. 64.  mma.sync
// m16n8k32 (s8 x s8 -> s32) fits them better than wgmma: its n8 tile
// matches N = 1, 16 and 32 without a 64-wide minimum tile of B in shared
// memory, and at these sizes the tensor cores are never the limit, so
// wgmma's asynchrony buys nothing.  One CTA of 8 warps owns 64 rows of C and
// 8 NT columns (NT = 1, 2, 4, 8 n8 tiles, the least that covers N, up to
// 64; larger N takes more CTAs along y).  Warp w computes the m16 tile
// w % 4 against half of the CTA's n8 tiles (w / 4; with NT = 1 warps 4-7
// only stage).  The whole K, rounded up to 32 bytes, is staged at once
// when K <= 256 (every K of the depth network): one barrier, then the
// k loop runs without another.  Larger K is staged 256 bytes at a time.
// A row of A and a column of B occupy K/4 + 4 words of shared memory, a
// count that is 4 modulo 8, so the fragment loads (8 rows x 4 words) hit
// 32 distinct banks.  A is staged 16 bytes a thread when K % 16 == 0, 4
// when K % 4 == 0, else byte by byte (qconv: a float4 of x a thread when
// cin % 4 == 0); rows, columns and k outside the matrices are zero-filled
// in shared memory, so no padded copy is ever made.
//
// What bounds it on an H100.  A product moves 10-270 KB and does at most
// 2.4 M multiply-adds: bytes bound it (about 1.26 MB a frame at 3.35 TB/s,
// 0.38 us; the operations take about 4 ns at 1,979 TOP/s), and every
// launch is far below a microsecond of that work, so a launch costs what a
// launch costs.  The fused launch removes the dozen eager launches that
// surrounded each product (quantise, pad, im2col, dequantise, bias, ReLU)
// and the device-memory round trips of their intermediates.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kBM = 64;                 // rows of C per CTA: four m16 tiles
constexpr int kThreads = 256;           // 8 warps
constexpr int kMaxKT = 256;             // bytes of k staged at once
constexpr int kMaxSW = kMaxKT / 4 + 4;  // words per staged row, padded
constexpr float kInv127 = 1.0f / 127.0f;

struct ConvShape {  // NHWC input, SAME padding
  int h, w, cin, ho, wo, ks, stride, pad_t, pad_l;
};

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte of k = 4 w + i in bits 8 i of word w: mma's order within a register.
__device__ __forceinline__ uint32_t byte_at(int8_t v, int i) {
  return (uint32_t)(uint8_t)v << (8 * i);
}

// The activation scale of image img: clamp_min(1e-8) (NaN stays NaN, as in
// PyTorch), then the product with float32(1/127) that XLA compiles the
// reference's division into.  xscale holds one scale for the whole batch
// (per_image = 0, the per-tensor scale of one forward) or one per image
// (per_image = 1: the serving pool's slot-batched step, where each slot's
// frame keeps the scale a solo forward would take).
__device__ __forceinline__ float image_scale(const float* __restrict__ xscale,
                                             int per_image, int img) {
  const float xs = __ldg(xscale + (per_image ? img : 0));
  return __fmul_rn(xs < 1e-8f ? 1e-8f : xs, kInv127);
}

// quantize_activation for one element: IEEE division, rint (ties to even).
__device__ __forceinline__ uint32_t quantize(float v, float sx, int i) {
  float q = rintf(__fdiv_rn(v, sx));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return byte_at((int8_t)(int)q, i);
}

// B (K x N) int8 row-major -> bs[column][k], zero outside the matrix.
__device__ void stage_b(uint32_t* bs, int sw, const int8_t* __restrict__ b,
                        int k, int n, int k0, int kt, int col0, int bn) {
  const int words = kt / 4;
  for (int e = threadIdx.x; e < bn * words; e += kThreads) {
    const int cc = e % bn, wd = e / bn;  // neighbouring lanes, columns
    const int gc = col0 + cc;
    uint32_t v = 0;
    if (gc < n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = k0 + 4 * wd + i;
        if (gk < k) v |= byte_at(b[(int64_t)gk * n + gc], i);
      }
    }
    bs[cc * sw + wd] = v;
  }
}

// A (M x K) int8 row-major -> as[row][k]; vec: bytes per load (16, 4, 1).
__device__ void stage_a_matrix(uint32_t* as, int sw,
                               const int8_t* __restrict__ a, int m, int k,
                               int row0, int k0, int kt, int vec) {
  const int words = kt / 4;
  if (vec == 16) {
    const int chunks = kt / 16;
    for (int e = threadIdx.x; e < kBM * chunks; e += kThreads) {
      const int r = e / chunks, ch = e % chunks;
      const int gr = row0 + r, gk = k0 + 16 * ch;
      int4 v = make_int4(0, 0, 0, 0);
      if (gr < m && gk < k)
        v = *reinterpret_cast<const int4*>(a + (int64_t)gr * k + gk);
      *reinterpret_cast<int4*>(as + r * sw + 4 * ch) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < kBM * words; e += kThreads) {
    const int r = e / words, wd = e % words;
    const int gr = row0 + r, gk = k0 + 4 * wd;
    uint32_t v = 0;
    if (gr < m && gk < k) {
      const int8_t* src = a + (int64_t)gr * k + gk;
      if (vec == 4) {
        v = *reinterpret_cast<const uint32_t*>(src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gk + i < k) v |= byte_at(src[i], i);
      }
    }
    as[r * sw + wd] = v;
  }
}

// The im2col rows of x (NHWC float32), quantised: as[row][k] with k =
// (dy, dx, c); taps in the SAME padding are zeros.  vec4: cin % 4 == 0 and
// x 16-byte aligned, so a word's four channels are one float4.
__device__ void stage_a_conv(uint32_t* as, int sw, const float* __restrict__ x,
                             float sx0, const float* __restrict__ xscale,
                             int per_image, const ConvShape& s, int m, int k,
                             int row0, int k0, int kt, bool vec4) {
  const int words = kt / 4;
  const int hw_out = s.ho * s.wo;
  for (int e = threadIdx.x; e < kBM * words; e += kThreads) {
    const int r = e / words, wd = e % words;
    const int gr = row0 + r;
    uint32_t v = 0;
    if (gr < m) {
      const int img = gr / hw_out, rem = gr - img * hw_out;
      const float sx = per_image ? image_scale(xscale, 1, img) : sx0;
      const int oy = rem / s.wo, ox = rem - oy * s.wo;
      const int iy0 = oy * s.stride - s.pad_t, ix0 = ox * s.stride - s.pad_l;
      const float* xi = x + (int64_t)img * s.h * s.w * s.cin;
      if (vec4) {
        const int gk = k0 + 4 * wd;
        if (gk < k) {
          const int tap = gk / s.cin, c = gk - tap * s.cin;
          const int iy = iy0 + tap / s.ks, ix = ix0 + tap % s.ks;
          if (iy >= 0 && iy < s.h && ix >= 0 && ix < s.w) {
            const float4 f = *reinterpret_cast<const float4*>(
                xi + ((int64_t)iy * s.w + ix) * s.cin + c);
            v = quantize(f.x, sx, 0) | quantize(f.y, sx, 1) |
                quantize(f.z, sx, 2) | quantize(f.w, sx, 3);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gk = k0 + 4 * wd + i;
          if (gk >= k) break;
          const int tap = gk / s.cin, c = gk - tap * s.cin;
          const int iy = iy0 + tap / s.ks, ix = ix0 + tap % s.ks;
          if (iy >= 0 && iy < s.h && ix >= 0 && ix < s.w)
            v |= quantize(xi[((int64_t)iy * s.w + ix) * s.cin + c], sx, i);
        }
      }
    }
    as[r * sw + wd] = v;
  }
}

// acc[j] += A[mrow .. mrow+15, :] B[:, ncol0 + 8 j .. + 7] over `words`
// words of k, on the tensor cores.
template <int NTW>
__device__ __forceinline__ void mma_rows(int32_t (&acc)[NTW][4],
                                         const uint32_t* as,
                                         const uint32_t* bs, int sw,
                                         int words, int mrow, int ncol0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* a0 = as + (mrow + g) * sw + t;
  const uint32_t* a1 = a0 + 8 * sw;
  const uint32_t* b0 = bs + (ncol0 + g) * sw + t;
  for (int kw = 0; kw < words; kw += 8) {  // 32 bytes of k per mma
    const uint32_t a[4] = {a0[kw], a1[kw], a0[kw + 4], a1[kw + 4]};
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const uint32_t* bp = b0 + 8 * j * sw + kw;
      const uint32_t b[2] = {bp[0], bp[4]};
      mma_s8(acc[j], a, b);
    }
  }
}

// The CTA's 64 x 8 NT tile of sum_k A B, staged by `stage_a` (a callable
// taking (as, sw, k0, kt)), left in each warp's accumulators; returns
// whether this warp holds any of it.
template <int NT, typename StageA>
__device__ __forceinline__ bool main_loop(
    int32_t (&acc)[NT > 1 ? NT / 2 : 1][4], uint32_t* as, uint32_t* bs,
    const int8_t* __restrict__ b, int k, int n, int row0, int col0,
    int& mrow, int& ncol0, StageA stage_a) {
  constexpr int NTW = NT > 1 ? NT / 2 : 1;
  const int warp = threadIdx.x >> 5;
  mrow = 16 * (warp & 3);
  ncol0 = 8 * NTW * (warp >> 2);
  const bool active = NT > 1 || warp < 4;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  for (int k0 = 0; k0 < k; k0 += kMaxKT) {
    const int kt = min(kMaxKT, (k - k0 + 31) / 32 * 32);
    const int sw = kt / 4 + 4;
    if (k0 > 0) __syncthreads();  // the previous tile's products are done
    stage_a(as, sw, k0, kt);
    stage_b(bs, sw, b, k, n, k0, kt, col0, 8 * NT);
    __syncthreads();
    if (active) mma_rows<NTW>(acc, as, bs, sw, kt / 4, mrow, ncol0);
  }
  return active;
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int32_t* __restrict__ c, int m, int k, int n, int vec) {
  constexpr int NTW = NT > 1 ? NT / 2 : 1;
  __shared__ __align__(16) uint32_t as[kBM * kMaxSW];
  __shared__ __align__(16) uint32_t bs[8 * NT * kMaxSW];
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * 8 * NT;
  int32_t acc[NTW][4];
  int mrow, ncol0;
  const bool active = main_loop<NT>(
      acc, as, bs, b, k, n, row0, col0, mrow, ncol0,
      [=](uint32_t* s, int sw, int k0, int kt) {
        stage_a_matrix(s, sw, a, m, k, row0, k0, kt, vec);
      });
  if (!active) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + mrow + g + 8 * (i >> 1);
      const int gc = col0 + ncol0 + 8 * j + 2 * t + (i & 1);
      if (gr < m && gc < n) c[(int64_t)gr * n + gc] = acc[j][i];
    }
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
qconv_int8_kernel(const float* __restrict__ x, const float* __restrict__ xscale,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ wscale,
                  const float* __restrict__ bias, float* __restrict__ y,
                  ConvShape s, int m, int k, int n, int relu, int per_image,
                  int vec4) {
  constexpr int NTW = NT > 1 ? NT / 2 : 1;
  __shared__ __align__(16) uint32_t as[kBM * kMaxSW];
  __shared__ __align__(16) uint32_t bs[8 * NT * kMaxSW];
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * 8 * NT;
  const int hw_out = s.ho * s.wo;
  const float sx0 = image_scale(xscale, 0, 0);  // the per-tensor scale
  int32_t acc[NTW][4];
  int mrow, ncol0;
  const bool active = main_loop<NT>(
      acc, as, bs, w, k, n, row0, col0, mrow, ncol0,
      [=](uint32_t* st, int sw, int k0, int kt) {
        stage_a_conv(st, sw, x, sx0, xscale, per_image, s, m, k, row0, k0,
                     kt, vec4 != 0);
      });
  if (!active) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + mrow + g + 8 * (i >> 1);
      const int gc = col0 + ncol0 + 8 * j + 2 * t + (i & 1);
      if (gr < m && gc < n) {
        const float sx =
            per_image ? image_scale(xscale, 1, gr / hw_out) : sx0;
        float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][i]), sx),
                            wscale[gc]);
        v = __fadd_rn(v, bias[gc]);
        if (relu && v < 0.f) v = 0.f;  // F.relu: NaN stays NaN
        y[(int64_t)gr * n + gc] = v;
      }
    }
}

// The least number of n8 tiles (1, 2, 4, 8) that covers N, at most 8.
int n_tiles(int n) {
  return n <= 8 ? 1 : n <= 16 ? 2 : n <= 32 ? 4 : 8;
}

template <typename Launch>
int dispatch_nt(int n, Launch launch) {
  switch (n_tiles(n)) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    default: launch(std::integral_constant<int, 8>()); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int int8_matmul_launch(const void* a, const void* b, void* c, int m, int k,
                       int n, void* stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const int vec = (k % 16 == 0 && pa % 16 == 0) ? 16
                  : (k % 4 == 0 && pa % 4 == 0) ? 4 : 1;
  const int bn = 8 * n_tiles(n);
  const dim3 grid((m + kBM - 1) / kBM, (n + bn - 1) / bn);
  return dispatch_nt(n, [&](auto nt) {
    int8_matmul_kernel<decltype(nt)::value>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
            static_cast<int32_t*>(c), m, k, n, vec);
  });
}

// x (batch, h, w, cin) float32 NHWC; w (ks ks cin, cout) int8; y (batch,
// ho, wo, cout) float32 with ho = ceil(h / stride), wo = ceil(w / stride);
// xscale one float (per_image = 0) or batch floats, image i's scale at i
// (per_image = 1).  Output row r belongs to image r / (ho wo).
int qconv_int8_launch(const void* x, const void* xscale, const void* w,
                      const void* wscale, const void* bias, void* y,
                      int batch, int h, int wd, int cin, int cout, int ks,
                      int stride, int relu, int per_image, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || ks < 1 ||
      stride < 1)
    return (int)cudaErrorInvalidValue;
  ConvShape s;
  s.h = h, s.w = wd, s.cin = cin, s.ks = ks, s.stride = stride;
  s.ho = (h + stride - 1) / stride;
  s.wo = (wd + stride - 1) / stride;
  const int ph = std::max((s.ho - 1) * stride + ks - h, 0);
  const int pw = std::max((s.wo - 1) * stride + ks - wd, 0);
  s.pad_t = ph / 2, s.pad_l = pw / 2;  // JAX SAME: the odd pixel goes last
  const int m = batch * s.ho * s.wo, k = ks * ks * cin;
  const int vec4 =
      cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int bn = 8 * n_tiles(cout);
  const dim3 grid((m + kBM - 1) / kBM, (cout + bn - 1) / bn);
  return dispatch_nt(cout, [&](auto nt) {
    qconv_int8_kernel<decltype(nt)::value>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(xscale),
            static_cast<const int8_t*>(w), static_cast<const float*>(wscale),
            static_cast<const float*>(bias), static_cast<float*>(y), s, m, k,
            cout, relu, per_image, vec4);
  });
}

}  // extern "C"
