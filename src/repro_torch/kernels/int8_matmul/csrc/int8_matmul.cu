// int8 x int8 -> int32 matrix product, written by hand for Hopper (sm_90a).
//
// What it replaces: src/repro/kernels/int8_matmul/kernel.py
//   int8_matmul_launch -> int8_matmul_pallas (body _int8_matmul_kernel)
// Contract (the op's, ref.py): C = A B with A (M, K) int8 and B (K, N) int8,
// both row-major and contiguous, C (M, N) int32 row-major, exact: no
// saturation.  |a|, |b| <= 128, so |C| <= K * 2^14 fits int32 for K < 2^17;
// the wrapper refuses larger K.  Any M, K, N >= 1.
//
// Design.  The TPU kernel zero-padded A and B to 128^3 tiles for the MXU
// and cropped the result; its grid ran K innermost, in order, adding into
// the output block.  Here one CTA of 256 threads owns one 64 x 64 tile of C
// and walks K itself in steps of kTileK = 32 bytes: each step stages the A
// tile (64 rows x 32 k) and the B tile (32 k x 64 columns, stored
// transposed: column-major in k) through shared memory as int8, writing
// zeros wherever a row, a column or a k lies outside the matrices, so the
// ragged edges are masked in the kernel and no padded copy is ever made
// (K is zero-filled to a multiple of 4 in shared memory only).  Each
// thread keeps a 4 x 4 block of int32 sums in registers and adds four
// products at a time with __dp4a over 4-byte groups of k; its rows are
// ty + 16 i and its columns tx + 16 j, so neighbouring lanes read
// neighbouring words.
//
// What bounds it on an H100.  At the main path's shapes (the int8 depth
// network's eight matrix products per frame, M = 64 .. 4096, K = 16 .. 144,
// N = 1 .. 64) a launch moves 10-270 KB and does at most 2.4 M int8
// multiply-adds: the bound is bytes (about 1.26 MB per frame, 0.38 us at
// 3.35 TB/s; the operations would take about 4 ns at 1,979 TOP/s).  Every
// launch is far below a microsecond of work, so each costs what a launch
// costs (a few us).  The design does nothing about that bound beyond
// reading each input byte from device memory once per CTA that needs it and
// writing each output once; it is the simple exact version.  A tensor-core
// path (mma.sync / wgmma on s8) and fusing the eight launches of a frame
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;                 // bytes of k per step
constexpr int kThreads = 256;              // 16 x 16, 4 x 4 outputs each
constexpr int kWordsK = kTileK / 4;        // 32-bit words of k per step
constexpr int kStride = kWordsK + 1;       // padded row, in words

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a,
                   const int8_t* __restrict__ b,
                   int32_t* __restrict__ c, int m, int k, int n) {
  // A tile row-major in k, B tile column-major in k: word w of row r holds
  // k = 4w .. 4w+3 of that row (A) or column (B).
  __shared__ int32_t as[kTileM * kStride];
  __shared__ int32_t bs[kTileN * kStride];
  int8_t* as8 = reinterpret_cast<int8_t*>(as);
  int8_t* bs8 = reinterpret_cast<int8_t*>(bs);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * kTileM;
  const int col0 = blockIdx.y * kTileN;

  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    // Stage A: 64 x 32 bytes, consecutive threads on consecutive k.
#pragma unroll
    for (int e = tid; e < kTileM * kTileK; e += kThreads) {
      const int r = e / kTileK;
      const int kk = e % kTileK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      const int8_t v =
          (gr < m && gk < k) ? a[(int64_t)gr * k + gk] : (int8_t)0;
      as8[r * kStride * 4 + kk] = v;
    }
    // Stage B: 32 x 64 bytes, consecutive threads on consecutive columns.
#pragma unroll
    for (int e = tid; e < kTileK * kTileN; e += kThreads) {
      const int kk = e / kTileN;
      const int cc = e % kTileN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      const int8_t v =
          (gk < k && gc < n) ? b[(int64_t)gk * n + gc] : (int8_t)0;
      bs8[cc * kStride * 4 + kk] = v;
    }
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kWordsK; ++w) {
      int32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * kStride + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * kStride + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < n) c[(int64_t)gr * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int int8_matmul_launch(const void* a, const void* b, void* c, int m, int k,
                       int n, void* stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  int8_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(c), m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
