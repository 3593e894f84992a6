// Mamba-2 SSD (state-space dual) scan, written by hand for Hopper (sm_90a):
// chunk-parallel, one C B^T per batch row, products on the tensor cores.
//
// What it replaces: src/repro/kernels/mamba2_ssd/kernel.py
//   mamba2_ssd_launch -> mamba2_ssd_pallas (body _ssd_kernel)
// Contract (the op's, ref.py): per (b, h), from a zero state h (N x P),
//   h[n, p] <- exp(a_log_t) h[n, p] + B_t[n] x_t[p],   y_t[p] = C_t . h[:, p]
// x (B, H, T, P), a_log (B, H, T), B and C (B, T, N) shared by the heads of
// a batch row, float32 or bfloat16 (one type for the four; bf16 is widened
// to float32 as it is staged), read through their strides in elements (the
// last dim of x, B and C contiguous): the model hands over x and a_log as
// (B, T, H, .) tensors seen transposed.  y float32 is written into a
// (B, T, H, P) buffer, the model's layout, which the wrapper returns as its
// (B, H, T, P) view; the final h (B, H, N, P) float32.  T is a multiple of
// the chunk C <= 64; N <= 64; any P (64 columns a CTA).
//
// Design.  The TPU kernel walked the chunks of one (b, h) in order, as the
// sequential axis of its grid, with h in VMEM.  Here the chunked
// decomposition (chunked.py, mamba2_ssd_chunk_parallel) runs as three
// launches, two of them over all (chunk, head, batch row): at Zamba2-2.7B's
// prefill 5,120 CTAs of 64 x 64 work, against one CTA per (b, h), 320, that
// walked 16 chunks in order.
//   1. ssd_state_kernel, per (chunk, head, P tile, batch row): the chunk's
//      cumsum ca of a_log (a parallel scan in float64 over two warps, kept
//      as the float32 pair hi + lo); its own state S = (B exp(ca_C - ca))^T x
//      (N x P) and its total decay exp(ca_C), to device memory.  The CTAs of
//      head 0 also take G = C B^T (C x C), once per (batch row, chunk) for
//      all H heads, where the parent kernel took it in every head's CTA.
//   2. ssd_pass_kernel, per state element of each (b, h): in order over the
//      chunks, h_c = exp(ca_C) h_{c-1} + S_c, writing each chunk's incoming
//      state over its S (in place) and the last h as the final state.
//   3. ssd_output_kernel, per (chunk, head, P tile, batch row):
//      y = (G o L) x + exp(ca) (C h_in), L[t, s] = exp(ca_t - ca_s) for
//      s <= t, else 0 (only the k steps under the diagonal are taken).
// Every exponent is <= 0 (the intra-chunk one clamped at 0 against
// rounding), and each difference of cumsums is (hi_t - hi_s) + (lo_t -
// lo_s): a strong decay makes |ca| reach hundreds within a chunk, and a
// difference of float32 cumsums would lose the small exponents.
//
// The products (G, S, (G o L) x, C h) run on the tensor cores as 3xTF32
// (../../csrc/tf32_tiles.cuh, shared with the RWKV6 scan).  Each CTA is
// 8 warps, each owning 16 rows and 32 columns (4 n8 tiles) of the 64 x 64
// tile.  Operands sit in shared memory as float32 rows of 68 words (A,
// read row-major) or 72 words (B and transposed A), so each fragment load
// hits 32 distinct banks.
//
// What bounds it on an H100.  Zamba2-2.7B's prefill (B 4, H 80, T 1024,
// P = N = 64, C 64, float32 in) needs 6.749 GFLOP: the products over the
// lower triangle s <= t, C B^T once per batch row and chunk.  At the
// float32 CUDA-core peak (67 TFLOP/s) that is 100.7 us, the bound the
// kernel table keeps.  On the tensor cores the three TF32 products are
// 20.25 GFLOP, 40.9 us at 495 TFLOP/s; then bytes bound it: the function's
// own 176.4 MB (x, a_log, B, C read once, y and the final h written once)
// take 52.7 us at 3.35 TB/s, and this design adds the chunk states, (4, 80,
// 16, 64, 64) float32 = 83.9 MB, written by launch 1, read and written by
// launch 2, read by launch 3, and a second read of x: 595.8 MB in all,
// 177.9 us (chip_smoke.py, ssd_tensor_core_bound).  The state passing stays a launch of its own over every state
// element of the card: done instead by the last CTA of each (b, h) of
// launch 1 (a counter, fences, the chunk states re-read from L2), it made
// the scan slower on an H100: each such CTA walks 16 chunks in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32_tiles;

constexpr int kTile = 64;     // rows and columns of a CTA's tile
constexpr int kThreads = 256; // 8 warps: 16 rows x 32 columns each
constexpr int kNT = 4;        // n8 column tiles of a warp
constexpr int kLdA = 68;      // row-major A operand: 68 = 4 (mod 32) words
constexpr int kLdB = 72;      // B and transposed A: 72 = 8 (mod 32) words
constexpr int kTileA = kTile * kLdA;
constexpr int kTileB = kTile * kLdB;

struct Strides {  // in elements; the last dims of x, B and C are 1
  int64_t xb, xh, xt, ab, ah, at, bb, bt, cb, ct;
};

struct Shape {
  int nh, t, p, n, c, nc, ptiles;
  int vec;  // kVec* bits: which rows may be read four elements at a time
};

constexpr int kVecX = 1, kVecB = 2, kVecC = 4, kVecS = 8, kVecG = 16;
constexpr int kQuads = kTile * kTile / 4 / kThreads;  // 4 quads a thread

// The chunk's inclusive cumsum of a_log, in float64 by a scan over two
// warps, as float32 hi[s] + lo[s] for s < c.  Ends with a barrier.
template <typename T>
__device__ void chunk_cumsum(const T* __restrict__ a0, int64_t at, int t0,
                             int c, float* hi, float* lo, double* carry) {
  const int tid = threadIdx.x, lane = tid & 31;
  double v = 0.0;
  if (tid < kTile) {
    if (tid < c) v = (double)to_f32(a0[(t0 + tid) * at]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (tid == 31) *carry = v;
  }
  __syncthreads();
  if (tid < c) {
    if (tid >= 32) v += *carry;
    const float h = (float)v;
    hi[tid] = h;
    lo[tid] = (float)(v - (double)h);
  }
  __syncthreads();
}

// Quad i of this thread in a 64 x 64 tile: row q / 16, columns 4 (q % 16).
__device__ __forceinline__ int quad_row(int i) {
  return (threadIdx.x + i * kThreads) >> 4;
}
__device__ __forceinline__ int quad_col(int i) {
  return ((threadIdx.x + i * kThreads) & 15) * 4;
}

// dst[r][col] = rows r < nr, columns col < nw of src (row stride ld, in
// elements), as float32; zero elsewhere in the 64 x 64 tile.  All of a
// thread's loads are issued before its first store.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ldd,
                                      const T* __restrict__ src, int64_t ld,
                                      int nr, int nw, bool vec) {
  float4 v[kQuads];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int r = quad_row(i), c4 = quad_col(i);
    v[i] = r < nr ? load_quad(src + r * ld + c4, vec, nw - c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kQuads; ++i)
    *reinterpret_cast<float4*>(dst + quad_row(i) * ldd + quad_col(i)) = v[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ states, float* __restrict__ gbuf,
                 float* __restrict__ decay, Shape sh, Strides sd) {
  extern __shared__ float smem[];
  float* bs = smem;           // (s, n): B, then B exp(ca_C - ca)
  float* xs = bs + kTileB;    // (s, p)
  float* cs = xs + kTileB;    // (t, n): C, head 0 only
  float* hi = cs + kTileA;
  float* lo = hi + kTile;
  float* dec = lo + kTile;  // exp(ca_C - ca_s)
  double* carry = reinterpret_cast<double*>(dec + kTile);

  const int ci = blockIdx.x, row = blockIdx.z;
  const int head = blockIdx.y / sh.ptiles, pt = blockIdx.y % sh.ptiles;
  const int t0 = ci * sh.c, p0 = pt * kTile;
  const int pw = min(kTile, sh.p - p0);
  const int64_t bh = (int64_t)row * sh.nh + head;
  const bool takes_g = head == 0 && pt == 0;
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);

  chunk_cumsum(a + row * sd.ab + head * sd.ah, sd.at, t0, sh.c, hi, lo,
               carry);
  const float hl = hi[sh.c - 1], ll = lo[sh.c - 1];
  if (threadIdx.x < sh.c)
    dec[threadIdx.x] = expf((hl - hi[threadIdx.x]) + (ll - lo[threadIdx.x]));
  stage(bs, kLdB, bm + row * sd.bb + t0 * sd.bt, sd.bt, sh.c, sh.n,
        sh.vec & kVecB);
  stage(xs, kLdB, x + row * sd.xb + head * sd.xh + t0 * sd.xt + p0, sd.xt,
        sh.c, pw, sh.vec & kVecX);
  if (takes_g)
    stage(cs, kLdA, cm + row * sd.cb + t0 * sd.ct, sd.ct, sh.c, sh.n,
          sh.vec & kVecC);
  __syncthreads();

  float acc[kNT][4];
  if (takes_g) {  // G[t][s] = C_t . B_s, once for the H heads
    zero(acc);
    if (r0 < sh.c)
      mma_3xtf32(
          acc, r0, c0, (sh.n + 7) / 8,
          [&](int r, int k) { return cs[r * kLdA + k]; },
          [&](int k, int col) { return bs[col * kLdB + k]; });
    store_tile(acc, r0, c0,
               gbuf + ((int64_t)row * sh.nc + ci) * sh.c * sh.c, sh.c, sh.c,
               sh.c);
    __syncthreads();  // B is read unscaled above
  }
  for (int e = threadIdx.x; e < sh.c * kTile; e += kThreads) {
    const int s = e / kTile, col = e % kTile;
    bs[s * kLdB + col] *= dec[s];
  }
  if (threadIdx.x == 0 && pt == 0)
    decay[bh * sh.nc + ci] = expf(hl + ll);
  __syncthreads();

  // S[n][p] = sum_s B~[s][n] x[s][p]
  if (r0 < sh.n) {
    zero(acc);
    mma_3xtf32(
        acc, r0, c0, (sh.c + 7) / 8,
        [&](int r, int k) { return bs[k * kLdB + r]; },
        [&](int k, int col) { return xs[k * kLdB + col]; });
    store_tile(acc, r0, c0, states + (bh * sh.nc + ci) * sh.n * sh.p + p0,
               sh.p, sh.n, pw);
  }
}

__device__ __forceinline__ float pass_step(float d, float h, float own) {
  return d * h + own;
}
__device__ __forceinline__ float4 pass_step(float d, float4 h, float4 own) {
  return make_float4(d * h.x + own.x, d * h.y + own.y, d * h.z + own.z,
                     d * h.w + own.w);
}

// One thread per element (V = float) or four (V = float4) of a (b, h)
// state: h_c = exp(ca_C) h_{c-1} + S_c, in order over the chunks.  Each S_c
// is replaced by the chunk's incoming state h_{c-1} (chunk 0's, zero, is
// not written: the output launch skips it).  Eight chunks' S are loaded
// before any is overwritten, so eight loads are in flight.
template <typename V>
__global__ void __launch_bounds__(256)
ssd_pass_kernel(V* __restrict__ states, const float* __restrict__ decay,
                V* __restrict__ h_out, int nc, int nv, int64_t total) {
  constexpr int kBatch = 8;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t bh = idx / nv, e = idx % nv;
  V* s = states + bh * nc * nv + e;
  const float* d = decay + bh * nc;
  V h;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    V own[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (c0 + q < nc) own[q] = s[(int64_t)(c0 + q) * nv];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int ci = c0 + q;
      if (ci >= nc) break;
      if (ci == 0) {
        h = own[q];
      } else {
        s[(int64_t)ci * nv] = h;
        h = pass_step(d[ci], h, own[q]);
      }
    }
  }
  h_out[idx] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const T* __restrict__ cm, const float* __restrict__ states,
                  const float* __restrict__ gbuf, float* __restrict__ y,
                  Shape sh, Strides sd) {
  extern __shared__ float smem[];
  float* ms = smem;           // (t, s): G o L
  float* cs = ms + kTileA;    // (t, n): C exp(ca)
  float* xs = cs + kTileA;    // (s, p)
  float* hs = xs + kTileB;    // (n, p): the incoming state
  float* hi = hs + kTileB;
  float* lo = hi + kTile;
  float* grow = lo + kTile;  // exp(ca_t)
  double* carry = reinterpret_cast<double*>(grow + kTile);

  const int ci = blockIdx.x, row = blockIdx.z;
  const int head = blockIdx.y / sh.ptiles, pt = blockIdx.y % sh.ptiles;
  const int t0 = ci * sh.c, p0 = pt * kTile;
  const int pw = min(kTile, sh.p - p0);
  const int64_t bh = (int64_t)row * sh.nh + head;
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);

  chunk_cumsum(a + row * sd.ab + head * sd.ah, sd.at, t0, sh.c, hi, lo,
               carry);
  if (threadIdx.x < sh.c)
    grow[threadIdx.x] = expf(hi[threadIdx.x] + lo[threadIdx.x]);
  stage(xs, kLdB, x + row * sd.xb + head * sd.xh + t0 * sd.xt + p0, sd.xt,
        sh.c, pw, sh.vec & kVecX);
  if (ci > 0)
    stage(hs, kLdB, states + (bh * sh.nc + ci) * sh.n * sh.p + p0,
          (int64_t)sh.p, sh.n, pw, sh.vec & kVecS);
  // G (its lower triangle) and C, loaded before anything is stored.
  const T* crow = cm + row * sd.cb + t0 * sd.ct;
  const float* g = gbuf + ((int64_t)row * sh.nc + ci) * sh.c * sh.c;
  float4 gq[kQuads], cq[kQuads];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int r = quad_row(i), c4 = quad_col(i);
    const bool in = r < sh.c;
    gq[i] = in ? load_quad(g + r * sh.c + c4, sh.vec & kVecG,
                           min(sh.c, r + 1) - c4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    cq[i] = in ? load_quad(crow + r * sd.ct + c4, sh.vec & kVecC, sh.n - c4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();  // hi, lo, grow
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int r = quad_row(i), c4 = quad_col(i);
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f), cv = m;
    if (r < sh.c) {
      const float hr = hi[r], lr = lo[r];
      auto weight = [&](float gv, int s) {
        return s <= r ? gv * expf(fminf((hr - hi[s]) + (lr - lo[s]), 0.f))
                      : 0.f;
      };
      m = make_float4(weight(gq[i].x, c4), weight(gq[i].y, c4 + 1),
                      weight(gq[i].z, c4 + 2), weight(gq[i].w, c4 + 3));
      const float e = grow[r];
      cv = make_float4(cq[i].x * e, cq[i].y * e, cq[i].z * e, cq[i].w * e);
    }
    *reinterpret_cast<float4*>(ms + r * kLdA + c4) = m;
    *reinterpret_cast<float4*>(cs + r * kLdA + c4) = cv;
  }
  __syncthreads();

  if (r0 >= sh.c) return;
  float acc[kNT][4];
  zero(acc);
  // (G o L) x: rows r0 .. r0 + 15 need s <= r0 + 15 only.
  mma_3xtf32(
      acc, r0, c0, min((sh.c + 7) / 8, (r0 + 16) / 8),
      [&](int r, int k) { return ms[r * kLdA + k]; },
      [&](int k, int col) { return xs[k * kLdB + col]; });
  if (ci > 0)  // + exp(ca) (C h_in)
    mma_3xtf32(
        acc, r0, c0, (sh.n + 7) / 8,
        [&](int r, int k) { return cs[r * kLdA + k]; },
        [&](int k, int col) { return hs[k * kLdB + col]; });
  store_tile(acc, r0, c0,
             y + (((int64_t)row * sh.t + t0) * sh.nh + head) * sh.p + p0,
             (int64_t)sh.nh * sh.p, sh.c, pw);
}

constexpr int kStateSmem = 4 * (2 * kTileB + kTileA + 3 * kTile) + 8;
constexpr int kOutputSmem = 4 * (2 * kTileA + 2 * kTileB + 3 * kTile) + 8;

template <typename T>
int launch(const void* x, const void* a, const void* b_, const void* c_,
           void* y, void* h, void* states, void* gbuf, void* decay, int b,
           const Shape& sh, const Strides& sd, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be asked for; done on
  // the first launch, before any graph capture of it.
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStateSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_output_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kOutputSmem);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  const dim3 grid(sh.nc, sh.nh * sh.ptiles, b);
  ssd_state_kernel<T><<<grid, kThreads, kStateSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b_), static_cast<const T*>(c_),
      static_cast<float*>(states), static_cast<float*>(gbuf),
      static_cast<float*>(decay), sh, sd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int np = sh.n * sh.p;  // the buffers are 256-byte aligned
  if (np % 4 == 0) {
    const int64_t total = (int64_t)b * sh.nh * (np / 4);
    ssd_pass_kernel<float4><<<(unsigned)((total + 255) / 256), 256, 0,
                              stream>>>(
        static_cast<float4*>(states), static_cast<const float*>(decay),
        static_cast<float4*>(h), sh.nc, np / 4, total);
  } else {
    const int64_t total = (int64_t)b * sh.nh * np;
    ssd_pass_kernel<float><<<(unsigned)((total + 255) / 256), 256, 0,
                             stream>>>(
        static_cast<float*>(states), static_cast<const float*>(decay),
        static_cast<float*>(h), sh.nc, np, total);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_output_kernel<T><<<grid, kThreads, kOutputSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(c_), static_cast<const float*>(states),
      static_cast<const float*>(gbuf), static_cast<float*>(y), sh, sd);
  return (int)cudaGetLastError();
}

}  // namespace

// y (B, T, H, P) float32; h (B, H, N, P) float32; scratch: states (B, H,
// T / C, N, P), gbuf (B, T / C, C, C), decay (B, H, T / C), all float32.
extern "C" int mamba2_ssd_launch(
    const void* x, const void* a, const void* b_, const void* c_, void* y,
    void* h, void* states, void* gbuf, void* decay, int b, int nh, int t,
    int p, int n, int c, int64_t xb, int64_t xh, int64_t xt, int64_t ab,
    int64_t ah, int64_t at, int64_t bb, int64_t bt, int64_t cb, int64_t ct,
    int dtype, void* stream) {
  if (b < 1 || nh < 1 || p < 1 || n < 1 || n > kTile || c < 1 ||
      c > kTile || t < c || t % c != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sd{xb, xh, xt, ab, ah, at, bb, bt, cb, ct};
  // Rows read four elements at a time: every row start 4-element aligned.
  const uintptr_t lanes = dtype == 0 ? 16 : 8;  // bytes of four elements
  auto rows4 = [&](const void* ptr, int64_t s0, int64_t s1, int64_t s2,
                   int width) {
    return reinterpret_cast<uintptr_t>(ptr) % lanes == 0 && s0 % 4 == 0 &&
           s1 % 4 == 0 && s2 % 4 == 0 && width % 4 == 0;
  };
  const int vec = (rows4(x, xb, xh, xt, p) ? kVecX : 0) |
                  (rows4(b_, bb, bt, 0, n) ? kVecB : 0) |
                  (rows4(c_, cb, ct, 0, n) ? kVecC : 0) |
                  (p % 4 == 0 ? kVecS : 0) | (c % 4 == 0 ? kVecG : 0);
  const Shape sh{nh, t, p, n, c, t / c, (p + kTile - 1) / kTile, vec};
  if (dtype == 0)
    return launch<float>(x, a, b_, c_, y, h, states, gbuf, decay, b, sh, sd,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b_, c_, y, h, states, gbuf, decay, b,
                                 sh, sd, st);
  return (int)cudaErrorInvalidValue;
}
