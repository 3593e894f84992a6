// RWKV6 (Finch) wkv scan, written by hand for Hopper (sm_90a):
// chunk-parallel, products on the tensor cores (3xTF32).
//
// What it replaces: src/repro/kernels/rwkv6_scan/kernel.py
//   rwkv6_scan_launch -> rwkv6_scan_pallas (body _rwkv6_kernel)
// Contract (the op's, ref.py): per (b, h), from a zero state S (K x V),
//   o_t[j]   = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
//   S[i, j] <- exp(w_log_t[i]) S[i, j] + k_t[i] v_t[j]
// r, k, w_log (B, H, T, K) and v (B, H, T, V), float32 or bfloat16 (one
// type for the four; bf16 is widened to float32 as it is staged), read
// through their strides in elements (the last dim contiguous): the model
// hands them over as (B, T, H, .) tensors seen transposed.  u (H, K)
// float32 contiguous.  o float32 is written into a (B, T, H, V) buffer, the
// model's layout, which the wrapper returns as its (B, H, T, V) view; the
// final S (B, H, K, V) float32.  T is a multiple of the chunk C <= 64;
// any K (64 channels a tile) and any V (64 columns a CTA).
//
// Design.  The TPU kernel walked the chunks of one (b, h) in order, as the
// sequential axis of its grid, with S in VMEM.  Here the chunked
// decomposition (chunked.py, rwkv6_scan_chunk_parallel) runs as three
// launches, two of them over all (chunk, head, V tile, batch row): at
// RWKV6-3B's prefill (one K tile) 5,120 CTAs, against one CTA per (b, h), 160, that
// walked 32 chunks in order.  W is the chunk's inclusive cumsum of w_log,
// per channel, summed in float64 (a thread per channel and quarter of the
// chunk) and kept as float32 pairs hi + lo; the exclusive We_t is W_{t-1}.
//   1. rwkv_state_kernel, per chunk and K tile: the chunk's own state
//      dS = (k exp(W_C - W))^T v (K x V) and its decay exp(W_C) (K), to
//      device memory.
//   2. rwkv_pass_kernel, per state element of each (b, h): in order over
//      the chunks, S_n = exp(W_C,n)[i] S_{n-1} + dS_n, writing each chunk's
//      incoming state over its dS (in place) and the last S as the final
//      state.
//   3. rwkv_output_kernel, per chunk: o = A v + (r exp(We)) S_in, with A
//      the pair weights A[t][s] = sum_i r_t[i] k_s[i] exp(We_t[i] - W_s[i])
//      for s < t and the bonus r_t . u . k_t on the diagonal.  Both terms
//      are sums over the channels i, so a K above 64 takes one launch per
//      tile of 64 channels, in order, each after the first adding its
//      share to o.
// A by secondary chunking (Yang et al., Gated Linear Attention, 2023, §4),
// in levels: the chunk is cut into leaves of kLeaf = 8 rows; in each block
// of 2h rows (h = 8, 16, 32), for t in the upper half and s in the lower
// half, with e the lower half's last row,
//   exp(We_t - W_s) = exp(We_t - W_e) exp(W_e - W_s),
// both exponents <= 0 (w_log < 0), so neither factor can overflow and the
// pairs are one product of a scaled r and a scaled k on the tensor cores.
// Each row lies on one side of one block per level, so a level's operands
// are one (t, i) array, written over an input the leaves no longer need.
// (The Pallas body's split into exp(We) and exp(-W) overflows float32 once
// a chunk's summed decay passes about 88, which a strong decay, w_log =
// -exp(2 z), reaches within a chunk.)  Only the leaves keep the per-pair
// log-space form, each exponent clamped at 0 and taken as (hi_t - hi_s) +
// (lo_t - lo_s): a strong decay makes |W| reach hundreds within a chunk,
// where a difference of float32 cumsums would lose the small exponents of
// nearby pairs.  At C = 32 that is 4 * 28 * 64 = 7,168 exponentials a
// chunk, against 31,744 when every pair took its own; with the operands,
// about 15,400 a chunk.  Shared memory is 72 KB a CTA at C = 32, so three
// CTAs share an SM.
//
// The products (A's blocks below the leaves, dS, A v, (r exp(We)) S_in)
// run as 3xTF32 on mma.sync.m16n8k8 (../../csrc/tf32_tiles.cuh, shared
// with the SSD scan); with a bf16 v, exact in TF32, dS and A v take two
// products, not three.  Operands sit in shared memory as float32 rows of
// 68 words (read along the row) or 72 words (read down a column), so each
// fragment load hits 32 distinct banks.
//
// What bounds it on an H100.  RWKV6-3B's prefill (B 4, H 40, T 1024,
// K = V = 64, C 32, bf16 in) needs 3.376 GFLOP: the chunked form's
// products, the intra-chunk ones over the pairs s <= t.  At the float32
// CUDA-core peak (67 TFLOP/s) that is 50.4 us, the bound the kernel table
// keeps.  On the tensor cores the three TF32 products are 10.1 GFLOP,
// 20.5 us at 495 TFLOP/s; then bytes bound it: the function's own 128.5 MB
// (r, k, v, w_log read once, o and S written once) take 38.4 us at 3.35
// TB/s.  This design adds the chunk states, (4, 40, 32, 64, 64) float32 =
// 83.9 MB, written by launch 1, read and written by launch 2, read by
// launch 3, and a second read of k, v and w_log: about 527 MB, 157 us
// (chip_smoke.py, rwkv_tensor_core_bound).  Its exponentials, about 79 M a
// scan, take some 19 us at 16 MUFU.EX2 a clock per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32_tiles;

constexpr int kLeaf = 8;       // rows of A's diagonal sub-blocks
constexpr int kTile = 64;      // K rows and V columns of a tile; C <= 64
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdA = 68;       // rows read along the row: 4 (mod 32) words
constexpr int kLdB = 72;       // rows read down a column: 8 (mod 32) words

struct Strides {  // (b, h, t) of r, k, v, w_log in elements; last dims 1
  int64_t rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt;
};

struct Shape {
  int nh, t, dk, dv, c, nc, vtiles, ktiles;
  int vec;  // kVec* bits: which rows may be read 16 bytes at a time
};

constexpr int kVecR = 1, kVecK = 2, kVecV = 4, kVecW = 8, kVecS = 16;

// Sixteen bytes of a row (4 floats or 8 bf16) as float32, the last `left`
// elements of which lie in the row; one 16-byte load when vec and the
// piece is whole.
__device__ __forceinline__ void load_piece(const float* p, bool vec, int left,
                                           float4 (&out)[1]) {
  out[0] = load_quad(p, vec, left);
}
__device__ __forceinline__ float4 widen(uint32_t a, uint32_t b) {
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 y =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return make_float4(x.x, x.y, y.x, y.y);
}
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, bool vec,
                                           int left, float4 (&out)[2]) {
  if (vec && left >= 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    out[0] = widen(u.x, u.y);
    out[1] = widen(u.z, u.w);
  } else {
    out[0] = load_quad(p, vec, left);
    out[1] = load_quad(p + 4, vec, left - 4);
  }
}

// A (kRows x 64) tile of a row-major source on its way to shared memory as
// float32: rows r < nr, columns col < nw of src (row stride ld, in
// elements), zero elsewhere.  load() issues every load of the tile and
// store() writes it, so that the loads of several tiles are in flight
// together.
template <int kRows, typename T>
struct Tile {
  static constexpr int kE = 16 / sizeof(T);  // elements of a piece
  static constexpr int kQ = kE / 4;          // float4s it widens to
  static constexpr int kPerRow = kTile / kE;
  static constexpr int kPieces = kRows * kPerRow;
  static constexpr int kIters = (kPieces + kThreads - 1) / kThreads;
  float4 v[kIters][kQ];

  __device__ __forceinline__ void load(const T* __restrict__ src, int64_t ld,
                                       int nr, int nw, bool vec) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int r = q / kPerRow, c0 = (q % kPerRow) * kE;
      if (q < kPieces && r < nr) {
        load_piece(src + r * ld + c0, vec, nw - c0, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < kQ; ++j) v[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int ldd) const {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (q >= kPieces) continue;
      const int r = q / kPerRow, c0 = (q % kPerRow) * kE;
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        *reinterpret_cast<float4*>(dst + r * ldd + c0 + 4 * j) = v[i][j];
    }
  }
};

// The chunk's cumsum of w_log, per channel, in float64: w holds w_log
// (rows < kRows, 64 columns, row stride kLdA; zero past the chunk and past
// K) and becomes the inclusive W as hi (in w) + lo.  Thread (q, i) sums
// rows q kRows / 4 .. (q + 1) kRows / 4 - 1 of channel i in order; the
// four segments' totals meet in sums (4 x 64 doubles).  Ends with a
// barrier.  The exclusive We_t is W_{t-1}: the output kernel keeps a zero
// row before W.
template <int kRows>
__device__ __forceinline__ void chunk_cumsum(float* w, float* lo,
                                             double* sums) {
  constexpr int kSeg = kRows / 4;
  static_assert(kThreads == 4 * kTile, "a thread per (segment, channel)");
  const int ch = threadIdx.x % kTile, seg = threadIdx.x / kTile;
  float* wq = w + seg * kSeg * kLdA + ch;
  double run[kSeg];
  double sum = 0.0;
#pragma unroll
  for (int m = 0; m < kSeg; ++m) run[m] = sum += (double)wq[m * kLdA];
  sums[threadIdx.x] = sum;
  __syncthreads();
  double off = 0.0;
  for (int q = 0; q < seg; ++q) off += sums[q * kTile + ch];
#pragma unroll
  for (int m = 0; m < kSeg; ++m) {
    const double x = off + run[m];
    const float h = (float)x;
    wq[m * kLdA] = h;
    lo[seg * kSeg * kLdA + ch + m * kLdA] = (float)(x - (double)h);
  }
  __syncthreads();
}

constexpr int kPart = 4 * kTile;  // doubles of chunk_cumsum's segment sums

template <int kRows>
constexpr int state_smem() {
  return 8 * kPart + 4 * (2 * kRows * kLdA + 2 * kRows * kLdB);
}

template <int kRows, typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ w, float* __restrict__ states,
                  float* __restrict__ decay, Shape sh, Strides sd) {
  extern __shared__ double smem_d[];
  double* seg_sums = smem_d;
  // (s, i): w_log, then W (hi)
  float* wh = reinterpret_cast<float*>(seg_sums + kPart);
  float* wl = wh + kRows * kLdA; // W (lo)
  float* ks = wl + kRows * kLdA; // (s, i): k, then k exp(W_C - W)
  float* vs = ks + kRows * kLdB; // (s, j)

  const int ci = blockIdx.x, row = blockIdx.z;
  const int vt = blockIdx.y % sh.vtiles;
  const int kt = blockIdx.y / sh.vtiles % sh.ktiles;
  const int head = blockIdx.y / (sh.vtiles * sh.ktiles);
  const int t0 = ci * sh.c, v0 = vt * kTile, k0 = kt * kTile;
  const int vw = min(kTile, sh.dv - v0), kw = min(kTile, sh.dk - k0);
  const int64_t bh = (int64_t)row * sh.nh + head;

  {
    Tile<kRows, T> tw, tk, tv;
    tw.load(w + row * sd.wb + head * sd.wh + t0 * sd.wt + k0, sd.wt, sh.c, kw,
            sh.vec & kVecW);
    tk.load(k + row * sd.kb + head * sd.kh + t0 * sd.kt + k0, sd.kt, sh.c, kw,
            sh.vec & kVecK);
    tv.load(v + row * sd.vb + head * sd.vh + t0 * sd.vt + v0, sd.vt, sh.c, vw,
            sh.vec & kVecV);
    tw.store(wh, kLdA);
    tk.store(ks, kLdB);
    tv.store(vs, kLdB);
  }
  __syncthreads();
  chunk_cumsum<kRows>(wh, wl, seg_sums);
  const float* hc = wh + (sh.c - 1) * kLdA;  // W_C
  const float* lc = wl + (sh.c - 1) * kLdA;
  for (int e = threadIdx.x; e < sh.c * kTile; e += kThreads) {
    const int s = e / kTile, i = e % kTile, at = s * kLdA + i;
    ks[s * kLdB + i] *= expf((hc[i] - wh[at]) + (lc[i] - wl[at]));
  }
  if (vt == 0)
    for (int i = threadIdx.x; i < kw; i += kThreads)
      decay[(bh * sh.nc + ci) * sh.dk + k0 + i] = expf(hc[i] + lc[i]);
  __syncthreads();

  // dS[i][j] = sum_s k^[s][i] v[s][j]: warps of 16 rows (channels) x 32
  // columns.
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  if (r0 >= kw) return;
  float acc[4][4];
  zero(acc);
  mma_3xtf32(
      acc, r0, c0, (sh.c + 7) / 8,
      [&](int r, int kk) { return ks[kk * kLdB + r]; },
      [&](int kk, int col) { return vs[kk * kLdB + col]; },
      sizeof(T) == 2);  // a bf16 v is exact in TF32
  store_tile(acc, r0, c0,
             states + ((bh * sh.nc + ci) * sh.dk + k0) * sh.dv + v0, sh.dv,
             kw, vw);
}

__device__ __forceinline__ float4 pass_step(float d, float4 s, float4 own) {
  return make_float4(d * s.x + own.x, d * s.y + own.y, d * s.z + own.z,
                     d * s.w + own.w);
}
__device__ __forceinline__ float pass_step(float d, float s, float own) {
  return d * s + own;
}

// One thread per element (V = float) or four (V = float4) of a (b, h)
// state: S_n = exp(W_C,n)[i] S_{n-1} + dS_n, in order over the chunks.
// Each dS_n is replaced by the chunk's incoming state S_{n-1} (chunk 0's,
// zero, is not written: the output launch skips it).  Eight chunks' dS are
// loaded before any is overwritten, so eight loads are in flight; both
// ways the states stream (ld/st.global.cs: touched once here, and far more
// than the L2 holds).
template <typename V>
__global__ void __launch_bounds__(256)
rwkv_pass_kernel(V* __restrict__ states, const float* __restrict__ decay,
                 V* __restrict__ s_out, int nc, int dk, int nv,
                 int64_t total) {
  constexpr int kBatch = 8;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t per = (int64_t)dk * nv;  // V elements of one state
  const int64_t bh = idx / per, e = idx % per;
  V* s = states + bh * nc * per + e;
  const float* d = decay + bh * nc * dk + e / nv;
  V h;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    V own[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (c0 + q < nc) own[q] = __ldcs(s + (int64_t)(c0 + q) * per);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int ci = c0 + q;
      if (ci >= nc) break;
      if (ci == 0) {
        h = own[q];
      } else {
        __stcs(s + (int64_t)ci * per, h);
        h = pass_step(d[(int64_t)ci * dk], h, own[q]);
      }
    }
  }
  s_out[idx] = h;
}

// Levels of the off-diagonal products: leaves of 8 rows paired in halves
// of 8, 16, 32 rows.
template <int kRows>
__host__ __device__ constexpr int levels() {
  return kRows <= 16 ? 1 : kRows <= 32 ? 2 : 3;
}

template <int kRows>
constexpr int output_smem() {
  // the segment sums; r, k, W (hi), W (lo) and A; two zero rows; v; the
  // incoming state
  return 8 * kPart +
         4 * (5 * kRows * kLdA + 2 * kLdA + kRows * kLdB + kTile * kLdB);
}

// Up to 32 rows three CTAs share an SM (72 KB of shared memory each at
// 32), which holds a CTA to 85 registers a thread.
template <int kRows, typename T>
__global__ void __launch_bounds__(kThreads, kRows <= 32 ? 3 : 1)
rwkv_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ states, float* __restrict__ o,
                   Shape sh, Strides sd, int k0) {
  extern __shared__ double smem_d[];
  double* seg_sums = smem_d;
  float* smem = reinterpret_cast<float*>(seg_sums + kPart);
  constexpr int kA = kRows * kLdA, kLevels = levels<kRows>();
  // Each (t, i) array holds its input until the diagonal walk is done, then
  // an operand of the products: r, then r exp(We); k, then the first
  // level's operands; W (hi) after a zero row (row t - 1 is We_t), then the
  // second level's; W (lo) likewise, then the third's.
  float* rs = smem;
  float* ks = rs + kA;
  float* wh = ks + kA + kLdA;
  float* wl = wh + kA + kLdA;
  float* as = wl + kA;  // (t, s): A
  float* vs = as + kA;  // (s, j)
  float* ss = vs + kRows * kLdB;  // (i, j): the incoming state
  float* const xs[3] = {ks, wh, wl};

  const int ci = blockIdx.x, row = blockIdx.z;
  const int head = blockIdx.y / sh.vtiles, vt = blockIdx.y % sh.vtiles;
  const int t0 = ci * sh.c, v0 = vt * kTile;
  const int vw = min(kTile, sh.dv - v0), kw = min(kTile, sh.dk - k0);
  const int64_t bh = (int64_t)row * sh.nh + head;
  const bool carry = ci > 0;  // chunk 0 starts from the zero state
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  {
    Tile<kRows, T> tr, tk, tw, tv;
    Tile<kTile, float> ts;
    tr.load(r + row * sd.rb + head * sd.rh + t0 * sd.rt + k0, sd.rt, sh.c, kw,
            sh.vec & kVecR);
    tk.load(k + row * sd.kb + head * sd.kh + t0 * sd.kt + k0, sd.kt, sh.c, kw,
            sh.vec & kVecK);
    tw.load(w + row * sd.wb + head * sd.wh + t0 * sd.wt + k0, sd.wt, sh.c, kw,
            sh.vec & kVecW);
    tv.load(v + row * sd.vb + head * sd.vh + t0 * sd.vt + v0, sd.vt, sh.c, vw,
            sh.vec & kVecV);
    if (carry)
      ts.load(states + ((bh * sh.nc + ci) * sh.dk + k0) * sh.dv + v0, sh.dv,
              kw, vw, sh.vec & kVecS);
    tr.store(rs, kLdA);
    tk.store(ks, kLdA);
    tw.store(wh, kLdA);
    tv.store(vs, kLdB);
    if (carry) ts.store(ss, kLdB);
    for (int i = tid; i < kTile; i += kThreads) wh[i - kLdA] = wl[i - kLdA] = 0.f;
  }
  __syncthreads();
  chunk_cumsum<kRows>(wh, wl, seg_sums);

  // A above the diagonal, within each row's 16-row tile: zero.
  for (int e = tid; e < kRows * 16; e += kThreads) {
    const int t = e / 16, s = t / 16 * 16 + e % 16;
    if (s > t) as[t * kLdA + s] = 0.f;
  }
  // A's leaves (diagonal sub-blocks of kLeaf rows) in log space, the bonus
  // on the diagonal: a group of kParts lanes per row t, each lane kCh
  // channels (float4s part, part + kParts, ...), with row t's r and We in
  // registers while s walks the leaf; the groups of a warp read the same
  // row s.  After its walk each lane forms row t's operands: r exp(We_t),
  // written over r at once (no other lane reads row t of r), and per level,
  // within each block of 2h rows, the upper half's r exp(We_t - W_e) or the
  // lower half's k exp(W_e - W_t), e the lower half's last row, written
  // over k and W once every walk is done.
  constexpr int kParts = kThreads / kRows, kCh = kTile / kParts;
  constexpr int kVec = kCh / 4;
  const int t = tid / kParts, part = tid % kParts;
  float4 xl[kLevels][kVec];
  {
    const int blk = t / kLeaf * kLeaf;
    // the warp's rows lie in one leaf; its last row bounds the walk
    const int walk = (warp + 1) * (32 / kParts) - 1 - blk;
    float4 rt[kVec], e1[kVec], e2[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int at = t * kLdA + 4 * (part + kParts * q);
      rt[q] = *reinterpret_cast<const float4*>(rs + at);
      e1[q] = *reinterpret_cast<const float4*>(wh + at - kLdA);
      e2[q] = *reinterpret_cast<const float4*>(wl + at - kLdA);
    }
    auto scaled = [](float4 x, float4 a1, float4 b1, float4 a2, float4 b2) {
      // x exp((a1 - b1) + (a2 - b2))
      return make_float4(x.x * expf((a1.x - b1.x) + (a2.x - b2.x)),
                         x.y * expf((a1.y - b1.y) + (a2.y - b2.y)),
                         x.z * expf((a1.z - b1.z) + (a2.z - b2.z)),
                         x.w * expf((a1.w - b1.w) + (a2.w - b2.w)));
    };
    for (int j = 0; j <= walk; ++j) {
      const int s = blk + j;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const int c = 4 * (part + kParts * q), at = s * kLdA + c;
        const float4 b = *reinterpret_cast<const float4*>(ks + at);
        if (s > t) continue;
        const float4 a = rt[q];
        if (s < t) {
          const float4 h1 = *reinterpret_cast<const float4*>(wh + at);
          const float4 h2 = *reinterpret_cast<const float4*>(wl + at);
          const float4 x1 = e1[q], x2 = e2[q];
          acc += a.x * b.x * expf(fminf((x1.x - h1.x) + (x2.x - h2.x), 0.f));
          acc += a.y * b.y * expf(fminf((x1.y - h1.y) + (x2.y - h2.y), 0.f));
          acc += a.z * b.z * expf(fminf((x1.z - h1.z) + (x2.z - h2.z), 0.f));
          acc += a.w * b.w * expf(fminf((x1.w - h1.w) + (x2.w - h2.w), 0.f));
          continue;
        }
        const float* uh = u + (int64_t)head * sh.dk + k0 + c;  // s == t
        acc += (c < kw ? a.x * __ldg(uh) * b.x : 0.f) +
               (c + 1 < kw ? a.y * __ldg(uh + 1) * b.y : 0.f) +
               (c + 2 < kw ? a.z * __ldg(uh + 2) * b.z : 0.f) +
               (c + 3 < kw ? a.w * __ldg(uh + 3) * b.w : 0.f);
      }
#pragma unroll
      for (int off = 1; off < kParts; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0 && s <= t) as[t * kLdA + s] = acc;
    }
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int c = 4 * (part + kParts * q), at = t * kLdA + c;
      if (carry)
        *reinterpret_cast<float4*>(rs + at) = scaled(rt[q], e1[q], z, e2[q], z);
      const float4 kt = *reinterpret_cast<const float4*>(ks + at);
      const float4 h1 = *reinterpret_cast<const float4*>(wh + at);
      const float4 h2 = *reinterpret_cast<const float4*>(wl + at);
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        const int h = kLeaf << l;
        const int last = ((t / (2 * h)) * 2 * h + h - 1) * kLdA + c;
        const float4 hl = *reinterpret_cast<const float4*>(wh + last);
        const float4 ll = *reinterpret_cast<const float4*>(wl + last);
        xl[l][q] = t % (2 * h) >= h ? scaled(rt[q], e1[q], hl, e2[q], ll)
                                    : scaled(kt, hl, h1, ll, h2);
      }
    }
  }
  __syncthreads();  // every walk is done with k and W
#pragma unroll
  for (int q = 0; q < kVec; ++q)
#pragma unroll
    for (int l = 0; l < kLevels; ++l)
      *reinterpret_cast<float4*>(xs[l] + t * kLdA + 4 * (part + kParts * q)) =
          xl[l][q];
  __syncthreads();

  // o's tile: warps of 16 rows x 8 kNT columns, kRows / 16 row tiles.
  constexpr int kNT = kRows / 16;
  const int r0 = 16 * (warp % kNT), c0 = 8 * kNT * (warp / kNT);
  float acc[kNT][4];
  zero(acc);
  if (carry)  // (r exp(We)) S_in
    mma_3xtf32(
        acc, r0, c0, (kw + 7) / 8,
        [&](int rr, int kk) { return rs[rr * kLdA + kk]; },
        [&](int kk, int col) { return ss[kk * kLdB + col]; });
  // A below the leaves, one level at a time: in each block of 2h rows,
  // A[t][s] = X[t] . X[s] for t in the upper half and s in the lower one
  // (X the level's operands), one n8 tile of t and one m16 tile of s a
  // warp, transposed (rows s, columns t).
  {
    int idx = 0;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      const int h = kLeaf << l;
      const float* x = xs[l];
      for (int base = 0; base + h < sh.c; base += 2 * h)
        for (int jt = 0; jt < h / 8; ++jt)
          for (int m = 0; 16 * m < h; ++m, ++idx) {
            if (idx % (kThreads / 32) != warp) continue;
            const int s0 = base + 16 * m, tc = base + h + 8 * jt;
            const int sl = base + h;  // rows s < sl lie in the lower half
            float at[1][4];
            zero(at);
            mma_3xtf32(
                at, s0, tc, (kw + 7) / 8,
                [&](int s, int kk) { return s < sl ? x[s * kLdA + kk] : 0.f; },
                [&](int kk, int tt) { return x[tt * kLdA + kk]; });
            const int g = lane >> 2, tt = tc + 2 * (lane & 3);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int s = s0 + g + 8 * half;
              if (s < sl) {
                as[tt * kLdA + s] = at[0][2 * half];
                as[(tt + 1) * kLdA + s] = at[0][2 * half + 1];
              }
            }
          }
    }
  }
  __syncthreads();

  // + A v: rows r0 .. r0 + 15 need s <= r0 + 15 only.  A bf16 v is exact
  // in TF32, so its lo part, and the product with it, is zero.
  mma_3xtf32(
      acc, r0, c0, min((sh.c + 7) / 8, (r0 + 16) / 8),
      [&](int rr, int kk) { return as[rr * kLdA + kk]; },
      [&](int kk, int col) { return vs[kk * kLdB + col]; },
      sizeof(T) == 2);
  // The first channel tile writes o; each later one adds its share.
  store_tile(acc, r0, c0,
             o + (((int64_t)row * sh.t + t0) * sh.nh + head) * sh.dv + v0,
             (int64_t)sh.nh * sh.dv, sh.c, vw, k0 > 0);
}

template <int kRows, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, void* s, void* states, void* decay, int b,
           const Shape& sh, const Strides& sd, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be asked for; done on
  // the first launch, before any graph capture of it.
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv_state_kernel<kRows, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem<kRows>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv_output_kernel<kRows, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 output_smem<kRows>());
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  const dim3 grid(sh.nc, sh.nh * sh.vtiles, b);
  const dim3 state_grid(sh.nc, sh.nh * sh.ktiles * sh.vtiles, b);
  rwkv_state_kernel<kRows, T><<<state_grid, kThreads, state_smem<kRows>(),
                                stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<float*>(states),
      static_cast<float*>(decay), sh, sd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (sh.dv % 4 == 0) {  // the buffers are 256-byte aligned
    const int nv = sh.dv / 4;
    const int64_t total = (int64_t)b * sh.nh * sh.dk * nv;
    rwkv_pass_kernel<float4><<<(unsigned)((total + 255) / 256), 256, 0,
                               stream>>>(
        static_cast<float4*>(states), static_cast<const float*>(decay),
        static_cast<float4*>(s), sh.nc, sh.dk, nv, total);
  } else {
    const int64_t total = (int64_t)b * sh.nh * sh.dk * sh.dv;
    rwkv_pass_kernel<float><<<(unsigned)((total + 255) / 256), 256, 0,
                              stream>>>(
        static_cast<float*>(states), static_cast<const float*>(decay),
        static_cast<float*>(s), sh.nc, sh.dk, sh.dv, total);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // o sums over the channels: one launch per tile of 64, in order, each
  // after the first adding its share.
  for (int k0 = 0; k0 < sh.dk && err == cudaSuccess; k0 += kTile) {
    rwkv_output_kernel<kRows, T><<<grid, kThreads, output_smem<kRows>(),
                                   stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(w),
        static_cast<const float*>(u), static_cast<const float*>(states),
        static_cast<float*>(o), sh, sd, k0);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T>
int launch_rows(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* o, void* s, void* states, void* decay,
                int b, const Shape& sh, const Strides& sd,
                cudaStream_t stream) {
  if (sh.c <= 16)
    return launch<16, T>(r, k, v, w, u, o, s, states, decay, b, sh, sd,
                         stream);
  if (sh.c <= 32)
    return launch<32, T>(r, k, v, w, u, o, s, states, decay, b, sh, sd,
                         stream);
  return launch<64, T>(r, k, v, w, u, o, s, states, decay, b, sh, sd, stream);
}

}  // namespace

// o (B, T, H, V) float32; s (B, H, K, V) float32; scratch: states (B, H,
// T / C, K, V) and decay (B, H, T / C, K), float32.
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    void* o, void* s, void* states, void* decay, int b, int h, int t, int dk,
    int dv, int c, int64_t rb, int64_t rh, int64_t rt, int64_t kb, int64_t kh,
    int64_t kt, int64_t vb, int64_t vh, int64_t vt, int64_t wb, int64_t wh,
    int64_t wt, int dtype, void* stream) {
  if (b < 1 || h < 1 || dk < 1 || dv < 1 || c < 1 || c > kTile || t < c ||
      t % c != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sd{rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt};
  // Rows read 16 bytes at a time: every row start 16-byte aligned.
  const int64_t lanes = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  auto rows16 = [&](const void* ptr, int64_t s0, int64_t s1, int64_t s2) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % lanes == 0 &&
           s1 % lanes == 0 && s2 % lanes == 0;
  };
  const int vec = (rows16(r, rb, rh, rt) ? kVecR : 0) |
                  (rows16(k, kb, kh, kt) ? kVecK : 0) |
                  (rows16(v, vb, vh, vt) ? kVecV : 0) |
                  (rows16(w, wb, wh, wt) ? kVecW : 0) |
                  (dv % 4 == 0 ? kVecS : 0);
  const Shape sh{h, t, dk, dv, c, t / c, (dv + kTile - 1) / kTile,
                 (dk + kTile - 1) / kTile, vec};
  if (dtype == 0)
    return launch_rows<float>(r, k, v, w, u, o, s, states, decay, b, sh, sd,
                              st);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(r, k, v, w, u, o, s, states, decay, b,
                                      sh, sd, st);
  return (int)cudaErrorInvalidValue;
}
