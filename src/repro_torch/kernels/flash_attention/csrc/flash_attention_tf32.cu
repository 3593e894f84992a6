// Flash attention (blockwise online softmax) on Hopper's tensor cores in
// 3xTF32, written by hand for sm_90a: the float32 instance of
// flash_attention_pallas at head dims 8, 16, 32, 64, 128 and 160, and the
// bf16 instance at 8, 16, 32 and 160.  bf16 at head dims 64 and 128 runs on
// wgmma (flash_attention_wgmma.cu); kernel.py's route() picks the instance.
//
// What it replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_pallas (body _flash_kernel)
// Contract (the Pallas kernel's): q (B, Hq, S, D), k / v (B, Hkv, S, D),
// f32 or bf16, read through their strides (the last dim contiguous); query
// head h reads kv head h / (Hq / Hkv) (the BlockSpec index map: no
// repeated heads); softmax scale given by the caller; causal or full; the
// running (m, l, acc) in f32, masked logits -1e30, output acc / l with l
// guarded (l > 0 ? l : 1), stored in q's type (bf16 rounded to nearest
// even, as Tensor.to rounds) through its strides (the wrapper hands a
// (B, S, Hq, D) buffer seen as (B, Hq, S, D)).
//
// What bounds it on an H100.  At the float32 main shape (TinyLlama-1.1B
// prefill in float32: q (4, 32, 1024, 64), kv heads 4, causal) the function
// needs 17.2 GFLOP against 75.5 MB moved once: 257 us on the CUDA cores'
// 67 TFLOP/s, the bound the kernel table keeps.  The tensor cores take
// TF32 only, which rounds its inputs to 10 bits (about 5e-4 relative), far
// past the reference's float32 gate of 2e-5.  3xTF32 keeps float32
// accuracy there: x = hi + lo, both TF32 (cvt.rna), and a product is
// lo.hi + hi.lo + hi.hi, each exact in the f32 accumulator (only lo.lo,
// 2^-22 relative, is dropped); three products at 495 TFLOP/s are 104 us.
// bf16 inputs are exact in TF32: Q K^T is one product, and P V two (P is
// f32, V exact).  At Zamba2-2.7B's shared attention (q (4, 32, 1024, 160)
// bf16, kv heads 32, causal) that floor is 130 us, where the function's
// own bound is 50 us of bytes.
//
// Design.  The TPU grid (B, Hq, S/bq, S/bk) ran its kv axis in order on one
// core, carrying (m, l, acc) in VMEM scratch.  Here one CTA takes a block
// of query rows of one (b, q-head), each warp 16 or 32 of them (Smem: 4
// warps of 32 rows up to D = 64, 8 warps of 16 rows at 128 and 160), and
// walks the keys of kv head h / group in tiles of 32 or 64.
//   * Q is staged once and the (K, V) tiles double-buffered in shared
//     memory in the inputs' own type, with 16-byte cp.async where the base
//     and the strides allow (zero-filled past S), else with scalar loads.
//     Row pitches keep every fragment load free of bank conflicts.
//   * S = Q K^T on mma.sync.m16n8k8 (tf32_tiles.cuh mma_tf32).  Its k
//     index is taken as dims in pairs (t is dim 2t, t + 4 dim 2t + 1 of
//     the step, for Q and K alike, which leaves the sum as it is), so a
//     lane reads its two elements of a row of Q or K in one load.  A
//     fragment of K is read and split once for all m16 tiles of the warp.
//   * The operands are split on the bits (split_tf32_bits: cvt.rna's
//     rounding in five instructions; 1.27x faster than two cvt.rna at the
//     main shape on an H100, scripts/sweep_flash_tf32.py).
//   * The online softmax runs on S's accumulator fragment (rows g, g + 8;
//     columns 2t, 2t + 1) in the log2 domain: scale * log2 e folded into
//     the one multiply, exp2f, the row max across the 4 lanes of a row
//     (two shuffles), l kept as each lane's partial sum and summed across
//     the row once at the end.  The mask is applied only on tiles that
//     cross the warp's diagonal or the ragged tail k >= S.
//   * O += P V with P straight from S's registers: the accumulator holds
//     keys 2t and 2t + 1 where the A fragment wants k indices t and t + 4,
//     so this kernel reads the A fragment's k index t as key 2t and t + 4
//     as key 2t + 1, and loads V's B fragment with the same permutation
//     (rows 2t and 2t + 1 of the tile).  P never goes through shared
//     memory or a shuffle.
//   * Causal: tiles above the block's diagonal are never loaded, a warp
//     skips a tile whose keys all come after its rows, and the heaviest
//     q-blocks are launched first.  Within a tile nothing is skipped: a
//     branch per n8 tile would cut the unrolled products into blocks that
//     the compiler cannot schedule across.
//   * O goes from registers to memory as pairs (float2 or bf16x2).
// Registers: O is D / 2 floats a thread per m16 tile (80 at D = 160), S
// kBlockK / 2; Q stays in shared memory.  Where the time goes: the
// splits, conversions and fragment loads around each mma (about five
// instructions a product), not the tensor cores, which mma.sync drives at
// about 319 TFLOP/s in TF32 on an H100 (scripts/measure_mma_rate.py).
//
// Precision: exp2f (2 ulp) and IEEE division (no --use_fast_math).  The
// products are float32-accurate (3xTF32) and summed in another order than
// the plain version's; the reference's gates (2e-5 in f32, 3e-2 in bf16)
// are far above what that moves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_tiles.cuh"

namespace {

using tf32_tiles::mma_tf32;
using tf32_tiles::split_tf32_bits;
using tf32_tiles::to_f32;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kVecQ = 1, kVecK = 2, kVecV = 4;  // 16-byte copies allowed

// Element strides (b, h, s) of q, k, v and o; the last dim is contiguous.
struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// Shared memory of one instance, in elements of T: Q (kBlockQ rows of
// kLdK), then two stages of a K tile (kBlockK rows of kLdK) and a V tile
// (kBlockK rows of kLdV).  Every row is a multiple of 16 bytes (cp.async),
// and the pitches keep a warp's fragment loads free of bank conflicts:
// Q and K are read as pairs of elements (8 bytes in float32: lanes g, t of
// a half warp read 8-byte unit g P + t of a row, so P = kLdK / 2 must be 4
// or 12 mod 16; 4 bytes in bf16: kLdK / 2 words, 4 mod 8), V as single
// elements at rows 2t, 2t + 1 and column g (words per row 4 mod 8).
//
// The tiles of each instance, as timed on an H100 (scripts/
// sweep_flash_tf32.py): up to D = 64 a warp takes two m16 tiles (32 rows,
// each fragment of K and V read and split once for both), four warps a
// CTA, keys in tiles of 32; at D = 128 and 160 one m16 tile a warp (O
// alone is D / 2 registers a thread), eight warps, keys in tiles of 64,
// but 32 for float32 at D = 160, whose tiles of 64 would not fit.
template <typename T, int D>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kSmall = D <= 64;
  static constexpr int kM = kSmall ? 2 : 1;         // m16 tiles of a warp
  static constexpr int kWarps = kSmall ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockK = kSmall || (kF32 && D > 128) ? 32 : 64;
  static constexpr int kNK = kBlockK / 8;           // n8 tiles of S a warp
  static constexpr int kBlockQ = 16 * kM * kWarps;  // query rows of a CTA
  static constexpr int kLdBf = D % 16 == 0 ? D + 8 : D + 16;
  static constexpr int kLdK =
      kF32 ? ((D + 8) % 16 == 8 ? D + 8 : D + 16) : kLdBf;
  static constexpr int kLdV = kF32 ? D + 4 : kLdBf;
  static constexpr int kQ = kBlockQ * kLdK;
  static constexpr int kTileK = kBlockK * kLdK;
  static constexpr int kStage = kTileK + kBlockK * kLdV;  // a K and a V tile
  static constexpr int kBytes = (kQ + 2 * kStage) * (int)sizeof(T);
  static_assert((kLdK * sizeof(T)) % 16 == 0 && (kLdV * sizeof(T)) % 16 == 0,
                "rows must be 16-byte aligned");
  static_assert(kF32 ? (kLdK / 2) % 16 == 4 || (kLdK / 2) % 16 == 12
                     : (kLdK / 2) % 8 == 4,
                "Q and K pitch: pair loads must hit distinct banks");
  static_assert((kLdV * sizeof(T) / 4) % 8 == 4,
                "V pitch must be 4 mod 8 words");
  static_assert((D * sizeof(T)) % 16 == 0 && D % 8 == 0, "head dim");
};

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows r0 .. r0 + kRows - 1 of a (S, D) slab at src (row stride rs
// elements) into dst (pitch kLd); rows at or past seq are zero.  With vec,
// 16-byte cp.async (the caller commits the group); else scalar loads.
template <typename T, int D, int kRows, int kLd>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t rs,
                                      int r0, int seq, bool vec) {
  constexpr int kThreads = Smem<T, D>::kThreads;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte chunk
    constexpr int kChunks = D / kPer;     // chunks a row
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kPer;
      const bool in = r0 + r < seq;
      cp_async16(dst + r * kLd + c, in ? src + (r0 + r) * rs + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * kLd + c] =
          r0 + r < seq ? src[(r0 + r) * rs + c] : zero_value<T>();
    }
  }
}

// Elements p[0], p[1] as float32 (p is 8- or 4-byte aligned).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int D>
__global__ void __launch_bounds__(Smem<T, D>::kThreads)
    fa_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int hq,
                   int hkv, int seq, int causal, float scale_log2, int vec,
                   Strides st) {
  using Sm = Smem<T, D>;
  constexpr int kLdK = Sm::kLdK, kLdV = Sm::kLdV;
  constexpr int kM = Sm::kM, kBlockK = Sm::kBlockK, kNK = Sm::kNK;
  constexpr int kBlockQ = Sm::kBlockQ;
  constexpr bool kExact = !Sm::kF32;  // bf16 is exact in TF32
  constexpr int kDSteps = D / 8;      // k steps of Q K^T; n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* skv = sq + Sm::kQ;  // stage i: K at skv + i kStage, V after kTileK

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_block = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = q_block * kBlockQ;
  const int r0 = 16 * kM * warp;  // the warp's first row in the block
  // this lane's rows: q0 + r0 + 16 mi + g + 8 i, for m tile mi, half i
  const int row = q0 + r0 + g;
  // the last key any row of this warp reads
  const int last = causal ? min(seq - 1, q0 + r0 + 16 * kM - 1) : seq - 1;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;

  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  stage<T, D, kBlockQ, kLdK>(sq, qp, st.qs, q0, seq, vec & kVecQ);
  stage<T, D, kBlockK, kLdK>(skv, kp, st.ks, 0, seq, vec & kVecK);
  stage<T, D, kBlockK, kLdV>(skv + Sm::kTileK, vp, st.vs, 0, seq,
                             vec & kVecV);
  cp_async_commit();

  float acc[kM][kDSteps][4];
  float m[kM][2], l[kM][2];  // l: this lane's share of each row's sum
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int n = 0; n < kDSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mi][i] = kNegInf;
      l[mi][i] = 0.f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    if (it + 1 < n_tiles) {
      T* next = skv + ((it + 1) & 1) * Sm::kStage;
      stage<T, D, kBlockK, kLdK>(next, kp, st.ks, k0 + kBlockK, seq,
                                 vec & kVecK);
      stage<T, D, kBlockK, kLdV>(next + Sm::kTileK, vp, st.vs, k0 + kBlockK,
                                 seq, vec & kVecV);
    }
    cp_async_commit();  // possibly empty: the wait below is then exact
    cp_async_wait_one();
    __syncthreads();  // tile it (and Q) in shared memory for all

    if (last >= k0) {  // else every key of the tile is masked for the warp
      const T* ks = skv + (it & 1) * Sm::kStage;
      const T* vs = ks + Sm::kTileK;

      // S = Q K^T, the k index of step kk taken as dims in pairs: t is dim
      // 8 kk + 2t and t + 4 dim 8 kk + 2t + 1 (for Q and K alike, so the
      // sum is the same), so each lane reads its two elements of a row in
      // one load.  Each B fragment of K is read and split once and used
      // for the warp's kM m tiles.
      float s[kM][kNK][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int j = 0; j < kNK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        uint32_t ah[kM][4], al[kM][4];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          const T* qa = sq + (r0 + 16 * mi + g) * kLdK + 8 * kk + 2 * t;
          const float2 top = load_pair(qa), bottom = load_pair(qa + 8 * kLdK);
          const float a[4] = {top.x, bottom.x, top.y, bottom.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kExact)
              ah[mi][i] = __float_as_uint(a[i]);
            else
              split_tf32_bits(a[i], ah[mi][i], al[mi][i]);
          }
        }
#pragma unroll
        for (int j = 0; j < kNK; ++j) {
          const float2 kb_ = load_pair(ks + (8 * j + g) * kLdK + 8 * kk + 2 * t);
          const float b0 = kb_.x, b1 = kb_.y;
          if constexpr (kExact) {
            const uint32_t bb[2] = {__float_as_uint(b0), __float_as_uint(b1)};
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) mma_tf32(s[mi][j], ah[mi], bb);
          } else {
            uint32_t bh[2], bl[2];
            split_tf32_bits(b0, bh[0], bl[0]);
            split_tf32_bits(b1, bh[1], bl[1]);
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) {
              mma_tf32(s[mi][j], al[mi], bh);
              mma_tf32(s[mi][j], ah[mi], bl);
              mma_tf32(s[mi][j], ah[mi], bh);
            }
          }
        }
      }

      // Scale, mask (only where the tile crosses the diagonal or S), and
      // the online softmax on the fragments.
      const bool masked_tile =
          k0 + kBlockK > seq || (causal && k0 + kBlockK - 1 > q0 + r0);
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        float mt[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < kNK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int r = row + 16 * mi + 8 * (e >> 1);
            float x = s[mi][j][e] * scale_log2;  // log2 e folded in
            if (masked_tile && (key >= seq || (causal && key > r)))
              x = kNegInf;
            s[mi][j][e] = x;
            mt[e >> 1] = fmaxf(mt[e >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
          mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
          const float m_new = fmaxf(m[mi][i], mt[i]);
          alpha[i] = exp2f(m[mi][i] - m_new);
          m[mi][i] = m_new;
          l[mi][i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < kNK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[mi][j][e] - m[mi][e >> 1]);
            s[mi][j][e] = p;
            l[mi][e >> 1] += p;
          }
#pragma unroll
        for (int n = 0; n < kDSteps; ++n) {
          acc[mi][n][0] *= alpha[0];
          acc[mi][n][1] *= alpha[0];
          acc[mi][n][2] *= alpha[1];
          acc[mi][n][3] *= alpha[1];
        }
      }

      // O += P V: P's A fragment from S's registers (k index t is key 2t,
      // t + 4 is key 2t + 1), V's B fragment from rows 2t and 2t + 1, read
      // and split once for the kM m tiles.
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        uint32_t ph[kM][4], pl[kM][4];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          split_tf32_bits(s[mi][j][0], ph[mi][0], pl[mi][0]);
          split_tf32_bits(s[mi][j][2], ph[mi][1], pl[mi][1]);
          split_tf32_bits(s[mi][j][1], ph[mi][2], pl[mi][2]);
          split_tf32_bits(s[mi][j][3], ph[mi][3], pl[mi][3]);
        }
        const T* vb_ = vs + (8 * j + 2 * t) * kLdV + g;
#pragma unroll
        for (int n = 0; n < kDSteps; ++n) {
          const float b0 = to_f32(vb_[8 * n]);
          const float b1 = to_f32(vb_[kLdV + 8 * n]);
          if constexpr (kExact) {
            const uint32_t bb[2] = {__float_as_uint(b0), __float_as_uint(b1)};
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) {
              mma_tf32(acc[mi][n], pl[mi], bb);
              mma_tf32(acc[mi][n], ph[mi], bb);
            }
          } else {
            uint32_t bh[2], bl[2];
            split_tf32_bits(b0, bh[0], bl[0]);
            split_tf32_bits(b1, bh[1], bl[1]);
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) {
              mma_tf32(acc[mi][n], pl[mi], bh);
              mma_tf32(acc[mi][n], ph[mi], bl);
              mma_tf32(acc[mi][n], ph[mi], bh);
            }
          }
        }
      }
    }
    __syncthreads();  // tile it is read: its buffer takes tile it + 2
  }

  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mi][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float safe_l = li > 0.f ? li : 1.f;
      const int r = row + 16 * mi + 8 * i;
      if (r >= seq) continue;
#pragma unroll
      for (int n = 0; n < kDSteps; ++n)
        store_pair(op + r * st.os + 8 * n + 2 * t, acc[mi][n][2 * i] / safe_l,
                   acc[mi][n][2 * i + 1] / safe_l);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int seq, int causal, float scale,
           const Strides& st, cudaStream_t stream) {
  using Sm = Smem<T, D>;
  // Above 48 KB a block's dynamic shared memory must be asked for; done
  // on the first launch, before any graph capture of it.
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_tf32_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Sm::kBytes);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  // 16-byte copies need every row start 16-byte aligned.
  auto rows16 = [](const void* p, int64_t s0, int64_t s1, int64_t s2) {
    constexpr int64_t kPer = 16 / sizeof(T);
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % kPer == 0 &&
           s1 % kPer == 0 && s2 % kPer == 0;
  };
  const int vec = (rows16(q, st.qb, st.qh, st.qs) ? kVecQ : 0) |
                  (rows16(k, st.kb, st.kh, st.ks) ? kVecK : 0) |
                  (rows16(v, st.vb, st.vh, st.vs) ? kVecV : 0);
  const dim3 grid((seq + Sm::kBlockQ - 1) / Sm::kBlockQ, hq, b);
  fa_tf32_kernel<T, D><<<grid, Sm::kThreads, Sm::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, seq, causal,
      scale * kLog2e, vec, st);
  return (int)cudaGetLastError();
}

// Float32 at every head dim; bf16 at 8, 16, 32 and 160 (64 and 128 go to
// the wgmma kernel).
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int seq, int d, int causal, float scale,
               const Strides& st, cudaStream_t stream) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, o, b, hq, hkv, seq, causal, scale, st,
                          stream);
    case 16:
      return launch<T, 16>(q, k, v, o, b, hq, hkv, seq, causal, scale, st,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, seq, causal, scale, st,
                           stream);
    case 160:
      return launch<T, 160>(q, k, v, o, b, hq, hkv, seq, causal, scale, st,
                            stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    if (d == 64)
      return launch<T, 64>(q, k, v, o, b, hq, hkv, seq, causal, scale, st,
                           stream);
    if (d == 128)
      return launch<T, 128>(q, k, v, o, b, hq, hkv, seq, causal, scale, st,
                            stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Entry point bound with ctypes.  dtype: 0 = float32 (head dims 8, 16, 32,
// 64, 128, 160), 1 = bfloat16 (head dims 8, 16, 32, 160).  The strides are
// in elements, (b, h, s) for each of q, k, v, o.  The caller has checked
// shapes, types and strides (kernel.py).  Launches on the caller's stream,
// allocates nothing and does not synchronise.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an instance it was not built for.
extern "C" int fa_tf32_launch(const void* q, const void* k, const void* v,
                              void* o, int b, int hq, int hkv, int seq, int d,
                              int causal, float scale, int dtype, int64_t qb,
                              int64_t qh, int64_t qs, int64_t kb, int64_t kh,
                              int64_t ks, int64_t vb, int64_t vh, int64_t vs,
                              int64_t ob, int64_t oh, int64_t os,
                              void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, b, hq, hkv, seq, d, causal, scale,
                             st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, seq, d, causal,
                                     scale, st, s);
  return (int)cudaErrorInvalidValue;
}
