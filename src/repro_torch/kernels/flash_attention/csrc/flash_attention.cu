// Flash attention (blockwise online softmax) on the CUDA cores, written by
// hand for Hopper (sm_90a): the float32 instance of flash_attention_pallas
// at every head dim, and the bf16 instance at the small head dims (8, 16,
// 32).  bf16 at head dims 64 and 128 runs on the tensor cores
// (flash_attention_wgmma.cu); kernel.py's route() picks the instance.
//
// What it replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_pallas (body _flash_kernel)
// Contract (the Pallas kernel's): q (B, Hq, S, D), k / v (B, Hkv, S, D),
// f32 or bf16, read through their strides (the last dim contiguous); query
// head h reads kv head h / (Hq / Hkv) (the BlockSpec index map: no
// repeated heads); softmax scale given by the caller; causal or full; the
// running (m, l, acc) in f32, masked logits -1e30, output acc / l with l
// guarded (l > 0 ? l : 1), stored in q's type (bf16 rounded to nearest
// even by __float2bfloat16, as Tensor.to rounds) through its strides.
//
// Design.  The TPU grid (B, Hq, S/bq, S/bk) ran its kv axis in order on one
// core, carrying (m, l, acc) in VMEM scratch.  Here one CTA takes one
// (b, q-head, block of kBlockQ = 64 queries) and a loop inside it walks the
// keys in tiles of kBlockK = 32; for causal attention the loop stops at the
// tile that holds the block's last query (the Pallas kernel's skipped
// blocks above the diagonal), and the heaviest q-blocks are launched first.
// Each tile of K and V of the matching kv head is staged in shared memory
// as f32.  Each query row belongs to kRow = max(1, D / 32) adjacent lanes,
// each holding 32 (or D) of its dims of q and acc in registers, in chunks
// of four interleaved across the lanes so that the lanes of a warp read
// distinct banks; a score is their partial dot products summed with warp
// shuffles.  Per tile: the scores of the 32 keys, the tile maximum, one
// rescale of acc, then p = exp(s - m) and acc += p v.
//
// What bounds it on an H100.  Float32 has no tensor-core path that holds
// the reference's float32 gate of 2e-5 (TF32 rounds its inputs to 10
// bits, about 5e-4 relative), so the bound of the float32 instance is the
// CUDA cores' 67 TFLOP/s: 257 us for the 17.2 GFLOP of the main path's
// shape (q (4, 32, 1024, 64), kv heads 4, causal).  This kernel does its
// products as f32 FMAs and reads every K / V value from shared memory once
// per query row, so it is bound by shared memory and FMA throughput, above
// that bound.
//
// Precision: IEEE expf and division (no --use_fast_math).  FMA contraction
// is allowed: the reference's gates (2e-5 in f32, 3e-2 in bf16) are far
// above the few ulps it moves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element strides (b, h, s) of q, k, v and o; the last dim is contiguous.
struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D >= 64 ? D / 32 : 1))
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int seq, int causal, float scale, Strides st) {
  constexpr int kRow = D >= 64 ? D / 32 : 1;  // lanes per query row
  constexpr int kDims = D / kRow;              // dims per lane
  constexpr int kChunks = kDims / 4;           // float4 chunks per lane
  static_assert(D % 4 == 0 && kDims % 4 == 0, "D must be a multiple of 4");
  static_assert(2 * kBlockK * D * sizeof(float) <= 48 * 1024,
                "K and V tiles exceed the static shared memory limit");
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];

  const int tid = threadIdx.x;
  const int row = tid / kRow;
  const int lane_in_row = tid % kRow;
  const int q_block = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = q_block * kBlockQ;
  const int q_pos = q0 + row;
  const bool active = q_pos < seq;

  const T* qh = q + b * st.qb + h * st.qh;
  const T* kh = k + b * st.kb + kvh * st.kh;
  const T* vh = v + b * st.vb + kvh * st.vh;
  T* oh = o + b * st.ob + h * st.oh;

  // This lane's dims: chunks c = i * kRow + lane_in_row, dims 4c .. 4c+3.
  float qr[kDims], acc[kDims];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = (i * kRow + lane_in_row) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[i * 4 + e] = active ? to_f32(qh[q_pos * st.qs + d0 + e]) : 0.f;
      acc[i * 4 + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    const int n_tile = min(kBlockK, seq - k0) * D;
    for (int idx = tid; idx < kBlockK * D; idx += blockDim.x) {
      const bool in = idx < n_tile;
      const int64_t key = k0 + idx / D, dim = idx % D;
      ks[idx] = in ? to_f32(kh[key * st.ks + dim]) : 0.f;
      vs[idx] = in ? to_f32(vh[key * st.vs + dim]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kj = reinterpret_cast<const float4*>(ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kv4 = kj[i * kRow + lane_in_row];
        dot += qr[i * 4 + 0] * kv4.x;
        dot += qr[i * 4 + 1] * kv4.y;
        dot += qr[i * 4 + 2] * kv4.z;
        dot += qr[i * 4 + 3] * kv4.w;
      }
#pragma unroll
      for (int off = 1; off < kRow; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int k_pos = k0 + j;
      const bool masked = k_pos >= seq || (causal && k_pos > q_pos);
      s[j] = masked ? kNegInf : dot * scale;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = alpha * l + p_sum;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vj = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 v4 = vj[i * kRow + lane_in_row];
        acc[i * 4 + 0] += s[j] * v4.x;
        acc[i * 4 + 1] += s[j] * v4.y;
        acc[i * 4 + 2] += s[j] * v4.z;
        acc[i * 4 + 3] += s[j] * v4.w;
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float safe_l = l > 0.f ? l : 1.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = (i * kRow + lane_in_row) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(oh + q_pos * st.os + d0 + e, acc[i * 4 + e] / safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int seq, int causal, float scale,
           const Strides& st, cudaStream_t stream) {
  constexpr int kThreads = kBlockQ * (D >= 64 ? D / 32 : 1);
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, hq, b);
  flash_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, seq, causal,
      scale, st);
  return (int)cudaGetLastError();
}

// Float32 at every head dim; bf16 only at the small ones (8, 16, 32).
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int seq, int d, int causal, float scale,
               const Strides& st, cudaStream_t stream) {
  constexpr bool kAll = std::is_same<T, float>::value;
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
  }
  if constexpr (kAll) {
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
// 64, 128), 1 = bfloat16 (head dims 8, 16, 32).  The strides are in
// elements, (b, h, s) for each of q, k, v, o.  The caller has checked
// shapes, types and strides (kernel.py).  Launches on the caller's stream,
// allocates nothing and does not synchronise.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an instance it was not built for.
extern "C" int fa_cuda_core_launch(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int seq, int d, int causal, float scale, int dtype, int64_t qb,
    int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks, int64_t vb,
    int64_t vh, int64_t vs, int64_t ob, int64_t oh, int64_t os,
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
