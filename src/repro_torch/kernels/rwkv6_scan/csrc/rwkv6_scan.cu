// RWKV6 (Finch) wkv scan, written by hand for Hopper (sm_90a).
//
// What it replaces: src/repro/kernels/rwkv6_scan/kernel.py
//   rwkv6_scan_launch -> rwkv6_scan_pallas (body _rwkv6_kernel)
// Contract (the op's, ref.py): per (b, h), from a zero state S (K x V),
//   o_t[j]   = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
//   S[i, j] <- exp(w_log_t[i]) S[i, j] + k_t[i] v_t[j]
// r, k, w_log (B, H, T, K) and v (B, H, T, V), float32 or bfloat16 (one
// type for the four), read through their strides in elements (the last
// dim contiguous): the model hands them over as (B, T, H, .) tensors seen
// transposed, and the kernel reads them there, with no copy in between.
// u (H, K) float32 contiguous; o (B, H, T, V) and the final S (B, H, K, V)
// float32, contiguous.  T is a multiple of the chunk C <= 64.
//
// Design.  The TPU kernel walked the chunks of one (b, h) as the
// sequential axis of its grid, carrying S in VMEM scratch.  Blocks on the
// card run in no order, so here one CTA of 256 threads owns one (b, h) and
// loops over its chunks itself, with S (K x V float32, 16 KB at K = V = 64)
// in shared memory for the whole scan.  Per chunk it stages r, k, w_log and
// v as float32 in shared memory, takes the inclusive and exclusive
// cumsums W, We of w_log along the chunk (one thread per channel, in
// order, in float64, each kept as a float32 pair hi + lo), and then, each
// phase split over the threads and separated by a barrier:
//   A[t][s] = sum_k r[t,k] k[s,k] exp(We[t,k] - W[s,k])  for s < t,
//   A[t][t] = sum_k r[t,k] u[k] k[t,k]                    (the bonus);
//   r~ = r exp(We), k^ = k exp(W_C - W)                    (in place);
//   o = A v + r~ S                                         (old S);
//   S = exp(W_C) S + k^T v.
// The intra-chunk weights are taken in log space, exp(We[t,k] - W[s,k])
// with an exponent <= 0 (clamped at 0 against rounding), as chunked.py
// does, and each exponent as (hi_t - hi_s) + (lo_t - lo_s): a strong decay
// makes |W| reach hundreds within a chunk, where a difference of float32
// cumsums would lose the small exponents of nearby pairs (chunked.py's
// header has the numbers).  The Pallas body's split into exp(We) and exp(-W)
// costs 2 C K exponentials per chunk where this costs C (C - 1) / 2 K, but
// exp(-W) overflows float32 once the chunk's summed decay passes about 88,
// which a strong decay (w_log = -exp(2 z)) reaches within a chunk; the log
// form cannot overflow, whatever the decay.  Rows of the (C, K) arrays are
// padded by one float so that threads reading rows s of one column hit
// distinct banks.
//
// What bounds it on an H100.  RWKV6-3B's prefill (B 4, H 40, T 1024,
// K = V = 64, C 32, bf16 in) moves about 128 MB (3.35 TB/s: 38 us) and
// needs about 3.38 GFLOP: the chunked form's products, the intra-chunk
// ones over the lower triangle and its diagonal only (f32 outside the
// tensor cores, 67 TFLOP/s: 50 us), so the bound is the operations.  This simple version is far from it: the products run on
// CUDA cores from shared memory, the exponentials of A (C^2 K / 2 per
// chunk) are issued one per product, and only B H = 160 CTAs fill the 132
// SMs.  Tensor-core products (mma.sync / wgmma on staged tiles) and
// splitting a head's V across CTAs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Strides {  // (b, h, t) of r, k, v, w_log in elements; last dims 1
  int64_t rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ o,
                  float* __restrict__ s_out, int h, int t, int dk, int dv,
                  int c, Strides sd) {
  extern __shared__ float smem[];
  const int kp = dk + 1;       // padded row of the (C, K) arrays
  float* st = smem;            // (K, V) state
  float* rs = st + dk * dv;    // (C, K+1): r, then r * exp(We)
  float* ks = rs + c * kp;     // (C, K+1): k, then k * exp(W_C - W)
  float* cw = ks + c * kp;     // (C, K+1): w_log, then W (hi), inclusive
  float* cl = cw + c * kp;     // (C, K+1): W (lo)
  float* we = cl + c * kp;     // (C, K+1): We (hi), exclusive
  float* el = we + c * kp;     // (C, K+1): We (lo)
  float* vs = el + c * kp;     // (C, V)
  float* as = vs + c * dv;     // (C, C): intra-chunk weights

  const int bh = blockIdx.x;  // b * H + head
  const int row = bh / h, head = bh % h;
  const int tid = threadIdx.x;
  const int64_t base_o = (int64_t)bh * t * dv;
  const T* r0 = r + row * sd.rb + head * sd.rh;
  const T* k0 = k + row * sd.kb + head * sd.kh;
  const T* v0 = v + row * sd.vb + head * sd.vh;
  const T* w0 = w + row * sd.wb + head * sd.wh;
  const float* uh = u + (int64_t)head * dk;

  for (int e = tid; e < dk * dv; e += kThreads) st[e] = 0.f;

  for (int t0 = 0; t0 < t; t0 += c) {
    __syncthreads();  // the previous chunk is done with every array
    for (int e = tid; e < c * dk; e += kThreads) {
      const int i = e / dk, j = e % dk;
      rs[i * kp + j] = to_f32(r0[(t0 + i) * sd.rt + j]);
      ks[i * kp + j] = to_f32(k0[(t0 + i) * sd.kt + j]);
      cw[i * kp + j] = to_f32(w0[(t0 + i) * sd.wt + j]);
    }
    for (int e = tid; e < c * dv; e += kThreads) {
      const int i = e / dv, j = e % dv;
      vs[i * dv + j] = to_f32(v0[(t0 + i) * sd.vt + j]);
    }
    __syncthreads();
    for (int j = tid; j < dk; j += kThreads) {  // cumsums, in order
      double acc = 0.0;
      for (int i = 0; i < c; ++i) {
        const int at = i * kp + j;
        float hi = (float)acc;
        we[at] = hi;
        el[at] = (float)(acc - (double)hi);
        acc += (double)cw[at];
        hi = (float)acc;
        cw[at] = hi;
        cl[at] = (float)(acc - (double)hi);
      }
    }
    __syncthreads();
    for (int e = tid; e < c * c; e += kThreads) {  // A, lower triangle
      const int ti = e / c, si = e % c;
      const float* rt = rs + ti * kp;
      const float* ksi = ks + si * kp;
      float a = 0.f;
      if (si < ti) {
        const float* wet = we + ti * kp;
        const float* elt = el + ti * kp;
        const float* cws = cw + si * kp;
        const float* cls = cl + si * kp;
        for (int j = 0; j < dk; ++j) {
          const float x = (wet[j] - cws[j]) + (elt[j] - cls[j]);
          a += rt[j] * ksi[j] * expf(fminf(x, 0.f));
        }
      } else if (si == ti) {
        for (int j = 0; j < dk; ++j) a += rt[j] * __ldg(uh + j) * ksi[j];
      }
      as[e] = a;
    }
    __syncthreads();
    const float* cw_last = cw + (c - 1) * kp;
    const float* cl_last = cl + (c - 1) * kp;
    for (int e = tid; e < c * dk; e += kThreads) {
      const int i = e / dk, j = e % dk, at = i * kp + j;
      rs[at] *= expf(we[at] + el[at]);
      ks[at] *= expf((cw_last[j] - cw[at]) + (cl_last[j] - cl[at]));
    }
    __syncthreads();
    for (int e = tid; e < c * dv; e += kThreads) {  // o = A v + r~ S
      const int ti = e / dv, j = e % dv;
      float intra = 0.f;
      for (int si = 0; si <= ti; ++si) intra += as[ti * c + si] * vs[si * dv + j];
      float inter = 0.f;
      for (int q = 0; q < dk; ++q) inter += rs[ti * kp + q] * st[q * dv + j];
      o[base_o + (int64_t)(t0 + ti) * dv + j] = intra + inter;
    }
    __syncthreads();
    for (int e = tid; e < dk * dv; e += kThreads) {  // S = e^W_C S + k^T v
      const int q = e / dv, j = e % dv;
      float acc = 0.f;
      for (int si = 0; si < c; ++si) acc += ks[si * kp + q] * vs[si * dv + j];
      st[e] = expf(cw_last[q] + cl_last[q]) * st[e] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * dv; e += kThreads)
    s_out[(int64_t)bh * dk * dv + e] = st[e];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, void* s, int b, int h, int t, int dk,
           int dv, int c, const Strides& sd, int smem, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be asked for; done
  // once per size, before any graph capture of the launch.
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  rwkv6_scan_kernel<T><<<b * h, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(s), h, t, dk, dv, c, sd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    void* o, void* s, int b, int h, int t, int dk, int dv, int c, int64_t rb,
    int64_t rh, int64_t rt, int64_t kb, int64_t kh, int64_t kt, int64_t vb,
    int64_t vh, int64_t vt, int64_t wb, int64_t wh, int64_t wt, int dtype,
    int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sd{rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt};
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, o, s, b, h, t, dk, dv, c, sd, smem,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, o, s, b, h, t, dk, dv, c, sd,
                                 smem, st);
  return (int)cudaErrorInvalidValue;
}
