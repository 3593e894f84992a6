// Mamba-2 SSD (state-space dual) scan, written by hand for Hopper (sm_90a).
//
// What it replaces: src/repro/kernels/mamba2_ssd/kernel.py
//   mamba2_ssd_launch -> mamba2_ssd_pallas (body _ssd_kernel)
// Contract (the op's, ref.py): per (b, h), from a zero state h (N x P),
//   h[n, p] <- exp(a_log_t) h[n, p] + B_t[n] x_t[p],   y_t[p] = C_t . h[:, p]
// x (B, H, T, P), a_log (B, H, T), B and C (B, T, N) shared by the heads of
// a batch row, float32 or bfloat16 (one type for the four), read through
// their strides in elements (the last dim of x, B and C contiguous): the
// model hands over x and a_log as (B, T, H, .) tensors seen transposed,
// and the kernel reads them there, with no copy in between.  y (B, H, T, P)
// and the final h (B, H, N, P) float32, contiguous.  T is a multiple of the
// chunk C <= 64.
//
// Design.  The TPU kernel walked the chunks of one (b, h) as the
// sequential axis of its grid, carrying h in VMEM scratch.  Here one CTA of
// 256 threads owns one (b, h) and loops over its chunks itself, with h
// (N x P float32, 16 KB at N = P = 64) in shared memory for the whole scan.
// Per chunk it stages x, a_log, B and C as float32 in shared memory, takes
// ca = cumsum(a_log) along the chunk (one thread, in order, in float64,
// kept as a float32 pair hi + lo), and then, each phase split over the
// threads and separated by a barrier:
//   M[t][s] = (C_t . B_s) exp(ca_t - ca_s) for s <= t, else 0,
//   d_s = exp(ca_C - ca_s);
//   y = M x + exp(ca) (C h)                               (old h);
//   h = exp(ca_C) h + (B d)^T x.
// Every exponent is <= 0 (the intra-chunk one clamped at 0 against
// rounding), so nothing overflows; each difference of cumsums is taken as
// (hi_t - hi_s) + (lo_t - lo_s), as chunked.py does, since a strong decay
// makes |ca| reach hundreds within a chunk and a difference of float32
// cumsums would lose the small exponents of nearby steps.  Rows of B and
// C are padded by one float so that threads reading rows s of one column
// hit distinct banks.
// B and C are shared by the heads, so every CTA of a batch row recomputes
// the same C B^T: H-fold redundant work, left for later.
//
// What bounds it on an H100.  Zamba2-2.7B's prefill (B 4, H 80, T 1024,
// P = N = 64, C 64, float32 in, as the model passes them) moves about 176 MB
// (3.35 TB/s: 53 us) and needs about 6.75 GFLOP: the chunked form's
// products over the lower triangle only, C B^T once per batch row (f32
// outside the tensor cores, 67 TFLOP/s: 101 us), so the bound is the
// operations.  This simple version runs the products on CUDA cores from
// shared memory, each CTA all of its (C, C) M; 320 CTAs cover the 132 SMs
// in about 2.4 waves.  Tensor-core tiles and one C B^T per batch row are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Strides {  // in elements; the last dims of x, B and C are 1
  int64_t xb, xh, xt, ab, ah, at, bb, bt, cb, ct;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_ssd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  float* __restrict__ y, float* __restrict__ h_out, int nh,
                  int t, int p, int n, int c, Strides sd) {
  extern __shared__ float smem[];
  const int np1 = n + 1;       // padded row of B and C
  float* hs = smem;            // (N, P) state
  float* xs = hs + n * p;      // (C, P)
  float* bs = xs + c * p;      // (C, N+1)
  float* cs = bs + c * np1;    // (C, N+1)
  float* ms = cs + c * np1;    // (C, C)
  float* ca = ms + c * c;      // (C): a_log, then its cumsum (hi)
  float* cl = ca + c;          // (C): the cumsum's lo part
  float* dec = cl + c;         // (C): exp(ca_C - ca)

  const int bh = blockIdx.x;  // b * H + head
  const int row = bh / nh, head = bh % nh;
  const int tid = threadIdx.x;
  const int64_t base_y = (int64_t)bh * t * p;
  const T* x0 = x + row * sd.xb + head * sd.xh;
  const T* a0 = a + row * sd.ab + head * sd.ah;
  const T* b0 = bm + row * sd.bb;
  const T* c0 = cm + row * sd.cb;

  for (int e = tid; e < n * p; e += kThreads) hs[e] = 0.f;

  for (int t0 = 0; t0 < t; t0 += c) {
    __syncthreads();  // the previous chunk is done with every array
    for (int e = tid; e < c * p; e += kThreads) {
      const int i = e / p, j = e % p;
      xs[e] = to_f32(x0[(t0 + i) * sd.xt + j]);
    }
    for (int e = tid; e < c * n; e += kThreads) {
      const int i = e / n, j = e % n;
      bs[i * np1 + j] = to_f32(b0[(t0 + i) * sd.bt + j]);
      cs[i * np1 + j] = to_f32(c0[(t0 + i) * sd.ct + j]);
    }
    if (tid < c) ca[tid] = to_f32(a0[(t0 + tid) * sd.at]);
    __syncthreads();
    if (tid == 0) {  // cumsum, in order
      double acc = 0.0;
      for (int i = 0; i < c; ++i) {
        acc += (double)ca[i];
        const float hi = (float)acc;
        ca[i] = hi;
        cl[i] = (float)(acc - (double)hi);
      }
    }
    __syncthreads();
    const float ca_last = ca[c - 1], cl_last = cl[c - 1];
    for (int e = tid; e < c * c; e += kThreads) {  // M, lower triangle
      const int ti = e / c, si = e % c;
      float m = 0.f;
      if (si <= ti) {
        const float* ct = cs + ti * np1;
        const float* bsi = bs + si * np1;
        float g = 0.f;
        for (int q = 0; q < n; ++q) g += ct[q] * bsi[q];
        m = g * expf(fminf((ca[ti] - ca[si]) + (cl[ti] - cl[si]), 0.f));
      }
      ms[e] = m;
    }
    if (tid < c) dec[tid] = expf((ca_last - ca[tid]) + (cl_last - cl[tid]));
    __syncthreads();
    for (int e = tid; e < c * p; e += kThreads) {  // y = M x + e^ca (C h)
      const int ti = e / p, j = e % p;
      float intra = 0.f;
      for (int si = 0; si <= ti; ++si) intra += ms[ti * c + si] * xs[si * p + j];
      float inter = 0.f;
      for (int q = 0; q < n; ++q) inter += cs[ti * np1 + q] * hs[q * p + j];
      y[base_y + (int64_t)(t0 + ti) * p + j] =
          intra + expf(ca[ti] + cl[ti]) * inter;
    }
    __syncthreads();
    for (int e = tid; e < n * p; e += kThreads) {  // h = e^ca_C h + (B d)^T x
      const int q = e / p, j = e % p;
      float acc = 0.f;
      for (int si = 0; si < c; ++si)
        acc += (bs[si * np1 + q] * dec[si]) * xs[si * p + j];
      hs[e] = expf(ca_last + cl_last) * hs[e] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * p; e += kThreads)
    h_out[(int64_t)bh * n * p + e] = hs[e];
}

template <typename T>
int launch(const void* x, const void* a, const void* b_, const void* c_,
           void* y, void* h, int b, int nh, int t, int p, int n, int c,
           const Strides& sd, int smem, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be asked for; done
  // once per size, before any graph capture of the launch.
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        mamba2_ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  mamba2_ssd_kernel<T><<<b * nh, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b_), static_cast<const T*>(c_),
      static_cast<float*>(y), static_cast<float*>(h), nh, t, p, n, c, sd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mamba2_ssd_launch(
    const void* x, const void* a, const void* b_, const void* c_, void* y,
    void* h, int b, int nh, int t, int p, int n, int c, int64_t xb,
    int64_t xh, int64_t xt, int64_t ab, int64_t ah, int64_t at, int64_t bb,
    int64_t bt, int64_t cb, int64_t ct, int dtype, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sd{xb, xh, xt, ab, ah, at, bb, bt, cb, ct};
  if (dtype == 0)
    return launch<float>(x, a, b_, c_, y, h, b, nh, t, p, n, c, sd, smem, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b_, c_, y, h, b, nh, t, p, n, c, sd,
                                 smem, st);
  return (int)cudaErrorInvalidValue;
}
