// Flash attention on Hopper's tensor cores (sm_90a): the bf16 instance of
// flash_attention_pallas at head dims 64 and 128.
//
// What it replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_pallas (body _flash_kernel), for bf16 q, k, v.  The
//   float32 inputs and the other head dims (8, 16, 32, 160) go to the
//   3xTF32 kernel beside it (flash_attention_tf32.cu); kernel.py's route()
//   picks one.
// Contract (the Pallas kernel's): q (B, Hq, S, D), k / v (B, Hkv, S, D),
// read through their strides (the last dim contiguous; every other stride
// and the base 16-byte aligned, as TMA needs); query head h reads kv head
// h / (Hq / Hkv); causal or full; the running (m, l, acc) in f32, masked
// logits -1e30 before the row max; output acc / l with l guarded
// (l > 0 ? l : 1), rounded to bf16 to nearest even, written through its
// strides (the wrapper hands a (B, S, Hq, D) buffer seen as (B, Hq, S, D)).
//
// What bounds it on an H100.  At the main path's shape (TinyLlama-1.1B
// prefill: q (4, 32, 1024, 64) bf16, kv heads 4, causal) the function
// needs 17.2 GFLOP (QK^T and PV over the S (S + 1) / 2 causal pairs of
// each head) against 37.7 MB moved once: 17.4 us at the tensor cores'
// 989 TFLOP/s, above 11.3 us at 3.35 TB/s.  So the products must run on
// the tensor cores, and the bytes must stay out of the way.
//
// Design.  One CTA takes 128 query rows of one (b, q-head): two consumer
// warpgroups of 64 rows and one producer warp (288 threads; at D = 64 two
// CTAs an SM, at D = 128 one: see Tile).
//   * The producer warp fills, with TMA (cp.async.bulk.tensor on 4-D
//     tensor maps that carry the inputs' strides), Q once and a ring of
//     kStages (K, V) tiles of 64 keys, each completing on its own
//     mbarrier; a stage is refilled once all 256 consumer threads have
//     arrived on its "empty" barrier.  Rows past S come in as zeros.
//   * S = Q K^T: wgmma m64n64k16 with Q and K from shared memory (both
//     K-major, 128-byte swizzle: the layout TMA writes with
//     CU_TENSOR_MAP_SWIZZLE_128B; D = 128 is two 64-column atoms).
//   * The online softmax runs on the f32 accumulator fragments: the row
//     max and sum across the 4 lanes that share a row (shuffles 1, 2),
//     exp2 with scale * log2(e) folded into one FMA, l summed from the
//     unrounded f32 p.  The mask (-1e30 before the max) is applied only
//     on tiles that cross the diagonal or the ragged tail k >= S.
//   * O += P V: P's accumulator fragment, rounded to bf16 pairs, is
//     already wgmma's register A operand (it never goes to shared
//     memory); V is the same (keys, D) tile read as an MN-major B operand
//     (the transpose bit).  Each 64-column half of D is one m64n64k16.
//   * Causal: tiles above the block's diagonal are never loaded; a
//     warpgroup skips a tile whose keys all come after its rows; the
//     heaviest q-blocks are launched first (q-block on the grid's slowest
//     axis).
//   * The output goes from registers straight to memory as bf16 pairs.
//
// Precision: P is rounded to bf16 as the PV operand (the Pallas body
// forms f32 p); exp2 is ex2.approx (2 ulp).  Both sit far below the bf16
// output's own rounding and the reference's bf16 gate of 3e-2.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;                // query rows of a CTA
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr float kNegInf = -1e30f;

// Per head dim: keys per tile, (K, V) tiles in flight, CTAs an SM.  A
// thread holds kBlockN / 2 floats of S, D / 2 of O and kBlockN / 4 words
// of P.  At D = 64 a thread stays under 113 registers, so two CTAs (four
// consumer warpgroups) share an SM and hide each other's waits: 1.4x
// faster at the main shape than one CTA an SM, 2 to 4 stages alike
// (scripts/sweep_flash_tiles.py on an H100).  At D = 128 O takes 64
// registers, and one CTA an SM keeps the kernel free of spills, which
// an in-flight wgmma's registers do not survive.
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int kBlockN = 64, kStages = 4, kMinBlocks = 2;
};
template <>
struct Tile<128> {
  static constexpr int kBlockN = 64, kStages = 2, kMinBlocks = 1;
};

template <int D>
struct Smem {  // byte offsets from a 1024-aligned base
  static constexpr int kBlockN = Tile<D>::kBlockN;
  static constexpr int kStages = Tile<D>::kStages;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8;
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to align
};

// --- shared memory, mbarriers, TMA ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of the 4-D tensor map (D, S, H, B) into shared memory at dst,
// completing on bar; coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(s0), "r"(h),
      "r"(b), "r"(bar)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose rows
// are 128 bytes (64 bf16): start address >> 4 (bits 0-13); leading and
// stride byte offsets >> 4 (bits 16-29, 32-45), both the 1024 bytes
// between groups of 8 rows (the leading offset is unused by these
// shapes: one 64-column atom per operand); bits 62-63 = 1, 128B swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --- the kernel ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, int64_t o_b, int64_t o_h,
                    int64_t o_s, int seq, int group, int causal,
                    float scale_log2) {
  using L = Smem<D>;
  constexpr int kBlockN = L::kBlockN, kStages = L::kStages;
  static_assert(kBlockN == 64, "S = Q K^T is one m64n64k16 per 16 dims");
  constexpr int kHalves = D / 64;  // 64-column atoms of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;                // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;      // + 8 * stage
  const uint32_t empty = v_full + 8 * kStages;       // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // heaviest first
  const int kvh = h / group;
  const int k_end = causal ? min(seq, q0 + kBlockM) : seq;
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp; one lane issues
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < kHalves; ++c)
        tma_load(sq + c * kBlockM * 128, &tm_q, q_full, c * 64, q0, h, b);
      for (int t = 0, stage = 0, phase = 0; t < n_tiles; ++t) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const int k0 = t * kBlockN;
        const uint32_t kb = k_full + 8 * stage, vb = v_full + 8 * stage;
        mbar_expect_tx(kb, L::kTileBytes);
        for (int c = 0; c < kHalves; ++c)
          tma_load(sk + stage * L::kTileBytes + c * kBlockN * 128, &tm_k, kb,
                   c * 64, k0, kvh, b);
        mbar_expect_tx(vb, L::kTileBytes);
        for (int c = 0; c < kHalves; ++c)
          tma_load(sv + stage * L::kTileBytes + c * kBlockN * 128, &tm_v, vb,
                   c * 64, k0, kvh, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // A consumer: warpgroup wg holds rows q0 + 64 wg ... + 63.  In the
  // accumulator fragments this thread's value j lies in row
  // row0 + 8 ((j / 2) % 2), column 8 (j / 4) + 2 (lane % 4) + j % 2.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int wg_first = q0 + wg * 64, wg_last = wg_first + 63;
  const uint32_t q_rows = sq + wg * 64 * 128;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0, stage = 0, phase = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    if (causal && k0 > wg_last) {  // every key after every row here
      mbar_arrive(empty + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      continue;
    }

    // S = Q K^T (64 x kBlockN, f32).
    float s[kBlockN / 2];
    mbar_wait(k_full + 8 * stage, phase);
    const uint32_t k_rows = sk + stage * L::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t atom = (kk / 4), col = (kk % 4) * 32;
      wgmma_ss_n64(s, desc_sw128(q_rows + atom * kBlockM * 128 + col),
                   desc_sw128(k_rows + atom * kBlockN * 128 + col), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBlockN / 2>(s);

    if (k0 + kBlockN > seq || (causal && k0 + kBlockN - 1 > wg_first)) {
#pragma unroll
      for (int j = 0; j < kBlockN / 2; ++j) {
        const int col = k0 + (j / 4) * 8 + (lane % 4) * 2 + (j % 2);
        const int row = row0 + ((j / 2) % 2) * 8;
        if (col >= seq || (causal && col > row)) s[j] = kNegInf;
      }
    }

    // Online softmax in the log2 domain: m is the running max of
    // s * scale * log2(e).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockN / 2; ++j)
      mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], s[j]);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    uint32_t p[kBlockN / 4];  // bf16 pairs: wgmma's A fragments for PV
#pragma unroll
    for (int j = 0; j < kBlockN / 2; j += 2) {
      const int i = (j / 2) % 2;
      const float p0 = ex2(fmaf(s[j], scale_log2, -m[i]));
      const float p1 = ex2(fmaf(s[j + 1], scale_log2, -m[i]));
      l[i] += p0 + p1;
      p[j / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j / 2) % 2];

    // O += P V (64 x D, f32), 16 keys a step.
    mbar_wait(v_full + 8 * stage, phase);
    const uint32_t v_rows = sv + stage * L::kTileBytes;
    fence_regs<D / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
        wgmma_rs_n64(acc + 32 * c, p + 4 * kk,
                     desc_sw128(v_rows + c * kBlockN * 128 + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    mbar_arrive(empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // l was summed over this thread's columns only; the row's 4 lanes add.
  float safe_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    safe_l[i] = l[i] > 0.f ? l[i] : 1.f;
  }
  __nv_bfloat16* ob = o + b * o_b + h * o_h;
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int i = (j / 2) % 2;
    const int row = row0 + 8 * i;
    if (row < seq) {
      const int col = (j / 4) * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(ob + row * o_s + col) =
          __floats2bfloat162_rn(acc[j] / safe_l[i], acc[j + 1] / safe_l[i]);
    }
  }
}

// --- host side ----------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 (B, H, S, D) tensor with element strides
// (sb, sh, ss, 1): dims (D, S, H, B) innermost first, boxes of 64 columns
// x rows x 1 x 1, 128-byte swizzle, zeros past the edges.
bool encode(CUtensorMap* map, EncodeTiled fn, const void* ptr, int b, int h,
            int s, int d, int64_t sb, int64_t sh, int64_t ss, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int seq, int causal, float scale,
           const int64_t* st, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be asked for; done
  // once, before any graph capture of the launch.
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::kLaunchBytes);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, fn, q, b, hq, seq, D, st[0], st[1], st[2], kBlockM) ||
      !encode(&tk, fn, k, b, hkv, seq, D, st[3], st[4], st[5],
              Tile<D>::kBlockN) ||
      !encode(&tv, fn, v, b, hkv, seq, D, st[6], st[7], st[8],
              Tile<D>::kBlockN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hq, b, (seq + kBlockM - 1) / kBlockM);
  fa_wgmma_kernel<D><<<grid, kThreads, Smem<D>::kLaunchBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], seq,
      hq / hkv, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// Entry point bound with ctypes: bf16 q, k, v, o at head dim 64 or 128.
// The strides are in elements, (b, h, s) for each of q, k, v, o (the last
// dim is contiguous); the caller (kernel.py) has checked shapes, type and
// alignment.  Launches on the caller's stream, allocates nothing and does
// not synchronise.  Returns cudaGetLastError(), or an error code for a
// head dim it was not built for or a tensor map the driver refuses.
extern "C" int fa_tensor_core_launch(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int seq, int d, int causal, float scale, int64_t qb, int64_t qh,
    int64_t qs, int64_t kb, int64_t kh, int64_t ks, int64_t vb, int64_t vh,
    int64_t vs, int64_t ob, int64_t oh, int64_t os, void* stream) {
  const int64_t st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, o, b, hq, hkv, seq, causal, scale, st, s);
  if (d == 128)
    return launch<128>(q, k, v, o, b, hq, hkv, seq, causal, scale, st, s);
  return (int)cudaErrorInvalidValue;
}
