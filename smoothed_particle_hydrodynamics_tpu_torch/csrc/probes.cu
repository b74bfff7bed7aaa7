// Hardware probes for NVIDIA Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by smoothed_particle_hydrodynamics_tpu_torch/tools/, whose
// probe_vpu_ops.py, probe_gather.py and probe_mxu.py hold the plain PyTorch
// version of each kernel and the probe's main routine.
//
// Replaces the JAX package's TPU probes in tools/:
//   chain_kernel<Op>          <- probe_vpu_ops.py::_chain_kernel (and the
//                                approximate-reciprocal table kernel, :118);
//   gather_tile_kernel<Mode>  <- probe_gather.py::make_gather;
//   d2_tile_kernel<Mode>      <- probe_mxu.py::kernel.
// Each asks, for this card, a question the TPU probe asked of the TPU.
//
// chain_kernel: what one f32 op costs inside the force loops.  One thread
// per element (a grid-stride loop) runs a K-deep dependent chain of one op in
// registers.  The mul baseline moves 64 MB in and 64 MB out and sits near
// the memory bound; ops that issue on the multi-function unit (MUFU: rcp,
// rsqrt; 16 per clock per SM against 128 for f32 mul/add) are bound by
// issue.  The build's flags (utils/build.py: --fmad=false, no
// -use_fast_math) make sqrtf and '/' the IEEE-rounded sequences that
// csrc/sweep_t.cu's force loops compile to.  ptxas folds rcp.approx of
// rcp.approx to the identity, so the approximate-reciprocal chain adds a
// zero it cannot see (a kernel argument) before each reciprocal.
//
// gather_tile_kernel: can a kernel gather rows of a [S, 128] window in
// place of the TPU's failed in-kernel compaction?  out[b S + r, l] =
// src[b S + idx[b S + r, l], l].  Bound by device memory: src, idx and out
// once each (3 x 16.8 MB at 4M elements, 15.0 us at 3.35 TB/s; the probe
// times it on copies that together span ~4x the 50 MB L2).
// GATHER_SMEM is a persistent TMA pipeline: as many CTAs as fit on the SMs
// walk the tiles (block b, lane strip y) of width w; one producer thread
// loads each tile's strip [S, w] as TMA boxes of up to 256 rows into a ring
// of 2-3 shared-memory buffers (an mbarrier per buffer completes on the
// strip's bytes), so the next tiles' strips load while this one gathers;
// the 512 consumers read their idx as 16 B streaming loads before waiting
// for the strip, gather 4 lanes each, store 16 B, and release the buffer.
// w is chosen for stages, not banks (probe_gather.strip_width: 2 strips
// must fit in 227 KB, so w = 16 at S = 1024 and 8 at 1920; at w < 32 the
// lane-varying reads conflict at most 32 / w ways, a few thousand
// shared-memory cycles per SM, under the device-memory time).
// GATHER_ONESHOT is GATHER_SMEM's first design, kept as its reference: one
// CTA of 1024 threads per (block, strip) stages the whole strip with
// scalar loads, syncs, then gathers (no overlap of idx and out with the
// strip, one CTA per SM at S = 1024).  GATHER_GLOBAL reads src directly
// with __ldg.  EW (2x + 1) and CHAIN (12 x (x * 1.0001 + 0.5)) are the
// elementwise yardsticks.
//
// d2_tile_kernel: can the pair distance run on the tensor cores, and at
// what precision?  One CTA per tile transposes three [9, 128] granules
// into shared memory [384, 9], reads rows [off, off + 160) (off from device
// memory, per tile), builds P = [x_j, |x_j|^2, 1] and Q = [-2 x_i; 1;
// |x_i|^2] and computes d^2 = P Q [160, 128]: FMA in f32 on the CUDA cores;
// TF32 with mma.sync m16n8k8 (K padded 5 -> 8 with zeros, operands rounded
// by cvt.rna.tf32.f32, 10 m-tiles by 16 n-tiles); TF32X3 with each operand
// split into a TF32 big part and a TF32 small part and three products
// (the analog of the TPU's Precision.HIGHEST).  Bound by writing d^2.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

#include <cstdio>

namespace {

constexpr int kLanes = 128;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Grid of a grid-stride loop over n elements: at most 2048 threads per SM.
int stride_blocks(long long n, int threads) {
  const long long need = (n + threads - 1) / threads;
  const long long cap = static_cast<long long>(sm_count()) * (2048 / threads);
  return static_cast<int>(need < cap ? need : cap);
}

// ---------------------------------------------------------------------------
// chain_kernel<Op>
// ---------------------------------------------------------------------------

// In the order of probe_vpu_ops.OPS.
enum ChainOp {
  kMul = 0,
  kAdd,
  kSqrt,
  kRsqrt,
  kDiv,
  kRecip,
  kRecipApprox,
  kSelect,
  kCenterNow,
  kCenterRecip,
  kCenterRsqrt,
};

// the center term's constants (tools/probe_vpu_ops.py:90)
constexpr float kH = 2.0f, kEps = 1e-3f, kScale = 0.77f, kM = 1.1f;

// pl.reciprocal(approx=True): one MUFU.RCP, flushing subnormals
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// zero: 0.0f at run time (see the header), read by kRecipApprox only
template <int Op>
__device__ __forceinline__ float chain_op(float v, float zero) {
  if constexpr (Op == kMul) {
    return v * 1.0000001f;
  } else if constexpr (Op == kAdd) {
    return v + 1e-7f;
  } else if constexpr (Op == kSqrt) {
    return sqrtf(v);  // sqrt.rn.f32 under the package's flags
  } else if constexpr (Op == kRsqrt) {
    return rsqrtf(v);  // MUFU.RSQ
  } else if constexpr (Op == kDiv) {
    return 1.0000001f / v;  // div.rn.f32
  } else if constexpr (Op == kRecip) {
    return __frcp_rn(v);
  } else if constexpr (Op == kRecipApprox) {
    return rcp_approx(v + zero);
  } else if constexpr (Op == kSelect) {
    return v > 1.0f ? v * 0.9999f : v;
  } else if constexpr (Op == kCenterNow) {
    // the operators of K2's center term (csrc/sweep_t.cu force_kernel_t:
    // d = sqrtf(d2) * scale, then num / (d + eps) * scale)
    const float d = sqrtf(v) * kScale;
    const float hd = kH - d;
    return (hd * hd) * kM / (d + kEps) * kScale * 0.3f + v * 0.7f;
  } else if constexpr (Op == kCenterRecip) {
    const float d = sqrtf(v) * kScale;
    const float hd = kH - d;
    return (hd * hd) * kM * rcp_approx(d + kEps) * kScale * 0.3f + v * 0.7f;
  } else {
    static_assert(Op == kCenterRsqrt, "unknown chain op");
    const float t = rsqrtf(v);
    const float d = v * t * kScale;
    const float hd = kH - d;
    return (hd * hd) * kM * rcp_approx(d + kEps) * kScale * 0.3f + v * 0.7f;
  }
}

template <int Op>
__global__ void chain_kernel(const float* __restrict__ x,
                             float* __restrict__ out, long long n, int k,
                             float zero) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float v = x[i];
#pragma unroll 16
    for (int j = 0; j < k; ++j) v = chain_op<Op>(v, zero);
    out[i] = v;
  }
}

template <int Op>
void launch_chain(const float* x, float* out, long long n, int k,
                  cudaStream_t s) {
  constexpr int kThreads = 256;
  chain_kernel<Op><<<stride_blocks(n, kThreads), kThreads, 0, s>>>(x, out, n,
                                                                  k, 0.0f);
}

// ---------------------------------------------------------------------------
// gather_tile_kernel<Mode>
// ---------------------------------------------------------------------------

// In the order of probe_gather.MODES; kGatherOneShot (probe_gather.ONESHOT)
// is the first design of kGatherSmem, kept as its reference.
enum GatherMode { kEw = 0, kChain, kGatherSmem, kGatherGlobal, kGatherOneShot };

constexpr int kGatherThreads = 256;  // the elementwise and global modes
constexpr int kOneShotThreads = 1024;
constexpr int kConsumerWarps = 16;   // kGatherSmem: 512 consumers
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kPipeThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 3;
constexpr int kVecs = 8;             // 16 B vectors a consumer holds at once
constexpr int kMaxBoxRows = 256;     // TMA's largest box side

constexpr int gather_threads(int mode) {
  return mode == kGatherSmem      ? kPipeThreads
         : mode == kGatherOneShot ? kOneShotThreads
                                  : kGatherThreads;
}

// src, idx, out: [nb * S, 128] (fewer than 2^31 elements); idx holds rows
// of its own block, in [0, S): an index outside traps (the launch fails)
// instead of reading out of bounds.  w: the strip width, a power of two
// dividing 128 (kGatherSmem: 8 to 32; kGatherOneShot: any).  kGatherSmem's
// ring holds `stages` strips, each loaded as S / box_rows TMA boxes.
struct GatherArgs {
  const float* src;
  const int* idx;
  float* out;
  int S, nb, w, stages, box_rows;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at (lane x, row y) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map,
                                            int x, int y,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// 16 B of idx, read once: not kept in L1
__device__ __forceinline__ int4 ld_stream(const int* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// (v.x, v.y, v.z, v.w) rotated left by r (0-3): component c of the result
// is component (c + r) & 3 of v
template <typename V>
__device__ __forceinline__ V rotl(V v, int r) {
  if (r & 1) v = V{v.y, v.z, v.w, v.x};
  if (r & 2) v = V{v.z, v.w, v.x, v.y};
  return v;
}

template <int Mode>
__global__ void __launch_bounds__(gather_threads(Mode))
    gather_tile_kernel(const __grid_constant__ CUtensorMap map,
                       const GatherArgs a) {
  const float* __restrict__ src = a.src;
  const int* __restrict__ idx = a.idx;
  float* __restrict__ out = a.out;
  const int S = a.S;
  if constexpr (Mode == kGatherSmem) {
    // Persistent: CTA c takes tiles c, c + grid, ...; tile t is block
    // b = t / strips, lanes [y w, y w + w) with y = t % strips.  The last
    // warp's first thread loads each tile's strip [S, w] by TMA into the
    // ring's next buffer (`full` completes on the strip's bytes); the
    // consumers read their idx vectors, wait for the strip, gather, store,
    // and release the buffer (`empty`, one arrival per warp).  Tile i uses
    // buffer i % stages in its round i / stages: full's phase of that
    // round's parity, and empty's of the round before.
    __shared__ unsigned long long full[kMaxStages], empty[kMaxStages];
    extern __shared__ unsigned char dyn[];
    float* ring = reinterpret_cast<float*>(
        (reinterpret_cast<unsigned long long>(dyn) + 127) & ~127ull);
    const int w = a.w, stages = a.stages;
    const int strips = kLanes / w;
    const int tiles = a.nb * strips;
    const int strip_floats = S * w;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        const int boxes = S / a.box_rows;
        for (int i = 0, t = blockIdx.x; t < tiles; ++i, t += gridDim.x) {
          const int s = i % stages;
          if (i >= stages) mbar_wait(&empty[s], (i / stages - 1) & 1);
          mbar_expect_tx(&full[s], strip_floats * sizeof(float));
          const int b = t / strips, y = t - b * strips;
          float* dst = ring + s * strip_floats;
          for (int k = 0; k < boxes; ++k) {
            tma_load_2d(dst + k * a.box_rows * w, &map, y * w,
                        b * S + k * a.box_rows, &full[s]);
          }
        }
      }
      return;
    }
    // Consumer vector v of a tile: row v / quads, lanes 4 (v % quads) + 0-3
    // of the strip.  A warp's 32 vectors span 32 / quads rows; at w = 32
    // that is 4 rows of the same 8 quads, so each thread reads its four
    // lanes starting at component rot (its row in the warp, mod 4): the
    // warp's 4 rows then hit 32 distinct banks at each step.  At w = 16
    // (8) two (four) threads share a bank position, in rows that differ:
    // at most 2-way (4-way) conflicts.
    const int quads = w >> 2;
    const int qsh = __ffs(quads) - 1;
    const int wsh = __ffs(w) - 1;
    const int vecs = S << qsh;
    const int rot = (lane >> qsh) & 3;
    for (int i = 0, t = blockIdx.x; t < tiles; ++i, t += gridDim.x) {
      const int s = i % stages;
      const int b = t / strips, y = t - b * strips;
      const int base = b * S * kLanes + y * w;
      const float* strip = ring + s * strip_floats;
      // every consumer waits for the strip, with vectors or not, so no warp
      // can arrive at `empty` twice in one of its phases
      bool waited = false;
      for (int v0 = threadIdx.x; v0 < vecs || !waited;
           v0 += kVecs * kConsumers) {
        int4 j[kVecs];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          const int v = v0 + u * kConsumers;
          if (v < vecs) {
            j[u] = ld_stream(idx + base + ((v >> qsh) << 7) +
                             ((v & (quads - 1)) << 2));
          }
        }
        if (!waited) {
          mbar_wait(&full[s], (i / stages) & 1);
          waited = true;
        }
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          const int v = v0 + u * kConsumers;
          if (v < vecs) {
            const int4 jr = rotl(j[u], rot);
            const unsigned hi = max(max(static_cast<unsigned>(jr.x),
                                        static_cast<unsigned>(jr.y)),
                                    max(static_cast<unsigned>(jr.z),
                                        static_cast<unsigned>(jr.w)));
            if (hi >= static_cast<unsigned>(S)) __trap();
            const int l0 = (v & (quads - 1)) << 2;
            const float4 o = {strip[(jr.x << wsh) + l0 + rot],
                              strip[(jr.y << wsh) + l0 + ((rot + 1) & 3)],
                              strip[(jr.z << wsh) + l0 + ((rot + 2) & 3)],
                              strip[(jr.w << wsh) + l0 + ((rot + 3) & 3)]};
            *reinterpret_cast<float4*>(out + base + ((v >> qsh) << 7) + l0) =
                rotl(o, (4 - rot) & 3);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  } else if constexpr (Mode == kGatherOneShot) {
    // grid (nb, 128 / w), 1024 threads: block b's lanes [l0, l0 + w),
    // staged whole in shared memory, then gathered
    extern __shared__ float strip1[];  // [S, w], lane fastest
    const int w = a.w;
    const int base = blockIdx.x * S * kLanes + blockIdx.y * w;
    const int sh = __ffs(w) - 1;  // log2 w
    const int cells = S * w;
    for (int e = threadIdx.x; e < cells; e += blockDim.x) {
      const int r = e >> sh;
      strip1[e] = src[base + r * kLanes + (e & (w - 1))];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < cells; e += blockDim.x) {
      const int l = e & (w - 1);
      const int at = base + (e >> sh) * kLanes + l;
      const int j = idx[at];
      if (static_cast<unsigned>(j) >= static_cast<unsigned>(S)) __trap();
      out[at] = strip1[(j << sh) + l];
    }
  } else {
    const int n = a.nb * S * kLanes;
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      if constexpr (Mode == kEw) {
        out[i] = src[i] * 2.0f + 1.0f;
      } else if constexpr (Mode == kChain) {
        float x = src[i];
#pragma unroll
        for (int j = 0; j < 12; ++j) x = x * 1.0001f + 0.5f;
        out[i] = x;
      } else {
        static_assert(Mode == kGatherGlobal, "unknown gather mode");
        const int row = i >> 7;              // i / 128
        const int first = row - row % S;     // the block's first row
        const int j = idx[i];
        if (static_cast<unsigned>(j) >= static_cast<unsigned>(S)) __trap();
        out[i] = __ldg(src + (first + j) * kLanes + (i & (kLanes - 1)));
      }
    }
  }
}

// Errors of the tensor-map encoder: kEncodeError + its CUresult, or
// kNoEncoder when the CUDA library has none (sph_error_string names both).
constexpr int kEncodeError = 100000;
constexpr int kNoEncoder = kEncodeError - 1;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA library the runtime loaded (so the
// library links nothing beyond the runtime)
int encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (!found) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return kNoEncoder;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return 0;
}

// The tensor map of src [rows, 128] f32 in boxes of [box_rows, w], encoded
// once per (pointer, rows, w, box_rows) and kept (the last 8).
int strip_map(const float* src, int rows, int w, int box_rows,
              CUtensorMap* out) {
  struct Entry {
    const float* src;
    int rows, w, box_rows;
    CUtensorMap map;
  };
  static Entry cache[8];
  static int held = 0, next = 0;
  for (int e = 0; e < held; ++e) {
    const Entry& c = cache[e];
    if (c.src == src && c.rows == rows && c.w == w && c.box_rows == box_rows) {
      *out = c.map;
      return 0;
    }
  }
  EncodeTiled encode;
  if (const int err = encoder(&encode)) return err;
  Entry& c = cache[next];
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kLanes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kLanes * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      &c.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(src),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) {
    c.src = nullptr;
    return kEncodeError + static_cast<int>(res);
  }
  c.src = src;
  c.rows = rows;
  c.w = w;
  c.box_rows = box_rows;
  next = (next + 1) % 8;
  held = held < 8 ? held + 1 : 8;
  *out = c.map;
  return 0;
}

// Raise kernel's dynamic shared-memory limit to `bytes` the first time a
// launch needs more than it was given so far (not on every launch).
template <int Mode>
cudaError_t smem_limit(int bytes) {
  static int given = 48 * 1024;
  if (bytes <= given) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gather_tile_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess) given = bytes;
  return err;
}

// max_grid > 0 caps the CTAs below what fits on the SMs, so that each takes
// many tiles and wraps its ring (chip_smoke.py checks that walk).
int launch_gather_pipe(const GatherArgs& a, int max_grid, cudaStream_t s) {
  const int w = a.w;
  const bool ok =
      w >= 8 && w <= 32 && (w & (w - 1)) == 0 && a.stages >= 1 &&
      a.stages <= kMaxStages && a.box_rows >= 1 &&
      a.box_rows <= kMaxBoxRows && a.S % a.box_rows == 0 &&
      (a.box_rows * w * sizeof(float)) % 128 == 0;  // box offsets aligned
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = a.stages * a.S * w * static_cast<int>(sizeof(float)) + 128;
  CUtensorMap map;
  if (const int err = strip_map(a.src, a.nb * a.S, w, a.box_rows, &map)) {
    return err;
  }
  if (const cudaError_t err = smem_limit<kGatherSmem>(smem)) {
    return static_cast<int>(err);
  }
  int fit = 0;  // CTAs per SM at this ring size
  if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, gather_tile_kernel<kGatherSmem>, kPipeThreads, smem)) {
    return static_cast<int>(err);
  }
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = a.nb * (kLanes / w);
  int grid = fit * sm_count() < tiles ? fit * sm_count() : tiles;
  if (max_grid > 0 && max_grid < grid) grid = max_grid;
  gather_tile_kernel<kGatherSmem><<<grid, kPipeThreads, smem, s>>>(map, a);
  return 0;
}

// ---------------------------------------------------------------------------
// d2_tile_kernel<Mode>
// ---------------------------------------------------------------------------

// In the order of probe_mxu.MODES.
enum D2Mode { kFma = 0, kTf32, kTf32x3 };

constexpr int kF = 9;                  // rows of a granule
constexpr int kGranules = 3;
constexpr int kTrRows = kGranules * kLanes;  // 384
constexpr int kSt = 160;               // window rows
constexpr int kKPad = 8;               // P's columns / Q's rows, 5 padded
constexpr int kD2Threads = 128;        // 4 warps, 4 n-tiles of 8 lanes each

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: a 16x8 row-major A fragment, an 8x8 column-major B fragment
// (PTX ISA, mma.m16n8k8 .tf32: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0 d1 (g, 2t, 2t + 1),
// d2 d3 (g + 8, 2t, 2t + 1), with g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(d[0]), "f"(d[1]), "f"(d[2]), "f"(d[3]));
}

// g [T, 3, 9, 128], selfv [T, 9, 128] (rows 0-2: x_i), off [T] in
// [0, 224] (an off outside traps); out [T, 160, 128].
template <int Mode>
__global__ void __launch_bounds__(kD2Threads)
    d2_tile_kernel(const float* __restrict__ g, const float* __restrict__ selfv,
                   const int* __restrict__ off, float* __restrict__ out) {
  __shared__ float tr[kTrRows * kF];  // the transposed granules
  __shared__ float p[kSt * kKPad];    // [160, 8]
  __shared__ float q[kKPad * kLanes];  // [8, 128]
  const int t = blockIdx.x;
  const int tid = threadIdx.x;

  // 1. transpose: tr[c * 128 + l][f] = g[t, c, f, l] (stride 9 words, so 32
  //    consecutive lanes write 32 distinct banks)
  const float* gt = g + static_cast<long long>(t) * kGranules * kF * kLanes;
  for (int e = tid; e < kGranules * kF * kLanes; e += kD2Threads) {
    const int c = e / (kF * kLanes);
    const int f = (e / kLanes) % kF;
    const int l = e % kLanes;
    tr[(c * kLanes + l) * kF + f] = gt[e];
  }
  // Q's column l (one thread per lane)
  {
    const float* st = selfv + static_cast<long long>(t) * kF * kLanes;
    const float x0 = st[tid], x1 = st[kLanes + tid], x2 = st[2 * kLanes + tid];
    q[tid] = -2.0f * x0;
    q[kLanes + tid] = -2.0f * x1;
    q[2 * kLanes + tid] = -2.0f * x2;
    q[3 * kLanes + tid] = 1.0f;
    q[4 * kLanes + tid] = x0 * x0 + x1 * x1 + x2 * x2;
    for (int r = 5; r < kKPad; ++r) q[r * kLanes + tid] = 0.0f;
  }
  __syncthreads();

  // 2.-3. rows [o, o + 160) of the scratch, and P
  const int o = off[t];
  if (o < 0 || o > kTrRows - kSt) __trap();
  for (int r = tid; r < kSt; r += kD2Threads) {
    const float* w = tr + (o + r) * kF;
    const float x0 = w[0], x1 = w[1], x2 = w[2];
    float* pr = p + r * kKPad;
    pr[0] = x0;
    pr[1] = x1;
    pr[2] = x2;
    pr[3] = x0 * x0 + x1 * x1 + x2 * x2;
    pr[4] = 1.0f;
    for (int c = 5; c < kKPad; ++c) pr[c] = 0.0f;
  }
  __syncthreads();

  float* ot = out + static_cast<long long>(t) * kSt * kLanes;
  if constexpr (Mode == kFma) {
    // one thread per lane, P's rows broadcast from shared memory
    const float q0 = q[tid], q1 = q[kLanes + tid], q2 = q[2 * kLanes + tid];
    const float q3 = q[3 * kLanes + tid], q4 = q[4 * kLanes + tid];
    for (int r = 0; r < kSt; ++r) {
      const float* pr = p + r * kKPad;
      float d = pr[0] * q0;
      d = fmaf(pr[1], q1, d);
      d = fmaf(pr[2], q2, d);
      d = fmaf(pr[3], q3, d);
      d = fmaf(pr[4], q4, d);
      ot[r * kLanes + tid] = d;
    }
  } else {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tq = lane & 3;
    for (int mt = 0; mt < kSt / 16; ++mt) {
      const float* p0 = p + (mt * 16 + gid) * kKPad;
      const float* p1 = p0 + 8 * kKPad;
      const float av[4] = {p0[tq], p1[tq], p0[tq + 4], p1[tq + 4]};
      unsigned ab[4], as[4];
      for (int i = 0; i < 4; ++i) {
        ab[i] = to_tf32(av[i]);
        as[i] = Mode == kTf32x3 ? to_tf32(av[i] - __uint_as_float(ab[i])) : 0u;
      }
      for (int nt = warp * 4; nt < warp * 4 + 4; ++nt) {
        const int col = nt * 8 + gid;
        const float bv[2] = {q[tq * kLanes + col], q[(tq + 4) * kLanes + col]};
        unsigned bb[2], bs[2];
        for (int i = 0; i < 2; ++i) {
          bb[i] = to_tf32(bv[i]);
          bs[i] = Mode == kTf32x3 ? to_tf32(bv[i] - __uint_as_float(bb[i]))
                                  : 0u;
        }
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (Mode == kTf32x3) {
          // the small cross terms first, the big product last
          mma_tf32(d, as, bb);
          mma_tf32(d, ab, bs);
        }
        mma_tf32(d, ab, bb);
        const int c0 = nt * 8 + tq * 2;
        *reinterpret_cast<float2*>(ot + (mt * 16 + gid) * kLanes + c0) =
            make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(ot + (mt * 16 + gid + 8) * kLanes + c0) =
            make_float2(d[2], d[3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError(): nonzero when the launch was refused.

// out = x after k steps of chain op `op` (ChainOp), elementwise over n.
int probe_chain(const float* x, float* out, long long n, int op, int k,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kMul: launch_chain<kMul>(x, out, n, k, s); break;
    case kAdd: launch_chain<kAdd>(x, out, n, k, s); break;
    case kSqrt: launch_chain<kSqrt>(x, out, n, k, s); break;
    case kRsqrt: launch_chain<kRsqrt>(x, out, n, k, s); break;
    case kDiv: launch_chain<kDiv>(x, out, n, k, s); break;
    case kRecip: launch_chain<kRecip>(x, out, n, k, s); break;
    case kRecipApprox: launch_chain<kRecipApprox>(x, out, n, k, s); break;
    case kSelect: launch_chain<kSelect>(x, out, n, k, s); break;
    case kCenterNow: launch_chain<kCenterNow>(x, out, n, k, s); break;
    case kCenterRecip: launch_chain<kCenterRecip>(x, out, n, k, s); break;
    case kCenterRsqrt: launch_chain<kCenterRsqrt>(x, out, n, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One gather-probe mode (GatherMode) over nb blocks of [S, 128].  w: the
// strip width of kGatherSmem and kGatherOneShot; stages, box_rows and
// max_grid (0: as many CTAs as fit): kGatherSmem's ring and grid (the
// other modes ignore them).
int probe_gather_tile(const float* src, const int* idx, float* out, int S,
                      int nb, int w, int stages, int box_rows, int max_grid,
                      int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(nb) * S * kLanes;
  const GatherArgs a{src, idx, out, S, nb, w, stages, box_rows};
  const CUtensorMap none{};
  const int blocks = stride_blocks(n, kGatherThreads);
  switch (mode) {
    case kEw:
      gather_tile_kernel<kEw><<<blocks, kGatherThreads, 0, s>>>(none, a);
      break;
    case kChain:
      gather_tile_kernel<kChain><<<blocks, kGatherThreads, 0, s>>>(none, a);
      break;
    case kGatherGlobal:
      gather_tile_kernel<kGatherGlobal><<<blocks, kGatherThreads, 0, s>>>(
          none, a);
      break;
    case kGatherSmem:
      if (const int err = launch_gather_pipe(a, max_grid, s)) return err;
      break;
    case kGatherOneShot: {
      if (w <= 0 || (w & (w - 1)) != 0 || w > kLanes) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const int smem = S * w * static_cast<int>(sizeof(float));
      if (const cudaError_t err = smem_limit<kGatherOneShot>(smem)) {
        return static_cast<int>(err);
      }
      gather_tile_kernel<kGatherOneShot>
          <<<dim3(nb, kLanes / w), kOneShotThreads, smem, s>>>(none, a);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// d^2 of `tiles` tiles in mode `mode` (D2Mode).
int probe_d2_tile(const float* g, const float* selfv, const int* off,
                  float* out, int tiles, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFma:
      d2_tile_kernel<kFma><<<tiles, kD2Threads, 0, s>>>(g, selfv, off, out);
      break;
    case kTf32:
      d2_tile_kernel<kTf32><<<tiles, kD2Threads, 0, s>>>(g, selfv, off, out);
      break;
    case kTf32x3:
      d2_tile_kernel<kTf32x3><<<tiles, kD2Threads, 0, s>>>(g, selfv, off, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sph_error_string(int code) {
  static char msg[96];
  if (code == kNoEncoder) return "no cuTensorMapEncodeTiled in libcuda";
  if (code >= kEncodeError) {
    std::snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed: CUresult %d",
                  code - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
