// Floor probes of the neighbor sweeps for NVIDIA Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by
// smoothed_particle_hydrodynamics_tpu_torch/tools/probe_dma_floor.py, whose
// floor_window_t_plain and floor_band_t_plain are the PyTorch versions of
// the same sums.
//
// Replaces tools/probe_dma_floor.py::_probe_kernel (the JAX package's probe,
// a Pallas TPU kernel run through pallas_step_t._run_chunked): a kernel with
// the skeleton of a production sweep and trivial arithmetic, whose three
// modes change one thing at a time so that the sweep's time splits into the
// bytes it stages, its per-window (here per-piece) costs and its compute.
//
// The ladder.  For a self row's x_i and a candidate row's first two columns
// (x_j, y_j): u = x_j - x_i, then K times u = fma(u, c, y_j) with
// c = 0.9999999f, a dependent FMA chain the compiler cannot fold.  A self
// row's output is the sum of u over the rows it tests.  K (2, 12, 24) is a
// template parameter, so the ladder unrolls as the TPU kernel's does.
//
// floor_window_t<Mode, K>: the TPU kernel's walk.  One CUDA block per block
// of b sorted self rows (b = pallas_block_t, one thread a row); for each of
// the 9 rods the block stages the rows [ws, ws + L) of the padded candidate
// frame ([n_pad, 6]: x y z cid m iota, the JAX tool's columns) into shared
// memory with 16-byte cp.async copies, the next rod's rows landing while
// this rod's are tested (the TPU kernel's DMA double buffer, here over rods
// within a block), and every thread runs the ladder over every staged row.
// Window starts are multiples of 8 rows (_block_windows_t aligns them), so
// every copy is 16-byte aligned.  Modes:
//   full:      L = s_t rows, the ladder over each;
//   halfbytes: L = s_t / 2 rows, the ladder over them twice (the same
//              ladders, half the bytes and half the copy instructions);
//   nostage:   no copies; the ladder over a zero-filled slot of s_t rows.
// The JAX kernel's halfbytes reads rows [s_t/2, s_t) of a scratch buffer
// that nothing wrote, and its nodma reads the scratch as it is: on the TPU
// their times are valid and their outputs undefined.  Here both are
// defined: halfbytes gives twice the full sum at window s_t/2 over the same
// starts, nostage 9 s_t (-x_i c^K), summed row by row.
//
// floor_band_t<Mode, K, W>: the port's production skeleton.  It runs
// band_walk (band_walk.cuh, the walk of sweep_t.cu's K1, K2 and K3) over a
// candidate frame of W words a row ([m, W]) and its cell-start table, with
// this probe's Stage and Test: each lane runs the ladder on every row of its
// own bands, as K1 (W = 4: x y z m) and exact K2 (W = 9 = kForceCols) test
// their rows, in 96-row pieces as they stage them.  Modes:
//   full:      the W words of each piece's rows staged, as the sweeps do;
//   halfbytes: the same pieces and tested rows, W / 2 words a row staged;
//   nostage:   the same pieces and tested rows (cell-start loads and warp
//              reductions included), no copies, a zero-filled slot.
// So full - nostage is the staging, and the FMA slope of nostage over K
// gives the ladder's rate and, at K = 0, the walk alone.
//
// What bounds them.  At K = 2 the window walk's staged bytes (9 s_t rows of
// 24 B a block: ~350 MB at the 1M splash) over device memory, most of them
// from L2 since neighbouring blocks' windows overlap; at K = 24 the ladder's
// lane operations, (K + 2) a tested row and self row, over the card's
// 128 lanes a clock a SM.  The band walk tests ~350 rows a self row exact at
// the 1M splash against the window walk's ~1900, so its ladder is ~6x
// cheaper and its walk (pieces, warp reductions, cell-start loads) is a
// larger share: that share is what this probe measures.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "band_walk.cuh"

namespace {

enum Mode { kFull = 0, kHalfBytes = 1, kNoStage = 2 };

constexpr float kC = 0.9999999f;
constexpr int kFrameCols = 6;   // window frame: x y z cid m iota
constexpr int kFloorPiece = 96;  // K1's and exact K2's piece (sweep_t.cu)
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory

template <int K>
__device__ __forceinline__ float ladder(float xj, float yj, float xi) {
  float u = xj - xi;
#pragma unroll
  for (int k = 0; k < K; ++k) u = __fmaf_rn(u, kC, yj);
  return u;
}

struct WindowArgs {
  const float* frame;  // [n_pad, kFrameCols] padded candidate frame
  const float* x;      // [n] self x
  const int* ws;       // [nblocks * 9] window starts (multiples of 8)
  float* out;          // [n]
  int n, s_t;
};

template <int kMode>
__host__ __device__ constexpr int window_rows(int s_t) {
  return kMode == kHalfBytes ? s_t / 2 : s_t;
}

template <int kMode, int K>
__global__ void floor_window_t(WindowArgs a) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  const int len = window_rows<kMode>(a.s_t);
  const int slot = len * kFrameCols;  // words; a multiple of 24
  const int i = blockIdx.x * b + threadIdx.x;
  const float xi = i < a.n ? a.x[i] : 0.f;
  const int* ws = a.ws + blockIdx.x * kRods;
  auto stage = [&](int r, float* dst) {
    const float4* src = reinterpret_cast<const float4*>(
        a.frame + static_cast<long long>(ws[r]) * kFrameCols);
    float4* d = reinterpret_cast<float4*>(dst);
    for (int w = threadIdx.x; w < slot / 4; w += b)
      __pipeline_memcpy_async(d + w, src + w, sizeof(float4));
  };
  if constexpr (kMode == kNoStage) {
    for (int w = threadIdx.x; w < slot; w += b) smem[w] = 0.f;
    __syncthreads();
  } else {
    stage(0, smem);
    __pipeline_commit();
  }
  float acc = 0.f;
  for (int r = 0; r < kRods; ++r) {
    const float* t = smem;
    if constexpr (kMode != kNoStage) {
      t = smem + (r & 1) * slot;
      if (r + 1 < kRods) stage(r + 1, smem + ((r + 1) & 1) * slot);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // rod r's rows have landed
      __syncthreads();
    }
    for (int pass = 0; pass < (kMode == kHalfBytes ? 2 : 1); ++pass) {
      float s = 0.f;
#pragma unroll 4
      for (int j = 0; j < len; ++j)
        s += ladder<K>(t[j * kFrameCols], t[j * kFrameCols + 1], xi);
      acc += s;
    }
    if constexpr (kMode != kNoStage)
      __syncthreads();  // every thread is done with the slot before restage
  }
  if (i < a.n) a.out[i] = acc;
}

struct BandArgs {
  const float* cand;      // [m, W] candidate frame, sorted by cell
  const float* x;         // [n] self x
  const int* cid;         // [n] self cell ids
  const int* cell_start;  // [num_cells + 1] first candidate row of each cell
  float* out;             // [n]
  int n, m, num_cells, nx, ny;
};

// Words a row the band walk stages: W, or the first W / 2 (halfbytes).
template <int kMode, int W>
constexpr int kBandWords = kMode == kHalfBytes ? W / 2 : W;

template <int kMode, int K, int W>
__global__ void __launch_bounds__(kBandBlock) floor_band_t(BandArgs a) {
  constexpr int kWords = kBandWords<kMode, W>;
  constexpr int kPiece = kFloorPiece;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBandBlock + threadIdx.x;
  const bool live = i < a.n;
  float xi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.x[i];
    ci = a.cid[i];
  }
  if constexpr (kMode == kNoStage) {
    extern __shared__ float smem[];
    float* buf = smem + (threadIdx.x >> 5) * 2 * kPiece * kWords;
    for (int w = lane; w < 2 * kPiece * kWords; w += 32) buf[w] = 0.f;
    __syncwarp();
  }
  float acc = 0.f;
  auto stage = [&](float* dst, const Piece& p) {
    if constexpr (kMode == kFull) {
      stage_rows<W>(dst, a.cand, p.lo, p.hi, lane);
    } else if constexpr (kMode == kHalfBytes) {
      // the first W / 2 words of each row, one word a lane a copy
      const int words = (p.hi - p.lo) * kWords;
      for (int w = lane; w < words; w += 32) {
        const int row = w / kWords;
        const float* s =
            a.cand + static_cast<long long>(p.lo + row) * W + (w - row * kWords);
        __pipeline_memcpy_async(dst + w, s, sizeof(float));
      }
    }
  };
  auto test = [&](const float* sp, const Piece& p) {
    const int j1 = min(p.e, p.hi);
    for (int j = max(p.a, p.lo); j < j1; ++j) {
      const int k = j - p.lo;
      acc += ladder<K>(sp[k * kWords], sp[k * kWords + 1], xi);
    }
  };
  band_walk<kPiece, kWords>(a.cell_start, ci, live, a.nx, a.ny, a.num_cells,
                            a.m, stage, test);
  if (live) a.out[i] = acc;
}

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, int nblocks, int threads,
           size_t smem, void* stream) {
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nblocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, int K>
int launch_window(const WindowArgs& a, int block, void* stream) {
  const int slots = kMode == kNoStage ? 1 : 2;
  const size_t smem = static_cast<size_t>(slots) *
                      window_rows<kMode>(a.s_t) * kFrameCols * sizeof(float);
  return launch(floor_window_t<kMode, K>, a, (a.n + block - 1) / block, block,
                smem, stream);
}

template <int kMode, int K, int W>
int launch_band(const BandArgs& a, void* stream) {
  const size_t smem = static_cast<size_t>(kBandBlock / 32) * 2 *
                      kFloorPiece * kBandWords<kMode, W> * sizeof(float);
  return launch(floor_band_t<kMode, K, W>, a,
                (a.n + kBandBlock - 1) / kBandBlock, kBandBlock, smem, stream);
}

template <int kMode>
int window_k(const WindowArgs& a, int block, int k, void* stream) {
  switch (k) {
    case 2:
      return launch_window<kMode, 2>(a, block, stream);
    case 12:
      return launch_window<kMode, 12>(a, block, stream);
    case 24:
      return launch_window<kMode, 24>(a, block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kMode, int W>
int band_k(const BandArgs& a, int k, void* stream) {
  switch (k) {
    case 2:
      return launch_band<kMode, 2, W>(a, stream);
    case 12:
      return launch_band<kMode, 12, W>(a, stream);
    case 24:
      return launch_band<kMode, 24, W>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int W>
int band_mode(const BandArgs& a, int mode, int k, void* stream) {
  switch (mode) {
    case kFull:
      return band_k<kFull, W>(a, k, stream);
    case kHalfBytes:
      return band_k<kHalfBytes, W>(a, k, stream);
    case kNoStage:
      return band_k<kNoStage, W>(a, k, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError(): nonzero when the launch was refused or an
// argument (mode, k, width, shared memory) is not one it takes.
// mode: 0 full, 1 halfbytes, 2 nostage; k: 2, 12 or 24.

// The window walk: self rows [n] in blocks of `block` threads, each block's
// 9 rods at the starts ws[blk * 9 + r] of the padded frame [n_pad, 6];
// s_t a multiple of 8.
int floor_window(const float* frame, const float* x, const int* ws,
                 float* out, int n, int block, int s_t, int mode, int k,
                 void* stream) {
  WindowArgs a;
  a.frame = frame;
  a.x = x;
  a.ws = ws;
  a.out = out;
  a.n = n;
  a.s_t = s_t;
  if (s_t <= 0 || s_t % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kFull:
      return window_k<kFull>(a, block, k, stream);
    case kHalfBytes:
      return window_k<kHalfBytes>(a, block, k, stream);
    case kNoStage:
      return window_k<kNoStage>(a, block, k, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The band walk: self rows [n] (x, cid) over m candidates [m, width] sorted
// by cell, with the candidates' [num_cells + 1] cell-start table; width 4
// (K1's staged words) or 9 (exact K2's).
int floor_band(const float* cand, const float* x, const int* cid,
               const int* cell_start, float* out, int n, int m, int width,
               int num_cells, int nx, int ny, int mode, int k, void* stream) {
  BandArgs a;
  a.cand = cand;
  a.x = x;
  a.cid = cid;
  a.cell_start = cell_start;
  a.out = out;
  a.n = n;
  a.m = m;
  a.num_cells = num_cells;
  a.nx = nx;
  a.ny = ny;
  switch (width) {
    case 4:
      return band_mode<4>(a, mode, k, stream);
    case 9:
      return band_mode<9>(a, mode, k, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
