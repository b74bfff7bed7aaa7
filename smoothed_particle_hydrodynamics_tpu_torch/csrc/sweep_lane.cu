// Lane-layout neighbor sweeps for NVIDIA Hopper (sm_90a): the eager
// (rebin-every-step) path of pallas_layout="lane".  Plain C interface, loaded
// with ctypes by smoothed_particle_hydrodynamics_tpu_torch/ops/sweeps_lane.py,
// whose density_lane_plain / force_lane_plain are the PyTorch versions of the
// same sums.
//
// Replace, in smoothed_particle_hydrodynamics_tpu/ops/pallas_step.py:
//   density_band_lane <- _density_kernel (:196, called at :417);
//   force_band_lane   <- _force_kernel   (:244, called at :450).
// Each launches once per step, over every row of the sorted frame.  The
// block walks density_kernel_lane and force_kernel_lane, which the band
// walks replaced, stay below as their bit-equality reference and "before"
// time (launched only by chip_smoke.py).
//
// These kernels share no device code with sweep_t.cu: they are a second,
// independent implementation of the same pair physics, against which the
// sublane kernels can be held on the card (and the other way round).
//
// What they compute.  Particles are sorted by linear cell id
// (z*ny + y)*nx + x, and their fields are rows of one table
// fields[F][n_pad]: density x y z m cid, force x y z vx vy vz m rho cid, the
// cid row holding int32 bits, rows [n, n_pad) padding (zeros, cid -2^30).
// Block b of `block` sorted rows walks, for each of the 9 (dy, dz) rods, the
// rows [ws, ws + wc*window) of the table (ws 128-aligned, wc <= 127 chunks of
// `window` rows, from the window table).  A pair (i, j) counts when
//     |cid_j - cid_i - delta_rod| <= 1  and  j != i  and  d^2 < h^2,
// with dx = x_i - x_j and d^2 = dx*dx + dy*dy + dz*dz.  The density kernel
// sums m_j poly6_norm t^3, t = h_scaled^2 - d^2 scale^2, and the neighbor
// count, plus the self term when include_self is set.  The force kernel forms
// per pair p_j = (rho_j - rho0) k, 1/rho_j (rho_j > 0, else 1),
// pweight = pw_i + p_j/rho_j^2, and sums the pressure term
// dx (h-d)^2 (m_j pweight)/(d+eps) scale and the viscosity term
// (v_j - v_i) (h-d) m_j/rho_j; the epilogue is (mu/rho_i v + a) visc_norm.
//
// Block walk (density_kernel_lane, force_kernel_lane).  One CUDA block per
// block of sorted rows, one thread per row.  For each rod the block stages
// one chunk of `window` candidate rows of every field in shared memory (each
// thread copies window/block rows), then each thread tests the whole chunk
// against its own particle and sums in registers.  The TPU kernels' tiled
// [n_pad/128, F, 128] DMA layout, double buffering and split grids are not
// carried over.  Rows of the last block beyond n are staged for their block
// but neither computed nor written.
//
// What bounds them.  The instruction rate of the pair tests: the block walk
// tests 9 rods x wc x window rows per thread, whole chunks (the 128-aligned
// start and the chunk rounding add rows outside the true rod window), of
// which under one percent are neighbors (~4700 rows tested for ~29 neighbors
// at the 1M splash).  The least time for the same work on an H100 is far
// below that: at the 1M splash the density kernel must move ~29 MB (each
// field row read once, the outputs written once), ~9 us at 3.35 TB/s, above
// its 15 flops on each of ~2.9e7 pairs within h at 67 TFLOP/s f32; the force
// kernel's 40 flops a pair, ~17 us, are above its ~49 MB.  The band walks
// below cut the tested rows to each lane's own cell bands.
//
// Rounding.  d^2 and t are formed with explicitly rounded intrinsics (no FMA
// contraction), so the mask sees the same bits as the plain PyTorch version's
// separate multiplies and adds; the build also passes --fmad=false so the
// rest of the arithmetic rounds op by op as well.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRods = 9;
constexpr int kDensityFields = 5;  // x y z m cid
constexpr int kForceFields = 9;    // x y z vx vy vz m rho cid
constexpr int kPadCid = -(1 << 30);

// Linear cell-id offset of rod r of [(dy, dz) for dy in (-1, 0, 1)
// for dz in (-1, 0, 1)]: (dz * ny + dy) * nx.
__device__ __forceinline__ int lane_rod_delta(int r, int nx, int ny) {
  const int dy = r / 3 - 1;
  const int dz = r % 3 - 1;
  return (dz * ny + dy) * nx;
}

// |cid_j - cid_i - delta| <= 1 in wrapping unsigned arithmetic: the pad rows'
// -2^30 lands far outside every band instead of overflowing.
__device__ __forceinline__ bool lane_in_band(int cid_j, int cid_i, int delta) {
  return static_cast<unsigned>(cid_j) - static_cast<unsigned>(cid_i) -
             static_cast<unsigned>(delta) + 1u <=
         2u;
}

__device__ __forceinline__ float lane_dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Copy rows [base, base + window) of `nf` field rows into shared memory,
// field f at s[f * window + k]; rows at or past n_pad (none, for a table
// built by _block_windows) read as padding.
__device__ __forceinline__ void stage_chunk(float* s, const float* fields,
                                            int nf, int n_pad, int base,
                                            int window) {
  for (int k = threadIdx.x; k < window; k += blockDim.x) {
    const int j = base + k;
    const bool in = j < n_pad;
    for (int f = 0; f < nf - 1; ++f) {
      s[f * window + k] =
          in ? fields[static_cast<long long>(f) * n_pad + j] : 0.f;
    }
    s[(nf - 1) * window + k] =
        in ? fields[static_cast<long long>(nf - 1) * n_pad + j]
           : __int_as_float(kPadCid);
  }
}

struct LaneDensityArgs {
  const float* fields;  // [5, n_pad]: x y z m, cid bits
  const int* ws;        // [nblocks * 9] window starts
  const int* wc;        // [nblocks * 9] chunk counts
  const int* cell_start;  // [num_cells + 1] first row of each cell (bands)
  float* rho;           // [n] out
  int* ncount;          // [n] out
  int n, n_pad, window, nx, ny, include_self, block, num_cells;
  float h2, h_scaled2, scale2, poly6;
};

__global__ void density_kernel_lane(LaneDensityArgs a) {
  extern __shared__ float smem[];
  const int s = a.window;
  const float* sx = smem;
  const float* sy = sx + s;
  const float* sz = sy + s;
  const float* sm = sz + s;
  const float* sc = sm + s;

  const int blk = blockIdx.x;
  const int i = blk * blockDim.x + threadIdx.x;
  const bool live = i < a.n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.fields[i];
    yi = a.fields[a.n_pad + i];
    zi = a.fields[2 * a.n_pad + i];
    ci = __float_as_int(a.fields[4 * a.n_pad + i]);
  }
  float rho = 0.f;
  int count = 0;
  for (int r = 0; r < kRods; ++r) {
    const int delta = lane_rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int chunks = a.wc[blk * kRods + r];
    for (int c = 0; c < chunks; ++c) {
      const int base = start + c * s;
      stage_chunk(smem, a.fields, kDensityFields, a.n_pad, base, s);
      __syncthreads();
      if (live) {
        for (int k = 0; k < s; ++k) {
          const float d2 = lane_dist2(xi - sx[k], yi - sy[k], zi - sz[k]);
          if (lane_in_band(__float_as_int(sc[k]), ci, delta) && base + k != i &&
              d2 < a.h2) {
            const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
            const float w = a.poly6 * t * t * t;
            rho += sm[k] * w;
            ++count;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    if (a.include_self) {
      const float h2s = a.h_scaled2;
      rho += a.fields[3 * a.n_pad + i] * a.poly6 * h2s * h2s * h2s;
    }
    a.rho[i] = rho;
    a.ncount[i] = count;
  }
}

struct LaneForceArgs {
  const float* fields;  // [9, n_pad]: x y z vx vy vz m rho, cid bits
  const int* ws;        // [nblocks * 9]
  const int* wc;        // [nblocks * 9]
  const int* cell_start;  // [num_cells + 1] first row of each cell (bands)
  float* acc;           // [n, 3] out: hydro acceleration
  int n, n_pad, window, nx, ny, block, num_cells;
  float h2, h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

__global__ void force_kernel_lane(LaneForceArgs a) {
  extern __shared__ float smem[];
  const int s = a.window;
  const int blk = blockIdx.x;
  const int i = blk * blockDim.x + threadIdx.x;
  const bool live = i < a.n;
  const long long np = a.n_pad;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  float rhoi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.fields[i];
    yi = a.fields[np + i];
    zi = a.fields[2 * np + i];
    vxi = a.fields[3 * np + i];
    vyi = a.fields[4 * np + i];
    vzi = a.fields[5 * np + i];
    rhoi = a.fields[7 * np + i];
    ci = __float_as_int(a.fields[8 * np + i]);
  }
  const float p_i = (rhoi - a.rho0) * a.stiffness;
  const float rhoi_inv = 1.f / (rhoi > 0.f ? rhoi : 1.f);
  const float pw_i = p_i * rhoi_inv * rhoi_inv;

  float ax = 0.f, ay = 0.f, az = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  for (int r = 0; r < kRods; ++r) {
    const int delta = lane_rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int chunks = a.wc[blk * kRods + r];
    for (int c = 0; c < chunks; ++c) {
      const int base = start + c * s;
      stage_chunk(smem, a.fields, kForceFields, a.n_pad, base, s);
      __syncthreads();
      if (live) {
        for (int k = 0; k < s; ++k) {
          const float dx = xi - smem[k];
          const float dy = yi - smem[s + k];
          const float dz = zi - smem[2 * s + k];
          const float d2 = lane_dist2(dx, dy, dz);
          if (lane_in_band(__float_as_int(smem[8 * s + k]), ci, delta) &&
              base + k != i && d2 < a.h2) {
            const float mj = smem[6 * s + k];
            const float rhoj = smem[7 * s + k];
            const float d = sqrtf(d2) * a.scale;
            const float hd = a.h - d;
            const float p_j = (rhoj - a.rho0) * a.stiffness;
            const float rhoj_inv = 1.f / (rhoj > 0.f ? rhoj : 1.f);
            const float pweight = pw_i + p_j * rhoj_inv * rhoj_inv;
            const float center = (hd * hd) * (mj * pweight) / (d + a.eps) * a.scale;
            ax += dx * center;
            ay += dy * center;
            az += dz * center;
            const float vweight = hd * (rhoj_inv * mj);
            vx += (smem[3 * s + k] - vxi) * vweight;
            vy += (smem[4 * s + k] - vyi) * vweight;
            vz += (smem[5 * s + k] - vzi) * vweight;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    const float mu_rhoi = a.viscosity * rhoi_inv;
    a.acc[3 * i] = mu_rhoi * vx * a.visc_norm + ax * a.visc_norm;
    a.acc[3 * i + 1] = mu_rhoi * vy * a.visc_norm + ay * a.visc_norm;
    a.acc[3 * i + 2] = mu_rhoi * vz * a.visc_norm + az * a.visc_norm;
  }
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// The lane pair as per-lane cell-band walks: density_band_lane and
// force_band_lane, the kernels the lane path launches.
//
// The frame is sorted by cell id, so the rows j that pass the cid mask of
// row i for rod delta, |cid_j - cid_i - delta| <= 1, are one contiguous
// range: [T[c - 1], T[c + 2]) with c = cid_i + delta, T the frame's cell
// start table (T[c] = first row of cell c, T[num_cells] = n; pad rows sit
// past n, in no band), the cell range clamped to [0, num_cells] so a rod
// outside the grid is empty.  Lane i walks that range intersected with its
// block's rod window [ws, ws + wc * window), blk = i / block: with no chunk
// cut by the 127 clamp the band lies inside the window (the block's first
// and last cells bracket cid_i) and the intersection cuts nothing; where the
// clamp cut chunks it drops exactly the rows the block walk never reaches.
// So each lane tests the block walk's pairs, rod by rod in increasing row
// order, which is the block walk's order (rod, chunk, k): with the same op
// sequence (dx = x_i - x_j, p_j and 1/rho_j per pair, the rounded d^2,
// --fmad=false) rho, the counts and acc equal density_kernel_lane's and
// force_kernel_lane's bit for bit.  The pair test keeps j != i and
// d^2 < h^2; the cid row of the candidates is no longer read.
//
// Staging.  A warp walks rod by rod; the union of its lanes' bands is copied
// into a warp-private shared-memory buffer with cp.async, one field row of
// the [F, n_pad] table after another (coalesced per field), in pieces of
// kLanePiece rows, the next piece landing while the current one is tested
// (double-buffered), and each lane tests only its own band rows in the
// piece.  Only __syncwarp and warp reductions: the 4 warps of a 128-thread
// block never wait on each other, whatever `block` (the window table's row
// block) is.  At the 1M splash a lane's band is ~180 rows against the block
// walk's ~4700 per thread.
//
// This walk is written here, not shared with sweep_t.cu's band walk, to
// keep the two kernel families independent (see the top of this file).

constexpr int kBandThreads = 128;  // threads (self rows) per block: 4 warps
constexpr int kLanePiece = 96;     // rows per staged piece
constexpr int kDensityWords = 4;   // staged field rows: x y z m
constexpr int kForceWords = 8;     // x y z vx vy vz m rho
constexpr unsigned kWarpMask = 0xffffffffu;

// Rows [a, e) that lane i (in window-table block blk, cell ci) tests in rod
// r: its cell band intersected with the block's rod window.
template <typename Args>
__device__ __forceinline__ void lane_band(const Args& g, int blk, int r,
                                          int ci, int& a, int& e) {
  const int c = ci + lane_rod_delta(r, g.nx, g.ny);
  const int k = blk * kRods + r;
  const int w0 = __ldg(g.ws + k);
  const int w1 = w0 + __ldg(g.wc + k) * g.window;
  a = max(__ldg(g.cell_start + min(max(c - 1, 0), g.num_cells)), w0);
  e = min(__ldg(g.cell_start + min(max(c + 2, 0), g.num_cells)), w1);
}

// One staged piece of a warp's walk: rows [lo, hi) of rod r's union
// [.., u_hi), and this lane's band [a, e) in rod r.  r == kRods: done.
struct LanePiece {
  int r, lo, hi, u_hi, a, e;
};

// Advance p to the warp's next piece: the rest of rod r's union, else the
// union of the next rod in which some live lane has a non-empty band.  Every
// lane calls it with the same p.r, p.hi, p.u_hi (warp-uniform); lanes past
// n join with empty bands.
template <typename Args>
__device__ __forceinline__ void lane_next_piece(LanePiece& p, const Args& g,
                                                int blk, int ci, bool live) {
  if (p.hi < p.u_hi) {
    p.lo = p.hi;
    p.hi = min(p.lo + kLanePiece, p.u_hi);
    return;
  }
  while (++p.r < kRods) {
    int a = 0, e = 0;
    if (live) lane_band(g, blk, p.r, ci, a, e);
    const bool some = a < e;
    const int lo = __reduce_min_sync(kWarpMask, some ? a : INT_MAX);
    const int hi = __reduce_max_sync(kWarpMask, some ? e : 0);
    if (lo < hi) {
      p.lo = lo;
      p.hi = min(lo + kLanePiece, hi);
      p.u_hi = hi;
      p.a = a;
      p.e = e;
      return;
    }
  }
}

// Copy rows [lo, hi) of the first kWords field rows to dst[f * kLanePiece +
// (j - lo)], asynchronously; the lanes take consecutive rows of one field.
template <int kWords>
__device__ __forceinline__ void stage_piece(float* dst, const float* fields,
                                            long long n_pad, int lo, int hi,
                                            int lane) {
  const int len = hi - lo;
  for (int f = 0; f < kWords; ++f) {
    const float* src = fields + f * n_pad + lo;
    for (int k = lane; k < len; k += 32)
      __pipeline_memcpy_async(dst + f * kLanePiece + k, src + k, sizeof(float));
  }
}

// The staged walk both band kernels run: per warp two slots of kLanePiece
// rows of kWords words; test(slot, piece) tests this lane's band rows in a
// slot once its copies have landed.
template <int kWords, typename Args, typename Test>
__device__ __forceinline__ void lane_band_walk(const Args& g, int blk, int ci,
                                               bool live, Test test) {
  extern __shared__ float smem[];
  constexpr int kSlot = kLanePiece * kWords;
  const int lane = threadIdx.x & 31;
  const long long np = g.n_pad;
  float* buf = smem + (threadIdx.x >> 5) * 2 * kSlot;
  LanePiece cur{-1, 0, 0, 0, 0, 0};
  lane_next_piece(cur, g, blk, ci, live);
  if (cur.r < kRods) stage_piece<kWords>(buf, g.fields, np, cur.lo, cur.hi, lane);
  __pipeline_commit();
  int slot = 0;
  while (cur.r < kRods) {
    LanePiece nxt = cur;
    lane_next_piece(nxt, g, blk, ci, live);
    if (nxt.r < kRods)
      stage_piece<kWords>(buf + (slot ^ 1) * kSlot, g.fields, np, nxt.lo,
                          nxt.hi, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // cur's rows have landed
    __syncwarp();
    test(buf + slot * kSlot, cur);
    __syncwarp();  // every lane is done with this slot before its restage
    cur = nxt;
    slot ^= 1;
  }
}

__global__ void __launch_bounds__(kBandThreads)
    density_band_lane(LaneDensityArgs a) {
  const int i = blockIdx.x * kBandThreads + threadIdx.x;
  const bool live = i < a.n;
  const long long np = a.n_pad;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int ci = 0, blk = 0;
  if (live) {
    xi = a.fields[i];
    yi = a.fields[np + i];
    zi = a.fields[2 * np + i];
    ci = __float_as_int(a.fields[4 * np + i]);
    blk = i / a.block;
  }
  float rho = 0.f;
  int count = 0;
  auto test = [&](const float* s, const LanePiece& p) {
    const float* sx = s;
    const float* sy = sx + kLanePiece;
    const float* sz = sy + kLanePiece;
    const float* sm = sz + kLanePiece;
    const int j1 = min(p.e, p.hi);
    for (int j = max(p.a, p.lo); j < j1; ++j) {
      const int k = j - p.lo;
      const float d2 = lane_dist2(xi - sx[k], yi - sy[k], zi - sz[k]);
      if (j != i && d2 < a.h2) {
        const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
        const float w = a.poly6 * t * t * t;
        rho += sm[k] * w;
        ++count;
      }
    }
  };
  lane_band_walk<kDensityWords>(a, blk, ci, live, test);
  if (live) {
    if (a.include_self) {
      const float h2s = a.h_scaled2;
      rho += a.fields[3 * np + i] * a.poly6 * h2s * h2s * h2s;
    }
    a.rho[i] = rho;
    a.ncount[i] = count;
  }
}

__global__ void __launch_bounds__(kBandThreads)
    force_band_lane(LaneForceArgs a) {
  const int i = blockIdx.x * kBandThreads + threadIdx.x;
  const bool live = i < a.n;
  const long long np = a.n_pad;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  float rhoi = 0.f;
  int ci = 0, blk = 0;
  if (live) {
    xi = a.fields[i];
    yi = a.fields[np + i];
    zi = a.fields[2 * np + i];
    vxi = a.fields[3 * np + i];
    vyi = a.fields[4 * np + i];
    vzi = a.fields[5 * np + i];
    rhoi = a.fields[7 * np + i];
    ci = __float_as_int(a.fields[8 * np + i]);
    blk = i / a.block;
  }
  const float p_i = (rhoi - a.rho0) * a.stiffness;
  const float rhoi_inv = 1.f / (rhoi > 0.f ? rhoi : 1.f);
  const float pw_i = p_i * rhoi_inv * rhoi_inv;

  float ax = 0.f, ay = 0.f, az = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  auto test = [&](const float* s, const LanePiece& p) {
    const int j1 = min(p.e, p.hi);
    for (int j = max(p.a, p.lo); j < j1; ++j) {
      const int k = j - p.lo;
      const float dx = xi - s[k];
      const float dy = yi - s[kLanePiece + k];
      const float dz = zi - s[2 * kLanePiece + k];
      const float d2 = lane_dist2(dx, dy, dz);
      if (j != i && d2 < a.h2) {
        const float mj = s[6 * kLanePiece + k];
        const float rhoj = s[7 * kLanePiece + k];
        const float d = sqrtf(d2) * a.scale;
        const float hd = a.h - d;
        const float p_j = (rhoj - a.rho0) * a.stiffness;
        const float rhoj_inv = 1.f / (rhoj > 0.f ? rhoj : 1.f);
        const float pweight = pw_i + p_j * rhoj_inv * rhoj_inv;
        const float center = (hd * hd) * (mj * pweight) / (d + a.eps) * a.scale;
        ax += dx * center;
        ay += dy * center;
        az += dz * center;
        const float vweight = hd * (rhoj_inv * mj);
        vx += (s[3 * kLanePiece + k] - vxi) * vweight;
        vy += (s[4 * kLanePiece + k] - vyi) * vweight;
        vz += (s[5 * kLanePiece + k] - vzi) * vweight;
      }
    }
  };
  lane_band_walk<kForceWords>(a, blk, ci, live, test);
  if (live) {
    const float mu_rhoi = a.viscosity * rhoi_inv;
    a.acc[3 * i] = mu_rhoi * vx * a.visc_norm + ax * a.visc_norm;
    a.acc[3 * i + 1] = mu_rhoi * vy * a.visc_norm + ay * a.visc_norm;
    a.acc[3 * i + 2] = mu_rhoi * vz * a.visc_norm + az * a.visc_norm;
  }
}

// One launch: the band walk (band != 0: ceil(n / 128) blocks of 128 threads,
// two slots of kLanePiece rows of kWords words per warp) or the block walk
// (ceil(n / block) blocks of `block` threads, one chunk of every field row).
template <int kWords, int kBlockFields, typename Args>
int launch_lane(void (*band_kernel)(Args), void (*block_kernel)(Args),
                const Args& a, int band, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (band) {
    if (a.cell_start == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int nblocks = (a.n + kBandThreads - 1) / kBandThreads;
    const size_t smem = static_cast<size_t>(kBandThreads / 32) * 2 *
                        kLanePiece * kWords * sizeof(float);
    band_kernel<<<nblocks, kBandThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(kBlockFields) * a.window * sizeof(float);
  const cudaError_t err = allow_smem(block_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (a.n + a.block - 1) / a.block;
  block_kernel<<<nblocks, a.block, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError(): nonzero when the launch was refused.  band != 0
// launches the band walk over cell_start (which must not be null); band == 0
// the block walk, which reads neither cell_start nor num_cells.
int sph_density_lane(const float* fields, const int* ws, const int* wc,
                     const int* cell_start, float* rho, int* ncount, int n,
                     int n_pad, int block, int window, int nx, int ny,
                     int num_cells, int include_self, int band, float h2,
                     float h_scaled2, float scale2, float poly6,
                     void* stream) {
  LaneDensityArgs a;
  a.fields = fields;
  a.ws = ws;
  a.wc = wc;
  a.cell_start = cell_start;
  a.rho = rho;
  a.ncount = ncount;
  a.n = n;
  a.n_pad = n_pad;
  a.window = window;
  a.nx = nx;
  a.ny = ny;
  a.include_self = include_self;
  a.block = block;
  a.num_cells = num_cells;
  a.h2 = h2;
  a.h_scaled2 = h_scaled2;
  a.scale2 = scale2;
  a.poly6 = poly6;
  return launch_lane<kDensityWords, kDensityFields>(
      density_band_lane, density_kernel_lane, a, band, stream);
}

int sph_force_lane(const float* fields, const int* ws, const int* wc,
                   const int* cell_start, float* acc, int n, int n_pad,
                   int block, int window, int nx, int ny, int num_cells,
                   int band, float h2, float h, float scale, float eps,
                   float stiffness, float rho0, float viscosity,
                   float visc_norm, void* stream) {
  LaneForceArgs a;
  a.fields = fields;
  a.ws = ws;
  a.wc = wc;
  a.cell_start = cell_start;
  a.acc = acc;
  a.n = n;
  a.n_pad = n_pad;
  a.window = window;
  a.nx = nx;
  a.ny = ny;
  a.block = block;
  a.num_cells = num_cells;
  a.h2 = h2;
  a.h = h;
  a.scale = scale;
  a.eps = eps;
  a.stiffness = stiffness;
  a.rho0 = rho0;
  a.viscosity = viscosity;
  a.visc_norm = visc_norm;
  return launch_lane<kForceWords, kForceFields>(
      force_band_lane, force_kernel_lane, a, band, stream);
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
