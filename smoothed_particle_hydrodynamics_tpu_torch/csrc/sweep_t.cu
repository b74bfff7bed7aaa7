// Neighbor sweeps over the cell-sorted particle frame, for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// smoothed_particle_hydrodynamics_tpu_torch/ops/sweeps_t.py, whose
// density_t_plain / force_t_plain / fused_t_plain are the PyTorch versions of
// the same sums.
//
// Replaces, in smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py:
//   K1 density_band_t, K2 force_band_t <- _density_kernel_t and
//      _force_kernel_t, exact and capped, and the fused path's sub-frame
//      pre-pass (_density_kernel_t with self_src_row=5: density_band_t
//      <kExclSrcSrc>), on one device (the lazy paths) and in the slab
//      engine: per-lane band walks, see their section;
//   K3 fused_band_t <- _fused_kernel_t (capped only), the same band walk.
// The block walks density_kernel_t<Excl>, force_kernel_t<Excl> and
// fused_kernel_t stay as their bit-equality reference.
//
// What they compute.  Particles are sorted by linear cell id
// (z*ny + y)*nx + x, so each of the 9 (dy, dz) stencil rods of a block of b
// consecutive sorted SELF rows is one contiguous row window
// [ws, ws + wc*s_t) of the CANDIDATE frame (the window tables of
// _block_windows_t).  In exact mode both frames are the sorted particles; in
// capped ("Subsets") mode the candidates are the sub frame: at most K_c
// hash-chosen particles of each cell, compacted to the front, so windows
// span extent*K_c rows instead of extent*occupancy.  A pair (i, j) counts when
//     |cid_j - cid_i - delta_rod| <= 1  and  id_j != own_i  and  d^2 < h^2,
// with d^2 in world coordinates and the self-exclusion ids of the Excl mode.
// K1 sums rho_i = sum m_j poly6(d) and the neighbor count (plus the self term
// when include_self is set); K2 sums the pressure term
// sum (x_i - x_j) (h-d)^2 (m_j pw_i + m_j pw_j) / (d+eps) and the viscosity
// term sum (v_j - v_i) (h-d) m_j / rho_j, then applies mu/rho_i and the
// Laplacian norm, as the TPU kernels do after their sweep.  K3 does K1 and K2
// in one pass: its rho and count use K1's exact op sequence (so they equal
// capped K1's bit for bit), and since pw_i needs that rho, the pressure sum
// is split into P1 = sum (x_i - x_j) c1 and P2 = sum (x_i - x_j) c2 with
// c1 = (h-d)^2/(d+eps) scale m_j and c2 = the same with m_j pw_j, combined
// after the walk as pw_i P1 + P2 (the direct-sum form of the TPU kernel's
// block-relative MXU dots).  The candidates' pw_j come from the pre-pass.
//
// Design.  One CUDA block per block of b sorted self rows, one thread per
// row.  For each rod the block walks the window in tiles of b rows: every
// thread stages one candidate row into shared memory, then every thread tests
// the whole tile against its own particle and sums in registers.  The TPU
// kernels' DMA double-buffering, 128-lane row padding, per-block reference
// point and MXU reductions are not carried over: the window walk is bounded
// by the candidate count instead of padding rows, and the sums are direct
// per-pair sums (acc then differs from the TPU's only by reassociation).
// Cell ids and source rows are int32 (the TPU kernels carry them as f32,
// exact only below 2^24).
//
// Self rows and candidates may be two frames.  A self row's own id is
// self_base + i: 0 on the single-chip path, where self row i is candidate
// row i; h_cap in the distributed slab engine, whose candidates are the
// extended frame [left halo | own slab | right halo] and whose self rows are
// the own slab (the TPU kernels' block_base, parallel/slabs.py:571).
//
// What bounds it.  The instruction rate of the pair tests: every thread
// tests 9 windows of about (block extent + 2 cells) rows, of which a few
// percent are neighbors, so most of the instruction stream is the d^2 and cid
// mask of rejected pairs.  Candidate loads are small next to that (each tile
// row is read once per block and reused by b threads from shared memory).
// Capped mode cuts the rows tested per particle by the window shrink; K3 also
// saves K1's whole pass over the full frame for the price of a pre-pass over
// the sub frame only.  The band kernels below cut them by walking each row's
// own bands.
//
// Rounding.  d^2 and t = h_scaled^2 - d^2 * scale^2 are formed with
// explicitly rounded intrinsics (no FMA contraction), so the mask sees the
// same bits as the plain PyTorch version's separate multiplies and adds and
// neighbor counts agree exactly; the build also passes --fmad=false so the
// rest of the arithmetic rounds op by op as well.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRods = 9;
// force candidate columns: x y z rimj*vx rimj*vy rimj*vz rimj mj mj*pwj
constexpr int kForceCols = 9;

// Self-exclusion: which ids a pair compares to drop the particle itself.
enum Excl {
  kExclRow = 0,     // candidate row vs self row: one frame for both (exact)
  kExclSrc = 1,     // candidate's full-frame row vs self row (capped)
  kExclSrcSrc = 2,  // candidate's vs self's full-frame row (sub-frame pre-pass)
};

// Rod r of [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]: its linear
// cell-id offset (dz * ny + dy) * nx.
__device__ __forceinline__ int rod_delta(int r, int nx, int ny) {
  const int dy = r / 3 - 1;
  const int dz = r % 3 - 1;
  return (dz * ny + dy) * nx;
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// |cid_j - cid_i - delta| <= 1, in wrapping unsigned arithmetic: a capped sub
// frame's tail rows carry cell id -2^30, whose difference to any cell lands
// far outside the band instead of overflowing.
__device__ __forceinline__ bool in_band(int cid_j, int cid_i, int delta) {
  const unsigned dc = static_cast<unsigned>(cid_j) -
                      static_cast<unsigned>(cid_i) -
                      static_cast<unsigned>(delta) + 1u;
  return dc <= 2u;
}

struct DensityArgs {
  const float* pos;    // [n, 3] self positions
  const float* mass;   // [n] self masses (the self term)
  const int* cid;      // [n] self cell ids (frozen between rebins)
  const int* src;      // [n] self full-frame rows (kExclSrcSrc only)
  const float* cpos;   // [m, 3] candidate positions
  const float* cmass;  // [m] candidate masses (capped: reweighted)
  const int* ccid;     // [m] candidate cell ids
  const int* csrc;     // [m] candidate full-frame rows (not kExclRow)
  const int* ws;       // [nblocks * 9] window starts into the candidates
  const int* wc;       // [nblocks * 9] window chunk counts
  float* rho;          // [n] out
  int* ncount;         // [n] out
  int n, m, s_t, nx, ny, include_self;
  int self_base;       // own id of self row i: self_base + i (not kExclSrcSrc)
  float h2, h_scaled2, scale2, poly6;
};

template <int kExcl>
__global__ void density_kernel_t(DensityArgs a) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  float* sx = smem;
  float* sy = sx + b;
  float* sz = sy + b;
  float* sm = sz + b;
  int* sc = reinterpret_cast<int*>(sm + b);
  int* ss = sc + b;  // candidate src (not staged for kExclRow)

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int i = blk * b + tid;
  const bool live = i < a.n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int ci = 0;
  int own = a.self_base + i;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    ci = a.cid[i];
    if (kExcl == kExclSrcSrc) own = a.src[i];
  }
  float rho = 0.f;
  int count = 0;
  for (int r = 0; r < kRods; ++r) {
    const int delta = rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int stop = min(start + a.wc[blk * kRods + r] * a.s_t, a.m);
    for (int t0 = start; t0 < stop; t0 += b) {
      const int j = t0 + tid;
      if (j < stop) {
        sx[tid] = a.cpos[3 * j];
        sy[tid] = a.cpos[3 * j + 1];
        sz[tid] = a.cpos[3 * j + 2];
        sm[tid] = a.cmass[j];
        sc[tid] = a.ccid[j];
        if (kExcl != kExclRow) ss[tid] = a.csrc[j];
      }
      __syncthreads();
      const int len = min(b, stop - t0);
      if (live) {
        for (int k = 0; k < len; ++k) {
          const float d2 = dist2(sx[k] - xi, sy[k] - yi, sz[k] - zi);
          const int id = kExcl == kExclRow ? t0 + k : ss[k];
          if (in_band(sc[k], ci, delta) && id != own && d2 < a.h2) {
            const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
            const float w3 = a.poly6 * t * t * t;
            rho += sm[k] * w3;
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
      rho += a.mass[i] * a.poly6 * h2s * h2s * h2s;
    }
    a.rho[i] = rho;
    a.ncount[i] = count;
  }
}

struct ForceArgs {
  const float* pos;   // [n, 3] self positions
  const float* vel;   // [n, 3] self velocities
  const float* rho;   // [n] self densities from K1
  const int* cid;     // [n] self cell ids
  const float* cand;  // [m, kForceCols] candidate columns (fused_cand_cols)
  const int* ccid;    // [m] candidate cell ids
  const int* csrc;    // [m] candidate full-frame rows (kExclSrc only)
  const int* ws;      // [nblocks * 9]
  const int* wc;      // [nblocks * 9]
  float* acc;         // [n, 3] out: hydro acceleration
  int n, m, s_t, nx, ny;
  int self_base;      // own id of self row i: self_base + i
  float h2, h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

template <int kExcl>
__global__ void force_kernel_t(ForceArgs a) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  float* sf = smem;  // column c of the tile at sf[c * b + row]
  int* sc = reinterpret_cast<int*>(smem + kForceCols * b);
  int* ss = sc + b;

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int i = blk * b + tid;
  const bool live = i < a.n;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  float rhoi = 1.f;
  int ci = 0;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    vxi = a.vel[3 * i];
    vyi = a.vel[3 * i + 1];
    vzi = a.vel[3 * i + 2];
    rhoi = a.rho[i];
    ci = a.cid[i];
  }
  const int own = a.self_base + i;
  const float rhoi_inv = 1.f / (rhoi > 0.f ? rhoi : 1.f);
  const float pw_i = (rhoi - a.rho0) * a.stiffness * rhoi_inv * rhoi_inv;

  float ax = 0.f, ay = 0.f, az = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  for (int r = 0; r < kRods; ++r) {
    const int delta = rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int stop = min(start + a.wc[blk * kRods + r] * a.s_t, a.m);
    for (int t0 = start; t0 < stop; t0 += b) {
      const int j = t0 + tid;
      if (j < stop) {
        const float* row = a.cand + static_cast<long long>(j) * kForceCols;
        for (int c = 0; c < kForceCols; ++c) sf[c * b + tid] = row[c];
        sc[tid] = a.ccid[j];
        if (kExcl != kExclRow) ss[tid] = a.csrc[j];
      }
      __syncthreads();
      const int len = min(b, stop - t0);
      if (live) {
        for (int k = 0; k < len; ++k) {
          const float dx = sf[k] - xi;
          const float dy = sf[b + k] - yi;
          const float dz = sf[2 * b + k] - zi;
          const float d2 = dist2(dx, dy, dz);
          const int id = kExcl == kExclRow ? t0 + k : ss[k];
          if (in_band(sc[k], ci, delta) && id != own && d2 < a.h2) {
            const float d = sqrtf(d2) * a.scale;
            const float hd = a.h - d;
            const float num = (hd * hd) * (sf[7 * b + k] * pw_i + sf[8 * b + k]);
            const float center = num / (d + a.eps) * a.scale;
            ax -= dx * center;
            ay -= dy * center;
            az -= dz * center;
            const float rim = sf[6 * b + k];
            vx += (sf[3 * b + k] - vxi * rim) * hd;
            vy += (sf[4 * b + k] - vyi * rim) * hd;
            vz += (sf[5 * b + k] - vzi * rim) * hd;
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

struct FusedArgs {
  const float* pos;   // [n, 3] self positions
  const float* vel;   // [n, 3] self velocities
  const float* mass;  // [n] self masses (the self term)
  const int* cid;     // [n] self cell ids
  const float* cand;  // [m, kForceCols] sub-frame candidate columns
  const int* ccid;    // [m] candidate cell ids
  const int* csrc;    // [m] candidate full-frame rows
  const int* ws;      // [nblocks * 9]
  const int* wc;      // [nblocks * 9]
  float* acc;         // [n, 3] out: hydro acceleration
  float* rho;         // [n] out
  int* ncount;        // [n] out
  int n, m, s_t, nx, ny, include_self;
  int self_base;      // own id of self row i: self_base + i
  float h2, h_scaled2, scale2, poly6;
  float h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

__global__ void fused_kernel_t(FusedArgs a) {
  extern __shared__ float smem[];
  const int b = blockDim.x;
  float* sf = smem;  // column c of the tile at sf[c * b + row]
  int* sc = reinterpret_cast<int*>(smem + kForceCols * b);
  int* ss = sc + b;

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int i = blk * b + tid;
  const bool live = i < a.n;
  const int own = a.self_base + i;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    vxi = a.vel[3 * i];
    vyi = a.vel[3 * i + 1];
    vzi = a.vel[3 * i + 2];
    ci = a.cid[i];
  }
  float rho = 0.f;
  int count = 0;
  float p1x = 0.f, p1y = 0.f, p1z = 0.f, p2x = 0.f, p2y = 0.f, p2z = 0.f;
  float vx = 0.f, vy = 0.f, vz = 0.f;
  for (int r = 0; r < kRods; ++r) {
    const int delta = rod_delta(r, a.nx, a.ny);
    const int start = a.ws[blk * kRods + r];
    const int stop = min(start + a.wc[blk * kRods + r] * a.s_t, a.m);
    for (int t0 = start; t0 < stop; t0 += b) {
      const int j = t0 + tid;
      if (j < stop) {
        const float* row = a.cand + static_cast<long long>(j) * kForceCols;
        for (int c = 0; c < kForceCols; ++c) sf[c * b + tid] = row[c];
        sc[tid] = a.ccid[j];
        ss[tid] = a.csrc[j];
      }
      __syncthreads();
      const int len = min(b, stop - t0);
      if (live) {
        for (int k = 0; k < len; ++k) {
          const float dx = sf[k] - xi;
          const float dy = sf[b + k] - yi;
          const float dz = sf[2 * b + k] - zi;
          const float d2 = dist2(dx, dy, dz);
          if (in_band(sc[k], ci, delta) && ss[k] != own && d2 < a.h2) {
            // density part: K1's op sequence, so rho and count equal its bits
            const float mj = sf[7 * b + k];
            const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
            const float w3 = a.poly6 * t * t * t;
            rho += mj * w3;
            ++count;
            const float d = sqrtf(d2) * a.scale;
            const float hd = a.h - d;
            const float hd2inv = (hd * hd) / (d + a.eps) * a.scale;
            const float c1 = hd2inv * mj;
            const float c2 = hd2inv * sf[8 * b + k];
            p1x -= dx * c1;
            p1y -= dy * c1;
            p1z -= dz * c1;
            p2x -= dx * c2;
            p2y -= dy * c2;
            p2z -= dz * c2;
            const float rim = sf[6 * b + k];
            vx += (sf[3 * b + k] - vxi * rim) * hd;
            vy += (sf[4 * b + k] - vyi * rim) * hd;
            vz += (sf[5 * b + k] - vzi * rim) * hd;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    if (a.include_self) {
      const float h2s = a.h_scaled2;
      rho += a.mass[i] * a.poly6 * h2s * h2s * h2s;
    }
    const float rhoi_inv = 1.f / (rho > 0.f ? rho : 1.f);
    const float pw_i = (rho - a.rho0) * a.stiffness * rhoi_inv * rhoi_inv;
    const float mu_rhoi = a.viscosity * rhoi_inv;
    a.acc[3 * i] = mu_rhoi * vx * a.visc_norm + (pw_i * p1x + p2x) * a.visc_norm;
    a.acc[3 * i + 1] =
        mu_rhoi * vy * a.visc_norm + (pw_i * p1y + p2y) * a.visc_norm;
    a.acc[3 * i + 2] =
        mu_rhoi * vz * a.visc_norm + (pw_i * p1z + p2z) * a.visc_norm;
    a.rho[i] = rho;
    a.ncount[i] = count;
  }
}

// ---------------------------------------------------------------------------
// K1, K2 and K3 as per-lane band walks: density_band_t and force_band_t,
// exact (kExclRow) and capped (kExclSrc), the fused path's pre-pass
// density_band_t<kExclSrcSrc> and K3 fused_band_t, the single-device lazy
// paths' kernels and the slab engine's.
//
// Replace _density_kernel_t (pallas_step_t.py:293, capped :321, pre-pass
// :1090), _force_kernel_t (:360, capped :403) and _fused_kernel_t (:497) in
// place of the block walks above; in the slab engine, the callers of
// _slab_chunked_call (parallel/slabs.py:494, :588, :663, :704, :750, :792).
//
// The fused path's two kernels walk the capped sub frame's table too.  K3's
// self rows, candidates and exclusion are capped K2's (the sorted frame, or
// the own slab with self_base = h_cap, over the sub frame's fused_cand_cols
// and src rows); it sums K1's rho and count and K2's split pressure and
// viscosity terms in fused_kernel_t's op order, so rho and the counts also
// equal capped K1's band walk's on the same tensors.  The pre-pass's self
// rows are the sub frame itself: self row i's own id is its src row src[i]
// (kExclSrcSrc), and its unkept tail rows carry self cid TAIL_CID = -2^30,
// whose bands are all empty, so they write the self term and count 0 (the
// block walk gives them whatever their block's windows hold; no pair reads
// a tail row's density).
//
// The slab engine's candidates are the LIVE rows of a rank's extended frame
// [left halo | own slab | right halo], compacted in order (the chain ends'
// inert rows, the own slab's dead run and a short neighbour's dead rows sit
// at 1e30 and add nothing, but the dead ones carry real cell ids: the own
// dead run that of the slab's last cell, so a table over the raw frame
// would hand every band that reaches that cell the whole run).  Its self
// rows are the own slab: self row i is compacted row self_base + i
// (self_base = the live left-halo rows), and its dead rows carry a self cid
// of NO_CELL, so their bands are empty and they write 0.  In capped mode its
// candidates are the rank's sub frame, as on one device; self row i's own id
// is self_base + i = h_cap + i against each candidate's extended-frame row
// csrc[j], and the dead rows carry NO_CELL as above.
//
// The candidate frame is sorted by cell id (exact: the sorted particles;
// capped: the sub frame, whose kept rows come first in cid order), so the
// candidates of self row i that pass the block walk's cid mask for rod
// delta, |cid_j - cid_i - delta| <= 1, are one contiguous range: rows
// [cell_start[ci+delta-1], cell_start[ci+delta+2]) of the candidates'
// cell-start table (cell_start[c] = first candidate row of cell c,
// cell_start[num_cells] = the candidates in cells: n exact, the kept rows
// within the sub frame capped, so its tail rows are in no band).  That
// range lies inside the block's rod window, so walking it in increasing row
// order sums the same pairs in the same order as the block walk: rho, the
// counts and acc equal density_kernel_t's and force_kernel_t's bit for bit
// (same op sequence, --fmad=false).  The pair test is left with the
// self-exclusion (j != self_base + i exact, csrc[j] != self_base + i capped)
// and d^2 < h^2; the cid load and mask are gone.
//
// What bounds them.  Still the instructions of rejected-pair tests (a few
// percent of the tested rows are pairs within h), but each lane now tests
// only its own band: at the 1M splash ~350 rows per particle exact against
// ~2100 for the block walk, and at most 9 x 3 cells x K_c rows capped.  A
// warp walks rod by rod; the union of its lanes' bands is staged into a
// warp-private shared-memory buffer with cp.async (coalesced, one word per
// lane per copy), the next piece landing while the current one is tested
// (the TPU kernels' DMA double buffer), and each lane tests the rows of its
// own band in the piece.  A rod whose union fits a piece costs the warp the
// longest band of its lanes, not the union.  No __syncthreads: the 4 warps
// of a block never wait on each other.  Tensor cores cannot decide the d^2
// mask (a TF32 or split-float d^2 flips decisions the direct f32 form gets
// right), and the ~28 pairs of ~350 rows leave no dense product for them;
// rows are 16-40 B at per-warp starts, which fits cp.async, not TMA.  On an
// H100 at the 1M splash the exact staged walk took 0.36 ms (K1) and 0.66 ms
// (K2) against the block walk's 1.87 and 2.60, and against 0.38 and 0.72
// for lanes reading their band rows straight from global memory with __ldg
// (rows shared by a warp broadcast from L1), so the staged walk is kept.
// Capped, the walk took 0.147 ms (K1) and 0.241 ms (K2) against the block
// walk's 1.03 and 1.33, testing ~95 rows per lane against ~1030.

constexpr int kBandBlock = 128;   // threads (self rows) per block: 4 warps
constexpr unsigned kFullMask = 0xffffffffu;

// Rows per staged piece.  A rod's warp union is ~64 rows exact and ~18
// capped.  In turns on an H100 at the 1M splash, 32-row pieces ran capped
// K2 (40-byte rows: 10.2 KB of shared memory per block against 30.7) 4 %
// faster than 96-row ones, but capped K1 1 % slower and exact K1/K2 60 %
// and 40 % slower (a rod then takes several pieces, each costing the warp
// its longest overlap), so only capped K2 stages 32.
constexpr int kDensityPiece = 96;
template <int kExcl>
constexpr int kForcePiece = kExcl == kExclSrc ? 32 : 96;
// K3 stages capped K2's 40-byte rows in capped K2's 32-row pieces.
constexpr int kFusedPiece = kForcePiece<kExclSrc>;

// Rows [a, e) of self row i's band for rod delta; the cell range is clamped
// to [0, num_cells], so a band wholly outside the grid is empty, and the
// rows to the m candidates.
__device__ __forceinline__ void band_rows(const int* cell_start, int ci,
                                          int delta, int num_cells, int m,
                                          int& a, int& e) {
  a = min(__ldg(cell_start + min(max(ci + delta - 1, 0), num_cells)), m);
  e = min(__ldg(cell_start + min(max(ci + delta + 2, 0), num_cells)), m);
}

// One staged piece of a warp's walk: rows [lo, hi) of rod r's union
// [.., u_hi), and this lane's band [a, e) in rod r.  r == kRods: done.
struct Piece {
  int r, lo, hi, u_hi, a, e;
};

// Advance p to the warp's next piece of at most kPiece rows: the rest of
// rod r's union, else the union of the next rod in which some live lane has
// a non-empty band.  Every lane calls it with the same p.r, p.hi, p.u_hi
// (warp-uniform).
template <int kPiece>
__device__ __forceinline__ void next_piece(Piece& p, const int* cell_start,
                                           int ci, bool live, int nx, int ny,
                                           int num_cells, int m) {
  if (p.hi < p.u_hi) {
    p.lo = p.hi;
    p.hi = min(p.lo + kPiece, p.u_hi);
    return;
  }
  while (++p.r < kRods) {
    int a = 0, e = 0;
    if (live)
      band_rows(cell_start, ci, rod_delta(p.r, nx, ny), num_cells, m, a, e);
    const bool some = a < e;
    const int lo = __reduce_min_sync(kFullMask, some ? a : INT_MAX);
    const int hi = __reduce_max_sync(kFullMask, some ? e : 0);
    if (lo < hi) {
      p.lo = lo;
      p.hi = min(lo + kPiece, hi);
      p.u_hi = hi;
      p.a = a;
      p.e = e;
      return;
    }
  }
}

// Copy rows [lo, hi) of a row-major [m, W] array to dst[(j - lo) * W + c]:
// the lanes take consecutive words (coalesced), asynchronously.
template <int W, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int lo,
                                           int hi, int lane) {
  const T* s = src + static_cast<long long>(lo) * W;
  const int words = (hi - lo) * W;
  for (int w = lane; w < words; w += 32)
    __pipeline_memcpy_async(dst + w, s + w, sizeof(T));
}

// The staged walk both band kernels share.  Per warp, two slots of kPiece
// rows of kWords words each (double-buffered); stage(dst, piece) issues a
// piece's copies into a slot, and test(slot, piece) tests this lane's band
// rows in it once they have landed.
template <int kPiece, int kWords, typename Stage, typename Test>
__device__ __forceinline__ void band_walk(const int* cell_start, int ci,
                                          bool live, int nx, int ny,
                                          int num_cells, int m, Stage stage,
                                          Test test) {
  extern __shared__ float smem[];
  constexpr int kSlot = kPiece * kWords;
  float* buf = smem + (threadIdx.x >> 5) * 2 * kSlot;
  Piece cur{-1, 0, 0, 0, 0, 0};
  next_piece<kPiece>(cur, cell_start, ci, live, nx, ny, num_cells, m);
  if (cur.r < kRods) stage(buf, cur);
  __pipeline_commit();
  int slot = 0;
  while (cur.r < kRods) {
    Piece nxt = cur;
    next_piece<kPiece>(nxt, cell_start, ci, live, nx, ny, num_cells, m);
    if (nxt.r < kRods) stage(buf + (slot ^ 1) * kSlot, nxt);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // cur's rows have landed
    __syncwarp();
    test(buf + slot * kSlot, cur);
    __syncwarp();  // every lane is done with this slot before its restage
    cur = nxt;
    slot ^= 1;
  }
}

// Staged words per candidate row: K1 x y z m, K2 and K3 the kForceCols
// columns, each + the candidate's src row but in exact mode (kExclRow).
template <int kExcl>
constexpr int kDensityWords = kExcl != kExclRow ? 5 : 4;
template <int kExcl>
constexpr int kForceWords = kExcl != kExclRow ? kForceCols + 1 : kForceCols;

struct DensityBandArgs {
  const float* pos;       // [n, 3] self positions (sorted)
  const float* mass;      // [n] self masses (the self term)
  const int* cid;         // [n] self cell ids (frozen between rebins)
  const int* src;         // [n] self src rows (kExclSrcSrc only)
  const float* cpos;      // [m, 3] candidate positions (exact: pos)
  const float* cmass;     // [m] candidate masses (capped: reweighted)
  const int* csrc;        // [m] candidate src rows (not kExclRow)
  const int* cell_start;  // [num_cells + 1] first candidate row of each cell
  float* rho;             // [n] out
  int* ncount;            // [n] out
  int n, m, num_cells, nx, ny, include_self;
  int self_base;          // own id of self row i: self_base + i (not SrcSrc)
  float h2, h_scaled2, scale2, poly6;
};

// Density sum of a pair within h, density_kernel_t's op sequence.
__device__ __forceinline__ void density_add(const DensityBandArgs& a,
                                            float d2, float mj, float& rho,
                                            int& count) {
  const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
  const float w3 = a.poly6 * t * t * t;
  rho += mj * w3;
  ++count;
}

template <int kExcl>
__global__ void __launch_bounds__(kBandBlock)
    density_band_t(DensityBandArgs a) {
  // a slot: x y z (row-major), then m, then (capped) the src rows
  constexpr int kPiece = kDensityPiece;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBandBlock + threadIdx.x;
  const bool live = i < a.n;
  int own = a.self_base + i;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    ci = a.cid[i];
    if (kExcl == kExclSrcSrc) own = a.src[i];
  }
  float rho = 0.f;
  int count = 0;
  auto stage = [&](float* dst, const Piece& p) {
    stage_rows<3>(dst, a.cpos, p.lo, p.hi, lane);
    stage_rows<1>(dst + 3 * kPiece, a.cmass, p.lo, p.hi, lane);
    if constexpr (kExcl != kExclRow)
      stage_rows<1>(reinterpret_cast<int*>(dst + 4 * kPiece), a.csrc, p.lo,
                    p.hi, lane);
  };
  auto test = [&](const float* sp, const Piece& p) {
    const int* ss = reinterpret_cast<const int*>(sp + 4 * kPiece);
    const int j1 = min(p.e, p.hi);
    for (int j = max(p.a, p.lo); j < j1; ++j) {
      const int k = j - p.lo;
      const float d2 =
          dist2(sp[3 * k] - xi, sp[3 * k + 1] - yi, sp[3 * k + 2] - zi);
      const int id = kExcl == kExclRow ? j : ss[k];
      if (id != own && d2 < a.h2)
        density_add(a, d2, sp[3 * kPiece + k], rho, count);
    }
  };
  band_walk<kPiece, kDensityWords<kExcl>>(a.cell_start, ci, live, a.nx, a.ny,
                                          a.num_cells, a.m, stage, test);
  if (live) {
    if (a.include_self) {
      const float h2s = a.h_scaled2;
      rho += a.mass[i] * a.poly6 * h2s * h2s * h2s;
    }
    a.rho[i] = rho;
    a.ncount[i] = count;
  }
}

struct ForceBandArgs {
  const float* pos;       // [n, 3] self positions (sorted)
  const float* vel;       // [n, 3]
  const float* rho;       // [n] densities from K1
  const int* cid;         // [n] cell ids
  const float* cand;      // [m, kForceCols] candidate columns
  const int* csrc;        // [m] candidate src rows (kExclSrc only)
  const int* cell_start;  // [num_cells + 1] first candidate row of each cell
  float* acc;             // [n, 3] out: hydro acceleration
  int n, m, num_cells, nx, ny;
  int self_base;          // own id of self row i: self_base + i
  float h2, h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

struct ForceSums {
  float ax, ay, az, vx, vy, vz;
};

// Force pair term on candidate row c (its kForceCols columns),
// force_kernel_t's op sequence; d2 and dx dy dz already formed.
__device__ __forceinline__ void force_pair(const ForceBandArgs& a,
                                           const float* c, float dx, float dy,
                                           float dz, float d2, float pw_i,
                                           float vxi, float vyi, float vzi,
                                           ForceSums& s) {
  const float d = sqrtf(d2) * a.scale;
  const float hd = a.h - d;
  const float num = (hd * hd) * (c[7] * pw_i + c[8]);
  const float center = num / (d + a.eps) * a.scale;
  s.ax -= dx * center;
  s.ay -= dy * center;
  s.az -= dz * center;
  const float rim = c[6];
  s.vx += (c[3] - vxi * rim) * hd;
  s.vy += (c[4] - vyi * rim) * hd;
  s.vz += (c[5] - vzi * rim) * hd;
}

template <int kExcl>
__global__ void __launch_bounds__(kBandBlock)
    force_band_t(ForceBandArgs a) {
  // a slot: the kForceCols columns (row-major), then (capped) the src rows
  constexpr int kPiece = kForcePiece<kExcl>;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBandBlock + threadIdx.x;
  const bool live = i < a.n;
  const int own = a.self_base + i;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  float rhoi = 1.f;
  int ci = 0;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    vxi = a.vel[3 * i];
    vyi = a.vel[3 * i + 1];
    vzi = a.vel[3 * i + 2];
    rhoi = a.rho[i];
    ci = a.cid[i];
  }
  const float rhoi_inv = 1.f / (rhoi > 0.f ? rhoi : 1.f);
  const float pw_i = (rhoi - a.rho0) * a.stiffness * rhoi_inv * rhoi_inv;
  ForceSums s{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto stage = [&](float* dst, const Piece& p) {
    stage_rows<kForceCols>(dst, a.cand, p.lo, p.hi, lane);
    if constexpr (kExcl != kExclRow)
      stage_rows<1>(reinterpret_cast<int*>(dst + kForceCols * kPiece),
                    a.csrc, p.lo, p.hi, lane);
  };
  auto test = [&](const float* sp, const Piece& p) {
    const int* ss = reinterpret_cast<const int*>(sp + kForceCols * kPiece);
    const int j1 = min(p.e, p.hi);
    for (int j = max(p.a, p.lo); j < j1; ++j) {
      const int k = j - p.lo;
      const float* c = sp + k * kForceCols;
      const float dx = c[0] - xi;
      const float dy = c[1] - yi;
      const float dz = c[2] - zi;
      const float d2 = dist2(dx, dy, dz);
      const int id = kExcl == kExclRow ? j : ss[k];
      if (id != own && d2 < a.h2)
        force_pair(a, c, dx, dy, dz, d2, pw_i, vxi, vyi, vzi, s);
    }
  };
  band_walk<kPiece, kForceWords<kExcl>>(a.cell_start, ci, live, a.nx, a.ny,
                                        a.num_cells, a.m, stage, test);
  if (live) {
    const float mu_rhoi = a.viscosity * rhoi_inv;
    a.acc[3 * i] = mu_rhoi * s.vx * a.visc_norm + s.ax * a.visc_norm;
    a.acc[3 * i + 1] = mu_rhoi * s.vy * a.visc_norm + s.ay * a.visc_norm;
    a.acc[3 * i + 2] = mu_rhoi * s.vz * a.visc_norm + s.az * a.visc_norm;
  }
}

struct FusedBandArgs {
  const float* pos;       // [n, 3] self positions
  const float* vel;       // [n, 3] self velocities
  const float* mass;      // [n] self masses (the self term)
  const int* cid;         // [n] self cell ids (NO_CELL: no band)
  const float* cand;      // [m, kForceCols] sub-frame candidate columns
  const int* csrc;        // [m] candidate src rows
  const int* cell_start;  // [num_cells + 1] first kept sub row of each cell
  float* acc;             // [n, 3] out: hydro acceleration
  float* rho;             // [n] out
  int* ncount;            // [n] out
  int n, m, num_cells, nx, ny, include_self;
  int self_base;          // own id of self row i: self_base + i
  float h2, h_scaled2, scale2, poly6;
  float h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

// K3's sums: K1's rho and count, the pressure sums P1 (m_j) and P2
// (m_j pw_j), the viscosity sums.
struct FusedSums {
  float rho;
  int count;
  float p1x, p1y, p1z, p2x, p2y, p2z, vx, vy, vz;
};

// K3 over the sub frame's bands: fused_kernel_t's pair term and epilogue
// (same op order) on the pairs of capped K2's bands.  It carries 11
// accumulators against K2's 6.
__global__ void __launch_bounds__(kBandBlock) fused_band_t(FusedBandArgs a) {
  // a slot: the kForceCols columns (row-major), then the src rows
  constexpr int kPiece = kFusedPiece;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBandBlock + threadIdx.x;
  const bool live = i < a.n;
  const int own = a.self_base + i;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f;
  int ci = 0;
  if (live) {
    xi = a.pos[3 * i];
    yi = a.pos[3 * i + 1];
    zi = a.pos[3 * i + 2];
    vxi = a.vel[3 * i];
    vyi = a.vel[3 * i + 1];
    vzi = a.vel[3 * i + 2];
    ci = a.cid[i];
  }
  FusedSums s{0.f, 0, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto stage = [&](float* dst, const Piece& p) {
    stage_rows<kForceCols>(dst, a.cand, p.lo, p.hi, lane);
    stage_rows<1>(reinterpret_cast<int*>(dst + kForceCols * kPiece), a.csrc,
                  p.lo, p.hi, lane);
  };
  auto test = [&](const float* sp, const Piece& p) {
    const int* ss = reinterpret_cast<const int*>(sp + kForceCols * kPiece);
    const int j1 = min(p.e, p.hi);
    for (int j = max(p.a, p.lo); j < j1; ++j) {
      const int k = j - p.lo;
      const float* c = sp + k * kForceCols;
      const float dx = c[0] - xi;
      const float dy = c[1] - yi;
      const float dz = c[2] - zi;
      const float d2 = dist2(dx, dy, dz);
      if (ss[k] != own && d2 < a.h2) {
        // density part: K1's op sequence, so rho and count equal its bits
        const float mj = c[7];
        const float t = __fsub_rn(a.h_scaled2, __fmul_rn(d2, a.scale2));
        const float w3 = a.poly6 * t * t * t;
        s.rho += mj * w3;
        ++s.count;
        const float d = sqrtf(d2) * a.scale;
        const float hd = a.h - d;
        const float hd2inv = (hd * hd) / (d + a.eps) * a.scale;
        const float c1 = hd2inv * mj;
        const float c2 = hd2inv * c[8];
        s.p1x -= dx * c1;
        s.p1y -= dy * c1;
        s.p1z -= dz * c1;
        s.p2x -= dx * c2;
        s.p2y -= dy * c2;
        s.p2z -= dz * c2;
        const float rim = c[6];
        s.vx += (c[3] - vxi * rim) * hd;
        s.vy += (c[4] - vyi * rim) * hd;
        s.vz += (c[5] - vzi * rim) * hd;
      }
    }
  };
  band_walk<kPiece, kForceWords<kExclSrc>>(a.cell_start, ci, live, a.nx, a.ny,
                                           a.num_cells, a.m, stage, test);
  if (live) {
    float rho = s.rho;
    if (a.include_self) {
      const float h2s = a.h_scaled2;
      rho += a.mass[i] * a.poly6 * h2s * h2s * h2s;
    }
    const float rhoi_inv = 1.f / (rho > 0.f ? rho : 1.f);
    const float pw_i = (rho - a.rho0) * a.stiffness * rhoi_inv * rhoi_inv;
    const float mu_rhoi = a.viscosity * rhoi_inv;
    a.acc[3 * i] =
        mu_rhoi * s.vx * a.visc_norm + (pw_i * s.p1x + s.p2x) * a.visc_norm;
    a.acc[3 * i + 1] =
        mu_rhoi * s.vy * a.visc_norm + (pw_i * s.p1y + s.p2y) * a.visc_norm;
    a.acc[3 * i + 2] =
        mu_rhoi * s.vz * a.visc_norm + (pw_i * s.p1z + s.p2z) * a.visc_norm;
    a.rho[i] = rho;
    a.ncount[i] = s.count;
  }
}

// One band kernel launch: ceil(n / kBandBlock) blocks, per warp two slots of
// kPiece rows of kWords words.
template <int kPiece, int kWords, typename Args>
int launch_band(void (*kernel)(Args), const Args& a, void* stream) {
  const int nblocks = (a.n + kBandBlock - 1) / kBandBlock;
  const size_t smem = static_cast<size_t>(kBandBlock / 32) * 2 * kPiece *
                      kWords * sizeof(float);
  kernel<<<nblocks, kBandBlock, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kExcl>
int launch_density_band(const DensityBandArgs& a, void* stream) {
  return launch_band<kDensityPiece, kDensityWords<kExcl>>(
      density_band_t<kExcl>, a, stream);
}

template <int kExcl>
int launch_force_band(const ForceBandArgs& a, void* stream) {
  return launch_band<kForcePiece<kExcl>, kForceWords<kExcl>>(
      force_band_t<kExcl>, a, stream);
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError(): nonzero when the launch was refused.  Pointers
// a mode does not read (src, csrc) may be null.
int sph_density_t(const float* pos, const float* mass, const int* cid,
                  const int* src, const float* cpos, const float* cmass,
                  const int* ccid, const int* csrc, const int* ws,
                  const int* wc, float* rho, int* ncount, int n, int m,
                  int block, int s_t, int nx, int ny, int include_self,
                  int excl, int self_base, float h2, float h_scaled2,
                  float scale2, float poly6, void* stream) {
  DensityArgs a;
  a.pos = pos;
  a.mass = mass;
  a.cid = cid;
  a.src = src;
  a.cpos = cpos;
  a.cmass = cmass;
  a.ccid = ccid;
  a.csrc = csrc;
  a.ws = ws;
  a.wc = wc;
  a.rho = rho;
  a.ncount = ncount;
  a.n = n;
  a.m = m;
  a.s_t = s_t;
  a.nx = nx;
  a.ny = ny;
  a.include_self = include_self;
  a.self_base = self_base;
  a.h2 = h2;
  a.h_scaled2 = h_scaled2;
  a.scale2 = scale2;
  a.poly6 = poly6;
  const int nblocks = (n + block - 1) / block;
  const size_t smem = static_cast<size_t>(block) * 6 * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (excl) {
    case kExclRow:
      density_kernel_t<kExclRow><<<nblocks, block, smem, s>>>(a);
      break;
    case kExclSrc:
      density_kernel_t<kExclSrc><<<nblocks, block, smem, s>>>(a);
      break;
    case kExclSrcSrc:
      density_kernel_t<kExclSrcSrc><<<nblocks, block, smem, s>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int sph_force_t(const float* pos, const float* vel, const float* rho,
                const int* cid, const float* cand, const int* ccid,
                const int* csrc, const int* ws, const int* wc, float* acc,
                int n, int m, int block, int s_t, int nx, int ny, int excl,
                int self_base, float h2, float h, float scale, float eps,
                float stiffness, float rho0, float viscosity, float visc_norm,
                void* stream) {
  ForceArgs a;
  a.pos = pos;
  a.vel = vel;
  a.rho = rho;
  a.cid = cid;
  a.cand = cand;
  a.ccid = ccid;
  a.csrc = csrc;
  a.ws = ws;
  a.wc = wc;
  a.acc = acc;
  a.n = n;
  a.m = m;
  a.s_t = s_t;
  a.nx = nx;
  a.ny = ny;
  a.self_base = self_base;
  a.h2 = h2;
  a.h = h;
  a.scale = scale;
  a.eps = eps;
  a.stiffness = stiffness;
  a.rho0 = rho0;
  a.viscosity = viscosity;
  a.visc_norm = visc_norm;
  const int nblocks = (n + block - 1) / block;
  const size_t smem =
      static_cast<size_t>(block) * (kForceCols + 2) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (excl) {
    case kExclRow:
      force_kernel_t<kExclRow><<<nblocks, block, smem, s>>>(a);
      break;
    case kExclSrc:
      force_kernel_t<kExclSrc><<<nblocks, block, smem, s>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int sph_fused_t(const float* pos, const float* vel, const float* mass,
                const int* cid, const float* cand, const int* ccid,
                const int* csrc, const int* ws, const int* wc, float* acc,
                float* rho, int* ncount, int n, int m, int block, int s_t,
                int nx, int ny, int include_self, int self_base, float h2,
                float h_scaled2, float scale2, float poly6, float h,
                float scale, float eps, float stiffness, float rho0,
                float viscosity, float visc_norm, void* stream) {
  FusedArgs a;
  a.pos = pos;
  a.vel = vel;
  a.mass = mass;
  a.cid = cid;
  a.cand = cand;
  a.ccid = ccid;
  a.csrc = csrc;
  a.ws = ws;
  a.wc = wc;
  a.acc = acc;
  a.rho = rho;
  a.ncount = ncount;
  a.n = n;
  a.m = m;
  a.s_t = s_t;
  a.nx = nx;
  a.ny = ny;
  a.include_self = include_self;
  a.self_base = self_base;
  a.h2 = h2;
  a.h_scaled2 = h_scaled2;
  a.scale2 = scale2;
  a.poly6 = poly6;
  a.h = h;
  a.scale = scale;
  a.eps = eps;
  a.stiffness = stiffness;
  a.rho0 = rho0;
  a.viscosity = viscosity;
  a.visc_norm = visc_norm;
  const int nblocks = (n + block - 1) / block;
  const size_t smem =
      static_cast<size_t>(block) * (kForceCols + 2) * sizeof(float);
  fused_kernel_t<<<nblocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// The band walks: self rows [n] over m candidates sorted by cell id, with
// cell_start the candidates' [num_cells + 1] cell-start table.  excl
// kExclRow: the candidates are the self rows (cpos = pos, cmass = mass,
// csrc null, self_base 0) or, in the slab engine, the live rows of the
// extended frame (self_base: the compacted row of self row 0); kExclSrc:
// the capped sub frame, csrc its sorted rows (self_base 0) or, in the slab
// engine, its extended-frame rows (self_base h_cap); kExclSrcSrc (density
// only, the fused path's pre-pass): the self rows are the sub frame itself,
// src = csrc its src rows.  src is read by kExclSrcSrc only.
int sph_density_band_t(const float* pos, const float* mass, const int* cid,
                       const int* src, const float* cpos, const float* cmass,
                       const int* csrc, const int* cell_start, float* rho,
                       int* ncount, int n, int m, int num_cells, int nx,
                       int ny, int include_self, int excl, int self_base,
                       float h2, float h_scaled2, float scale2, float poly6,
                       void* stream) {
  DensityBandArgs a;
  a.pos = pos;
  a.mass = mass;
  a.cid = cid;
  a.src = src;
  a.cpos = cpos;
  a.cmass = cmass;
  a.csrc = csrc;
  a.cell_start = cell_start;
  a.rho = rho;
  a.ncount = ncount;
  a.n = n;
  a.m = m;
  a.num_cells = num_cells;
  a.nx = nx;
  a.ny = ny;
  a.include_self = include_self;
  a.self_base = self_base;
  a.h2 = h2;
  a.h_scaled2 = h_scaled2;
  a.scale2 = scale2;
  a.poly6 = poly6;
  switch (excl) {
    case kExclRow:
      return launch_density_band<kExclRow>(a, stream);
    case kExclSrc:
      return launch_density_band<kExclSrc>(a, stream);
    case kExclSrcSrc:
      return launch_density_band<kExclSrcSrc>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int sph_force_band_t(const float* pos, const float* vel, const float* rho,
                     const int* cid, const float* cand, const int* csrc,
                     const int* cell_start, float* acc, int n, int m,
                     int num_cells, int nx, int ny, int excl, int self_base,
                     float h2, float h, float scale, float eps,
                     float stiffness, float rho0, float viscosity,
                     float visc_norm, void* stream) {
  ForceBandArgs a;
  a.pos = pos;
  a.vel = vel;
  a.rho = rho;
  a.cid = cid;
  a.cand = cand;
  a.csrc = csrc;
  a.cell_start = cell_start;
  a.acc = acc;
  a.n = n;
  a.m = m;
  a.num_cells = num_cells;
  a.nx = nx;
  a.ny = ny;
  a.self_base = self_base;
  a.h2 = h2;
  a.h = h;
  a.scale = scale;
  a.eps = eps;
  a.stiffness = stiffness;
  a.rho0 = rho0;
  a.viscosity = viscosity;
  a.visc_norm = visc_norm;
  switch (excl) {
    case kExclRow:
      return launch_force_band<kExclRow>(a, stream);
    case kExclSrc:
      return launch_force_band<kExclSrc>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3 over the sub frame's table: capped K2's self rows, candidates and
// exclusion (csrc[j] != self_base + i).
int sph_fused_band_t(const float* pos, const float* vel, const float* mass,
                     const int* cid, const float* cand, const int* csrc,
                     const int* cell_start, float* acc, float* rho,
                     int* ncount, int n, int m, int num_cells, int nx, int ny,
                     int include_self, int self_base, float h2,
                     float h_scaled2, float scale2, float poly6, float h,
                     float scale, float eps, float stiffness, float rho0,
                     float viscosity, float visc_norm, void* stream) {
  FusedBandArgs a;
  a.pos = pos;
  a.vel = vel;
  a.mass = mass;
  a.cid = cid;
  a.cand = cand;
  a.csrc = csrc;
  a.cell_start = cell_start;
  a.acc = acc;
  a.rho = rho;
  a.ncount = ncount;
  a.n = n;
  a.m = m;
  a.num_cells = num_cells;
  a.nx = nx;
  a.ny = ny;
  a.include_self = include_self;
  a.self_base = self_base;
  a.h2 = h2;
  a.h_scaled2 = h_scaled2;
  a.scale2 = scale2;
  a.poly6 = poly6;
  a.h = h;
  a.scale = scale;
  a.eps = eps;
  a.stiffness = stiffness;
  a.rho0 = rho0;
  a.viscosity = viscosity;
  a.visc_norm = visc_norm;
  return launch_band<kFusedPiece, kForceWords<kExclSrc>>(fused_band_t, a,
                                                         stream);
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
