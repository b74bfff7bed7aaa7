// Neighbor sweeps over the cell-sorted particle frame, for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// smoothed_particle_hydrodynamics_tpu_torch/ops/sweeps_t.py, whose
// density_t_plain / force_t_plain / fused_t_plain are the PyTorch versions of
// the same sums over the same bands.
//
// Replaces, in smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py:
//   K1 density_band_t, K2 force_band_t <- its density and force kernels
//      (:293 and :360), exact and capped, and the fused path's sub-frame
//      pre-pass (the density kernel with self_src_row=5: density_band_t
//      <kExclSrcSrc>), on one device (the lazy paths) and in the slab
//      engine: per-lane band walks, see their section;
//   K3 fused_band_t <- its fused kernel (:497, capped only), the same band
//      walk.
//
// What they compute.  Particles are sorted by linear cell id
// (z*ny + y)*nx + x.  The TPU kernels walk, for each of the 9 (dy, dz)
// stencil rods of a block of sorted SELF rows, one contiguous row window of
// the CANDIDATE frame and mask it by cell id; here each self row walks only
// the candidate rows that mask admits (its cell bands, below).  In exact mode
// both frames are the sorted particles; in capped ("Subsets") mode the
// candidates are the sub frame: at most K_c hash-chosen particles of each
// cell, compacted to the front, so a band spans 3 cells x K_c rows at most.
// A pair (i, j) counts when
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
// The TPU kernels' 128-lane row padding, per-block reference point and MXU
// reductions are not carried over: the sums are direct per-pair sums (acc
// then differs from the TPU's only by reassociation).  Cell ids and source
// rows are int32 (the TPU kernels carry them as f32, exact only below 2^24).
//
// Self rows and candidates may be two frames.  A self row's own id is
// self_base + i: 0 on the single-chip path, where self row i is candidate
// row i; in the distributed slab engine, whose self rows are the own slab
// of the extended frame [left halo | own slab | right halo], the offset of
// the own slab in the candidates (the TPU kernels' block_base,
// parallel/slabs.py:571).
//
// Rounding.  d^2 and t = h_scaled^2 - d^2 * scale^2 are formed with
// explicitly rounded intrinsics (no FMA contraction), so the mask sees the
// same bits as the plain PyTorch version's separate multiplies and adds and
// neighbor counts agree exactly; the build also passes --fmad=false so the
// rest of the arithmetic rounds op by op as well.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

#include "band_walk.cuh"

namespace {

// force candidate columns: x y z rimj*vx rimj*vy rimj*vz rimj mj mj*pwj
constexpr int kForceCols = 9;

// Self-exclusion: which ids a pair compares to drop the particle itself.
enum Excl {
  kExclRow = 0,     // candidate row vs self row: one frame for both (exact)
  kExclSrc = 1,     // candidate's full-frame row vs self row (capped)
  kExclSrcSrc = 2,  // candidate's vs self's full-frame row (sub-frame pre-pass)
};

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------------------
// K1, K2 and K3 as per-lane band walks: density_band_t and force_band_t,
// exact (kExclRow) and capped (kExclSrc), the fused path's pre-pass
// density_band_t<kExclSrcSrc> and K3 fused_band_t, the single-device lazy
// paths' kernels and the slab engine's.
//
// Replace pallas_step_t.py's density kernel (:293, capped :321, pre-pass
// :1090), force kernel (:360, capped :403) and fused kernel (:497); in the
// slab engine, the callers of
// _slab_chunked_call (parallel/slabs.py:494, :588, :663, :704, :750, :792).
//
// The fused path's two kernels walk the capped sub frame's table too.  K3's
// self rows, candidates and exclusion are capped K2's (the sorted frame, or
// the own slab with self_base = h_cap, over the sub frame's fused_cand_cols
// and src rows); it sums K1's rho and count and K2's split pressure and
// viscosity terms in one op order (K1's for rho and the counts, which thus
// equal capped K1's band walk's on the same tensors).  The pre-pass's self
// rows are the sub frame itself: self row i's own id is its src row src[i]
// (kExclSrcSrc), and its unkept tail rows carry self cid TAIL_CID = -2^30,
// whose bands are all empty, so they write the self term and count 0 (no
// pair reads a tail row's density).
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
// candidates of self row i that pass the cid mask for rod
// delta, |cid_j - cid_i - delta| <= 1, are one contiguous range: rows
// [cell_start[ci+delta-1], cell_start[ci+delta+2]) of the candidates'
// cell-start table (cell_start[c] = first candidate row of cell c,
// cell_start[num_cells] = the candidates in cells: n exact, the kept rows
// within the sub frame capped, so its tail rows are in no band).  That
// range is exactly the rows of the TPU kernels' block rod window that pass
// the mask, in the window's order (the CPU tests check this against the JAX
// package's window tables).  The pair test is left with the
// self-exclusion (j != self_base + i exact, csrc[j] != self_base + i capped)
// and d^2 < h^2; the cid load and mask are gone.
//
// What bounds them.  Still the instructions of rejected-pair tests (a few
// percent of the tested rows are pairs within h), but each lane tests only
// its own band: at the 1M splash ~350 rows per particle exact against ~2100
// in its block's rod windows, and at most 9 x 3 cells x K_c rows capped.  A
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
// (K2) against 1.87 and 2.60 for a one-thread-per-row walk of whole block
// windows through shared memory, and against 0.38 and 0.72 for lanes
// reading their band rows straight from global memory with __ldg (rows
// shared by a warp broadcast from L1), so the staged walk is kept.  Capped,
// the walk took 0.147 ms (K1) and 0.241 ms (K2) against the window walk's
// 1.03 and 1.33, testing ~95 rows per lane against ~1030.
//
// K2 tests, then drains.  With the pair term inside the row loop, some lane
// of 32 hits on nearly every tested row (~8 % of a band's rows are pairs),
// so the warp issued K2's sqrt, divide and ~20 further ops for one to three
// lanes.  K2 now tests a piece's band rows into a per-lane hit mask and then
// drains the mask, issuing the pair term once a drain round: per warp and
// piece, the most hits of any lane.  On an H100: at the 1M splash (exact)
// the test pass alone takes 0.330 ms (K1 0.352), the pair term in the loop
// took 0.322 more and the drain takes 0.261 (36.5 % of the lanes busy), so
// K2 0.652 -> 0.591 ms; the 10M dam break at rest 7.06 -> 6.39 (test pass
// 3.69), but at its step 480 (39.8 pairs a particle against 29.6) only
// 8.66 -> 8.60, the drain 4.19 ms at 31.9 %; capped K_c 4, 1M 0.230 ->
// 0.209 and 10M 2.25 -> 2.07.  A drain per 32-row word (3 a piece exact)
// took 6.52 ms at 10M (27.5 % busy), so the drain is per piece.  The drain
// is bound by issue, not latency: two hits a round ran no faster, while
// draining a third of each lane's hits cut it ~60 %.  What is left is the
// idle lanes of each round.
//
// The walk (band_rows, Piece, next_piece, stage_rows, band_walk) and its
// constants live in band_walk.cuh, which csrc/floor_t.cu's floor probe
// includes too.

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

// Density sum of a pair within h: K1's op sequence, which K3 repeats.
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
  // [2] or null: the pairs and the drain rounds of the walk, added to
  // (the counters sweeps.force_pairs and sweeps.force_rounds)
  unsigned long long* stats;
  int n, m, num_cells, nx, ny;
  int self_base;          // own id of self row i: self_base + i
  float h2, h, scale, eps, stiffness, rho0, viscosity, visc_norm;
};

struct ForceSums {
  float ax, ay, az, vx, vy, vz;
};

// Force pair term on candidate row c (its kForceCols columns),
// d2 and dx dy dz already formed.
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

// K2 tests a piece's band rows first and runs the pair term on the hits
// only.  The test pass sets bit t of a per-lane hit mask (kPiece / 32 words
// in registers) for the t-th row of the lane's band in the piece that is a
// pair; t, not the row's slot index, so that every lane of an iteration
// writes the same word and the mask needs no per-row select.  The drain pass
// takes each lane's set bits in ascending order, recomputes the row's
// offsets and d^2 with the same rounded ops (the same bits) and adds its
// pair term: each lane adds the same pairs in the same order as one loop
// over the rows would, so the sums are bit-equal to it, while the warp
// issues the pair term once a drain round (the most hits of any lane in the
// piece) and not on every tested row in which some lane hits.  The drain
// ends before band_walk's __syncwarp frees the slot for restaging.
template <int kExcl>
__global__ void __launch_bounds__(kBandBlock)
    force_band_t(ForceBandArgs a) {
  // a slot: the kForceCols columns (row-major), then (capped) the src rows
  constexpr int kPiece = kForcePiece<kExcl>;
  constexpr int kHitWords = kPiece / 32;
  static_assert(kPiece % 32 == 0, "a piece is a whole number of mask words");
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
  unsigned pairs = 0, rounds = 0;  // counted where a.stats is set
  auto stage = [&](float* dst, const Piece& p) {
    stage_rows<kForceCols>(dst, a.cand, p.lo, p.hi, lane);
    if constexpr (kExcl != kExclRow)
      stage_rows<1>(reinterpret_cast<int*>(dst + kForceCols * kPiece),
                    a.csrc, p.lo, p.hi, lane);
  };
  auto test = [&](const float* sp, const Piece& p) {
    const int j0 = max(p.a, p.lo);  // this lane's band rows [j0, j0 + len)
    const int len = min(p.e, p.hi) - j0;
    const float* c0 = sp + (j0 - p.lo) * kForceCols;
    const int* s0 =
        reinterpret_cast<const int*>(sp + kForceCols * kPiece) + (j0 - p.lo);
    unsigned hit[kHitWords];
#pragma unroll
    for (int w = 0; w < kHitWords; ++w) {
      unsigned bits = 0;
      const int t1 = min(len, 32 * w + 32);
      for (int t = 32 * w; t < t1; ++t) {
        const float* c = c0 + t * kForceCols;
        const float d2 = dist2(c[0] - xi, c[1] - yi, c[2] - zi);
        const int id = kExcl == kExclRow ? j0 + t : s0[t];
        if (id != own && d2 < a.h2) bits |= 1u << (t - 32 * w);
      }
      hit[w] = bits;
    }
    if (a.stats) {
      int n = 0;
#pragma unroll
      for (int w = 0; w < kHitWords; ++w) n += __popc(hit[w]);
      pairs += n;
      rounds += __reduce_max_sync(kFullMask, n);
    }
    for (;;) {  // the lowest set bit of the lowest non-empty word
      int t = -1;
#pragma unroll
      for (int w = 0; w < kHitWords; ++w)
        if (t < 0 && hit[w]) {
          t = 32 * w + __ffs(hit[w]) - 1;
          hit[w] &= hit[w] - 1;
        }
      if (t < 0) break;
      const float* c = c0 + t * kForceCols;
      const float dx = c[0] - xi;
      const float dy = c[1] - yi;
      const float dz = c[2] - zi;
      force_pair(a, c, dx, dy, dz, dist2(dx, dy, dz), pw_i, vxi, vyi, vzi, s);
    }
  };
  band_walk<kPiece, kForceWords<kExcl>>(a.cell_start, ci, live, a.nx, a.ny,
                                        a.num_cells, a.m, stage, test);
  if (a.stats) {
    const unsigned total = __reduce_add_sync(kFullMask, pairs);
    if (lane == 0 && rounds) {
      atomicAdd(a.stats, static_cast<unsigned long long>(total));
      atomicAdd(a.stats + 1, static_cast<unsigned long long>(rounds));
    }
  }
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

// K3 over the sub frame's bands: K1's density term and the split pressure
// and viscosity terms on the pairs of capped K2's bands.  It carries 11
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

// The counter sweeps.rows_tested (utils/trace.py): the lane-rows one band
// kernel launch over these bands tests.  Per warp of the band kernels' grid,
// 32 lanes times the sum over the rods of the rows of the union of its live
// lanes' non-empty bands (the rows next_piece stages), added into *rows.
__global__ void __launch_bounds__(kBandBlock)
    band_rows_t(const int* cid, const int* cell_start, int n, int m,
                int num_cells, int nx, int ny, unsigned long long* rows) {
  const int i = blockIdx.x * kBandBlock + threadIdx.x;
  const bool live = i < n;
  const int ci = live ? cid[i] : 0;
  unsigned long long sum = 0;
  for (int r = 0; r < kRods; ++r) {
    int a = 0, e = 0;
    if (live)
      band_rows(cell_start, ci, rod_delta(r, nx, ny), num_cells, m, a, e);
    const bool some = a < e;
    const int lo = __reduce_min_sync(kFullMask, some ? a : INT_MAX);
    const int hi = __reduce_max_sync(kFullMask, some ? e : 0);
    if (lo < hi) sum += static_cast<unsigned long long>(hi - lo);
  }
  if ((threadIdx.x & 31) == 0 && sum) atomicAdd(rows, 32ull * sum);
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError(): nonzero when the launch was refused.  Pointers
// a mode does not read (src, csrc) may be null.
//
// The band walks: self rows [n] over m candidates sorted by cell id, with
// cell_start the candidates' [num_cells + 1] cell-start table.  excl
// kExclRow: the candidates are the self rows (cpos = pos, cmass = mass,
// csrc null, self_base 0) or, in the slab engine, the live rows of the
// extended frame (self_base: the compacted row of self row 0); kExclSrc:
// the capped sub frame, csrc its sorted rows (self_base 0) or, in the slab
// engine, its extended-frame rows (self_base h_cap); kExclSrcSrc (density
// only, the fused path's pre-pass): the self rows are the sub frame itself,
// src = csrc its src rows.  src is read by kExclSrcSrc only.  K2's stats,
// where not null, is a [2] counter to which its launch adds the pairs it
// sums and its warps' drain rounds; null counts nothing (no atomic).
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
                     const int* cell_start, float* acc,
                     unsigned long long* stats, int n, int m, int num_cells,
                     int nx, int ny, int excl, int self_base, float h2,
                     float h, float scale, float eps, float stiffness,
                     float rho0, float viscosity, float visc_norm,
                     void* stream) {
  ForceBandArgs a;
  a.pos = pos;
  a.vel = vel;
  a.rho = rho;
  a.cid = cid;
  a.cand = cand;
  a.csrc = csrc;
  a.cell_start = cell_start;
  a.acc = acc;
  a.stats = stats;
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

// Adds the lane-rows of band_rows_t to *rows (a zeroed 64-bit counter).
int sph_band_rows_t(const int* cid, const int* cell_start, int n, int m,
                    int num_cells, int nx, int ny, unsigned long long* rows,
                    void* stream) {
  const int nblocks = (n + kBandBlock - 1) / kBandBlock;
  if (nblocks > 0)
    band_rows_t<<<nblocks, kBandBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        cid, cell_start, n, m, num_cells, nx, ny, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* sph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
