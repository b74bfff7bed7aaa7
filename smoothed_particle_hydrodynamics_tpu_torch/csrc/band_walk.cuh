// The per-warp staged band walk that the band kernels of csrc/sweep_t.cu
// (K1 density_band_t, K2 force_band_t, K3 fused_band_t) run, with its
// constants: the rods, the block of 4 warps, the band of a self row in the
// candidates' cell-start table, the pieces a warp stages and the
// double-buffered cp.async walk over them.  csrc/floor_t.cu's floor_band_t
// runs the same walk with trivial arithmetic (the floor probe of
// tools/probe_dma_floor.py), so the probe's skeleton is the production one
// by construction.  sweep_t.cu documents the design and its measurements.

#pragma once

#include <cuda_pipeline.h>

#include <climits>

namespace {

constexpr int kRods = 9;

// Rod r of [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]: its linear
// cell-id offset (dz * ny + dy) * nx.
__device__ __forceinline__ int rod_delta(int r, int nx, int ny) {
  const int dy = r / 3 - 1;
  const int dz = r % 3 - 1;
  return (dz * ny + dy) * nx;
}

constexpr int kBandBlock = 128;   // threads (self rows) per block: 4 warps
constexpr unsigned kFullMask = 0xffffffffu;

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

}  // namespace
