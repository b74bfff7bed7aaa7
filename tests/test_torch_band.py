"""The exact sweeps' cell-start table and per-lane bands (the rows the band
kernels ``density_band_t``/``force_band_t`` walk, ``csrc/sweep_t.cu``).

On the card the band kernels are held bit-equal to the block-walk kernels
(``chip_smoke.py`` phases 2 and 4); that rests on two facts checked here on
the CPU, by brute force against the window tables the JAX package defines
(``tests/test_torch_grid_integrate.py`` holds those equal to JAX's):

* each self row's band for a rod lies inside its block's rod window
  ``[ws, min(ws + wc*s_t, n))``;
* it holds exactly the rows of that window that pass the block walk's cid
  mask ``|cid_j - cid_i - delta| <= 1``, so walking it in row order sums
  the same pairs in the same order.

Also: the table against ``np.searchsorted``, the lazy carry freezing it and
rebuilding it on a rebin, capped mode carrying none, and the band counts of
``utils/walk_stats.py`` against a brute-force count.
"""

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy, sweeps_t
from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import rod_deltas
from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
    WARP, band_rows_per_lane)

# The sizes are small, and under pytest-xdist eight torch threads per worker
# oversubscribe the cores.
torch.set_num_threads(1)

# (scene, overrides): 1.25h and 1.0h cells on small grids whose pools fill
# the floor and corner cells, so rods reach below cell 0 and past the last
# cell; a dilute disk with empty rods; 256-row blocks.
CASES = [
    ("splash", dict(num_particles=3000, cell_size_factor=1.25,
                    pallas_window_t=64, grid_nx=8, grid_ny=8, grid_nz=8)),
    ("splash", dict(num_particles=3000, cell_size_factor=1.0,
                    pallas_window_t=64, grid_nx=8, grid_ny=8, grid_nz=8)),
    ("dam_break", dict(num_particles=1500, pallas_window_t=32,
                       grid_nx=16, grid_ny=16, grid_nz=16,
                       pallas_block_t=256)),
    ("disk", dict(num_particles=700, pallas_window_t=64)),
]
IDS = ["splash-1.25h", "splash-1.0h", "dam-break-1.0h-b256", "disk"]


def _prepared(scene, kw):
    cfg, st = make_scene(scene, device="cpu", **kw)
    return cfg, st, sweeps_t.prepare_t(cfg, st)


@pytest.mark.parametrize("scene,kw", CASES, ids=IDS)
def test_cell_start_is_a_search_of_the_sorted_cids(scene, kw):
    cfg, st, p = _prepared(scene, kw)
    cid = p.cid.numpy()
    assert np.all(np.diff(cid) >= 0)
    want = np.searchsorted(cid, np.arange(cfg.num_cells + 1), side="left")
    assert p.cell_start.dtype == torch.int32
    np.testing.assert_array_equal(p.cell_start.numpy(), want)
    assert int(p.cell_start[-1]) == st.n


@pytest.mark.parametrize("scene,kw", CASES, ids=IDS)
def test_band_is_the_masked_part_of_the_block_window(scene, kw):
    """Brute force over every self row and rod: the band [a, e) lies in the
    block's rod window and equals the window rows passing the cid mask."""
    cfg, st, p = _prepared(scene, kw)
    n, b, s_t = st.n, sweeps_t._blane(cfg), cfg.pallas_window_t
    cid = p.cid.numpy().astype(np.int64)
    ws = p.ws.numpy().reshape(-1, 9).astype(np.int64)
    wc = p.wc.numpy().reshape(-1, 9).astype(np.int64)
    a, e = (x.numpy() for x in sweeps_t.band_ranges(cfg, p.cid, p.cell_start))
    deltas = np.asarray(rod_deltas(cfg))
    rows = np.arange(n)
    edge = 0
    for i in range(n):
        blk = i // b
        for r, delta in enumerate(deltas):
            lo, hi = ws[blk, r], min(ws[blk, r] + wc[blk, r] * s_t, n)
            in_win = rows[lo:hi]
            passing = in_win[np.abs(cid[lo:hi] - cid[i] - delta) <= 1]
            band = rows[a[i, r]:max(a[i, r], e[i, r])]
            np.testing.assert_array_equal(band, passing, f"row {i} rod {r}")
            if band.size:
                assert lo <= a[i, r] and e[i, r] <= hi, f"row {i} rod {r}"
            edge += not 0 < cid[i] + delta < cfg.num_cells - 1
    # the pools fill the floor: some cell ranges reach past the grid's
    # first or last cell, where the clamp must give the right rows
    assert edge > 0 or scene == "disk"


def test_band_rows_per_lane_against_brute_force():
    cfg, st, p = _prepared(*CASES[0])
    n = st.n
    cid = p.cid.numpy().astype(np.int64)
    deltas = np.asarray(rod_deltas(cfg))
    rows = np.zeros((n, 9), np.int64)
    union = []
    for i in range(n):
        d = cid - cid[i]
        for r, delta in enumerate(deltas):
            rows[i, r] = np.count_nonzero(np.abs(d - delta) <= 1)
    for w0 in range(0, n, WARP):
        tot = 0
        for r, delta in enumerate(deltas):
            hit = np.zeros(n, bool)
            for i in range(w0, min(w0 + WARP, n)):
                hit |= np.abs(cid - cid[i] - delta) <= 1
            idx = np.flatnonzero(hit)
            tot += idx[-1] + 1 - idx[0] if idx.size else 0
        union.append(tot)
    got = band_rows_per_lane(cfg, p)
    nw = -(-n // WARP)
    padded = np.zeros((nw * WARP, 9), np.int64)
    padded[:n] = rows
    assert got["mean"] == pytest.approx(rows.sum(1).mean(), rel=1e-12)
    assert got["warp_max"] == pytest.approx(
        padded.reshape(nw, WARP, 9).max(1).sum(1).mean(), rel=1e-12)
    assert got["warp_union"] == pytest.approx(np.mean(union), rel=1e-12)
    assert got["mean"] <= got["warp_max"] <= got["warp_union"]


def test_lazy_carry_freezes_cell_start_and_rebuilds_it_on_rebin():
    cfg, st = make_scene("splash", device="cpu", num_particles=768,
                         cell_size_factor=1.5, pallas_window_t=64)
    carry = lazy.init_lazy(cfg, st)
    np.testing.assert_array_equal(carry.cell_start.numpy(),
                                  sweeps_t.prepare_t(cfg, st).cell_start)
    frozen = carry.cell_start
    carry, _ = lazy.lazy_step(cfg, carry)
    assert carry.rebin_count == 0 and carry.cell_start is frozen
    # a kick past the skin forces a rebin, which rebuilds the table from the
    # moved state
    kick = torch.zeros_like(carry.state.position)
    kick[:, 0] = torch.linspace(0.0, 3.0 * cfg.cell_size, st.n)
    moved = carry.state._replace(position=carry.state.position + kick)
    carry = carry._replace(state=moved)
    carry, _ = lazy.lazy_step(cfg, carry)
    assert carry.rebin_count == 1 and carry.steps_since == 0
    want = sweeps_t.prepare_t(cfg, moved).cell_start
    np.testing.assert_array_equal(carry.cell_start.numpy(), want.numpy())
    assert not torch.equal(carry.cell_start, frozen)


@pytest.mark.parametrize("fused", [False, True])
def test_capped_mode_has_no_cell_start(fused):
    cfg, st = make_scene("splash", device="cpu", num_particles=512,
                         cell_size_factor=1.25, pallas_window_t=64,
                         capped_candidates=4, pallas_block_t=256,
                         capped_fused=fused)
    assert sweeps_t.prepare_t(cfg, st).cell_start is None
    assert lazy.init_lazy(cfg, st).cell_start is None


def test_band_launch_refuses_a_missing_table():
    """A CUDA tensor reaches the band kernel or raises; without the table
    the launch stops before the library is even built."""
    cfg, st, p = _prepared(*CASES[0])
    with pytest.raises(ValueError, match="cell-start table"):
        sweeps_t._band_specs(cfg, st.n, p.pos_s, p.cid, None)
