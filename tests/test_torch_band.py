"""The sweeps' cell-start tables and per-lane bands (the rows the band
kernels ``density_band_t``/``force_band_t`` walk, ``csrc/sweep_t.cu``):
exact mode over the sorted frame, capped mode over the sub frame.

The JAX kernels walk each block's rod windows and mask them by cell id;
the band kernels and their twins walk the bands.  Two facts make them sum
the same pairs, checked here on the CPU by brute force against the JAX
package's own window tables (``tests/jax_windows.py``):

* each self row's band for a rod lies inside its block's rod window
  ``[ws, min(ws + wc*s_t, m))`` over the m candidate rows;
* it holds exactly the rows of that window that pass the cid mask
  ``|cid_j - cid_i - delta| <= 1`` (never a capped tail row), in the
  window's order.

Also: each table against ``np.searchsorted``, the lazy carry freezing it and
rebuilding it on a rebin, a launch without a table refused, and the band
counts of ``utils/walk_stats.py`` against a brute-force count.
"""

import jax_windows
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

# Capped mode: K_c 4 on 256-row blocks (bench.py's capped_k4), two-pass and
# fused; a sub frame cut below the kept count (sub_dropped > 0); K_c 2 on
# 128-row blocks and 1.0h cells; the dilute disk.
CAPPED_CASES = [
    ("splash", dict(CASES[0][1], capped_candidates=4, pallas_block_t=256)),
    ("splash", dict(CASES[0][1], capped_candidates=4, pallas_block_t=256,
                    capped_fused=True)),
    ("splash", dict(CASES[0][1], capped_candidates=4, pallas_block_t=256,
                    capped_sub_len=640)),
    ("splash", dict(CASES[1][1], capped_candidates=2)),
    ("disk", dict(num_particles=700, pallas_window_t=64, capped_candidates=3,
                  pallas_block_t=256)),
]
CAPPED_IDS = ["k4", "k4-fused", "k4-dropped", "k2-1.0h-b128", "disk-k3"]


def _prepared(scene, kw):
    cfg, st = make_scene(scene, device="cpu", **kw)
    return cfg, st, sweeps_t.prepare_t(cfg, st)


def _kept_cids(p) -> np.ndarray:
    """The sub frame's kept cids within S (its rows before the tail)."""
    cand = p.cand_cid.numpy()
    n_kept = int(np.count_nonzero(cand >= 0))
    assert np.all(cand[n_kept:] == sweeps_t.TAIL_CID)
    return cand[:n_kept].astype(np.int64)


def _check_bands(cfg, cid, cand_cid, p, m):
    """Brute force over every self row and rod: the band [a, e) lies in the
    block's rod window over the m candidates (the JAX package's table, each
    group's at G > 1) and equals the window rows passing the cid mask.
    Returns how many (row, rod) cell ranges reach past the grid's first or
    last cell."""
    b, s_t = sweeps_t._blane(cfg) // cfg.pallas_groups, cfg.pallas_window_t
    search = (cand_cid if p.sub_perm is None
              else jax_windows.sub_search(cfg, cand_cid))
    ws, wc = jax_windows.single_chip(cfg, cid, search)
    a, e = (x.numpy() for x in sweeps_t.band_ranges(cfg, p.cid, p.cell_start))
    deltas = np.asarray(rod_deltas(cfg))
    rows = np.arange(m)
    edge = 0
    for i in range(cid.shape[0]):
        blk = i // b
        for r, delta in enumerate(deltas):
            lo, hi = ws[blk, r], min(ws[blk, r] + wc[blk, r] * s_t, m)
            in_win = rows[lo:hi]
            passing = in_win[np.abs(cand_cid[lo:hi] - cid[i] - delta) <= 1]
            band = rows[a[i, r]:max(a[i, r], e[i, r])]
            np.testing.assert_array_equal(band, passing, f"row {i} rod {r}")
            if band.size:
                assert lo <= a[i, r] and e[i, r] <= hi, f"row {i} rod {r}"
            edge += not 0 < cid[i] + delta < cfg.num_cells - 1
    return edge


def _brute_rows(cid, cand_cid, deltas):
    """Per self row and rod, the candidates passing the cid mask; per warp,
    the sum over rods of the rows of the union of its lanes' passing rows."""
    n = cid.shape[0]
    rows = np.zeros((n, 9), np.int64)
    for i in range(n):
        d = cand_cid - cid[i]
        for r, delta in enumerate(deltas):
            rows[i, r] = np.count_nonzero(np.abs(d - delta) <= 1)
    union = []
    for w0 in range(0, n, WARP):
        tot = 0
        for r, delta in enumerate(deltas):
            hit = np.zeros(cand_cid.shape[0], bool)
            for i in range(w0, min(w0 + WARP, n)):
                hit |= np.abs(cand_cid - cid[i] - delta) <= 1
            idx = np.flatnonzero(hit)
            tot += idx[-1] + 1 - idx[0] if idx.size else 0
        union.append(tot)
    return rows, union


def _check_walk_stats(got, rows, union):
    n = rows.shape[0]
    nw = -(-n // WARP)
    padded = np.zeros((nw * WARP, 9), np.int64)
    padded[:n] = rows
    assert got["mean"] == pytest.approx(rows.sum(1).mean(), rel=1e-12)
    assert got["warp_max"] == pytest.approx(
        padded.reshape(nw, WARP, 9).max(1).sum(1).mean(), rel=1e-12)
    assert got["warp_union"] == pytest.approx(np.mean(union), rel=1e-12)
    assert got["mean"] <= got["warp_max"] <= got["warp_union"]


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
    cid = p.cid.numpy().astype(np.int64)
    edge = _check_bands(cfg, cid, cid, p, st.n)
    # the pools fill the floor: some cell ranges reach past the grid's
    # first or last cell, where the clamp must give the right rows
    assert edge > 0 or scene == "disk"


def test_band_rows_per_lane_against_brute_force():
    cfg, st, p = _prepared(*CASES[0])
    cid = p.cid.numpy().astype(np.int64)
    rows, union = _brute_rows(cid, cid, np.asarray(rod_deltas(cfg)))
    _check_walk_stats(band_rows_per_lane(cfg, p.cid, p.cell_start, st.n),
                      rows, union)


def test_capped_band_rows_per_lane_against_brute_force():
    """The capped bands counted over the sub frame: the full sub frame is
    searched, tail rows included, and the mask alone keeps them out."""
    cfg, st, p = _prepared(*CAPPED_CASES[0])
    cid = p.cid.numpy().astype(np.int64)
    cand = p.cand_cid.numpy().astype(np.int64)
    rows, union = _brute_rows(cid, cand, np.asarray(rod_deltas(cfg)))
    got = band_rows_per_lane(cfg, p.cid, p.cell_start, cand.shape[0])
    _check_walk_stats(got, rows, union)
    # at most 3 cells x K_c rows per rod
    assert rows.max() <= 3 * cfg.capped_candidates


def _check_lazy_table(cfg, st):
    """The carry freezes the prepared table and rebuilds it on a rebin."""
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


def test_lazy_carry_freezes_cell_start_and_rebuilds_it_on_rebin():
    cfg, st = make_scene("splash", device="cpu", num_particles=768,
                         cell_size_factor=1.5, pallas_window_t=64)
    _check_lazy_table(cfg, st)


def test_lazy_carry_freezes_capped_cell_start_and_rebuilds_it_on_rebin():
    cfg, st = make_scene("splash", device="cpu", num_particles=768,
                         cell_size_factor=1.5, pallas_window_t=64,
                         capped_candidates=4, pallas_block_t=256)
    _check_lazy_table(cfg, st)


@pytest.mark.parametrize("scene,kw", CAPPED_CASES, ids=CAPPED_IDS)
def test_capped_cell_start_is_a_search_of_the_kept_cids(scene, kw):
    """Capped mode's table is the sub frame's: entry c is its first row of
    cell c, and the last entry min(n_kept, S), so the tail rows (and kept
    rows cut past S) are in no band."""
    cfg, st, p = _prepared(scene, kw)
    kept = _kept_cids(p)
    assert np.all(np.diff(kept) >= 0)
    want = np.searchsorted(kept, np.arange(cfg.num_cells + 1), side="left")
    assert p.cell_start.dtype == torch.int32
    np.testing.assert_array_equal(p.cell_start.numpy(), want)
    n_kept = kept.shape[0] + int(p.sub_dropped)
    assert int(p.cell_start[-1]) == min(n_kept, p.sub_perm.shape[0])
    assert (int(p.sub_dropped) > 0) == ("capped_sub_len" in kw)
    np.testing.assert_array_equal(lazy.init_lazy(cfg, st).cell_start.numpy(),
                                  want)


@pytest.mark.parametrize("fused", [False, True])
def test_capped_mode_has_no_cell_start(fused):
    """Capped mode keeps no cell-start table of the sorted frame, whose rows
    are never its candidates: ``cell_start`` is the sub frame's, in the
    prepared tables and in the lazy carry, and the particles beyond K_c per
    cell lie in no band."""
    cfg, st = make_scene("splash", device="cpu", num_particles=512,
                         cell_size_factor=1.25, pallas_window_t=64,
                         capped_candidates=4, pallas_block_t=256,
                         capped_fused=fused)
    p = sweeps_t.prepare_t(cfg, st)
    cells = np.arange(cfg.num_cells + 1)
    want = np.searchsorted(_kept_cids(p), cells, side="left")
    np.testing.assert_array_equal(p.cell_start.numpy(), want)
    np.testing.assert_array_equal(lazy.init_lazy(cfg, st).cell_start.numpy(),
                                  want)
    assert int(p.cell_start[-1]) < st.n
    assert not np.array_equal(
        want, np.searchsorted(p.cid.numpy(), cells, side="left"))


@pytest.mark.parametrize("scene,kw", CAPPED_CASES, ids=CAPPED_IDS)
def test_capped_band_is_the_masked_part_of_the_sub_window(scene, kw):
    """Brute force over every self row and rod: the capped band lies in the
    block's rod window over the sub frame and equals the window rows passing
    the cid mask; no band reaches a tail row."""
    cfg, st, p = _prepared(scene, kw)
    cid = p.cid.numpy().astype(np.int64)
    cand = p.cand_cid.numpy().astype(np.int64)
    _check_bands(cfg, cid, cand, p, cand.shape[0])
    _, e = sweeps_t.band_ranges(cfg, p.cid, p.cell_start)
    assert int(e.max()) <= _kept_cids(p).shape[0]


def test_band_launch_refuses_a_missing_table():
    """A CUDA tensor reaches the band kernel or raises; without the table
    the launch stops before the library is even built."""
    cfg, st, p = _prepared(*CASES[0])
    with pytest.raises(ValueError, match="cell-start table"):
        sweeps_t._band_specs(cfg, st.n, st.n, p.pos_s, p.cid, None, None)


@pytest.mark.parametrize("kernel", ["density", "force"])
def test_capped_launch_refuses_a_missing_table(kernel, monkeypatch):
    """On the card (here: the kernel path forced for CPU tensors) a capped
    sweep without the sub frame's table raises before any library is
    built; on the CPU its twin raises too: no sweep falls back to a window
    walk."""
    cfg, st, p = _prepared(*CAPPED_CASES[0])
    monkeypatch.setattr(sweeps_t, "_use_plain", lambda x: False)
    monkeypatch.setattr(sweeps_t, "_kernels", None)  # a build would fail
    pos_c, vel_c = sweeps_t.gather_sub_pv(p)
    with pytest.raises(ValueError, match="cell-start table"):
        if kernel == "density":
            sweeps_t.density_capped_t(
                cfg, p.pos_s, p.mass_s, p.cid, None, pos_c, p.wm_sub,
                p.sub_perm)
        else:
            cand = sweeps_t.fused_cand_cols_plain(
                cfg, pos_c, vel_c, p.mass_s[p.sub_perm], p.wm_sub)
            sweeps_t.force_capped_t(
                cfg, p.pos_s, p.vel_s, p.mass_s, cand, p.cid, None,
                p.sub_perm)
    monkeypatch.setattr(sweeps_t, "_use_plain", lambda x: True)
    with pytest.raises(ValueError, match="cell-start table"):
        sweeps_t.density_capped_t(cfg, p.pos_s, p.mass_s, p.cid, None, pos_c,
                                  p.wm_sub, p.sub_perm)
    assert sweeps_t.density_capped_t.launches == 0
    assert sweeps_t.force_capped_t.launches == 0
