"""The lane frame's cell-start table and the per-lane bands the lane band
kernels walk (``density_band_lane``/``force_band_lane``,
``csrc/sweep_lane.cu``): each row's cell band per rod, intersected with its
block's rod window (``sweeps_lane.band_ranges_lane``).

The lane twins walk the block windows; the band kernels walk each row's
band inside them.  They sum the same pairs by the fact checked here on the
CPU, by brute force against the window table (which
``tests/test_torch_lane.py`` holds equal to the JAX package's): for every
row and rod, the band rows are exactly the rows of the block's window that
the cid mask admits before d^2 (pad rows included, which no mask admits),
in the window's order.  Where the 127-chunk clamp cuts a window, the
intersection cuts the same rows.

Also: the table against ``np.searchsorted``, the band counts of
``utils/walk_stats.py`` against a brute-force count, and the wrappers: a
launch on the card refuses a missing or misshaped table, CPU tensors take
the twin.
"""

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import grid as tgrid
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_lane as sl
from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
    WARP, lane_band_rows_per_lane)

# The sizes are small, and under pytest-xdist eight torch threads per worker
# oversubscribe the cores.
torch.set_num_threads(1)

# tests/test_torch_lane.py's scenes: the packed dam break with 128-row
# windows on 16^3 h-cells (multi-chunk windows), the disk at h = 0.5 on 8^3
# 2h-cells; and the dam break on 64-row blocks
CASES = {
    "dam_break": dict(num_particles=1024, grid_nx=16, grid_ny=16,
                      grid_nz=16, pallas_window=128),
    "disk": dict(num_particles=1024, grid_nx=8, grid_ny=8, grid_nz=8,
                 h=0.5),
    "dam_break-b64": dict(num_particles=1024, grid_nx=16, grid_ny=16,
                          grid_nz=16, pallas_window=128,
                          pallas_block_rows=64),
}


def _prepared(case):
    cfg, st = make_scene(case.split("-")[0], device="cpu",
                         pallas_layout="lane", **CASES[case])
    return cfg, st, sl.prepare_lane(cfg, st)


def _mask_rows(cfg, cid_table, ws, wc, n, blocks=None):
    """Brute force, per (block, rod): the rows of the block's window
    ``[ws, ws + wc*window)`` (inside the n_pad-row table whose cid row is
    ``cid_table``) that pass |cid_j - cid_i - delta| <= 1, for each of its
    self rows (below n), in every block or the given ones.  Yields (self
    rows, rod, passing count, first, last)."""
    b, s = cfg.pallas_block_rows, cfg.pallas_window
    deltas = np.asarray(tgrid.rod_deltas(cfg), np.int64)
    ws = ws.reshape(-1, 9).astype(np.int64)
    wc = wc.reshape(-1, 9).astype(np.int64)
    for blk in range(ws.shape[0]) if blocks is None else sorted(blocks):
        own = np.arange(blk * b, min(n, (blk + 1) * b))
        ci = cid_table[own]
        for r, delta in enumerate(deltas):
            lo = ws[blk, r]
            rows = np.arange(lo, lo + wc[blk, r] * s)
            cj = cid_table[rows]
            hit = np.abs(cj[None, :] - ci[:, None] - delta) <= 1
            cnt = hit.sum(1)
            first = np.where(cnt > 0, rows[hit.argmax(1)] if rows.size
                             else 0, -1)
            last = np.where(cnt > 0, rows[rows.size - 1 - hit[:, ::-1].argmax(1)]
                            if rows.size else 0, -1)
            yield own, r, cnt, first, last


def _check_bands(cfg, cid_table, a, e, ws, wc, n, blocks=None):
    """The bands [a, e) equal the masked window rows, row for row: a set of
    rows equals [a, e) when it has e - a members, the least a and the
    greatest e - 1."""
    checked = 0
    for own, r, cnt, first, last in _mask_rows(cfg, cid_table, ws, wc, n,
                                               blocks):
        length = np.maximum(e[own, r] - a[own, r], 0)
        np.testing.assert_array_equal(cnt, length, f"rows {own[0]}.. rod {r}")
        some = cnt > 0
        np.testing.assert_array_equal(first[some], a[own, r][some])
        np.testing.assert_array_equal(last[some], e[own, r][some] - 1)
        checked += int(some.sum())
    return checked


def _cid_table(cid, n_pad):
    """The field table's cid row: the sorted cids, then NO_CELL pad rows."""
    t = np.full(n_pad, tgrid.NO_CELL, np.int64)
    t[:cid.shape[0]] = cid
    return t


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_cell_start_is_a_search_of_the_sorted_cids(case):
    cfg, st, p = _prepared(case)
    cid = p.cid.numpy()
    assert np.all(np.diff(cid) >= 0)
    want = np.searchsorted(cid, np.arange(cfg.num_cells + 1), side="left")
    assert p.cell_start.dtype == torch.int32
    assert p.cell_start.shape == (cfg.num_cells + 1,)
    np.testing.assert_array_equal(p.cell_start.numpy(), want)
    assert int(p.cell_start[-1]) == st.n


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_band_is_the_masked_part_of_the_block_window(case):
    """Brute force over every row and rod: the band in the window equals
    the window rows the cid mask admits (pad rows never)."""
    cfg, st, p = _prepared(case)
    a, e = (x.numpy() for x in sl.band_ranges_lane(cfg, p.cid, p.cell_start,
                                                    p.ws, p.wc))
    n_pad = sl.n_pad(cfg, st.n)
    table = _cid_table(p.cid.numpy().astype(np.int64), n_pad)
    # the field table's cid row is the one the twin's window walk reads
    fd = sl.density_fields(cfg, p)
    np.testing.assert_array_equal(fd[-1].view(torch.int32).numpy(), table)
    assert _check_bands(cfg, table, a, e, p.ws.numpy(), p.wc.numpy(),
                        st.n) > 0
    assert int(p.truncated_ranges) == 0
    # unclamped: the cell band lies wholly inside the window
    a0, e0 = (x.numpy() for x in sl.band_ranges_lane(
        cfg, p.cid, p.cell_start, p.ws, torch.full_like(p.wc, 10 ** 6)))
    some = e0 > a0
    np.testing.assert_array_equal(a[some], a0[some])
    np.testing.assert_array_equal(e[some], e0[some])
    if case.startswith("dam_break"):
        assert p.wc.max() > 1, "want multi-chunk windows"


def test_lane_band_on_a_clamped_table_cuts_what_the_window_cuts():
    """``test_window_table_clamp_equals_jax``'s synthetic frame: a few cells
    of 20,000 rows, whose rod windows the 127-chunk clamp cuts.  The band in
    the window still equals the masked window rows (checked in a sample of
    the blocks where the intersection cuts rows from the cell bands, of the
    other clamped blocks and of the rest), and only clamped blocks are
    cut."""
    cfg, _, _ = _prepared("dam_break")
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4, cfg.num_cells)
    counts[rng.choice(cfg.num_cells, 6, replace=False)] = 20000
    cell_end = np.cumsum(counts)
    n = int(cell_end[-1])
    cid = np.repeat(np.arange(cfg.num_cells), counts)
    b, s = cfg.pallas_block_rows, cfg.pallas_window
    n_pad = sl.n_pad(cfg, n)
    ws, wc, clamped = sl._block_windows(
        cfg, torch.from_numpy(cid.astype(np.int32)),
        torch.from_numpy((cell_end - counts).astype(np.int32)),
        torch.from_numpy(cell_end.astype(np.int32)), -(-n // b), b, s, n,
        n_pad)
    assert int(clamped) > 0
    table = torch.from_numpy(np.concatenate([[0], cell_end]).astype(np.int32))
    a, e = (x.numpy() for x in sl.band_ranges_lane(
        cfg, torch.from_numpy(cid.astype(np.int32)), table, ws, wc))
    a0, e0 = (x.numpy() for x in sl.band_ranges_lane(
        cfg, torch.from_numpy(cid.astype(np.int32)), table, ws,
        torch.full_like(wc, 10 ** 6)))
    cut = (np.maximum(e, a) - a) < (e0 - a0)
    assert cut.any(), "the clamp must cut some bands"
    wcn = wc.numpy().reshape(-1, 9)
    hot = np.flatnonzero((wcn == sl.CHUNK_CLAMP).any(1))
    cut_blocks = np.unique(np.flatnonzero(cut.any(1)) // b)
    assert set(cut_blocks) <= set(hot)
    blocks = {int(x) for part in (cut_blocks, hot, np.arange(wcn.shape[0]))
              for x in rng.choice(part, min(8, part.size), replace=False)}
    assert _check_bands(cfg, _cid_table(cid, n_pad), a, e, ws.numpy(),
                        wc.numpy(), n, blocks) > 0


@pytest.mark.parametrize("case", ["dam_break", "disk"])
def test_lane_band_rows_per_lane_against_brute_force(case):
    """``walk_stats.lane_band_rows_per_lane`` (mean, max over a warp, warp
    union) against counts of the masked window rows by brute force."""
    cfg, st, p = _prepared(case)
    n = st.n
    table = _cid_table(p.cid.numpy().astype(np.int64), sl.n_pad(cfg, n))
    rows = np.zeros((n, 9), np.int64)
    first = np.full((n, 9), -1, np.int64)
    last = np.full((n, 9), -1, np.int64)
    for own, r, cnt, f, lst in _mask_rows(cfg, table, p.ws.numpy(),
                                          p.wc.numpy(), n):
        rows[own, r], first[own, r], last[own, r] = cnt, f, lst
    nw = -(-n // WARP)
    union = []
    for w0 in range(0, n, WARP):
        tot = 0
        for r in range(9):
            some = rows[w0:w0 + WARP, r] > 0
            if some.any():
                tot += (last[w0:w0 + WARP, r][some].max() + 1
                        - first[w0:w0 + WARP, r][some].min())
        union.append(tot)
    padded = np.zeros((nw * WARP, 9), np.int64)
    padded[:n] = rows
    got = lane_band_rows_per_lane(cfg, p)
    assert got["mean"] == pytest.approx(rows.sum(1).mean(), rel=1e-12)
    assert got["warp_max"] == pytest.approx(
        padded.reshape(nw, WARP, 9).max(1).sum(1).mean(), rel=1e-12)
    assert got["warp_union"] == pytest.approx(np.mean(union), rel=1e-12)
    assert got["mean"] <= got["warp_max"] <= got["warp_union"]


@pytest.mark.parametrize("kernel", ["density", "force"])
@pytest.mark.parametrize("table", ["missing", "misshaped"])
def test_lane_launch_refuses_a_bad_table(kernel, table, monkeypatch):
    """On the card (here: the kernel path forced for CPU tensors) a lane
    sweep without the frame's cell-start table, or with one of the wrong
    shape, raises before any library is built; it never falls back to the
    twin."""
    cfg, st, p = _prepared("disk")
    monkeypatch.setattr(sl, "use_plain", lambda x: False)
    monkeypatch.setattr(sl, "_kernels", None)  # a build would fail
    cs = None if table == "missing" else p.cell_start[:-1]
    before = [w.launches for w in sl.WRAPPERS]
    with pytest.raises(ValueError, match="cell-start table|cell_start"):
        if kernel == "density":
            sl.density_lane(cfg, sl.density_fields(cfg, p), p.ws, p.wc, st.n,
                            cs)
        else:
            rho = torch.ones(st.n)
            sl.force_lane(cfg, sl.force_fields(cfg, p, rho), p.ws, p.wc, st.n,
                          cs)
    assert [w.launches for w in sl.WRAPPERS] == before


def test_lane_wrappers_take_the_twin_on_cpu_with_or_without_table():
    """CPU tensors run the twins, with the table or without it, and count
    no launch; the step passes the table."""
    cfg, st, p = _prepared("dam_break")
    before = [w.launches for w in sl.WRAPPERS]
    fd = sl.density_fields(cfg, p)
    plain = sl.density_lane_plain(cfg, fd, p.ws, p.wc, st.n)
    for cs in (None, p.cell_start):
        rho, nc = sl.density_lane(cfg, fd, p.ws, p.wc, st.n, cs)
        assert torch.equal(rho, plain[0]) and torch.equal(nc, plain[1])
    ff = sl.force_fields(cfg, p, plain[0])
    acc = sl.force_lane_plain(cfg, ff, p.ws, p.wc, st.n)
    for cs in (None, p.cell_start):
        assert torch.equal(sl.force_lane(cfg, ff, p.ws, p.wc, st.n, cs), acc)
    sl.compute_step_quantities(cfg, st)
    assert [w.launches for w in sl.WRAPPERS] == before
