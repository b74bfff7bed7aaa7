"""The torch package's distributed slab engine, piece by piece, against the
JAX package's (``parallel/slabs.py``), on one rank's frames built host-side.

Scene: the 4096-particle dam break on a 32^3 grid of 1.25h cells (the
multi-chip dry run's scene), split over 1, 2, 4 or 8 slabs.  Bars: the
partition helpers, sort, candidate ranges and capped kept set bit-equal;
the band tables' bands exactly the masked live rows of the JAX engine's
window tables, in order; the six slab sweep callers (the JAX kernels in interpreter
mode, the torch wrappers' plain twins on CPU tensors) with equal neighbor
counts, rho rel-L2 <= 1e-6 and acc rel-L2 <= 1e-4 (JAX sums its force
terms block-relative on the MXU, measured ~5e-5 on the TPU), all finite;
one-rank whole steps (an in-process gloo group) within the multi-rank
file's bars.  ``self_base`` = 0 leaves the single-chip twins' bits as
they were, and any offset is a pure shift of the frame.
"""

from functools import partial

import jax
import jax.numpy as jnp
import jax_windows
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.parallel import slabs as js
from smoothed_particle_hydrodynamics_tpu.parallel.sharding import make_mesh
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import NO_CELL
from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slab_sweeps as ss
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs as ts
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy

# The twins gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores.
torch.set_num_threads(1)

RHO_BAR, ACC_BAR = 1e-6, 1e-4
POS_BAR, VEL_BAR, E_BAR = 1e-6, 1e-4, 1e-5
SCENE = dict(num_particles=4096, grid_nx=32, grid_ny=32, grid_nz=32,
             cell_size_factor=1.25, cell_capacity=32, range_slice=64)
# the dry run's kernel settings: window 64 exact, 32 capped (K_c = 4)
EXACT = dict(pallas_window_t=64)
CAPPED = dict(pallas_window_t=32, capped_candidates=4)
MODES = {"celllist": ("celllist", {}), "exact": ("pallas", EXACT),
         "capped": ("pallas", CAPPED),
         "fused": ("pallas", dict(CAPPED, capped_fused=True))}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _scenes(**kw):
    jc, jst = jscene("dam_break", **{**SCENE, **kw})
    return (jc.replace(pallas_interpret=True), jst,
            TCfg.from_json(jc.to_json()),
            state_from_numpy(jst.to_numpy(), device="cpu"))


def _eq(t, j) -> None:
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j))


@pytest.fixture(scope="module")
def scene():
    return _scenes()


# ---------------------------------------------------------------------------
# Partition helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_split_and_caps_match_jax(scene, ndev):
    jc, jst, tc, tst = scene
    zs = ts.derive_zsplit(tc, tst, ndev)
    assert zs == js.derive_zsplit(jc, jst, ndev)
    assert ts.uniform_zsplit(tc, ndev) == js.uniform_zsplit(jc, ndev)
    for split in (None, zs):
        for headroom in (1.5, 1.05):
            assert ts.derive_slab_caps(tc, tst, ndev, headroom, split) == \
                js.derive_slab_caps(jc, jst, ndev, headroom, split)
    wide = dict(pallas_block_t=256)
    assert ts.derive_slab_caps(tc.replace(**wide), tst, ndev, zsplit=zs) == \
        js.derive_slab_caps(jc.replace(**wide), jst, ndev, zsplit=zs)
    capped = dict(capped_candidates=4)
    assert ts.derive_sub_len_slab(tc.replace(**capped), tst, ndev, zs) == \
        js.derive_sub_len_slab(jc.replace(**capped), jst, ndev, zs)


@pytest.mark.parametrize("ndev", [1, 4])
def test_partition_matches_distribute_and_collects_back(scene, ndev):
    jc, jst, tc, tst = scene
    zs = ts.derive_zsplit(tc, tst, ndev)
    p_cap = ts.derive_slab_caps(tc, tst, ndev, zsplit=zs)[0]
    fields, count = ts.partition(tc, tst, ndev, p_cap, zs)
    jcarry = js.distribute(jc, jst, make_mesh(ndev), p_cap, zsplit=zs)
    _eq(fields, jcarry.fields)
    _eq(count, jcarry.count)
    # a lone rank's view: its slice of the same partition
    carry = ts.distribute(tc, tst, comm.SlabGroup(ndev - 1, ndev, "cpu"),
                          p_cap, zs)
    _eq(carry.fields, fields[(ndev - 1) * p_cap:])
    assert carry.count == count[-1]
    pos, vel, mass = ts.collect_rows(fields, tst.n)
    _eq(pos, tst.position)
    _eq(vel, tst.velocity)
    _eq(mass, tst.mass)


# ---------------------------------------------------------------------------
# One rank's frame
# ---------------------------------------------------------------------------

def _frame(tc, tst, ndev: int, d: int, zsplit=None, caps=None) -> dict:
    """Rank d's extended frame at the first step of an ``ndev`` split (the
    engine's ``prepare_frame`` with no movers): its sorted store, the
    neighbours' raw edge windows, chain-end inert rows."""
    nxny = tc.grid_nx * tc.grid_ny
    zsplit = zsplit or ts.derive_zsplit(tc, tst, ndev)
    p_cap, h_cap, _ = caps or ts.derive_slab_caps(tc, tst, ndev, zsplit=zsplit)
    fields, count = ts.partition(tc, tst, ndev, p_cap, zsplit)
    srt = [ts._sort_local(tc, torch.from_numpy(fields[r * p_cap:(r + 1) * p_cap]),
                          zsplit[r + 1] * nxny) for r in range(ndev)]
    inert = ts._inert(h_cap, "cpu")
    if d == 0:
        left = (inert, torch.full((h_cap,), -1, dtype=torch.int32))
    else:
        left = ts._edge_window(*srt[d - 1], int(count[d - 1]), h_cap, True)
    if d == ndev - 1:
        right = (inert, torch.full((h_cap,), tc.num_cells, dtype=torch.int32))
    else:
        right = ts._edge_window(*srt[d + 1], int(count[d + 1]), h_cap, False)
    fields_s, cid_s = srt[d]
    return dict(ext=torch.cat([left[0], fields_s, right[0]]),
                cid_ext=torch.cat([left[1], cid_s, right[1]]), cid_s=cid_s,
                cnt=int(count[d]), p_cap=p_cap, h_cap=h_cap,
                slab_lo=zsplit[d] * nxny, slab_hi=zsplit[d + 1] * nxny,
                base=(zsplit[d] - 1) * nxny,
                loc=(max(b - a for a, b in zip(zsplit, zsplit[1:])) + 2) * nxny,
                d=d, ndev=ndev)


# (ndev, rank): the middle ranks have live halos on both sides, rank 0 and
# the last rank one inert chain end each, the one-rank slab both
FRAMES = [(4, 1), (4, 2), (4, 0), (4, 3), (1, 0)]


def test_sort_local_matches_jax(scene):
    jc, jst, tc, tst = scene
    zs = ts.derive_zsplit(tc, tst, 4)
    p_cap = ts.derive_slab_caps(tc, tst, 4, zsplit=zs)[0]
    fields, _ = ts.partition(tc, tst, 4, p_cap, zs)
    rows = fields[p_cap:2 * p_cap]
    # storage order scrambled, dead rows interleaved with live ones
    rows = rows[np.random.default_rng(0).permutation(p_cap)]
    slab_hi = zs[2] * tc.grid_nx * tc.grid_ny
    got_f, got_c = ts._sort_local(tc, torch.from_numpy(rows), slab_hi)
    ref_f, ref_c = js._sort_local(jc, jnp.asarray(rows), jnp.int32(slab_hi))
    _eq(got_f, ref_f)
    _eq(got_c, ref_c)
    assert (got_c[-(rows[:, 7] < 0).sum():] == slab_hi - 1).all()


@pytest.mark.parametrize("ndev,d", FRAMES)
def test_local_ranges_match_jax(scene, ndev, d):
    jc, _, tc, tst = scene
    f = _frame(tc, tst, ndev, d)
    valid = f["ext"][f["h_cap"]:f["h_cap"] + f["p_cap"], 7] >= 0
    got = ts._local_ranges(tc, f["cid_ext"], f["cid_s"], valid)
    ref = js._local_ranges(jc, jnp.asarray(f["cid_ext"]),
                           jnp.asarray(f["cid_s"]), jnp.asarray(valid),
                           f["ext"].shape[0])
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])


def _live_bands(tc, f):
    """The exact band table of frame ``f`` (``_band_tables``) and its live
    own rows' bands [count, 9]."""
    band = ts._band_tables(tc, f["ext"], f["cid_ext"], f["cid_s"], f["cnt"],
                           f["h_cap"])
    a, e = sw.band_ranges(tc, band.cid[:f["cnt"]], band.cell_start)
    return band, a.numpy(), e.numpy()


@pytest.mark.parametrize("ndev,d", FRAMES)
def test_pallas_tables_match_jax(scene, ndev, d):
    """The exact band walks' table of each frame against the JAX engine's
    window tables (``_pallas_tables``, dead-row aware, plane-local): every
    live own row's band, mapped back to the raw frame, holds its block's
    rod window rows that pass the cid mask and are live, in order (and
    beyond them only cells no 3D neighbour away); it never holds the inert
    left head or a dead row."""
    jc, _, tc, tst = scene
    tc = tc.replace(**EXACT)
    f = _frame(tc, tst, ndev, d)
    assert f["cnt"] < f["p_cap"], "the frame must hold dead rows"
    ws, wc = jax_windows.slab(tc, f["cid_s"], f["cid_ext"], f["h_cap"],
                              f["p_cap"], f["cnt"], f["slab_hi"], f["base"],
                              f["loc"])
    band, a, e = _live_bands(tc, f)
    valid = (f["ext"][:, 7] >= 0).numpy()
    jax_windows.assert_bands(tc, ws, wc, f["cid_s"], f["cid_ext"], a, e,
                             f["ext"].shape[0], band.rows.numpy(), valid,
                             f["cnt"])
    # no band reaches the inert left head (cid -1, position 1e30) or a
    # dead row, which sit outside the live rows
    assert valid[band.rows.numpy()].all()
    assert int((e > a).sum()) > 0


def _synthetic_cids(case: str):
    """Hand-built store cids (the JAX tests' ``test_slabs.py:419`` and
    ``:579`` layouts) on a 16^3 grid: a one-slab store with its live rows in
    the top cells, dead rows and inert chain ends; a middle slab with halo
    rows below and above the queryable planes."""
    nxny = 16 * 16
    rng = np.random.default_rng(0 if case == "dead" else 3)
    if case == "dead":
        slab_lo, slab_hi, p_cap, h_cap, cnt = 0, 16 * nxny, 1024, 128, 500
        live = np.sort(rng.integers(slab_hi - 3 * nxny, slab_hi, cnt))
        left = np.full(h_cap, -1)
        right = np.full(h_cap, 16 * nxny)
        base, loc = None, None
    else:
        slab_lo, slab_hi, p_cap, h_cap, cnt = 8 * nxny, 16 * nxny, 256, 128, 200
        live = np.sort(rng.integers(slab_lo, slab_hi, cnt))
        left = np.sort(np.concatenate([
            rng.integers(slab_lo - 3 * nxny, slab_lo - nxny, 40),
            rng.integers(slab_lo - nxny, slab_lo, h_cap - 40)]))
        right = np.sort(np.concatenate([
            rng.integers(slab_hi, slab_hi + nxny, h_cap - 30),
            rng.integers(slab_hi + nxny, slab_hi + 3 * nxny, 30)]))
        base, loc = slab_lo - nxny, 10 * nxny
    cid_loc = np.concatenate([live, np.full(p_cap - cnt, slab_hi - 1)])
    cid_ext = np.concatenate([left, cid_loc, right])
    return (cid_loc.astype(np.int32), cid_ext.astype(np.int32), h_cap, p_cap,
            cnt, slab_hi, base, loc)


def _synthetic_ext(cid_ext, h_cap: int, p_cap: int, cnt: int):
    """A raw frame for synthetic cids: the chain ends' inert rows (cid -1
    and past the grid) and the own dead rows invalid, every other row a
    valid particle."""
    cid = torch.from_numpy(cid_ext)
    pos = torch.arange(cid.shape[0])
    dead = (pos >= h_cap + cnt) & (pos < h_cap + p_cap)
    ext = torch.zeros(cid.shape[0], 8)
    ext[:, 7] = torch.where(dead | (cid < 0) | (cid >= 16 ** 3), -1.0,
                            pos.float())
    return ext


@pytest.mark.parametrize("case", ["dead", "mid_slab"])
def test_pallas_tables_synthetic_match_jax(case):
    """The JAX tests' hand-built layouts: the live own rows' bands against
    the JAX engine's window tables of the same cids (as
    ``test_pallas_tables_match_jax``); the dead rows walk nothing."""
    kw = dict(num_particles=4096, grid_nx=16, grid_ny=16, grid_nz=16,
              pallas_window_t=64)
    jc, _ = jscene("dam_break", **kw)
    tc = TCfg.from_json(jc.to_json())
    cid_loc, cid_ext, h_cap, p_cap, cnt, slab_hi, base, loc = \
        _synthetic_cids(case)
    ws, wc = jax_windows.slab(tc, cid_loc, cid_ext, h_cap, p_cap, cnt,
                              slab_hi, base, loc)
    ext = _synthetic_ext(cid_ext, h_cap, p_cap, cnt)
    f = dict(ext=ext, cid_ext=torch.from_numpy(cid_ext),
             cid_s=torch.from_numpy(cid_loc), cnt=cnt, h_cap=h_cap)
    band, a, e = _live_bands(tc, f)
    valid = (ext[:, 7] >= 0).numpy()
    jax_windows.assert_bands(tc, ws, wc, cid_loc, cid_ext, a, e,
                             cid_ext.shape[0], band.rows.numpy(), valid, cnt)
    assert (band.cid[cnt:] == NO_CELL).all()
    assert band.rows.shape[0] == int(valid.sum())
    if case == "dead":
        assert (wc[4:] == 0).all()        # fully dead blocks: no chunks
        assert wc[:4].max() <= 8          # no window spans the dead run


# ---------------------------------------------------------------------------
# Capped sub frame
# ---------------------------------------------------------------------------

def _check_sub_frame(got, ref, num_cells):
    sub_src, cand_cid, cid_search, w_sub, dropped = got
    n_kept = int((cand_cid >= 0).sum())
    _eq(sub_src, ref[0])
    _eq(cid_search, ref[2])
    _eq(w_sub, ref[3])
    _eq(dropped, ref[4])
    # kept rows carry their cid; the tail TAIL_CID where JAX has -10
    _eq(cand_cid[:n_kept].float(), ref[1][:n_kept])
    assert (np.asarray(ref[1])[n_kept:] == -10).all()
    assert (cand_cid[n_kept:] == sw.TAIL_CID).all()
    assert not (cand_cid == -10).any()
    assert (cid_search[n_kept:] == num_cells).all()


@pytest.mark.parametrize("ndev,d", [(4, 1), (4, 0), (1, 0)])
@pytest.mark.parametrize("short", [False, True])
def test_capped_sub_frame_matches_jax(scene, ndev, d, short):
    jc, jst, tc, tst = scene
    jc, tc = jc.replace(**CAPPED), tc.replace(**CAPPED)
    f = _frame(tc, tst, ndev, d)
    zs = ts.derive_zsplit(tc, tst, ndev)
    sub_len = ts.derive_sub_len_slab(tc, tst, ndev, zs)
    if short:   # an undersized sub frame: the overflow is counted
        sub_len = 256
    got = ts._capped_sub_frame(tc, f["ext"], f["cid_ext"], sub_len,
                               f["slab_lo"], f["slab_hi"])
    ref = js._capped_sub_frame(jc, jnp.asarray(f["ext"]),
                               jnp.asarray(f["cid_ext"]), sub_len,
                               jnp.int32(f["slab_lo"]), jnp.int32(f["slab_hi"]))
    _check_sub_frame(got, ref, tc.num_cells)
    assert (int(got[4]) > 0) == short
    # the sub frame's band table against the JAX engine's tables: own
    # blocks and (fused) sub blocks
    sub = ts._sub_band(tc, got[2], f["cid_s"], f["cnt"])
    search = ref[2]
    ws, wc = jax_windows.slab_sub(tc, f["cid_s"], search, sub_len, f["cnt"],
                                  f["base"], f["loc"])
    a, e = sw.band_ranges(tc, sub.cid[:f["cnt"]], sub.cell_start)
    jax_windows.assert_bands(tc, ws, wc, f["cid_s"], got[1], a.numpy(),
                             e.numpy(), sub_len, n=f["cnt"])
    n_kept = int((got[1] >= 0).sum())
    ws, wc = jax_windows.slab_sub(tc, jax_windows.prepass_self(tc, search),
                                  search, sub_len, n_kept, f["base"],
                                  f["loc"])
    a, e = sw.band_ranges(tc, got[1], sub.cell_start)
    jax_windows.assert_bands(tc, ws, wc, got[1], got[1], a.numpy(),
                             e.numpy(), sub_len, n=n_kept)
    assert bool((e[n_kept:] <= a[n_kept:]).all())


@pytest.mark.parametrize("grid", [(16, 16, 16), (256, 256, 160)])
def test_capped_sub_frame_ties_match_jax(grid):
    """Crowded cells, invalid rows and non-queryable rows, on a grid with
    >= 8 spare key bits (the packed (cid, hash) key) and on one with fewer
    (the two-key sort): the same kept set, order and weights."""
    nx, ny, nz = grid
    jc, _ = jscene("dam_break", num_particles=4096, grid_nx=nx, grid_ny=ny,
                   grid_nz=nz, pallas_window_t=32, capped_candidates=3)
    tc = TCfg.from_json(jc.to_json())
    nxny = nx * ny
    rng = np.random.default_rng(5)
    e = 3000
    slab_lo, slab_hi = 4 * nxny, 8 * nxny
    # few distinct cells (many members each) across and beyond the range
    cells = rng.integers(slab_lo - 2 * nxny, slab_hi + 2 * nxny, 40)
    cid_ext = np.sort(rng.choice(cells, e)).astype(np.int32)
    ext = np.zeros((e, 8), np.float32)
    ext[:, 7] = rng.permutation(100_000)[:e]
    ext[rng.random(e) < 0.1, 7] = -1.0
    assert (sw._hash_bits(tc) >= 8) == (grid == (16, 16, 16))
    for sub_len in (1024, 128):
        got = ts._capped_sub_frame(tc, torch.from_numpy(ext),
                                   torch.from_numpy(cid_ext), sub_len,
                                   slab_lo, slab_hi)
        ref = js._capped_sub_frame(jc, jnp.asarray(ext), jnp.asarray(cid_ext),
                                   sub_len, jnp.int32(slab_lo),
                                   jnp.int32(slab_hi))
        _check_sub_frame(got, ref, tc.num_cells)


@pytest.mark.parametrize("members", [3, 9])
def test_capped_sub_frame_last_cell_is_its_own_run(scene, members):
    """On the 32^3 grid (16 spare key bits) the JAX package's sentinel key
    ``0x7FFFFFFF >> 16`` is the last cell's id, so its last-cell run takes
    in the invalid rows.  The port's invalid rows (dead, and valid ids in
    no queryable cell) form a run of their own: the last cell's kept rows
    and weights equal a brute force over the valid rows, and every valid
    row stays valid, the one whose top hash bits are all ones (id 23184)
    included.  ``members`` rows sit in the last cell (K_c = 4)."""
    _, _, tc, _ = scene
    tc = tc.replace(**CAPPED)
    nc, nxny, k_c = tc.num_cells, tc.grid_nx * tc.grid_ny, tc.capped_candidates
    hb = sw._hash_bits(tc)
    assert hb == 16 and 0x7FFFFFFF >> hb == nc - 1
    rng = np.random.default_rng(11)
    slab_lo, slab_hi = 28 * nxny, nc          # the last slab
    cid_valid = np.concatenate([rng.integers(slab_lo - nxny, nc - 1, 300),
                                np.full(members, nc - 1)])
    oid_valid = rng.permutation(np.setdiff1d(np.arange(20_000), [23184]))
    oid_valid = oid_valid[:cid_valid.shape[0]]
    oid_valid[-1] = 23184                     # hash top 16 bits all ones
    assert (int(sw._hash32(torch.tensor(23184))) >> (31 - hb)) == (1 << hb) - 1
    # dead rows at the slab's last cell (where the store parks them) and
    # rows of cells this rank cannot query
    cid_bad = np.concatenate([np.full(40, nc - 1),
                              rng.integers(0, slab_lo - nxny, 30)])
    oid_bad = np.concatenate([np.full(40, -1), 30_000 + np.arange(30)])
    cid_ext = np.concatenate([cid_valid, cid_bad])
    oid = np.concatenate([oid_valid, oid_bad])
    srt = np.argsort(cid_ext, kind="stable")
    cid_ext, oid = cid_ext[srt].astype(np.int32), oid[srt]
    ext = np.zeros((cid_ext.shape[0], 8), np.float32)
    ext[:, ts._OID] = oid
    sub_src, cand_cid, _, w_sub, dropped = ts._capped_sub_frame(
        tc, torch.from_numpy(ext), torch.from_numpy(cid_ext), ext.shape[0],
        slab_lo, slab_hi)
    # brute force: per cell, the K_c valid rows of lowest (hash top bits,
    # id), weighted occ / min(occ, K_c)
    valid = (oid >= 0) & (cid_ext >= slab_lo - nxny) & (cid_ext < slab_hi + nxny)
    top = sw._hash32(torch.from_numpy(oid)).numpy() >> (31 - hb)
    want = {}
    for c in np.unique(cid_ext[valid]):
        rows = np.flatnonzero(valid & (cid_ext == c))
        rows = rows[np.lexsort((oid[rows], top[rows]))]
        occ = rows.shape[0]
        for r in rows[:k_c]:
            want[int(r)] = np.float32(occ) / np.float32(min(occ, k_c))
    n_kept = int((cand_cid >= 0).sum())
    assert int(dropped) == 0 and n_kept == len(want)
    got = dict(zip(sub_src[:n_kept].tolist(), w_sub[:n_kept].tolist()))
    assert got == want
    last = [r for r in want if cid_ext[r] == nc - 1]
    assert len(last) == min(members, k_c)
    assert [w_sub[:n_kept][cand_cid[:n_kept] == nc - 1].unique().item()] == \
        [members / min(members, k_c)]
    j = int(np.flatnonzero(oid == 23184)[0])
    assert (j in want) == (members <= k_c)


# ---------------------------------------------------------------------------
# The six slab sweep callers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def callers(scene):
    """One middle rank's frame of a 4-slab split (live halos both sides,
    dead rows, a transition block), the port's exact and capped band
    tables and the JAX engine's window tables of the same frame (the JAX
    callers read those), and physical densities for every row (dead and
    inert rows 0), from the single-chip step on the whole state."""
    jc, jst, tc, tst = scene
    f = _frame(tc, tst, 4, 1)
    rho_all = sw.compute_step_quantities(tc.replace(**EXACT), tst)[1]
    oid = f["ext"][:, 7].long()
    rho_e = torch.where(oid >= 0, rho_all[oid.clamp(min=0)], 0.0)
    zs = ts.derive_zsplit(tc, tst, 4)
    cc = tc.replace(**CAPPED)
    sub_len = ts.derive_sub_len_slab(cc, tst, 4, zs)
    sub = ts._capped_sub_frame(cc, f["ext"], f["cid_ext"], sub_len,
                               f["slab_lo"], f["slab_hi"])
    n_kept = int((sub[1] >= 0).sum())
    pad = -(-sub_len // 128) * 128 - sub_len
    cid_sub_loc = torch.cat([sub[2], torch.full((pad,), tc.num_cells,
                                                dtype=torch.int32)])
    return dict(
        f=f, rho_e=rho_e, sub=sub, sub_len=sub_len, n_kept=n_kept,
        band=ts._band_tables(tc, f["ext"], f["cid_ext"], f["cid_s"], f["cnt"],
                             f["h_cap"]),
        sub_band=ts._sub_band(cc, sub[2], f["cid_s"], f["cnt"]),
        tabs=jax_windows.slab(tc.replace(**EXACT), f["cid_s"], f["cid_ext"],
                              f["h_cap"], f["p_cap"], f["cnt"], f["slab_hi"],
                              f["base"], f["loc"]),
        ctabs=jax_windows.slab_sub(cc, f["cid_s"], sub[2], sub_len, f["cnt"],
                                   f["base"], f["loc"]),
        stabs=jax_windows.slab_sub(cc, cid_sub_loc, sub[2], sub_len, n_kept,
                                   f["base"], f["loc"]))


def _run_caller(name, c, jc, tc):
    """(torch outputs, JAX outputs) of one caller on the fixture's frame;
    the port walks its band tables, the JAX side gets the same arrays, its
    own window tables and its own kept-set columns."""
    f = c["f"]
    hp = (f["h_cap"], f["p_cap"])
    ext, cid_ext, rho_e = f["ext"], f["cid_ext"], c["rho_e"]
    rho_l = rho_e[f["h_cap"]:f["h_cap"] + f["p_cap"]]
    J = jnp.asarray
    if name in ("density_local", "force_local"):
        jc, tc = jc.replace(**EXACT), tc.replace(**EXACT)
        ws, wc = (J(t.reshape(-1).astype(np.int32)) for t in c["tabs"])
        if name == "density_local":
            got = ss.density_local(tc, ext, *hp, c["band"])
            ref = jax.jit(lambda *a: js._pallas_density_local(jc, *a, *hp))(
                J(ext), J(cid_ext), ws, wc)
        else:
            got = ss.force_local(tc, ext, rho_e, rho_l, *hp, c["band"])
            ref = jax.jit(lambda *a: js._pallas_force_local(jc, *a, *hp))(
                J(ext), J(cid_ext), J(rho_e), J(rho_l), ws, wc)
        return got, ref
    jc, tc = jc.replace(**CAPPED), tc.replace(**CAPPED)
    sub_src, cand_cid, _, w_sub, _ = c["sub"]
    s_len = c["sub_len"]
    cand_f = J(np.where(cand_cid.numpy() >= 0, cand_cid.numpy(), -10)
               .astype(np.float32))
    g8 = ext[sub_src.long()]
    ws, wc = (J(t.reshape(-1).astype(np.int32)) for t in c["ctabs"])
    band = c["sub_band"]
    if name == "density_local_capped":
        got = ss.density_local_capped(tc, ext, g8, sub_src, w_sub, *hp, band)
        ref = jax.jit(lambda *a: js._pallas_density_local_capped(
            jc, *a, *hp, s_len))(J(ext), J(g8), J(cid_ext), ws, wc,
                                 J(sub_src), cand_f, J(w_sub))
    elif name == "force_local_capped":
        got = ss.force_local_capped(tc, ext, g8, rho_e, rho_l, sub_src,
                                    w_sub, *hp, band)
        ref = jax.jit(lambda *a: js._pallas_force_local_capped(
            jc, *a, *hp, s_len))(J(ext), J(g8), J(cid_ext), J(rho_e),
                                 J(rho_l), ws, wc, J(sub_src), cand_f,
                                 J(w_sub))
    elif name == "density_sub_local":
        got = ss.density_sub_local(tc, g8, sub_src, cand_cid, w_sub, band)
        ws_s, wc_s = (J(t.reshape(-1).astype(np.int32)) for t in c["stabs"])
        ref = jax.jit(lambda *a: js._pallas_density_sub_local(
            jc, *a, s_len))(J(g8), J(sub_src), cand_f, J(w_sub), ws_s, wc_s)
    else:
        rho_cand = rho_e[sub_src.long()]
        fc = tc.replace(capped_fused=True)
        got = ss.fused_local_capped(fc, ext, g8, rho_cand, sub_src, w_sub,
                                    *hp, band)
        ref = jax.jit(lambda *a: js._pallas_fused_local_capped(
            jc.replace(capped_fused=True), *a, *hp, s_len))(
                J(ext), J(g8), J(cid_ext), J(rho_cand), ws, wc,
                J(sub_src), cand_f, J(w_sub))
    return got, ref


CALLERS = ["density_local", "force_local", "density_local_capped",
           "force_local_capped", "density_sub_local", "fused_local_capped"]


@pytest.mark.parametrize("name", CALLERS)
def test_slab_callers_match_jax(scene, callers, name):
    jc, _, tc, _ = scene
    got, ref = _run_caller(name, callers, jc, tc)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for t in got:   # every row, dead ones included, NaN-free
        assert torch.isfinite(t.float()).all(), name
    f = callers["f"]
    if name == "density_sub_local":
        rows = slice(0, callers["n_kept"])   # the tail feeds no pair
    else:   # live rows (JAX's dead rows see its own padding)
        rows = (f["ext"][f["h_cap"]:f["h_cap"] + f["p_cap"], 7] >= 0).numpy()
    if name == "fused_local_capped":
        got, ref = (got[1], got[2], got[0]), (ref[1], ref[2], ref[0])
    if "force" in name:
        assert _rel(got[0].numpy()[rows], np.asarray(ref[0])[rows]) <= ACC_BAR
        return
    assert _rel(got[0].numpy()[rows], np.asarray(ref[0])[rows]) <= RHO_BAR
    if len(got) > 1:
        _eq(got[1].numpy()[rows], np.asarray(ref[1])[rows])
        assert got[1].numpy()[rows].mean() > 3.0, "neighbors must be found"
    if name == "fused_local_capped":
        assert _rel(got[2].numpy()[rows], np.asarray(ref[2])[rows]) <= ACC_BAR


def test_halo_rows_reach_the_sums(callers, scene):
    """The frame's live halo rows are real candidates: dropping them (inert
    halos, as at a chain end) changes the edge planes' densities."""
    _, _, tc, _ = scene
    tc = tc.replace(**EXACT)
    f = callers["f"]
    h = f["h_cap"]
    band = callers["band"]
    rho, _ = ss.density_local(tc, f["ext"], h, f["p_cap"], band)
    cut = f["ext"].clone()
    cut[:h] = ts._inert(h, "cpu")
    cut[-h:] = ts._inert(h, "cpu")
    # the same live rows gathered from the cut frame: its halos at 1e30
    rho_cut, _ = ss.density_local(tc, cut, h, f["p_cap"], band)
    assert (rho_cut <= rho).all() and (rho_cut < rho).sum() > 50


# ---------------------------------------------------------------------------
# self_base
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_chip():
    """A single-chip prepared frame, exact and capped (fused)."""
    kw = dict(num_particles=2048, grid_nx=16, grid_ny=16, grid_nz=16,
              cell_size_factor=1.25, pallas_window_t=64)
    jc, jst = jscene("splash", **kw)
    tc = TCfg.from_json(jc.to_json())
    tst = state_from_numpy(jst.to_numpy(), device="cpu")
    cc = tc.replace(capped_candidates=4, capped_fused=True, pallas_block_t=256)
    return tc, sw.prepare_t(tc, tst), cc, sw.prepare_t(cc, tst)


def _shifted(k, cand_pos, *cols):
    """The candidate frame with k inert rows in front (position 1e30, zero
    elsewhere)."""
    out = [torch.cat([torch.full((k, 3), ts._BIG), cand_pos])]
    for c in cols:
        pad = torch.zeros((k,) + tuple(c.shape[1:]), dtype=c.dtype)
        out.append(torch.cat([pad, c]))
    return out


@pytest.mark.parametrize("k", [0, 128, 200])
def test_self_base_is_a_frame_shift(single_chip, k):
    """``self_base = k`` over a candidate frame with k rows in front (and
    the cell-start table moved by k) gives the bits of the unshifted sweep:
    the slab engine's own slab at offset ``self_base`` in its candidates.
    k = 0 is the single-chip path, bit-equal to the src-vs-src exclusion
    with own id the self row (``self_src = arange``)."""
    tc, p, cc, pc = single_chip
    n = p.pos_s.shape[0]
    rho, nc = sw.density_t_plain(tc, p.pos_s, p.mass_s, p.cid, p.cell_start,
                                 p.pos_s, p.mass_s)
    rho0, nc0 = sw.density_t_plain(
        tc, p.pos_s, p.mass_s, p.cid, p.cell_start, p.pos_s, p.mass_s,
        torch.arange(n, dtype=torch.int32), 0,
        torch.arange(n, dtype=torch.int32))
    _eq(rho, rho0)
    _eq(nc, nc0)
    pos_k, mass_k = _shifted(k, p.pos_s, p.mass_s)
    rho_k, nc_k = sw.density_t_plain(tc, p.pos_s, p.mass_s, p.cid,
                                     p.cell_start + k, pos_k, mass_k,
                                     self_base=k)
    _eq(rho_k, rho)
    _eq(nc_k, nc)
    cand = sw.fused_cand_cols(tc, p.pos_s, p.vel_s, rho, p.mass_s)
    acc = sw.force_t_plain(tc, p.pos_s, p.vel_s, rho, cand, p.cid,
                           p.cell_start)
    cand_k = torch.cat([torch.zeros(k, 9), cand])
    cand_k[:k, 0:3] = ts._BIG
    acc_k = sw.force_t_plain(tc, p.pos_s, p.vel_s, rho, cand_k, p.cid,
                             p.cell_start + k, self_base=k)
    _eq(acc_k, acc)
    # capped and fused: the candidates' src ids move with the self rows
    pos_c, vel_c = sw.gather_sub_pv(pc)
    cand_c = sw.fused_cand_cols(cc, pos_c, vel_c, pc.mass_s[pc.sub_perm],
                                pc.wm_sub)
    ref = sw.fused_t_plain(cc, pc.pos_s, pc.vel_s, pc.mass_s, pc.cid,
                           pc.cell_start, cand_c, pc.sub_perm)
    got = sw.fused_t_plain(cc, pc.pos_s, pc.vel_s, pc.mass_s, pc.cid,
                           pc.cell_start, cand_c, pc.sub_perm + k,
                           self_base=k)
    for a, b in zip(got, ref):
        _eq(a, b)
    ref = sw.density_t_plain(cc, pc.pos_s, pc.mass_s, pc.cid, pc.cell_start,
                             pos_c, pc.wm_sub, pc.sub_perm)
    got = sw.density_t_plain(cc, pc.pos_s, pc.mass_s, pc.cid, pc.cell_start,
                             pos_c, pc.wm_sub, pc.sub_perm + k, self_base=k)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])


def test_wrappers_take_the_twin_on_cpu(callers, scene):
    """On CPU tensors every slab wrapper runs its twin and counts no launch."""
    _, _, tc, _ = scene
    for w in ss.WRAPPERS:
        w.launches = 0
    f = callers["f"]
    args = ss.density_local_args(tc.replace(**EXACT), f["ext"], f["h_cap"],
                                 f["p_cap"], callers["band"])
    for a, b in zip(ss.density_ext(*args), ss.density_ext_plain(*args)):
        _eq(a, b)
    assert all(w.launches == 0 for w in ss.WRAPPERS)


# ---------------------------------------------------------------------------
# One rank, whole steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(scene):
    """Two steps (a rebuild, a frozen one) of the port at world 1 in an
    in-process gloo group and of the JAX engine on a one-device mesh."""
    jc, jst, tc, tst = scene
    zs = ts.derive_zsplit(tc, tst, 1)
    caps = ts.derive_slab_caps(tc, tst, 1, zsplit=zs)
    jobs, refs = [], {}
    for mode, (sweeps, kw) in MODES.items():
        cfg = tc.replace(**kw)
        sub = ts.derive_sub_len_slab(cfg, tst, 1, zs) or None
        jobs.append(dict(cfg=cfg, state=tst, caps=caps, zsplit=zs, steps=2,
                         sweeps=sweeps, sub_len=sub))
        refs[mode] = jax_slab_run(jc.replace(**kw), jst, 1, caps, zs, 2,
                                  sweeps, sub)
    with comm.local_group("cpu", "gloo") as g:
        assert g.backend == "gloo" and g.world == 1
        outs = ts.run_slab_jobs(g, jobs)
    return dict(zip(MODES, outs)), refs


def jax_slab_run(jc, jst, ndev, caps, zsplit, steps, sweeps, sub_len=None,
                 lazy=True):
    """The JAX slab engine's per-step diagnostics, counts and collected
    state (numpy)."""
    mesh = make_mesh(ndev)
    carry = js.distribute(jc, jst, mesh, caps[0], zsplit=zsplit)
    f = js.make_slab_step(jc, mesh, *caps, donate=False, sweeps=sweeps,
                          zsplit=zsplit, sub_len=sub_len, lazy=lazy)
    diags, counts = [], []
    for _ in range(steps):
        carry, d = f(carry)
        diags.append(d)
        counts.append(np.asarray(carry.count).tolist())
    got = js.collect(carry, jst.position.shape[0])
    return dict(diags={k: np.asarray([np.asarray(getattr(d, k)) for d in diags])
                       for k in diags[0]._fields},
                counts=counts, rebins=int(np.asarray(carry.rebin_count)[0]),
                position=np.asarray(got.position),
                velocity=np.asarray(got.velocity))


def check_steps_match(got: dict, ref: dict) -> None:
    """The multi-step bars: neighbor stats and counted losses equal, KE and
    PE rel <= 1e-5, collected positions rel-L2 <= 1e-6, velocities <= 1e-4,
    the same rebins."""
    g, r = got["diags"], ref["diags"]
    for k in ("neighbor_max", "neighbor_min", "truncated_ranges",
              "halo_dropped", "migration_dropped"):
        _eq(g[k], r[k])
    _eq(g["neighbor_mean"], r["neighbor_mean"])
    for k in ("kinetic_energy", "potential_energy"):
        err = np.abs(g[k].astype(np.float64) - r[k])
        assert (err <= E_BAR * np.maximum(np.abs(r[k]), 1e-30)).all(), k
    assert got["rebins"] == ref["rebins"]
    assert _rel(got["position"], ref["position"]) <= POS_BAR
    assert _rel(got["velocity"], ref["velocity"]) <= VEL_BAR
    assert np.isfinite(got["position"]).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_one_rank_steps_match_jax(one_rank, mode):
    outs, refs = one_rank
    check_steps_match(outs[mode], refs[mode])
    assert outs[mode]["rebins"] == 1       # the second step ran frozen
    assert outs[mode]["diags"]["neighbor_mean"][0] > 5.0
