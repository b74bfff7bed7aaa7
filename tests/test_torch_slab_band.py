"""The slab engine's exact band walks (``density_band_t``/``force_band_t``
of ``csrc/sweep_t.cu`` through ``parallel/slab_sweeps.py``): the frozen
``SlabBand`` tables of a rank's extended frame [left halo | own slab | right
halo], built by the engine's own ``prepare_frame`` on 1, 2 and 4 gloo ranks
(``parallel.comm.spawn_ranks``, the ranks tests' scenes and setups).

The JAX engine walks each own block's rod windows over the raw frame
(``parallel/slabs.py::_pallas_tables``) and masks them by cell id.  Checked
here on the CPU, by brute force against the JAX engine's own tables of the
same frames (``tests/jax_windows.py``):

* the band kernels' candidates are exactly the frame's valid rows, in
  order: the live left-halo rows, the own slab's first ``count`` rows, the
  live right-halo rows, each a prefix of its part;
* ``cell_start`` is the search of those rows' cids, and the own dead rows
  carry self cid ``NO_CELL``;
* each live own row's band for a rod, mapped back to the raw frame, is
  exactly the rows of its block's rod window that pass the cid mask and are
  live, in the window's order;
* no band holds a dead or inert row, also where the slab's top corner cell
  and a short neighbour's last cell are populated (the frames where a table
  over the raw frame puts the dead runs inside real cells).

Also: the pairs within h found through the bands against a brute force,
the twins on the wrappers' arguments against a pairwise oracle handed the
band kernels' arguments (a dense walk of every candidate in place of the
launch), ``utils/walk_stats.py``'s slab band counts, the lazy carry freezing
the tables and rebuilding them at a rebin, and a card launch without the
table refused.
"""

import jax_windows
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import physics
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import (NO_CELL,
                                                                rod_deltas)
from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slab_sweeps as ss
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs as ts
from smoothed_particle_hydrodynamics_tpu_torch.state import (
    state_from_numpy, state_to_numpy)
from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
    band_rows_per_lane, corner_state, slab_band_rows_per_lane)

torch.set_num_threads(1)

TIMEOUT_S = 300.0
RHO_BAR, ACC_BAR = 1e-6, 1e-4
OID = 7
EXACT = dict(pallas_window_t=64)
# the ranks tests' parity scene (tests/test_torch_slabs.py: SCENE)
SCENE = dict(num_particles=4096, grid_nx=32, grid_ny=32, grid_nz=32,
             cell_size_factor=1.25, cell_capacity=32, range_slice=64)


# ---------------------------------------------------------------------------
# Frames from the engine, on every rank
# ---------------------------------------------------------------------------

def _record(cfg, fr, band, caps, zsplit, rank) -> dict:
    """A rank's frame and its band tables as numpy (picklable)."""
    nxny = cfg.grid_nx * cfg.grid_ny
    fresh = ts._band_tables(cfg, fr.ext, fr.cid_ext, fr.cid_s, fr.count,
                            caps[1])
    return dict(
        ext=fr.ext.numpy(), cid_ext=fr.cid_ext.numpy(), cid_s=fr.cid_s.numpy(),
        count=fr.count, cell_start=band.cell_start.numpy(),
        cid=band.cid.numpy(), rows=band.rows.numpy(), nl=band.nl, nr=band.nr,
        need=fr.need,
        fresh_equal=all(np.array_equal(np.asarray(a), np.asarray(b))
                        for a, b in zip(fresh, band)),
        h_cap=caps[1], p_cap=caps[0], slab_hi=zsplit[rank + 1] * nxny,
        base=(zsplit[rank] - 1) * nxny,
        loc=(max(b - a for a, b in zip(zsplit, zsplit[1:])) + 2) * nxny)


def band_frames(group, jobs: list[dict]) -> list[list[dict]]:
    """Per job, per step: this rank's ``prepare_frame`` output (the step's
    frame and tables) as numpy, then the step itself.  ``kick_at`` steps
    first spread the positions in x by up to 3 cells (a rebin).  Whether a
    frozen step's band is the carry's own object is in ``same``."""
    out = []
    for job in jobs:
        cfg, caps, zs = job["cfg"], job["caps"], job["zsplit"]
        state = state_from_numpy(job["state"], group.device)
        carry = ts.init_lazy_slab(
            cfg, group, ts.distribute(cfg, state, group, caps[0], zs),
            caps[0], "pallas")
        recs = []
        for k in range(job["steps"]):
            if k in job.get("kick_at", ()):
                f = carry.fields.clone()
                valid = f[:, OID] >= 0.0
                spread = torch.linspace(0.0, 3.0 * cfg.cell_size, f.shape[0])
                f[:, 0] = torch.where(valid, f[:, 0] + spread, f[:, 0])
                carry = carry._replace(fields=f)
            fr = ts.prepare_frame(cfg, group, *caps, "pallas", zs, True, 0,
                                  carry)
            band, = fr.tabs
            rec = _record(cfg, fr, band, caps, zs, group.rank)
            rec["same"] = band is carry.tabs[0]
            recs.append(rec)
            carry, _ = ts.slab_step_body(cfg, group, *caps, 4096, "pallas",
                                         zs, True, 0, carry)
        out.append(recs)
    return out


def _scene_job(world: int, steps: int = 1, **extra) -> dict:
    cfg, st = make_scene("dam_break", device="cpu", **SCENE, **EXACT)
    zs = ts.derive_zsplit(cfg, st, world)
    return dict(cfg=cfg, state=state_to_numpy(st), caps=ts.derive_slab_caps(
        cfg, st, world, zsplit=zs), zsplit=zs, steps=steps, **extra)


def _small_h_job() -> dict:
    """``test_undersized_halo_is_counted``'s setup (the 16^3 dam break at 4
    ranks, h_cap 64 below the densest plane): truncated live halos."""
    from test_torch_slabs_ranks import _case

    jc, jst, caps, zs, _, _ = _case("small_h")
    cfg = SphConfig.from_json(jc.to_json()).replace(**EXACT)
    return dict(cfg=cfg, state=jst.to_numpy(), caps=caps, zsplit=zs, steps=1)


def _corner_job() -> dict:
    cfg, _ = make_scene("dam_break", device="cpu", num_particles=4096,
                        grid_nx=16, grid_ny=16, grid_nz=16, **EXACT)
    st = corner_state(cfg)
    cfg = cfg.replace(num_particles=st.n)
    zs = ts.uniform_zsplit(cfg, 4)
    caps = ts.derive_slab_caps(cfg, st, 4, zsplit=zs)
    return dict(cfg=cfg, state=state_to_numpy(st), caps=caps, zsplit=zs,
                steps=1)


def _spawn(world: int, jobs: list[dict]) -> list[list[list[dict]]]:
    """[job][step] records per rank: out[rank][job][step]."""
    return comm.spawn_ranks(world, band_frames, jobs, backend="gloo",
                            threads=1, timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def frames() -> dict:
    """name -> per-rank step-0 records, and the world-2 lazy runs."""
    with comm.local_group("cpu", "gloo") as g:
        one = band_frames(g, [_scene_job(1, steps=4, kick_at=(3,))])
    two = _spawn(2, [_scene_job(2, steps=4, kick_at=(3,))])
    four = _spawn(4, [_scene_job(4), _small_h_job(), _corner_job()])
    out = {"dam-w1": [one[0][0]], "dam-w2": [r[0][0] for r in two],
           "dam-w4": [r[0][0] for r in four], "small_h-w4": [r[1][0]
                                                              for r in four],
           "corner-w4": [r[2][0] for r in four]}
    out["lazy"] = {1: [one[0]], 2: [r[0] for r in two]}
    return out


def _cfg(name: str) -> SphConfig:
    if name.startswith("dam"):
        return _scene_job(1)["cfg"]
    if name.startswith("small_h"):
        return _small_h_job()["cfg"]
    return _corner_job()["cfg"]


FRAMES = ["dam-w1", "dam-w2", "dam-w4", "small_h-w4", "corner-w4"]


def _ranks(frames, name):
    return list(enumerate(frames[name]))


# ---------------------------------------------------------------------------
# The live rows and the table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FRAMES)
def test_live_rows_are_the_valid_rows_of_ext_in_order(frames, name):
    for d, f in _ranks(frames, name):
        valid = f["ext"][:, OID] >= 0
        h, p, cnt = f["h_cap"], f["p_cap"], f["count"]
        np.testing.assert_array_equal(f["rows"], np.flatnonzero(valid))
        nl, nr = f["nl"], f["nr"]
        assert nl + cnt + nr == f["rows"].shape[0]
        # each part's valid rows are a prefix of it
        np.testing.assert_array_equal(f["rows"][:nl], np.arange(nl))
        np.testing.assert_array_equal(f["rows"][nl:nl + cnt],
                                      h + np.arange(cnt))
        np.testing.assert_array_equal(f["rows"][nl + cnt:],
                                      h + p + np.arange(nr))
        assert nl == int(valid[:h].sum()) and nr == int(valid[h + p:].sum())
        assert cnt < p, "the own slab must hold dead rows"
        # chain ends: inert halos
        assert (d > 0 or nl == 0) and (d < len(frames[name]) - 1 or nr == 0)
    if name == "small_h-w4":   # truncated halos: every halo row is live
        assert all(f["nl"] == f["h_cap"] for _, f in _ranks(frames, name)[1:])
    if name == "corner-w4":    # short neighbours: dead rows in both halos
        f = frames[name][1]
        assert 0 < f["nl"] < f["h_cap"] and 0 < f["nr"] < f["h_cap"]


@pytest.mark.parametrize("name", FRAMES)
def test_cell_start_is_a_search_of_the_live_cids(frames, name):
    cfg = _cfg(name)
    for _, f in _ranks(frames, name):
        cid_live = f["cid_ext"][f["rows"]]
        assert np.all(np.diff(cid_live) >= 0)
        assert cid_live.min() >= 0 and cid_live.max() < cfg.num_cells
        want = np.searchsorted(cid_live, np.arange(cfg.num_cells + 1))
        assert f["cell_start"].dtype == np.int32
        np.testing.assert_array_equal(f["cell_start"], want)
        cnt = f["count"]
        assert f["cid"].dtype == np.int32
        np.testing.assert_array_equal(f["cid"][:cnt], f["cid_s"][:cnt])
        assert np.all(f["cid"][cnt:] == NO_CELL)
        assert f["fresh_equal"]


def _bands(cfg, f, cid=None, cell_start=None):
    """[n, 9] band rows [a, e) of the live own rows, in the given table
    (default the frame's own)."""
    cnt = f["count"]
    a, e = sw.band_ranges(
        cfg, torch.from_numpy(f["cid"][:cnt] if cid is None else cid),
        torch.from_numpy(f["cell_start"] if cell_start is None
                         else cell_start))
    return a.numpy(), e.numpy()


def _cell_xyz(cfg, cid):
    nx, ny = cfg.grid_nx, cfg.grid_ny
    return np.stack([cid % nx, (cid // nx) % ny, cid // (nx * ny)], axis=-1)


@pytest.mark.parametrize("name", FRAMES)
def test_band_is_the_live_masked_part_of_the_block_window(frames, name):
    """Brute force over every live own row and rod: the band's rows, mapped
    back to the raw frame, hold the rows of the block's rod window (the JAX
    engine's table) that pass the cid mask and are live, in order (a dead or
    inert row's d^2 is inf), and beyond them only rows of cells the linear
    cid band reaches by wrapping in x or y (no 3D neighbour of the row's
    cell, so never within h): the window tables are plane-local and leave
    out such cells two planes from the slab, the bands do not.  Both walks
    therefore sum the same pairs in the same order; the frames with wrapped
    extras are counted to show the case is exercised."""
    cfg = _cfg(name)
    b, s_t = sw._blane(cfg), cfg.pallas_window_t
    deltas = np.asarray(rod_deltas(cfg))
    wrapped = 0
    for _, f in _ranks(frames, name):
        e_rows = f["ext"].shape[0]
        ws, wc = jax_windows.slab(cfg, f["cid_s"], f["cid_ext"], f["h_cap"],
                                  f["p_cap"], f["count"], f["slab_hi"],
                                  f["base"], f["loc"])
        cid_ext = f["cid_ext"].astype(np.int64)
        xyz = _cell_xyz(cfg, cid_ext)
        valid = f["ext"][:, OID] >= 0
        a, e = _bands(cfg, f)
        rows = f["rows"]
        for i in range(f["count"]):
            ci = int(f["cid_s"][i])
            for r, delta in enumerate(deltas):
                lo = ws[i // b, r]
                hi = min(lo + wc[i // b, r] * s_t, e_rows)
                win = np.arange(lo, hi)
                keep = win[(np.abs(cid_ext[lo:hi] - ci - delta) <= 1)
                           & valid[lo:hi]]
                band = rows[a[i, r]:max(a[i, r], e[i, r])]
                inside = np.isin(band, keep)
                np.testing.assert_array_equal(band[inside], keep,
                                              f"row {i} rod {r}")
                far = np.abs(xyz[band[~inside]] - _cell_xyz(cfg, ci)) > 1
                assert far.any(axis=1).all(), f"row {i} rod {r}"
                wrapped += int((~inside).sum())
    if name == "corner-w4":
        assert wrapped > 0


def _foreign_rows(cfg, f, cell_start, row_map) -> int:
    """How many (live own row, rod, band row) reach a row that is not a
    valid particle of the raw frame, for bands over ``cell_start`` whose
    rows map to raw rows by ``row_map``."""
    a, e = _bands(cfg, f, cell_start=cell_start,
                  cid=f["cid_s"][:f["count"]])
    valid = f["ext"][:, OID] >= 0
    bad = 0
    for i in range(a.shape[0]):
        for r in range(9):
            bad += int((~valid[row_map[a[i, r]:max(a[i, r], e[i, r])]]).sum())
    return bad


@pytest.mark.parametrize("name", FRAMES)
def test_no_band_holds_a_dead_or_inert_row(frames, name):
    """Every band row of a live own row is a valid particle.  A table built
    over the raw ``ext`` (the search of its raw cids, inert rows at -1 and
    ``num_cells``, the dead runs in their cells) fails this test: on the
    corner frames, whose slab's top corner cell (the own dead run's) and
    whose neighbours' last cells (their dead rows') are populated, its
    bands reach those runs, and the check runs it too to show it."""
    cfg = _cfg(name)
    for d, f in _ranks(frames, name):
        assert _foreign_rows(cfg, f, f["cell_start"], f["rows"]) == 0
        raw = np.searchsorted(f["cid_ext"], np.arange(cfg.num_cells + 1))
        raw_bad = _foreign_rows(cfg, f, raw.astype(np.int32),
                                np.arange(f["ext"].shape[0]))
        if name == "corner-w4" and d == 1:
            assert raw_bad > 1000, raw_bad


def _d2(p, q):
    """[n, m] f32 d^2 in the kernels' op order (x^2 + y^2) + z^2."""
    dx = q[None, :, 0] - p[:, None, 0]
    dy = q[None, :, 1] - p[:, None, 1]
    dz = q[None, :, 2] - p[:, None, 2]
    return dx * dx + dy * dy + dz * dz


def _in_band(a, e, m):
    j = torch.arange(m)
    return ((j >= a[:, :, None]) & (j < e[:, :, None])).any(1)


@pytest.mark.parametrize("name", FRAMES)
def test_pairs_within_h_through_the_bands_equal_a_brute_force(frames, name):
    cfg = _cfg(name)
    pairs = live = 0
    for _, f in _ranks(frames, name):
        ext = torch.from_numpy(f["ext"])
        cnt, h, rows = f["count"], f["h_cap"], torch.from_numpy(f["rows"])
        own = ext[h:h + cnt, 0:3]
        a, e = (torch.from_numpy(x) for x in _bands(cfg, f))
        m = rows.shape[0]
        d2_live = _d2(own, ext[rows, 0:3])
        band = (_in_band(a, e, m) & (d2_live < cfg.h2)
                & (torch.arange(m)[None] != f["nl"] + torch.arange(cnt)[:, None]))
        got = torch.zeros(cnt, ext.shape[0], dtype=torch.bool)
        got[:, rows] = band
        valid = ext[:, OID] >= 0
        want = ((_d2(own, ext[:, 0:3]) < cfg.h2) & valid[None]
                & (torch.arange(ext.shape[0])[None]
                   != h + torch.arange(cnt)[:, None]))
        assert torch.equal(got, want)
        pairs += int(want.sum())
        live += cnt
    assert pairs > 3 * live, "neighbors must be found"


# ---------------------------------------------------------------------------
# The kernels' arguments: a pairwise oracle in place of the launch
# ---------------------------------------------------------------------------

# the band kernel each slab wrapper launches: exact without candidate src
# rows, capped (over the sub frame) with them
WALKED = {("K1", False): "density_band_t[slab]",
          ("K2", False): "force_band_t[slab]",
          ("K1", True): "density_band_t<capped>[slab]",
          ("K2", True): "force_band_t<capped>[slab]"}


def _oracle_mask(cfg, d2, cell_start, cand_src, self_base):
    """[n, m]: the pairs a pairwise oracle sums, every candidate in a cell
    (the table's last entry counts them: the live rows, or the sub frame's
    kept rows) within h, less self row i's own id ``self_base + i``; j's id
    is its row (exact) or ``cand_src[j]`` (capped)."""
    n, m = d2.shape
    ids = torch.arange(m) if cand_src is None else cand_src.long()
    return ((torch.arange(m) < int(cell_start[-1]))[None] & (d2 < cfg.h2)
            & (ids[None] != self_base + torch.arange(n)[:, None]))


def _walk_density(cfg, pos_s, mass_s, cid, cell_start, cand_pos, cand_mass,
                  cand_src=None, self_base=0, self_src=None, *, kernel):
    """The pairwise oracle on the band kernel K1's arguments, with dense
    tensors."""
    assert kernel == WALKED["K1", cand_src is not None] and self_src is None
    d2 = _d2(pos_s, cand_pos)
    mask = _oracle_mask(cfg, d2, cell_start, cand_src, self_base)
    t = cfg.h_scaled2 - d2 * np.float32(cfg.sim_scale * cfg.sim_scale)
    w = torch.where(mask, cand_mass[None] * (cfg.poly6_norm * t * t * t), 0.0)
    return (physics.self_density(cfg, w.sum(1), mass_s),
            mask.sum(1, dtype=torch.int32))


def _walk_force(cfg, pos_s, vel_s, rho_s, cand, cid, cell_start,
                cand_src=None, self_base=0, *, kernel):
    """The pairwise oracle on the band kernel K2's arguments, with dense
    tensors (force_t_plain's formulas)."""
    assert kernel == WALKED["K2", cand_src is not None]
    dxyz = [cand[None, :, c] - pos_s[:, None, c] for c in range(3)]
    d2 = dxyz[0] * dxyz[0] + dxyz[1] * dxyz[1] + dxyz[2] * dxyz[2]
    mask = _oracle_mask(cfg, d2, cell_start, cand_src, self_base)
    rhoi = rho_s[:, None]
    rhoi_inv = physics.safe_inv(rhoi)
    pw_i = ((rhoi - np.float32(cfg.rho0)) * np.float32(cfg.stiffness)
            * rhoi_inv * rhoi_inv)
    d = torch.sqrt(d2) * np.float32(cfg.sim_scale)
    hd = torch.where(mask, cfg.h_scaled - d, 0.0)
    num = hd * hd * (cand[None, :, 7] * pw_i + cand[None, :, 8])
    center = num / (d + np.float32(cfg.pressure_softening)) * np.float32(
        cfg.sim_scale)
    mu = np.float32(cfg.viscosity) * rhoi_inv[:, 0]
    acc = []
    for c in range(3):
        p = -torch.where(mask, dxyz[c] * center, 0.0).sum(1)
        v = torch.where(mask, (cand[None, :, 3 + c]
                               - vel_s[:, None, c] * cand[None, :, 6]) * hd,
                        0.0).sum(1)
        acc.append(mu * v * cfg.visc_lap_norm + p * cfg.visc_lap_norm)
    return torch.stack(acc, dim=1)


def _twin_cand_cols(cfg, pos_c, vel_c, rho_c, m_c, index, out):
    """``sw._launch_cand_cols`` on the CPU: the twin's columns."""
    if index is not None:
        rows = index.long()
        pos_c, vel_c, rho_c = pos_c[rows], vel_c[rows], rho_c[rows]
    out.copy_(sw.fused_cand_cols_plain(cfg, pos_c, vel_c, rho_c, m_c))


def _oracle_path(mp):
    """Force the kernel path for CPU tensors, with the pairwise oracles in
    place of the band launches (and the twin's candidate columns in place
    of ``cand_cols_t``'s)."""
    mp.setattr(sw, "_use_plain", lambda x: False)
    mp.setattr(sw, "_launch_density_band", _walk_density)
    mp.setattr(sw, "_launch_force_band", _walk_force)
    mp.setattr(sw, "_launch_cand_cols", _twin_cand_cols)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("name", ["dam-w2", "corner-w4"])
def test_band_arguments_give_the_twins_sums_on_live_rows(frames, name,
                                                         monkeypatch):
    """``density_local``/``force_local``'s twins against a pairwise oracle
    handed the band kernels' arguments (the kernel path, its launches
    replaced by a dense walk of every live candidate): counts equal and
    rho, acc within the bars on the live own rows; the dead rows 0 on both
    sides."""
    cfg = _cfg(name)
    pairs = live = 0
    for _, f in _ranks(frames, name):
        ext = torch.from_numpy(f["ext"])
        band = ss.SlabBand(torch.from_numpy(f["cell_start"]),
                           torch.from_numpy(f["cid"]),
                           torch.from_numpy(f["rows"]), f["nl"], f["nr"])
        hp = (f["h_cap"], f["p_cap"])
        rho_t, nc_t = ss.density_local(cfg, ext, *hp, band)
        rho_e = torch.where(ext[:, OID] >= 0, 1000.0 + ext[:, 2], 0.0)
        rho_l = rho_e[hp[0]:hp[0] + hp[1]]
        acc_t = ss.force_local(cfg, ext, rho_e, rho_l, *hp, band)
        with monkeypatch.context() as mp:
            _oracle_path(mp)
            rho_k, nc_k = ss.density_local(cfg, ext, *hp, band)
            acc_k = ss.force_local(cfg, ext, rho_e, rho_l, *hp, band)
        cnt = f["count"]
        assert torch.equal(nc_k[:cnt], nc_t[:cnt])
        pairs += int(nc_t[:cnt].sum())
        live += cnt
        assert _rel(rho_k[:cnt], rho_t[:cnt]) <= RHO_BAR
        assert _rel(acc_k[:cnt], acc_t[:cnt]) <= ACC_BAR
        assert not nc_t[cnt:].any() and not rho_t[cnt:].any()
        assert not nc_k[cnt:].any() and not rho_k[cnt:].any()
        assert torch.isfinite(acc_t).all()
    assert pairs > 3 * live, "neighbors must be found"
    assert ss.density_ext.launches == ss.force_ext.launches == len(
        frames[name])
    ss.density_ext.launches = ss.force_ext.launches = 0


@pytest.mark.parametrize("kernel", ["density", "force"])
def test_card_launch_refuses_a_missing_table(frames, kernel, monkeypatch):
    """On the card (here: the kernel path forced for CPU tensors) an exact
    slab sweep without the live rows' table raises before any library is
    built; it never falls back to a window walk."""
    cfg = _cfg("dam-w1")
    f = frames["dam-w1"][0]
    ext = torch.from_numpy(f["ext"])
    hp = (f["h_cap"], f["p_cap"])
    monkeypatch.setattr(sw, "_use_plain", lambda x: False)
    monkeypatch.setattr(sw, "_kernels", None)  # a build would fail
    monkeypatch.setattr(sw, "_launch_cand_cols", _twin_cand_cols)
    ss.density_ext.launches = ss.force_ext.launches = 0
    with pytest.raises(ValueError, match="cell-start table"):
        if kernel == "density":
            ss.density_local(cfg, ext, *hp, None)
        else:
            rho_e = torch.ones(ext.shape[0])
            ss.force_local(cfg, ext, rho_e, rho_e[:hp[1]], *hp, None)
    assert ss.density_ext.launches == 0 and ss.force_ext.launches == 0


# ---------------------------------------------------------------------------
# walk_stats and the lazy carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dam-w2", "corner-w4"])
def test_slab_band_rows_per_lane_against_brute_force(frames, name):
    from test_torch_band import _brute_rows, _check_walk_stats

    cfg = _cfg(name)
    for _, f in _ranks(frames, name):
        cnt = f["count"]
        cid = f["cid"][:cnt].astype(np.int64)
        rows, union = _brute_rows(cid, f["cid_ext"][f["rows"]].astype(np.int64),
                                  np.asarray(rod_deltas(cfg)))
        band = ss.SlabBand(torch.from_numpy(f["cell_start"]),
                           torch.from_numpy(f["cid"]),
                           torch.from_numpy(f["rows"]), f["nl"], f["nr"])
        _check_walk_stats(slab_band_rows_per_lane(cfg, band, cnt), rows,
                          union)


def test_world_one_bands_are_the_single_chip_bands(frames):
    """At world size 1 the live rows are the single-chip sorted frame: the
    same table and the same rows per lane as ``prepare_t``'s."""
    job = _scene_job(1)
    cfg = job["cfg"]
    p = sw.prepare_t(cfg, state_from_numpy(job["state"], "cpu"))
    f = frames["dam-w1"][0]
    np.testing.assert_array_equal(f["cell_start"], p.cell_start.numpy())
    np.testing.assert_array_equal(f["cid_ext"][f["rows"]], p.cid.numpy())
    band = ss.SlabBand(torch.from_numpy(f["cell_start"]),
                       torch.from_numpy(f["cid"]), torch.from_numpy(f["rows"]),
                       f["nl"], f["nr"])
    assert slab_band_rows_per_lane(cfg, band, f["count"]) == \
        band_rows_per_lane(cfg, p.cid, p.cell_start, p.cid.shape[0])


@pytest.mark.parametrize("world", [1, 2])
def test_lazy_carry_freezes_the_band_tables_and_rebuilds_them_on_rebin(
        frames, world):
    """Step 0 builds the tables, steps 1-2 reuse the carry's (the same
    object, nl and nr), and the kick before step 3 forces a rebin that
    rebuilds them from the moved frame (fresh build equal)."""
    for recs in frames["lazy"][world]:
        assert [r["need"] for r in recs] == [True, False, False, True]
        assert [r["same"] for r in recs] == [False, True, True, False]
        for r in recs:
            assert r["fresh_equal"]
        for r in recs[1:3]:
            for k in ("cell_start", "cid", "rows"):
                np.testing.assert_array_equal(r[k], recs[0][k])
            assert (r["nl"], r["nr"]) == (recs[0]["nl"], recs[0]["nr"])
        assert not np.array_equal(recs[3]["cell_start"], recs[0]["cell_start"])
