"""The fused capped path's band walks (``csrc/sweep_t.cu``): the sub-frame
pre-pass ``density_band_t<kExclSrcSrc>`` and K3 ``fused_band_t``, both over
the capped sub frame's cell-start table, on one device (``prepare_t`` with
``capped_fused``: ``PreparedT.cell_start``) and in the slab engine (the
``SubBand`` of ``prepare_frame``'s fused frames on 1, 2 and 4 gloo ranks).

The JAX package's pre-pass and fused kernels walk block windows of the
sub frame and mask them by cell id.  Checked here on the CPU, by brute
force against the JAX package's own window tables (``tests/jax_windows.py``):

* the pre-pass: each kept sub row's band for a rod is exactly the rows of
  its sub block's rod window that pass the cid mask, in order (the self
  row's own src is excluded by both walks alike); a tail row (self cid
  ``TAIL_CID``) has empty bands;
* K3: each self row's (each live own row's) bands are capped K2's, exactly
  the masked rows of its block's rod window over the sub frame, and reach
  no tail row.

Also: the pairs within h through the bands against a brute force, the
twins on the wrappers' arguments against a pairwise oracle handed the
kernels' arguments (a dense walk of every kept candidate in place of each
launch), the tail rows' values through the twins, a card call without the
table refused, and ``utils/walk_stats.prepass_rows`` against a brute-force
count.
"""

import jax_windows
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import physics
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import rod_deltas
from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slab_sweeps as ss
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs as ts
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
    resolve_sweep_settings)
from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
    prepass_rows)
from test_torch_band import (CAPPED_CASES, CAPPED_IDS, CASES, _brute_rows,
                             _check_bands, _check_walk_stats)
from test_torch_slab_band import (ACC_BAR, RHO_BAR, TIMEOUT_S, _d2,
                                  _in_band, _rel, _twin_cand_cols)
from test_torch_slab_capped_band import _corner_cfg, _dam_cfg, _job

torch.set_num_threads(1)

# tests/test_torch_band.py's capped cases in fused mode (its k4-fused case is
# its k4 case here), and a dam break with K_c 4 on its 256-row blocks
FUSED_CASES = [(scene, dict(kw, capped_fused=True))
               for (scene, kw), name in zip(CAPPED_CASES, CAPPED_IDS)
               if name != "k4-fused"]
FUSED_CASES.append(("dam_break", dict(CASES[2][1], capped_candidates=4,
                                      capped_fused=True)))
FUSED_IDS = [n for n in CAPPED_IDS if n != "k4-fused"] + ["dam-break-k4"]


@pytest.fixture(scope="module")
def prepared() -> dict:
    """case id -> (cfg, prepared tables), built once."""
    out = {}
    for (scene, kw), name in zip(FUSED_CASES, FUSED_IDS):
        cfg, st = make_scene(scene, device="cpu", **kw)
        cfg = resolve_sweep_settings(cfg, st, kw)
        out[name] = cfg, sw.prepare_t(cfg, st)
    return out


def _n_kept(cand_cid) -> int:
    return int((np.asarray(cand_cid) >= 0).sum())


def _window_bands(cfg, cid, cand, ws, wc, a, e, rows):
    """Brute force over the self ``rows`` and every rod: the band [a, e) is
    exactly the rows of the row's block's rod window (the JAX package's
    table ``ws``, ``wc``) over the ``cand`` cids that pass the cid mask, in
    order.  Rows of one block and cell share windows and bands, so each
    (block, cell) is checked once."""
    b, s_t = sw._blane(cfg), cfg.pallas_window_t
    m = cand.shape[0]
    cand = cand.astype(np.int64)
    deltas = np.asarray(rod_deltas(cfg))
    _, first = np.unique(np.stack([rows // b, cid[rows]]), axis=1,
                         return_index=True)
    for i in rows[first]:
        for r, delta in enumerate(deltas):
            lo = ws[i // b, r]
            win = np.arange(lo, max(lo, min(lo + wc[i // b, r] * s_t, m)))
            keep = win[np.abs(cand[win] - int(cid[i]) - delta) <= 1]
            band = np.arange(a[i, r], max(a[i, r], e[i, r]))
            np.testing.assert_array_equal(band, keep, f"row {i} rod {r}")


def _prepass_windows(cfg, cand, ws_s, wc_s, cell_start):
    """The pre-pass's bands (self rows and candidates the sub frame): each
    kept row's band is its sub block's masked window rows (the JAX package's
    pre-pass table ``ws_s``, ``wc_s``), in order (both walks then drop the
    row's own src alike); a tail row's bands are empty.  Returns the kept
    count."""
    n_kept = _n_kept(cand)
    a, e = (x.numpy() for x in sw.band_ranges(
        cfg, torch.from_numpy(cand), torch.from_numpy(cell_start)))
    assert np.all(e[n_kept:] <= a[n_kept:]), "a tail row has a band"
    _window_bands(cfg, cand, cand, ws_s, wc_s, a, e, np.arange(n_kept))
    return n_kept


def _pairs_vs_brute_force(cfg, pos_self, cid_self, own, pos_c, src_c, n_kept,
                          cell_start):
    """The pairs the bands give each self row, less its own id ``own[i]``,
    within h, against every kept candidate within h.  Returns the pairs."""
    a, e = sw.band_ranges(cfg, cid_self, cell_start)
    m = pos_c.shape[0]
    d2 = _d2(pos_self, pos_c)
    not_self = src_c.long()[None] != own.long()[:, None]
    got = _in_band(a, e, m) & (d2 < cfg.h2) & not_self
    want = (d2 < cfg.h2) & not_self & (torch.arange(m) < n_kept)[None]
    assert torch.equal(got, want)
    return int(want.sum())


# ---------------------------------------------------------------------------
# The kernels' arguments: a pairwise oracle in place of a launch
# ---------------------------------------------------------------------------

PREPASS = ("density_band_t<prepass>", "density_band_t<prepass>[slab]")
FUSED = ("fused_band_t", "fused_band_t[slab]")
CHUNK = 1024  # self rows per dense [rows, m] block of a walk


def _kept(cell_start, m: int) -> torch.Tensor:
    """[1, m]: the candidates in a cell (the table's last entry counts
    them), every one a pairwise oracle tests."""
    return (torch.arange(m) < int(cell_start[-1]))[None]


def _walk_prepass(cfg, pos_s, mass_s, cid, cell_start, cand_pos, cand_mass,
                  cand_src=None, self_base=0, self_src=None, *, kernel):
    """The pairwise oracle on the pre-pass band kernel's arguments, with
    dense tensors: each self row's pairs within h over every kept
    candidate, less those whose src is its own ``self_src[i]``.  The counts
    are kept in ``_walk_prepass.counts``."""
    assert kernel in PREPASS and self_src is not None
    m = cand_pos.shape[0]
    rho, nc = [], []
    for i0 in range(0, pos_s.shape[0], CHUNK):
        rows = slice(i0, i0 + CHUNK)
        d2 = _d2(pos_s[rows], cand_pos)
        mask = (_kept(cell_start, m) & (d2 < cfg.h2)
                & (cand_src.long()[None] != self_src[rows].long()[:, None]))
        t = cfg.h_scaled2 - d2 * np.float32(cfg.sim_scale * cfg.sim_scale)
        w = torch.where(mask, cand_mass[None] * (cfg.poly6_norm * t * t * t),
                        0.0)
        rho.append(physics.self_density(cfg, w.sum(1), mass_s[rows]))
        nc.append(mask.sum(1, dtype=torch.int32))
    _walk_prepass.counts = torch.cat(nc)
    return torch.cat(rho), _walk_prepass.counts


def _walk_fused(cfg, pos_s, vel_s, mass_s, cid, cell_start, cand, cand_src,
                self_base=0, *, kernel):
    """The pairwise oracle on K3's arguments, with dense tensors:
    ``fused_t_plain``'s formulas on each self row's pairs within h over
    every kept candidate, less its own id ``self_base + i``."""
    assert kernel in FUSED
    m = cand.shape[0]
    scale = np.float32(cfg.sim_scale)
    eps = np.float32(cfg.pressure_softening)
    norm = cfg.visc_lap_norm
    out = []
    for i0 in range(0, pos_s.shape[0], CHUNK):
        rows = slice(i0, i0 + CHUNK)
        pos, vel = pos_s[rows], vel_s[rows]
        n = pos.shape[0]
        dxyz = [cand[None, :, c] - pos[:, None, c] for c in range(3)]
        d2 = dxyz[0] * dxyz[0] + dxyz[1] * dxyz[1] + dxyz[2] * dxyz[2]
        own = self_base + i0 + torch.arange(n)
        mask = (_kept(cell_start, m) & (d2 < cfg.h2)
                & (cand_src.long()[None] != own[:, None]))
        t = cfg.h_scaled2 - d2 * np.float32(cfg.sim_scale * cfg.sim_scale)
        w = torch.where(mask, cand[None, :, 7] * (cfg.poly6_norm * t * t * t),
                        0.0)
        rho = physics.self_density(cfg, w.sum(1), mass_s[rows])
        d = torch.sqrt(d2) * scale
        hd = torch.where(mask, cfg.h_scaled - d, 0.0)
        hd2inv = hd * hd / (d + eps) * scale
        c1, c2 = hd2inv * cand[None, :, 7], hd2inv * cand[None, :, 8]
        rhoi_inv = physics.safe_inv(rho)
        pw_i = ((rho - np.float32(cfg.rho0)) * np.float32(cfg.stiffness)
                * rhoi_inv * rhoi_inv)
        mu = np.float32(cfg.viscosity) * rhoi_inv
        acc = []
        for c in range(3):
            p1 = -torch.where(mask, dxyz[c] * c1, 0.0).sum(1)
            p2 = -torch.where(mask, dxyz[c] * c2, 0.0).sum(1)
            v = torch.where(mask, (cand[None, :, 3 + c]
                                   - vel[:, None, c] * cand[None, :, 6]) * hd,
                            0.0).sum(1)
            acc.append(mu * v * norm + (pw_i * p1 + p2) * norm)
        out.append((torch.stack(acc, dim=1), rho,
                    mask.sum(1, dtype=torch.int32)))
    return tuple(torch.cat(x) for x in zip(*out))


def _band_path(monkeypatch):
    """Force the kernel path for CPU tensors, with the pairwise oracles in
    place of the launches (and the twin's candidate columns in place of
    ``cand_cols_t``'s)."""
    monkeypatch.setattr(sw, "_use_plain", lambda x: False)
    monkeypatch.setattr(sw, "_launch_density_band", _walk_prepass)
    monkeypatch.setattr(sw, "_launch_fused_band", _walk_fused)
    monkeypatch.setattr(sw, "_launch_cand_cols", _twin_cand_cols)


def _self_term(cfg, mass) -> torch.Tensor:
    return physics.self_density(cfg, torch.zeros_like(mass), mass)


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------

def _prepass_tables(cfg, cand_cid) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's pre-pass tables on one device: the sub frame's
    blocks over the sub frame itself."""
    search = jax_windows.sub_search(cfg, cand_cid)
    return jax_windows.single_chip(cfg, search, search)


@pytest.mark.parametrize("name", FUSED_IDS)
def test_prepass_band_is_the_masked_part_of_its_block_window(prepared, name):
    cfg, p = prepared[name]
    n_kept = _prepass_windows(cfg, p.cand_cid.numpy(),
                              *_prepass_tables(cfg, p.cand_cid),
                              p.cell_start.numpy())
    assert 0 < n_kept == int(p.cell_start[-1])


@pytest.mark.parametrize("name", FUSED_IDS)
def test_k3_bands_are_the_masked_part_of_the_block_window(prepared, name):
    """K3 walks capped K2's bands: the checks of the capped band walks
    (``tests/test_torch_band.py``) on the fused tables, and no band reaches
    a tail row."""
    cfg, p = prepared[name]
    cand = p.cand_cid.numpy().astype(np.int64)
    _check_bands(cfg, p.cid.numpy().astype(np.int64), cand, p, cand.shape[0])
    _, e = sw.band_ranges(cfg, p.cid, p.cell_start)
    assert int(e.max()) <= _n_kept(cand)


@pytest.mark.parametrize("name", FUSED_IDS)
def test_pairs_within_h_through_the_bands_equal_a_brute_force(prepared,
                                                              name):
    cfg, p = prepared[name]
    pos_c, _ = sw.gather_sub_pv(p)
    n_kept = _n_kept(p.cand_cid)
    pre = _pairs_vs_brute_force(cfg, pos_c[:n_kept], p.cand_cid[:n_kept],
                                p.sub_perm[:n_kept], pos_c, p.sub_perm,
                                n_kept, p.cell_start)
    k3 = _pairs_vs_brute_force(cfg, p.pos_s, p.cid,
                               torch.arange(p.pos_s.shape[0]), pos_c,
                               p.sub_perm, n_kept, p.cell_start)
    # the dilute disk has ~0.1 pairs per row, the pools tens
    assert pre > 0 and k3 > 0, "neighbors must be found"


@pytest.mark.parametrize("name", FUSED_IDS)
def test_band_arguments_give_the_twins_sums(prepared, name, monkeypatch):
    """``density_sub_t``/``fused_sweep_t``'s twins against a pairwise
    oracle handed the kernels' arguments (the kernel path, its launches
    replaced by a dense walk of every kept candidate): counts equal, rho
    and acc within the bars, the pre-pass on the kept rows, K3 on every
    row; the twins give the tail rows the self term and count 0."""
    cfg, p = prepared[name]
    pv = sw.gather_sub_pv(p)
    n_kept = _n_kept(p.cand_cid)
    kept = slice(0, n_kept)
    sub_t = sw.density_sub_t(cfg, p, pv)
    _, nc_t = sw.density_t_plain(*sw._pre_args(
        cfg, pv[0], p.mass_s[p.sub_perm], p.wm_sub, p.cand_cid, p.sub_perm,
        p.cell_start))
    acc_t, rho_t, fnc_t = sw.fused_sweep_t(cfg, p, sub_t, pv)
    sw.density_pre_t.launches = sw.fused_t.launches = 0
    with monkeypatch.context() as mp:
        _band_path(mp)
        sub_k = sw.density_sub_t(cfg, p, pv)
        nc_k = _walk_prepass.counts
        acc_k, rho_k, fnc_k = sw.fused_sweep_t(cfg, p, sub_k, pv)
    assert sw.density_pre_t.launches == sw.fused_t.launches == 1
    sw.density_pre_t.launches = sw.fused_t.launches = 0
    assert torch.equal(nc_k[kept], nc_t[kept])
    assert _rel(sub_k[kept], sub_t[kept]) <= RHO_BAR
    assert torch.equal(fnc_k, fnc_t)
    assert _rel(rho_k, rho_t) <= RHO_BAR
    assert _rel(acc_k, acc_t) <= ACC_BAR
    assert torch.isfinite(acc_t).all() and int(fnc_t.sum()) > 0
    tail = slice(n_kept, None)
    assert not nc_t[tail].any()
    assert torch.equal(sub_t[tail], _self_term(cfg, p.mass_s[p.sub_perm])[tail])


@pytest.mark.parametrize("kernel", ["prepass", "fused"])
def test_card_call_refuses_a_missing_table(prepared, kernel, monkeypatch):
    """On the card (here: the kernel path forced for CPU tensors) a fused
    sweep without the sub frame's table raises before any library is
    built; it never falls back to a window walk."""
    cfg, p = prepared["k4"]
    pos_c, vel_c = sw.gather_sub_pv(p)
    monkeypatch.setattr(sw, "_use_plain", lambda x: False)
    monkeypatch.setattr(sw, "_kernels", None)  # a build would fail
    sw.density_pre_t.launches = sw.fused_t.launches = 0
    with pytest.raises(ValueError, match="cell-start table"):
        if kernel == "prepass":
            sw.density_pre_t(cfg, pos_c, p.mass_s[p.sub_perm], p.wm_sub,
                             p.cand_cid, p.sub_perm, None)
        else:
            cand = sw.fused_cand_cols_plain(cfg, pos_c, vel_c, p.wm_sub,
                                            p.wm_sub)
            sw.fused_t(cfg, p.pos_s, p.vel_s, p.mass_s, p.cid, None, cand,
                       p.sub_perm)
    assert sw.density_pre_t.launches == sw.fused_t.launches == 0


def _check_prepass_rows(cfg, cand, ws_s, wc_s, cell_start):
    """``prepass_rows`` against a brute force: the band counts of the kept
    rows over the kept candidates.  Returns them and the rows per thread
    of the JAX package's pre-pass windows (``ws_s``, ``wc_s``) over the
    kept rows' blocks."""
    b, s_t = sw._blane(cfg), cfg.pallas_window_t
    s_len, n_kept = cand.shape[0], _n_kept(cand)
    band = prepass_rows(cfg, torch.from_numpy(cand),
                        torch.from_numpy(cell_start))
    nb = -(-n_kept // b)
    rows = [sum(max(min(ws_s[k, r] + wc_s[k, r] * s_t, s_len) - ws_s[k, r],
                    0) for r in range(9)) for k in range(nb)]
    kept = cand[:n_kept].astype(np.int64)
    brute, union = _brute_rows(kept, kept, np.asarray(rod_deltas(cfg)))
    _check_walk_stats(band, brute, union)
    assert brute.max() <= 3 * cfg.capped_candidates
    return np.mean(rows), band


@pytest.mark.parametrize("name", ["k4", "dam-break-k4"])
def test_prepass_rows_against_brute_force(prepared, name):
    cfg, p = prepared[name]
    window, band = _check_prepass_rows(cfg, p.cand_cid.numpy(),
                                       *_prepass_tables(cfg, p.cand_cid),
                                       p.cell_start.numpy())
    assert band["warp_max"] < window


# ---------------------------------------------------------------------------
# The slab engine: fused frames on 1, 2 and 4 gloo ranks
# ---------------------------------------------------------------------------

def fused_frames(group, jobs: list[dict]) -> list[dict]:
    """Per job: this rank's first-step fused frame and tables
    (``prepare_frame``) as numpy."""
    out = []
    for job in jobs:
        cfg, caps, zs = job["cfg"], job["caps"], job["zsplit"]
        state = state_from_numpy(job["state"], group.device)
        sub_len = ts.frame_sub_len(cfg, "pallas", caps[0], caps[1],
                                   job["sub_len"])
        carry = ts.init_lazy_slab(
            cfg, group, ts.distribute(cfg, state, group, caps[0], zs),
            caps[0], "pallas", sub_len)
        fr = ts.prepare_frame(cfg, group, *caps, "pallas", zs, True, sub_len,
                              carry)
        sub_src, cand_cid, w_sub, _, band = fr.tabs
        nxny = cfg.grid_nx * cfg.grid_ny
        out.append(dict(
            ext=fr.ext.numpy(), cid_ext=fr.cid_ext.numpy(), count=fr.count,
            cid_s=fr.cid_s.numpy(), sub_src=sub_src.numpy(),
            cand_cid=cand_cid.numpy(), w_sub=w_sub.numpy(),
            cell_start=band.cell_start.numpy(), cid=band.cid.numpy(),
            h_cap=caps[1], p_cap=caps[0], base=(zs[group.rank] - 1) * nxny,
            loc=(max(b - a for a, b in zip(zs, zs[1:])) + 2) * nxny))
    return out


def _slab_tables(cfg, f, prepass: bool = False):
    """The JAX engine's tables of a fused frame ``f``: the own slab's over
    the sub frame, or (``prepass``) the sub frame's over itself."""
    search = jax_windows.sub_search(cfg, f["cand_cid"])
    if prepass:
        return jax_windows.slab_sub(
            cfg, jax_windows.prepass_self(cfg, search), search,
            search.shape[0], _n_kept(f["cand_cid"]), f["base"], f["loc"])
    return jax_windows.slab_sub(cfg, f["cid_s"], search, search.shape[0],
                                f["count"], f["base"], f["loc"])


def _fused_dam_job(world: int) -> dict:
    cfg, st = _dam_cfg(fused=True)
    return _job(cfg, st, world, ts.derive_zsplit(cfg, st, world))


def _fused_corner_cfg():
    cfg, st = _corner_cfg()
    return cfg.replace(capped_fused=True), st


def _fused_corner_job() -> dict:
    cfg, st = _fused_corner_cfg()
    return _job(cfg, st, 4, ts.uniform_zsplit(cfg, 4))


@pytest.fixture(scope="module")
def frames() -> dict:
    with comm.local_group("cpu", "gloo") as g:
        one = fused_frames(g, [_fused_dam_job(1)])
    two = comm.spawn_ranks(2, fused_frames, [_fused_dam_job(2)],
                           backend="gloo", threads=1, timeout_s=TIMEOUT_S)
    four = comm.spawn_ranks(4, fused_frames, [_fused_dam_job(4),
                                              _fused_corner_job()],
                            backend="gloo", threads=1, timeout_s=TIMEOUT_S)
    return {"dam-w1": one, "dam-w2": [r[0] for r in two],
            "dam-w4": [r[0] for r in four],
            "corner-w4": [r[1] for r in four]}


SLAB_FRAMES = ["dam-w1", "dam-w2", "dam-w4", "corner-w4"]


def _slab_cfg(name: str):
    return (_dam_cfg(fused=True)[0] if name.startswith("dam")
            else _fused_corner_cfg()[0])


def _sub_band(f) -> ss.SubBand:
    return ss.SubBand(torch.from_numpy(f["cell_start"]),
                      torch.from_numpy(f["cid"]))


@pytest.mark.parametrize("name", SLAB_FRAMES)
def test_slab_prepass_band_is_the_masked_part_of_its_block_window(frames,
                                                                  name):
    cfg = _slab_cfg(name)
    for f in frames[name]:
        assert f["cell_start"][cfg.num_cells] == _n_kept(f["cand_cid"])
        _prepass_windows(cfg, f["cand_cid"], *_slab_tables(cfg, f, True),
                         f["cell_start"])


@pytest.mark.parametrize("name", SLAB_FRAMES)
def test_slab_k3_bands_are_the_masked_part_of_the_block_window(frames, name):
    """K3 walks the own rows' bands of the sub frame, capped K2's: each live
    own row's band is its block window's masked rows, in order; the own
    dead rows (``NO_CELL``) and the tail are in no band."""
    cfg = _slab_cfg(name)
    for f in frames[name]:
        cnt, cand = f["count"], f["cand_cid"]
        a, e = (x.numpy() for x in sw.band_ranges(
            cfg, torch.from_numpy(f["cid"]), torch.from_numpy(f["cell_start"])))
        assert np.all(e[cnt:] <= a[cnt:]) and e.max() <= _n_kept(cand)
        _window_bands(cfg, f["cid"], cand, *_slab_tables(cfg, f), a, e,
                      np.arange(cnt))


@pytest.mark.parametrize("name", SLAB_FRAMES)
def test_slab_pairs_within_h_through_the_bands_equal_a_brute_force(frames,
                                                                   name):
    cfg = _slab_cfg(name)
    pairs = rows = 0
    for f in frames[name]:
        ext = torch.from_numpy(f["ext"])
        src = torch.from_numpy(f["sub_src"])
        pos_c = ext[src.long(), 0:3]
        n_kept, cnt, h = _n_kept(f["cand_cid"]), f["count"], f["h_cap"]
        cell_start = torch.from_numpy(f["cell_start"])
        pairs += _pairs_vs_brute_force(
            cfg, pos_c[:n_kept], torch.from_numpy(f["cand_cid"][:n_kept]),
            src[:n_kept], pos_c, src, n_kept, cell_start)
        pairs += _pairs_vs_brute_force(
            cfg, ext[h:h + cnt, 0:3], torch.from_numpy(f["cid"][:cnt]),
            h + torch.arange(cnt), pos_c, src, n_kept, cell_start)
        rows += n_kept + cnt
    assert pairs > 3 * rows, "neighbors must be found"


@pytest.mark.parametrize("name", SLAB_FRAMES)
def test_slab_band_arguments_give_the_twins_sums(frames, name, monkeypatch):
    """``density_sub_local``/``fused_local_capped``'s twins against a
    pairwise oracle handed the kernels' arguments (the kernel path, its
    launches replaced by a dense walk of every kept candidate): counts
    equal, rho and acc within the bars, the pre-pass on the kept rows, K3
    on every own row (the dead rows 0 on both sides); the twins give the
    tail rows the self term and count 0."""
    cfg = _slab_cfg(name)
    ss.density_sub_pre.launches = ss.fused_ext.launches = 0
    pairs = live = 0
    for f in frames[name]:
        ext = torch.from_numpy(f["ext"])
        sub_src = torch.from_numpy(f["sub_src"])
        cand_cid = torch.from_numpy(f["cand_cid"])
        w_sub = torch.from_numpy(f["w_sub"])
        hp = (f["h_cap"], f["p_cap"])
        g8 = ext[sub_src.long()]
        n_kept, cnt = _n_kept(f["cand_cid"]), f["count"]
        kept = slice(0, n_kept)
        args = ss.density_sub_local_args(cfg, g8, sub_src, cand_cid, w_sub,
                                         _sub_band(f))
        sub_t = ss.density_sub_pre(*args)
        _, pos_sub, mass_sub, wm_sub = args[:4]
        _, nc_t = sw.density_t_plain(*sw._pre_args(
            cfg, pos_sub, mass_sub, wm_sub, cand_cid, sub_src,
            _sub_band(f).cell_start))
        # the candidates' densities: the pre-pass's, one rank's rows only
        rho_cand = torch.where(cand_cid >= 0, sub_t, 0.0)
        fargs = (cfg, ext, g8, rho_cand, sub_src, w_sub, *hp, _sub_band(f))
        acc_t, rho_t, fnc_t = ss.fused_local_capped(*fargs)
        with monkeypatch.context() as mp:
            _band_path(mp)
            sub_k = ss.density_sub_local(cfg, g8, sub_src, cand_cid, w_sub,
                                         _sub_band(f))
            nc_k = _walk_prepass.counts
            acc_k, rho_k, fnc_k = ss.fused_local_capped(*fargs)
        assert torch.equal(nc_k[kept], nc_t[kept])
        assert _rel(sub_k[kept], sub_t[kept]) <= RHO_BAR
        assert not nc_t[n_kept:].any()
        assert torch.equal(sub_t[n_kept:], _self_term(cfg, mass_sub)[n_kept:])
        assert torch.equal(fnc_k, fnc_t)
        assert _rel(rho_k, rho_t) <= RHO_BAR
        assert _rel(acc_k, acc_t) <= ACC_BAR
        assert not fnc_t[cnt:].any() and not rho_t[cnt:].any()
        assert torch.isfinite(acc_t).all()
        pairs += int(fnc_t.sum())
        live += cnt
    assert pairs > 3 * live, "neighbors must be found"
    assert ss.density_sub_pre.launches == ss.fused_ext.launches == len(
        frames[name])
    ss.density_sub_pre.launches = ss.fused_ext.launches = 0


@pytest.mark.parametrize("kernel", ["prepass", "fused"])
def test_slab_card_call_refuses_a_missing_table(frames, kernel, monkeypatch):
    cfg = _slab_cfg("dam-w1")
    f = frames["dam-w1"][0]
    ext = torch.from_numpy(f["ext"])
    sub_src = torch.from_numpy(f["sub_src"])
    cand_cid = torch.from_numpy(f["cand_cid"])
    w_sub = torch.from_numpy(f["w_sub"])
    g8 = ext[sub_src.long()]
    monkeypatch.setattr(sw, "_use_plain", lambda x: False)
    monkeypatch.setattr(sw, "_kernels", None)  # a build would fail
    monkeypatch.setattr(sw, "_launch_cand_cols", _twin_cand_cols)
    ss.density_sub_pre.launches = ss.fused_ext.launches = 0
    with pytest.raises(ValueError, match="cell-start table"):
        if kernel == "prepass":
            ss.density_sub_local(cfg, g8, sub_src, cand_cid, w_sub, None)
        else:
            ss.fused_local_capped(cfg, ext, g8, w_sub, sub_src, w_sub,
                                  f["h_cap"], f["p_cap"], None)
    assert ss.density_sub_pre.launches == ss.fused_ext.launches == 0


@pytest.mark.parametrize("name", SLAB_FRAMES)
def test_slab_prepass_rows_against_brute_force(frames, name):
    cfg = _slab_cfg(name)
    for f in frames[name]:
        _check_prepass_rows(cfg, f["cand_cid"], *_slab_tables(cfg, f, True),
                            f["cell_start"])
