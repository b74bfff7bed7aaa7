"""The slab engine's capped band walks (``density_band_t``/``force_band_t``
with ``kExclSrc`` of ``csrc/sweep_t.cu`` through ``parallel/slab_sweeps.py``):
the frozen ``SubBand`` table of a rank's capped sub frame (the kept rows of
its extended frame [left halo | own slab | right halo]), built by the
engine's own ``prepare_frame`` on 1, 2 and 4 gloo ranks
(``parallel.comm.spawn_ranks``) with ``capped_candidates=4``, on the
dam-break and populated-corner frames of ``tests/test_torch_slab_band.py``.

On the card the band kernels are held bit-equal to the ``kExclSrc`` block
walks over the same sub frame on every own row (``chip_smoke.py`` phase
11); that rests on what is checked here on the CPU, by brute force against
the sub frame's window tables (``tests/test_torch_slabs.py`` holds the sub
frame, its tables and the capped callers equal to JAX's):

* ``cell_start`` is the search of the kept rows' cids, and
  ``cell_start[num_cells]`` the kept count, so no band reaches the tail;
* the own dead rows carry self cid ``NO_CELL`` (they walk nothing);
* each live own row's band for a rod is exactly the rows of its block's rod
  window that pass the block walk's cid mask, in order, so walking it sums
  the same pairs in the same order.

Also: the pairs within h through the bands against a brute force, the
wrappers' argument plumbing against the twins (a PyTorch walk of the bands
in place of the launch), ``utils/walk_stats.py``'s capped slab counts, the
world-1 table against the single-chip capped table, the lazy carry
freezing the table and rebuilding it at a rebin (two-pass and fused), the
placeholder tables' layout, and a card call without the table refused.
"""

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import (NO_CELL,
                                                                rod_deltas)
from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slab_sweeps as ss
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs as ts
from smoothed_particle_hydrodynamics_tpu_torch.state import (
    state_from_numpy, state_to_numpy)
from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
    band_rows_per_lane, corner_state, slab_sub_band_rows_per_lane)
from test_torch_slab_band import (ACC_BAR, OID, RHO_BAR, SCENE, TIMEOUT_S,
                                  _d2, _in_band, _rel,
                                  _walk_density, _walk_force)

torch.set_num_threads(1)

# the slab tests' capped settings (tests/test_torch_slabs.py: CAPPED)
CAPPED = dict(pallas_window_t=32, capped_candidates=4)


# ---------------------------------------------------------------------------
# Frames from the engine, on every rank
# ---------------------------------------------------------------------------

def _structure(tabs) -> list:
    """(type, dtype, shape) of each table, fields of a NamedTuple in turn."""
    out = []
    for t in tabs:
        if isinstance(t, tuple):
            out.append((type(t).__name__, _structure(t)))
        else:
            out.append((str(t.dtype), tuple(t.shape)))
    return out


def _record(cfg, fr, job, rank, sub_len) -> dict:
    """A rank's frame and its capped tables as numpy (picklable)."""
    nxny = cfg.grid_nx * cfg.grid_ny
    zs, (p_cap, h_cap, _) = job["zsplit"], job["caps"]
    slab_lo, slab_hi = zs[rank] * nxny, zs[rank + 1] * nxny
    ws, wc, sub_src, cand_cid, w_sub, _, band = fr.tabs[:7]
    cid_search = ts._capped_sub_frame(cfg, fr.ext, fr.cid_ext, sub_len,
                                      slab_lo, slab_hi)[2]
    fresh = ts._sub_band(cfg, cid_search, fr.cid_s, fr.count)
    zeros = ts._table_zeros(cfg, "pallas", p_cap, sub_len)
    return dict(
        ext=fr.ext.numpy(), cid_ext=fr.cid_ext.numpy(), cid_s=fr.cid_s.numpy(),
        count=fr.count, ws=ws.numpy(), wc=wc.numpy(), sub_src=sub_src.numpy(),
        cand_cid=cand_cid.numpy(), w_sub=w_sub.numpy(),
        cell_start=band.cell_start.numpy(), cid=band.cid.numpy(),
        need=fr.need, fresh_equal=all(torch.equal(a, b)
                                      for a, b in zip(fresh, band)),
        layout=_structure(fr.tabs), zero_layout=_structure(zeros),
        h_cap=h_cap, p_cap=p_cap, slab_hi=slab_hi)


def capped_frames(group, jobs: list[dict]) -> list[list[dict]]:
    """Per job, per step: this rank's ``prepare_frame`` output (the step's
    frame and capped tables) as numpy, then the step itself.  ``kick_at``
    steps first spread the positions in x by up to 3 cells (a rebin).
    Whether a frozen step's table is the carry's own object is in
    ``same``."""
    out = []
    for job in jobs:
        cfg, caps, zs = job["cfg"], job["caps"], job["zsplit"]
        state = state_from_numpy(job["state"], group.device)
        sub_len = ts.frame_sub_len(cfg, "pallas", caps[0], caps[1],
                                   job["sub_len"])
        carry = ts.init_lazy_slab(
            cfg, group, ts.distribute(cfg, state, group, caps[0], zs),
            caps[0], "pallas", sub_len)
        recs = []
        for k in range(job["steps"]):
            if k in job.get("kick_at", ()):
                f = carry.fields.clone()
                valid = f[:, OID] >= 0.0
                spread = torch.linspace(0.0, 3.0 * cfg.cell_size, f.shape[0])
                f[:, 0] = torch.where(valid, f[:, 0] + spread, f[:, 0])
                carry = carry._replace(fields=f)
            fr = ts.prepare_frame(cfg, group, *caps, "pallas", zs, True,
                                  sub_len, carry)
            rec = _record(cfg, fr, job, group.rank, sub_len)
            rec["same"] = fr.tabs[6] is carry.tabs[6]
            recs.append(rec)
            carry, _ = ts.slab_step_body(cfg, group, *caps, 4096, "pallas",
                                         zs, True, sub_len, carry)
        out.append(recs)
    return out


def _job(cfg, st, world: int, zs, steps: int = 1, **extra) -> dict:
    caps = ts.derive_slab_caps(cfg, st, world, zsplit=zs)
    return dict(cfg=cfg, state=state_to_numpy(st), caps=caps, zsplit=zs,
                sub_len=ts.derive_sub_len_slab(cfg, st, world, zs),
                steps=steps, **extra)


def _dam_cfg(fused: bool = False):
    return make_scene("dam_break", device="cpu", **SCENE, **CAPPED,
                      capped_fused=fused)


def _scene_job(world: int, steps: int = 1, fused: bool = False, **extra):
    cfg, st = _dam_cfg(fused)
    return _job(cfg, st, world, ts.derive_zsplit(cfg, st, world), steps,
                **extra)


def _corner_cfg():
    cfg, _ = make_scene("dam_break", device="cpu", num_particles=4096,
                        grid_nx=16, grid_ny=16, grid_nz=16, **CAPPED)
    st = corner_state(cfg)
    return cfg.replace(num_particles=st.n), st


def _corner_job() -> dict:
    cfg, st = _corner_cfg()
    return _job(cfg, st, 4, ts.uniform_zsplit(cfg, 4))


LAZY = dict(steps=4, kick_at=(3,))


@pytest.fixture(scope="module")
def frames() -> dict:
    """name -> per-rank step-0 records, and the lazy runs (world 1 and 2,
    two-pass and fused)."""
    with comm.local_group("cpu", "gloo") as g:
        one = capped_frames(g, [_scene_job(1, **LAZY),
                                _scene_job(1, fused=True, **LAZY)])
    two = comm.spawn_ranks(2, capped_frames, [
        _scene_job(2, **LAZY), _scene_job(2, fused=True, **LAZY)],
        backend="gloo", threads=1, timeout_s=TIMEOUT_S)
    four = comm.spawn_ranks(4, capped_frames, [_scene_job(4), _corner_job()],
                            backend="gloo", threads=1, timeout_s=TIMEOUT_S)
    out = {"dam-w1": [one[0][0]], "dam-w2": [r[0][0] for r in two],
           "dam-w4": [r[0][0] for r in four],
           "corner-w4": [r[1][0] for r in four]}
    out["lazy"] = {(1, False): [one[0]], (1, True): [one[1]],
                   (2, False): [r[0] for r in two],
                   (2, True): [r[1] for r in two]}
    return out


def _cfg(name: str):
    return _dam_cfg()[0] if name.startswith("dam") else _corner_cfg()[0]


FRAMES = ["dam-w1", "dam-w2", "dam-w4", "corner-w4"]


def _ranks(frames, name):
    return list(enumerate(frames[name]))


def _n_kept(f) -> int:
    return int((f["cand_cid"] >= 0).sum())


def _sub_band(f) -> ss.SubBand:
    return ss.SubBand(torch.from_numpy(f["cell_start"]),
                      torch.from_numpy(f["cid"]))


def _bands(cfg, f):
    """[count, 9] band rows [a, e) of the live own rows in the sub frame."""
    cnt = f["count"]
    a, e = sw.band_ranges(cfg, torch.from_numpy(f["cid"][:cnt]),
                          torch.from_numpy(f["cell_start"]))
    return a.numpy(), e.numpy()


# ---------------------------------------------------------------------------
# The table and the own cids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FRAMES)
def test_cell_start_is_the_search_of_the_kept_cids(frames, name):
    cfg = _cfg(name)
    for _, f in _ranks(frames, name):
        n_kept = _n_kept(f)
        kept = f["cand_cid"][:n_kept]
        assert np.all(f["cand_cid"][n_kept:] == sw.TAIL_CID)
        assert np.all(np.diff(kept) >= 0)
        assert kept.min() >= 0 and kept.max() < cfg.num_cells
        want = np.searchsorted(kept, np.arange(cfg.num_cells + 1))
        assert f["cell_start"].dtype == np.int32
        np.testing.assert_array_equal(f["cell_start"], want)
        assert f["cell_start"][cfg.num_cells] == n_kept
        assert n_kept < f["sub_src"].shape[0], "the sub frame must have a tail"
        assert f["fresh_equal"]


@pytest.mark.parametrize("name", FRAMES)
def test_own_dead_rows_carry_no_cell(frames, name):
    """The own dead rows sit in the slab's last cell (``_sort_local``); the
    table's self cids put them in no cell, so they walk no band."""
    cfg = _cfg(name)
    for _, f in _ranks(frames, name):
        cnt = f["count"]
        assert cnt < f["p_cap"], "the own slab must hold dead rows"
        assert f["cid"].dtype == np.int32
        np.testing.assert_array_equal(f["cid"][:cnt], f["cid_s"][:cnt])
        assert np.all(f["cid"][cnt:] == NO_CELL)
        assert np.all(f["cid_s"][cnt:] == f["slab_hi"] - 1)
        a, e = sw.band_ranges(cfg, torch.from_numpy(f["cid"][cnt:]),
                              torch.from_numpy(f["cell_start"]))
        assert bool((e <= a).all())


@pytest.mark.parametrize("name", FRAMES)
def test_band_is_the_masked_part_of_the_block_window(frames, name):
    """Brute force over every live own row and rod: the band is exactly the
    rows of the block's rod window over the sub frame that pass the cid
    mask (the block walk's candidates; the tail's ``TAIL_CID`` fails it),
    in order, so both walks sum the same pairs in the same order.  Unlike
    the exact walk's live rows (``tests/test_torch_slab_band.py``), the sub
    frame holds only the cells the rank can query (own slab +- one plane),
    all inside the plane-local window tables, so no band reaches a row of a
    cell the window leaves out."""
    cfg = _cfg(name)
    b, s_t = sw._blane(cfg), cfg.pallas_window_t
    deltas = np.asarray(rod_deltas(cfg))
    for _, f in _ranks(frames, name):
        s_len = f["sub_src"].shape[0]
        ws = f["ws"].reshape(-1, 9).astype(np.int64)
        wc = f["wc"].reshape(-1, 9).astype(np.int64)
        cand = f["cand_cid"].astype(np.int64)
        a, e = _bands(cfg, f)
        for i in range(f["count"]):
            ci = int(f["cid_s"][i])
            for r, delta in enumerate(deltas):
                lo = ws[i // b, r]
                hi = min(lo + wc[i // b, r] * s_t, s_len)
                win = np.arange(lo, max(lo, hi))
                keep = win[np.abs(cand[win] - ci - delta) <= 1]
                band = np.arange(a[i, r], max(a[i, r], e[i, r]))
                np.testing.assert_array_equal(band, keep, f"row {i} rod {r}")


@pytest.mark.parametrize("name", FRAMES)
def test_no_band_holds_a_tail_row(frames, name):
    cfg = _cfg(name)
    for _, f in _ranks(frames, name):
        a, e = _bands(cfg, f)
        some = e > a
        assert some.any()
        assert e[some].max() <= _n_kept(f)
        rows = np.concatenate([np.arange(x, y) for x, y in zip(a[some],
                                                               e[some])])
        assert np.all(f["cand_cid"][rows] >= 0)


@pytest.mark.parametrize("name", FRAMES)
def test_pairs_within_h_through_the_bands_equal_a_brute_force(frames, name):
    """The pairs the bands give each live own row, less its own extended
    frame row ``h_cap + i``, against every kept candidate within h."""
    cfg = _cfg(name)
    pairs = live = 0
    for _, f in _ranks(frames, name):
        ext = torch.from_numpy(f["ext"])
        cnt, h = f["count"], f["h_cap"]
        n_kept = _n_kept(f)
        src = torch.from_numpy(f["sub_src"]).long()
        own = ext[h:h + cnt, 0:3]
        a, e = (torch.from_numpy(x) for x in _bands(cfg, f))
        m = src.shape[0]
        d2 = _d2(own, ext[src, 0:3])
        not_self = src[None] != h + torch.arange(cnt)[:, None]
        got = _in_band(a, e, m) & (d2 < cfg.h2) & not_self
        want = (d2 < cfg.h2) & not_self & (torch.arange(m) < n_kept)[None]
        assert torch.equal(got, want)
        pairs += int(want.sum())
        live += cnt
    assert pairs > 3 * live, "neighbors must be found"


# ---------------------------------------------------------------------------
# The kernels' arguments: a PyTorch walk of the bands in place of the launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FRAMES)
def test_band_arguments_give_the_twins_sums_on_every_own_row(
        frames, name, monkeypatch):
    """``density_local_capped``/``force_local_capped`` on the kernel path
    (launches replaced by a PyTorch walk of the bands they are handed)
    against the block-walk twins over the sub frame: counts equal and rho,
    acc within the bars on every own row, the dead rows 0 on both sides."""
    cfg = _cfg(name)
    pairs = live = 0
    ss.density_ext_capped.launches = ss.force_ext_capped.launches = 0
    for _, f in _ranks(frames, name):
        ext, cid_ext = torch.from_numpy(f["ext"]), torch.from_numpy(f["cid_ext"])
        ws, wc = torch.from_numpy(f["ws"]), torch.from_numpy(f["wc"])
        sub_src = torch.from_numpy(f["sub_src"])
        cand_cid = torch.from_numpy(f["cand_cid"])
        w_sub = torch.from_numpy(f["w_sub"])
        g8 = ext[sub_src.long()]
        hp = (f["h_cap"], f["p_cap"])
        sub = (sub_src, cand_cid, w_sub, *hp)
        rho_t, nc_t = ss.density_local_capped(cfg, ext, g8, cid_ext, ws, wc,
                                              *sub, _sub_band(f))
        rho_e = torch.where(ext[:, OID] >= 0, 1000.0 + ext[:, 2], 0.0)
        rho_l = rho_e[hp[0]:hp[0] + hp[1]]
        acc_t = ss.force_local_capped(cfg, ext, g8, cid_ext, rho_e, rho_l,
                                      ws, wc, *sub, _sub_band(f))
        with monkeypatch.context() as mp:
            mp.setattr(ss, "_use_plain", lambda x: False)
            mp.setattr(sw, "_launch_density_band", _walk_density)
            mp.setattr(sw, "_launch_force_band", _walk_force)
            rho_k, nc_k = ss.density_local_capped(cfg, ext, g8, cid_ext, ws,
                                                  wc, *sub, _sub_band(f))
            acc_k = ss.force_local_capped(cfg, ext, g8, cid_ext, rho_e,
                                          rho_l, ws, wc, *sub, _sub_band(f))
        cnt = f["count"]
        assert torch.equal(nc_k, nc_t)
        assert _rel(rho_k, rho_t) <= RHO_BAR
        assert _rel(acc_k, acc_t) <= ACC_BAR
        assert not nc_k[cnt:].any() and not rho_k[cnt:].any()
        assert torch.isfinite(acc_k).all()
        pairs += int(nc_k.sum())
        live += cnt
    assert pairs > 3 * live, "neighbors must be found"
    assert ss.density_ext_capped.launches == ss.force_ext_capped.launches \
        == len(frames[name])
    ss.density_ext_capped.launches = ss.force_ext_capped.launches = 0


@pytest.mark.parametrize("kernel", ["density", "force"])
def test_card_call_refuses_a_missing_table(frames, kernel, monkeypatch):
    """On the card (here: the kernel path forced for CPU tensors) a capped
    slab sweep without the sub frame's table raises before any library is
    built; it never falls back to the block walk."""
    cfg = _cfg("dam-w1")
    f = frames["dam-w1"][0]
    ext, cid_ext = torch.from_numpy(f["ext"]), torch.from_numpy(f["cid_ext"])
    ws, wc = torch.from_numpy(f["ws"]), torch.from_numpy(f["wc"])
    sub_src = torch.from_numpy(f["sub_src"])
    sub = (sub_src, torch.from_numpy(f["cand_cid"]),
           torch.from_numpy(f["w_sub"]), f["h_cap"], f["p_cap"])
    g8 = ext[sub_src.long()]
    monkeypatch.setattr(ss, "_use_plain", lambda x: False)
    monkeypatch.setattr(sw, "_kernels", None)  # a build would fail
    ss.density_ext_capped.launches = ss.force_ext_capped.launches = 0
    with pytest.raises(ValueError, match="cell-start table"):
        if kernel == "density":
            ss.density_local_capped(cfg, ext, g8, cid_ext, ws, wc, *sub)
        else:
            rho_e = torch.ones(ext.shape[0])
            ss.force_local_capped(cfg, ext, g8, cid_ext, rho_e,
                                  rho_e[:f["p_cap"]], ws, wc, *sub)
    assert ss.density_ext_capped.launches == 0
    assert ss.force_ext_capped.launches == 0


# ---------------------------------------------------------------------------
# walk_stats, the single-chip table, the lazy carry and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FRAMES)
def test_slab_sub_band_rows_per_lane_against_brute_force(frames, name):
    from test_torch_band import _brute_rows, _check_walk_stats

    cfg = _cfg(name)
    for _, f in _ranks(frames, name):
        cnt = f["count"]
        rows, union = _brute_rows(f["cid"][:cnt].astype(np.int64),
                                  f["cand_cid"][:_n_kept(f)].astype(np.int64),
                                  np.asarray(rod_deltas(cfg)))
        _check_walk_stats(slab_sub_band_rows_per_lane(cfg, _sub_band(f), cnt),
                          rows, union)


def test_world_one_table_is_the_single_chip_capped_table(frames):
    """At world size 1 the sub frame keeps, per cell, the single-chip sub
    frame's rows (K_c lowest hashes of the original id, which is the
    single-chip input row), so the two tables and rows per lane are equal;
    the own cids are the single-chip sorted cids."""
    job = _scene_job(1)
    cfg = job["cfg"]
    st = state_from_numpy(job["state"], "cpu")
    p = sw.prepare_t(cfg, st)
    f = frames["dam-w1"][0]
    np.testing.assert_array_equal(f["cell_start"], p.cell_start.numpy())
    np.testing.assert_array_equal(f["cid"][:f["count"]], p.cid.numpy())
    n_kept = _n_kept(f)
    slab_kept = f["ext"][f["sub_src"][:n_kept], OID].astype(np.int64)
    single_kept = p.order[p.sub_perm[:n_kept].long()].numpy()
    assert int(p.sub_dropped) == 0 and int((p.cand_cid >= 0).sum()) == n_kept
    np.testing.assert_array_equal(np.sort(slab_kept), np.sort(single_kept))
    assert slab_sub_band_rows_per_lane(cfg, _sub_band(f), f["count"]) == \
        band_rows_per_lane(cfg, p.cid, p.cell_start, st.n)


@pytest.mark.parametrize("world,fused", [(1, False), (1, True), (2, False),
                                         (2, True)])
def test_lazy_carry_freezes_the_sub_band_and_rebuilds_it_on_rebin(
        frames, world, fused):
    """Step 0 builds the table, steps 1-2 reuse the carry's (the same
    object), and the kick before step 3 forces a rebin that rebuilds it
    from the moved frame (fresh build equal), in two-pass and fused mode."""
    for recs in frames["lazy"][world, fused]:
        assert [r["need"] for r in recs] == [True, False, False, True]
        assert [r["same"] for r in recs] == [False, True, True, False]
        for r in recs:
            assert r["fresh_equal"]
        for r in recs[1:3]:
            for k in ("cell_start", "cid"):
                np.testing.assert_array_equal(r[k], recs[0][k])
        assert not np.array_equal(recs[3]["cell_start"], recs[0]["cell_start"])


@pytest.mark.parametrize("fused", [False, True])
def test_placeholder_tables_have_the_frame_layout(frames, fused):
    """``_table_zeros`` (the carry before its first rebin) lays out the
    capped tables as ``prepare_frame`` does: the ``SubBand`` after
    ``sub_dropped``, the fused pre-pass tables after it."""
    for recs in frames["lazy"][1, fused]:
        r = recs[0]
        assert r["layout"] == r["zero_layout"]
        assert len(r["layout"]) == (9 if fused else 7)
        assert r["layout"][6][0] == "SubBand"
