"""K2's test-and-drain counters (``force_band_t``'s ``stats``: the counters
``sweeps.force_pairs`` and ``sweeps.force_rounds``) and their twin
``walk_stats.drain_sums``.

On the CPU: ``drain_sums`` against a brute-force walk of each warp's
pieces (``band_walk.cuh``'s ``next_piece``, lane by lane, over a dense pair
matrix) on small exact and capped frames and on bands with no pair within
h, its pairs equal to K1's counts; K2's twin adds them to a counter and
sums the same accelerations with or without one; a profiled lazy solve
counts them once a bin, every K2 launch adding to them, while the fused
path (no K2) and an unprofiled solve count none.  On the card (skipped
without one): K2 against its twin and bit-equal over two launches, its
counters equal to the twin's and its pairs to K1's counts, on an exact 32k
frame, capped K_c 4, a slab-like frame whose self rows start at
``self_base > 0`` in the candidates, and bands with no hit.
"""

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState
from smoothed_particle_hydrodynamics_tpu_torch.utils import trace, walk_stats
from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
    resolve_sweep_settings)

torch.set_num_threads(1)

SPLASH = dict(cell_size_factor=1.25, pallas_window_t=64)
CAPPED = dict(capped_candidates=4, pallas_window_t=0, pallas_block_t=256)
ACC_BAR = 1e-4   # chip_smoke.py's bar for K2 against its twin


def _scene(n, capped=False, device="cpu", **kw):
    kw = {**SPLASH, "num_particles": n, **(CAPPED if capped else {}), **kw}
    cfg, st = make_scene("splash", device=device, **kw)
    return resolve_sweep_settings(cfg, st, kw), st


def _lattice(device="cpu"):
    """512 particles on a lattice of 1.5h in cells of 2h: every band holds
    rows, and no pair lies within h."""
    cfg, _ = make_scene("splash", device=device, num_particles=512,
                        cell_size_factor=2.0, pallas_window_t=64,
                        grid_nx=8, grid_ny=8, grid_nz=8)
    g = torch.arange(8, dtype=torch.float32)
    pos = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).view(-1, 3)
    pos = (pos * 1.5 + 0.5) * cfg.h
    st = ParticleState.from_arrays(pos.to(device),
                                   torch.zeros_like(pos).to(device), cfg=cfg)
    return cfg, st


def _k2_args(cfg, st, self_rows=None):
    """K2's arguments on ``st``'s bins (``_launch_force_band`` and
    ``force_t_plain`` take them, then ``self_base``), with K1's counts of
    the same bands.  ``self_rows`` (exact only): the self rows are that
    slice of the sorted frame and the candidates all of it, self row i's
    own id ``self_rows.start + i``, as in the slab engine."""
    p = sw.prepare_t(cfg, st)
    if cfg.capped_candidates:
        pos_c = p.pos_s[p.sub_perm]
        args_d = (cfg, p.pos_s, p.mass_s, p.cid, p.cell_start, pos_c,
                  p.wm_sub, p.sub_perm)
        rho, nc = sw.density_t_plain(*args_d)
        cand = sw.fused_cand_cols_plain(cfg, pos_c, p.vel_s[p.sub_perm],
                                        rho[p.sub_perm], p.wm_sub)
        return (cfg, p.pos_s, p.vel_s, rho, cand, p.cid, p.cell_start,
                p.sub_perm), 0, nc
    rho, _ = sw.density_t_plain(cfg, p.pos_s, p.mass_s, p.cid, p.cell_start,
                                p.pos_s, p.mass_s)
    cand = sw.fused_cand_cols_plain(cfg, p.pos_s, p.vel_s, rho, p.mass_s)
    rows = self_rows or slice(0, p.pos_s.shape[0])
    _, nc = sw.density_t_plain(cfg, p.pos_s[rows], p.mass_s[rows],
                               p.cid[rows], p.cell_start, p.pos_s, p.mass_s,
                               None, rows.start)
    return (cfg, p.pos_s[rows], p.vel_s[rows], rho[rows], cand, p.cid[rows],
            p.cell_start, None), rows.start, nc


def _brute_drains(args, self_base):
    """(pairs, rounds) of K2's walk, lane by lane: each warp's rods cut into
    pieces of ``FORCE_PIECE`` rows from the first row of the union of its
    lanes' non-empty bands, each piece costing the warp the most pairs of
    any one lane in it."""
    cfg, pos, _, _, cand, cid, cell_start, csrc = args
    a, e = (x.numpy() for x in sw.band_ranges(cfg, cid, cell_start))
    c = cand[:, 0:3]
    d = [c[None, :, k] - pos[:, None, k] for k in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    ids = (torch.arange(c.shape[0]) if csrc is None else csrc.long())
    own = torch.arange(self_base, self_base + pos.shape[0])
    pair = ((d2 < cfg.h2) & (ids[None] != own[:, None])).numpy()
    piece = sw.FORCE_PIECE[sw.EXCL_ROW if csrc is None else sw.EXCL_SRC]
    pairs = rounds = 0
    for w0 in range(0, pos.shape[0], walk_stats.WARP):
        lanes = range(w0, min(w0 + walk_stats.WARP, pos.shape[0]))
        for r in range(a.shape[1]):
            live = [i for i in lanes if e[i, r] > a[i, r]]
            if not live:
                continue
            lo = min(a[i, r] for i in live)
            hi = max(e[i, r] for i in live)
            for p0 in range(lo, hi, piece):
                p1 = min(p0 + piece, hi)
                hits = [int(pair[i, max(a[i, r], p0):min(e[i, r], p1)].sum())
                        for i in live]
                pairs += sum(hits)
                rounds += max(hits)
    return pairs, rounds


FRAMES = {
    "exact-768": lambda: _scene(768),
    "exact-700": lambda: _scene(700),
    "capped-kc4": lambda: _scene(1500, capped=True),
    "capped-kc2": lambda: _scene(1200, capped=True, capped_candidates=2,
                                 pallas_block_t=128),
    "no-hits": _lattice,
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_drain_sums_is_a_brute_force_walk_of_the_pieces(name):
    cfg, st = FRAMES[name]()
    args, base, nc = _k2_args(cfg, st)
    stats = torch.zeros(2, dtype=torch.int64)
    acc = sw.force_t_plain(*args, base, stats)
    pairs, rounds = _brute_drains(args, base)
    assert stats.tolist() == [pairs, rounds]
    assert pairs == int(nc.sum())
    if name == "no-hits":
        assert pairs == rounds == 0 and not acc.any()
    else:
        assert -(-pairs // walk_stats.WARP) <= rounds < pairs
    # the counter changes no sum
    assert torch.equal(acc, sw.force_t_plain(*args, base))


def test_drain_sums_on_a_slab_like_frame():
    """Self rows from row 300 of the candidates (``self_base`` 300): the
    warps are the self rows', the pairs skip each row's own id."""
    cfg, st = _scene(1000)
    args, base, nc = _k2_args(cfg, st, slice(300, 700))
    stats = torch.zeros(2, dtype=torch.int64)
    sw.force_t_plain(*args, base, stats)
    assert stats.tolist() == list(_brute_drains(args, base))
    assert int(stats[0]) == int(nc.sum()) > 0


def test_drain_sums_without_pairs_counts_nothing():
    a = torch.tensor([[0, 5], [2, 7]])
    e = torch.tensor([[4, 9], [6, 9]])
    none = torch.zeros(0, dtype=torch.long)
    got = walk_stats.drain_sums(a, e, none, none, 32)
    assert int(got["pairs"]) == int(got["rounds"]) == 0
    # two lanes of one warp: rod 0's union [0, 6) in pieces of 4 rows
    got = walk_stats.drain_sums(a, e, torch.tensor([0, 0, 1, 1, 1]),
                                torch.tensor([1, 3, 2, 3, 5]), 4)
    assert int(got["pairs"]) == 5
    assert int(got["rounds"]) == 2 + 1   # piece [0, 4): 2 and 2; [4, 8): 1


def _profiled_solve(capped, steps=6, fused=False):
    kw = dict(capped_fused=True) if fused else {}
    cfg, st = _scene(768, capped=capped, **kw)
    trace.take()
    carries = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        carry = lazy.init_lazy(cfg, st)
        carries.append(carry)
        for _ in range(steps):
            carry, _ = lazy.lazy_step(cfg, carry)
            carries.append(carry)
    return carries, trace.take()["counts"]


@pytest.mark.parametrize("capped", [False, True], ids=["exact", "capped"])
def test_a_profiled_solve_counts_every_k2_launch_once_a_bin(capped,
                                                            monkeypatch):
    """The counters' totals are the sums of K2's launches: its pairs those
    of K1's counts, step by step; each bin's counter counted once."""
    added = []
    twin = sw.force_t_plain

    def spy(*args, stats=None):
        before = stats.clone() if stats is not None else None
        out = twin(*args, stats=stats)
        if stats is not None:
            added.append(stats - before)
        return out

    monkeypatch.setattr(sw, "force_t_plain", spy)
    carries, counts = _profiled_solve(capped)
    bins = 1 + carries[-1].rebin_count
    pairs = sum(int(c.state.neighbor_count.sum()) for c in carries[1:])
    total = torch.stack(added).sum(0)
    assert len(added) == len(carries) - 1
    assert counts[sw.FORCE_PAIRS] == {"total": float(pairs), "times": bins}
    assert counts[sw.FORCE_ROUNDS] == {"total": float(total[1]),
                                       "times": bins}
    assert int(total[0]) == pairs > 0
    assert all(c.force_stats.shape == (2,) for c in carries)


def test_the_fused_path_and_an_unprofiled_solve_count_no_drain():
    carries, counts = _profiled_solve(True, steps=3, fused=True)
    assert not {sw.FORCE_PAIRS, sw.FORCE_ROUNDS} & set(counts)
    assert all(c.force_stats is None for c in carries)
    cfg, st = _scene(768)
    carry = lazy.init_lazy(cfg, st)
    carry, _ = lazy.lazy_step(cfg, carry)
    assert carry.force_stats is None
    assert trace.take()["counts"] == {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


CARD_FRAMES = {
    "exact-32k": lambda dev: (*_scene(32768, device=dev), None),
    "capped-kc4": lambda dev: (*_scene(32768, capped=True, device=dev),
                               None),
    "slab-self-base": lambda dev: (*_scene(32768, device=dev),
                                   slice(5000, 20000)),
    "no-hits": lambda dev: (*_lattice(dev), None),
}


@pytest.mark.card
@pytest.mark.parametrize("name", list(CARD_FRAMES))
def test_k2_on_the_card_against_its_twin_and_counters(card, name):
    cfg, st, rows = CARD_FRAMES[name](card)
    args, base, nc = _k2_args(cfg, st, rows)
    kernel = "force_band_t<capped>" if cfg.capped_candidates else \
        "force_band_t"
    stats = torch.zeros(2, dtype=torch.int64, device=card)
    acc = sw._launch_force_band(*args, base, stats, kernel=kernel)
    again = sw._launch_force_band(*args, base, kernel=kernel)
    twin_stats = torch.zeros(2, dtype=torch.int64, device=card)
    twin = sw.force_t_plain(*args, base, twin_stats)
    torch.cuda.synchronize()
    assert torch.equal(acc, again)
    assert stats.tolist() == twin_stats.tolist()
    assert int(stats[0]) == int(nc.sum())
    if name == "no-hits":
        assert stats.tolist() == [0, 0] and not acc.any() and not twin.any()
    else:
        rel = float((acc - twin).norm() / twin.norm())
        assert rel <= ACC_BAR
        assert 0 < int(stats[1]) < int(stats[0])
        assert np.isfinite(acc.cpu().numpy()).all()
