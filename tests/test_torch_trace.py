"""The port's spans and counters (``utils/trace.py``) in the lazy step.

Off (no profiler), nothing records and no CUDA call is made.  Under
``torch.profiler`` on the CPU, an 8-step lazy solve of the 768-particle
splash (one rebin, at step 6) records the step's six spans with their
parents and step ids; their host intervals, on the profiler's axis, hold
the aten events they issue and tile ``driver.step``; none of them shows
among the profiler's events, whose top-level aten ops are those of a run
with recording suppressed.  ``sweeps.rows_tested`` is ``walk_stats``'
count of the same bins, counted once by each band sweep over them (K1
and K2, or the fused path's K3); ``sweeps_t.band_rows_t``'s plain twin is
``band_stats``' warp union on exact and capped frames.  In capped mode
(a 6-step solve, a rebin forced at step 4) ``binning.prepare`` and
``sweeps.sorted`` are tiled by their children, the exact solve's span tree
is unchanged, and ``capped.kept_rows`` is ``_sub_frame``'s kept count of
each step's bins, counted once a step.  The stream intervals and the
counter's kernel need a card.
"""

from types import SimpleNamespace

import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy
from smoothed_particle_hydrodynamics_tpu_torch.ops.sweeps_t import (
    KEPT_ROWS, ROWS_TESTED, _run_rank_occ, band_ranges, band_rows_t,
    band_rows_t_plain, capped_span, prepare_t)
from smoothed_particle_hydrodynamics_tpu_torch.utils import trace, walk_stats
from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
    resolve_sweep_settings)

torch.set_num_threads(1)

STEPS = 8
SPLASH = dict(num_particles=768, cell_size_factor=1.25, pallas_window_t=64)
CHILDREN = {"driver.drift_read", "sweeps.sorted", "integrate.kdk",
            "diagnostics.step", "binning.prepare", "trace.rows_tested"}


def _solve(steps=STEPS):
    """The lazy solve step by step: the carry after each step."""
    cfg, st = make_scene("splash", device="cpu", **SPLASH)
    carry = lazy.init_lazy(cfg, st)
    carries = [carry]
    for _ in range(steps):
        carry, _ = lazy.lazy_step(cfg, carry)
        carries.append(carry)
    return cfg, carries


def _profiled(steps=STEPS):
    """(cfg, carries, the profiler's events, what trace.take() returned,
    the trace's start in ns)."""
    trace.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cfg, carries = _solve(steps)
    got = trace.take()
    return (cfg, carries, prof.events(), got,
            prof.profiler.kineto_results.trace_start_ns())


@pytest.fixture(scope="module")
def profiled():
    return _profiled()


def test_off_records_nothing_and_makes_no_cuda_call(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call while not recording")

    for name in ("Event", "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    trace.take()
    assert not trace.recording()
    dev = torch.device("cuda")
    assert trace.span("driver.step", dev) is trace.span("x", None)
    with trace.span("driver.step", dev):
        trace.count(ROWS_TESTED, torch.zeros((), dtype=torch.int64))
    _, carries = _solve(3)
    assert all(c.rows_tested is None for c in carries)
    assert trace.take() == {"spans": [], "counts": {}, "dropped": 0}


def test_a_profiled_lazy_solve_records_the_spans(profiled):
    cfg, carries, _, got, _ = profiled
    spans = got["spans"]
    assert got["dropped"] == 0
    assert carries[-1].rebin_count == 1      # one rebin in the solve
    names = {s["name"] for s in spans}
    assert names == CHILDREN | {"driver.step"}
    steps = [s for s in spans if s["name"] == "driver.step"]
    assert [s["step"] for s in steps] == list(range(1, STEPS + 1))
    assert all(s["parent"] is None and s["up"] == -1 for s in steps)
    for s in spans:
        if s["up"] >= 0:
            up = spans[s["up"]]
            assert up["name"] == s["parent"] == "driver.step"
            assert s["step"] == up["step"]
    kids = {}
    for s in spans:
        if s["parent"] == "driver.step":
            kids.setdefault(s["step"], []).append(s["name"])
    every = ["driver.drift_read", "sweeps.sorted", "integrate.kdk",
             "diagnostics.step"]
    rebin = ["driver.drift_read", "binning.prepare", "trace.rows_tested"] + \
        every[1:]
    assert sum(k == rebin for k in kids.values()) == 1
    assert all(k in (every, rebin) for k in kids.values())
    # the initial binning opens before the first step, outside any step
    first = [s["name"] for s in spans[:2]]
    assert first == ["binning.prepare", "trace.rows_tested"]
    assert spans[0]["step"] is None and spans[0]["parent"] is None
    assert all(s["stream_ms"] is None for s in spans)   # no card


def _aten(events):
    return [e for e in events if e.cpu_parent is None
            and e.name.startswith("aten::")]


def test_host_intervals_hold_their_aten_events(profiled):
    """On the profiler's axis (µs from its trace start), no span boundary
    cuts an aten event, every aten event inside a step lies inside one of
    the step's children, and every child that computes holds some."""
    _, _, events, got, origin = profiled
    spans = got["spans"]

    def us(s):
        return ((s["host_ns"][0] - origin) * 1e-3,
                (s["host_ns"][1] - origin) * 1e-3)

    held = {i: 0 for i in range(len(spans))}
    for e in _aten(events):
        a, b = e.time_range.start, e.time_range.end
        for i, s in enumerate(spans):
            lo, hi = us(s)
            assert not (a < lo < b or a < hi < b), (e.name, s["name"])
            if lo <= a and b <= hi:
                held[i] += 1
        step = [i for i, s in enumerate(spans) if s["name"] == "driver.step"
                and us(s)[0] <= a and b <= us(s)[1]]
        if step:
            kids = [i for i, s in enumerate(spans) if s["up"] == step[0]]
            assert any(us(spans[i])[0] <= a and b <= us(spans[i])[1]
                       for i in kids), e.name
    for i, s in enumerate(spans):
        if s["name"] in CHILDREN - {"trace.rows_tested"}:
            assert held[i] > 0, s["name"]
        if s["name"] == "trace.rows_tested":
            assert held[i] == 0   # the counter's ops are hidden


def test_spans_add_no_profiler_event_and_keep_the_host_ops(profiled,
                                                           monkeypatch):
    _, _, events, got, _ = profiled
    names = {s["name"] for s in got["spans"]}
    assert not names & {e.name for e in events}
    # the same solve with recording suppressed: the same top-level aten ops
    monkeypatch.setattr(trace, "_profiler",
                        SimpleNamespace(_is_profiler_enabled=False))
    _, carries, quiet, none, _ = _profiled()
    assert none["spans"] == [] and none["counts"] == {}
    assert carries[-1].rows_tested is None
    assert ([e.name for e in _aten(quiet)]
            == [e.name for e in _aten(events)])


def test_rows_tested_is_walk_stats_count_of_the_same_bins(profiled):
    cfg, carries, _, got, _ = profiled
    want = times = 0
    for c in carries[1:]:    # each step sweeps its carry's bins twice
        s = walk_stats.band_stats(*band_ranges(cfg, c.cid, c.cell_start),
                                  c.cid.shape[0])
        warps = -(-c.cid.shape[0] // walk_stats.WARP)
        want += 2 * walk_stats.WARP * warps * s["warp_union"]
        times += 2
        assert int(c.rows_tested) == round(
            walk_stats.WARP * warps * s["warp_union"])
    c = got["counts"][ROWS_TESTED]
    assert c["times"] == times == 2 * STEPS
    assert c["total"] == pytest.approx(want, rel=1e-12)


CAPPED = dict(capped_candidates=4, pallas_window_t=0)


@pytest.mark.parametrize("kw,sweeps", [
    (CAPPED, 2), (dict(CAPPED, capped_fused=True), 1)],
    ids=["capped", "fused"])
def test_each_band_sweep_counts_its_bins_rows(kw, sweeps):
    """Capped K1 and K2 each count the rows of their bins (exact: the
    profiled solve above); the fused path's K3 does, and its pre-pass,
    which walks the sub frame's own bands, not."""
    kw = dict(SPLASH, **kw)
    cfg, st = make_scene("splash", device="cpu", **kw)
    cfg = resolve_sweep_settings(cfg, st, kw)
    trace.take()
    want, steps = 0, 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        carry = lazy.init_lazy(cfg, st)
        for _ in range(steps):
            carry, _ = lazy.lazy_step(cfg, carry)
            want += sweeps * int(carry.rows_tested)
    c = trace.take()["counts"][ROWS_TESTED]
    assert c["times"] == sweeps * steps
    assert c["total"] == want > 0


CAPPED_KIDS = {
    "binning.prepare": {"binning.sort", "binning.capped_sub",
                        "binning.tables"},
    "sweeps.sorted": {"sweeps.capped_gather", "sweeps.walks", "sweeps.body"}}
FORCED = 4   # the capped solve's forced rebin, before this step's sweeps


def _capped_solve(steps=6):
    """The capped lazy solve of the 768-particle splash, a rebin forced at
    step ``FORCED`` (one row's bin position moved far off): the carry after
    each step."""
    kw = dict(SPLASH, **CAPPED)
    cfg, st = make_scene("splash", device="cpu", **kw)
    cfg = resolve_sweep_settings(cfg, st, kw)
    carry = lazy.init_lazy(cfg, st)
    carries = [carry]
    for k in range(steps):
        if k == FORCED:
            far = carry.pos_bin.clone()
            far[0] += 4.0 * cfg.cell_size
            carry = carry._replace(pos_bin=far)
        carry, _ = lazy.lazy_step(cfg, carry)
        carries.append(carry)
    return cfg, carries


@pytest.fixture(scope="module")
def profiled_capped():
    trace.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cfg, carries = _capped_solve()
    got = trace.take()
    return (cfg, carries, prof.events(), got,
            prof.profiler.kineto_results.trace_start_ns())


def test_a_profiled_capped_solve_tiles_binning_and_sweeps(profiled_capped):
    """Capped mode: ``binning.prepare`` holds ``binning.sort``,
    ``binning.capped_sub`` and ``binning.tables`` in that order, and
    ``sweeps.sorted`` the gathers, the walks and the body (K1's gather, K1,
    K2's gather and columns, K2, gravity and CFL); every aten event inside
    either lies inside one of its children, and every child holds some."""
    _, carries, events, got, origin = profiled_capped
    spans = got["spans"]
    assert got["dropped"] == 0
    assert carries[FORCED + 1].rebin_count > carries[FORCED].rebin_count
    names = {s["name"] for s in spans}
    assert names == (CHILDREN | {"driver.step"}
                     | set().union(*CAPPED_KIDS.values()))
    kids = {}
    for i, s in enumerate(spans):
        if s["parent"] in CAPPED_KIDS:
            assert spans[s["up"]]["name"] == s["parent"]
            assert s["step"] == spans[s["up"]]["step"]
            kids.setdefault(s["up"], []).append(s["name"])
    prepares = [i for i, s in enumerate(spans)
                if s["name"] == "binning.prepare"]
    sweeps = [i for i, s in enumerate(spans) if s["name"] == "sweeps.sorted"]
    assert len(prepares) == 1 + carries[-1].rebin_count
    assert len(sweeps) == len(carries) - 1
    for i in prepares:
        assert kids[i] == ["binning.sort", "binning.capped_sub",
                           "binning.tables"]
    for i in sweeps:
        assert kids[i] == ["sweeps.capped_gather", "sweeps.walks",
                           "sweeps.capped_gather", "sweeps.walks",
                           "sweeps.body"]

    def us(s):
        return ((s["host_ns"][0] - origin) * 1e-3,
                (s["host_ns"][1] - origin) * 1e-3)

    held = {i: 0 for i in range(len(spans))}
    for e in _aten(events):
        a, b = e.time_range.start, e.time_range.end
        for i, s in enumerate(spans):
            lo, hi = us(s)
            assert not (a < lo < b or a < hi < b), (e.name, s["name"])
            if lo <= a and b <= hi:
                held[i] += 1
        for i in prepares + sweeps:
            lo, hi = us(spans[i])
            if lo <= a and b <= hi:
                assert any(us(spans[j])[0] <= a and b <= us(spans[j])[1]
                           for j, s in enumerate(spans) if s["up"] == i), \
                    (e.name, spans[i]["name"])
    for i, s in enumerate(spans):
        if s["parent"] in CAPPED_KIDS:
            assert held[i] > 0, s["name"]


def test_capped_spans_add_no_profiler_event_and_keep_the_host_ops(
        profiled_capped, monkeypatch):
    """The capped spans and the kept-rows counter's work (hidden) leave the
    profiler's top-level aten ops those of the solve not recording."""
    _, _, events, got, _ = profiled_capped
    assert not {s["name"] for s in got["spans"]} & {e.name for e in events}
    monkeypatch.setattr(trace, "_profiler",
                        SimpleNamespace(_is_profiler_enabled=False))
    trace.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, carries = _capped_solve()
    assert trace.take() == {"spans": [], "counts": {}, "dropped": 0}
    assert all(c.kept_rows is None and c.rows_tested is None
               for c in carries)
    assert ([e.name for e in _aten(prof.events())]
            == [e.name for e in _aten(events)])


def test_kept_rows_is_the_sub_frame_s_kept_count(profiled_capped):
    """``capped.kept_rows``: each step counts once the kept rows of the
    bins it used, ``_sub_frame``'s ``keep.sum()`` of the same bins."""
    cfg, carries, _, got, _ = profiled_capped
    want = 0
    for c in carries[1:]:
        rank, _ = _run_rank_occ(c.cid)
        kept = int((rank < cfg.capped_candidates).sum())
        assert c.kept_rows.dtype == torch.int64 and c.kept_rows.dim() == 0
        assert int(c.kept_rows) == kept > 0
        want += kept
    assert got["counts"][KEPT_ROWS] == {"total": float(want),
                                        "times": len(carries) - 1}


def test_a_profiled_exact_solve_keeps_its_span_tree(profiled):
    """Exact mode: the span names of the tracing's first design, no span
    under ``binning.prepare`` or ``sweeps.sorted``, and no kept-rows
    count."""
    _, carries, _, got, _ = profiled
    spans = got["spans"]
    assert {s["name"] for s in spans} == CHILDREN | {"driver.step"}
    assert {s["parent"] for s in spans} == {None, "driver.step"}
    assert set(got["counts"]) == {ROWS_TESTED}
    assert all(c.kept_rows is None and c.bin_from is None for c in carries)


def test_off_records_nothing_in_capped_mode(monkeypatch):
    """Unprofiled, the capped spans and counter record nothing and make no
    CUDA call; no carry keeps a count."""
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call while not recording")

    for name in ("Event", "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    trace.take()
    assert not trace.recording()
    cfg, carries = _capped_solve()
    assert all(c.kept_rows is None and c.rows_tested is None
               for c in carries)
    assert capped_span(cfg, "sweeps.walks", torch.device("cuda")) \
        is trace.span("x", None)
    assert trace.take() == {"spans": [], "counts": {}, "dropped": 0}


def _frame(capped, n, device="cpu"):
    kw = dict(SPLASH, num_particles=n)
    if capped:
        kw.update(CAPPED)
    cfg, st = make_scene("splash", device=device, **kw)
    cfg = resolve_sweep_settings(cfg, st, kw)
    p = prepare_t(cfg, st)
    return cfg, p, p.sub_perm.shape[0] if capped else n


@pytest.mark.parametrize("capped", [False, True], ids=["exact", "capped"])
@pytest.mark.parametrize("n", [700, 768])
def test_band_rows_t_plain_is_band_stats_warp_union(capped, n):
    cfg, p, m = _frame(capped, n)
    s = walk_stats.band_sums(*band_ranges(cfg, p.cid, p.cell_start), m)
    got = band_rows_t_plain(cfg, p.cid, p.cell_start, m)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == walk_stats.WARP * int(s["warp_union"]) > 0
    assert s["warps"] == -(-n // walk_stats.WARP) and s["n"] == n
    assert torch.equal(band_rows_t(cfg, p.cid, p.cell_start, m), got)


@pytest.mark.card
@pytest.mark.parametrize("capped", [False, True], ids=["exact", "capped"])
def test_band_rows_t_kernel_on_the_card(capped):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg, p, m = _frame(capped, 700, device="cuda")
    got = band_rows_t(cfg, p.cid, p.cell_start, m)
    assert got.device.type == "cuda" and got.dtype == torch.int64
    want = band_rows_t_plain(cfg, p.cid.cpu(), p.cell_start.cpu(), m)
    assert int(got) == int(want) > 0


def _span(name, up, t0, t1):
    return {"name": name, "up": up, "host_ns": (t0, t1)}


def test_gaps_by_span_puts_each_gap_to_the_innermost_span():
    origin = 10**18
    ms = 10**6   # ns
    spans = [_span("driver.step", -1, origin + 10 * ms, origin + 50 * ms),
             _span("driver.drift_read", 0, origin + 10 * ms,
                   origin + 20 * ms),
             _span("sweeps.sorted", 0, origin + 22 * ms, origin + 40 * ms),
             _span("driver.step", -1, origin + 60 * ms, origin + 90 * ms),
             _span("integrate.kdk", 3, origin + 61 * ms, origin + 70 * ms)]
    dev = [(0.000, 0.005), (0.004, 0.011),     # merged: 0-11 ms
           (0.013, 0.014),                     # gap 11-13: drift_read
           (0.016, 0.030),                     # gap 14-16: drift_read
           (0.032, 0.033),                     # gap 30-32: sweeps.sorted
           (0.041, 0.042),                     # gap 33-41: mid 37, sweeps
           (0.053, 0.054),                     # gap 42-53: mid 47.5, step
           (0.100, 0.101),                     # gap 54-100: mid 77, step
           (0.140, 0.150)]                     # gap 101-140: outside
    gaps = trace.gaps_by_span(dev, spans, origin)
    assert gaps == pytest.approx({"driver.drift_read": 0.004,
                                  "sweeps.sorted": 0.010,
                                  "driver.step": 0.057,
                                  trace.OUTSIDE: 0.039})
    assert trace.gaps_by_span([], spans, origin) == {}


def test_count_keeps_a_recounted_scalar_once(monkeypatch):
    monkeypatch.setattr(trace, "_profiler",
                        SimpleNamespace(_is_profiler_enabled=True))
    trace.take()
    a, b = torch.tensor(5), torch.tensor(7)
    for v in (a, a, a, b, None, b):
        trace.count("c", v)
    trace.count("d", 1.5)
    assert [k for _, k in trace._counts["c"]] == [3, 2]
    got = trace.take()["counts"]
    assert got == {"c": {"total": 29.0, "times": 5},
                   "d": {"total": 1.5, "times": 1}}


@pytest.mark.card
def test_event_stamps_on_the_card():
    """Stream intervals on the card: a root's open and each leaf's close
    record an event, every other boundary shares the one before it; a
    leaf's interval covers its sleep; the host intervals sit on the
    profiler's axis around the kernels' launches."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize()
    trace.take()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with trace.span("driver.step", dev):
                with trace.span("a", dev):
                    torch.cuda._sleep(2_000_000)
                with trace.span("b", dev):
                    y = x * 2
                    torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    got = trace.take()
    origin = prof.profiler.kineto_results.trace_start_ns()
    spans = got["spans"]
    assert [s["name"] for s in spans] == ["driver.step", "a", "b"] * 3
    prev_end = -1.0
    for k in range(3):
        step, a, b = spans[3 * k:3 * k + 3]
        assert step["stream_ms"][0] == a["stream_ms"][0]
        assert a["stream_ms"][1] == b["stream_ms"][0]
        assert b["stream_ms"][1] == step["stream_ms"][1]
        assert step["stream_ms"][0] >= prev_end
        prev_end = step["stream_ms"][1]
        for s in (a, b):
            assert s["stream_ms"][1] - s["stream_ms"][0] > 0.1
    assert spans[0]["stream_ms"][0] == 0.0
    names = {s["name"] for s in spans}
    events = prof.events()
    assert not names & {e.name for e in events}
    muls = [e for e in events if e.name == "aten::mul"]
    bs = [s for s in spans if s["name"] == "b"]
    assert len(muls) == 3
    for e, s in zip(muls, bs):
        lo = (s["host_ns"][0] - origin) * 1e-3
        hi = (s["host_ns"][1] - origin) * 1e-3
        assert lo <= e.time_range.start and e.time_range.end <= hi
    assert float(y[0]) == 2.0


def _event(cuda, a, b, parent=None):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=a, end=b), cpu_parent=parent)


def test_profile_step_joins_the_spans_with_the_trace():
    """``profile_step.span_report`` on a synthetic trace (µs from the trace
    start): per span host and stream ms a step, the idle gaps by span, and
    those between top-level host events apart."""
    from smoothed_particle_hydrodynamics_tpu_torch.utils import profile_step

    origin = 5 * 10**17
    us = 1000   # ns
    spans = [dict(_span("driver.step", -1, origin, origin + 100 * us),
                  stream_ms=(0.0, 0.1), parent=None),
             dict(_span("sweeps.sorted", 0, origin + 10 * us,
                        origin + 60 * us),
                  stream_ms=(0.0, 0.07), parent="driver.step")]
    taken = {"spans": spans, "counts": {"c": {"total": 4.0, "times": 2}},
             "dropped": 0}
    events = [_event(True, 0, 20), _event(True, 30, 40),   # gap 20-30
              _event(True, 50, 70), _event(True, 80, 90),  # 40-50, 70-80
              _event(False, 22, 28),                       # holds 25
              _event(False, 44, 46, parent=object())]      # not top-level
    r = profile_step.span_report(taken, events, 2, origin)
    assert r["span_host_ms_per_step"] == pytest.approx(
        {"driver.step": 0.05, "sweeps.sorted": 0.025})
    assert r["span_stream_ms_per_step"] == pytest.approx(
        {"driver.step": 0.05, "sweeps.sorted": 0.035})
    assert r["idle_ms_per_step_by_span"] == pytest.approx(
        {"sweeps.sorted": 0.01, "driver.step": 0.005})
    assert r["idle_between_host_events_ms_per_step_by_span"] == \
        pytest.approx({"sweeps.sorted": 0.005, "driver.step": 0.005})
    assert r["counters"] == taken["counts"] and r["spans_dropped"] == 0
