"""``chip_smoke.py`` leaves no process of its own running when it ends.

Its slab phases start ranks through ``spawn_ranks`` with the ``spawn``
method, which starts multiprocessing's resource tracker as a child of the
script.  ``chip_smoke.stop_resource_tracker`` (run on every exit) must stop
and reap it.  On the CPU, with gloo ranks, in a subprocess so that this
test process's own tracker is left alone.  ``utils/leftover.py``, which
reports the processes that outlive a command, and the script's run without
a card under it.
"""

import json

import pytest
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import operator
import os

from multiprocessing import resource_tracker

import chip_smoke
from smoothed_particle_hydrodynamics_tpu_torch.parallel.comm import spawn_ranks

assert spawn_ranks(2, operator.truth, backend="gloo",
                   timeout_s=120) == [True, True]
pid = resource_tracker._resource_tracker._pid
os.kill(pid, 0)   # the tracker outlived the ranks
chip_smoke.stop_resource_tracker()
try:
    os.kill(pid, 0)
except ProcessLookupError:
    print("reaped", pid)
else:
    print("running", pid)
"""


def test_stop_resource_tracker_reaps_the_spawned_ranks_tracker():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("reaped "), out.stdout
    assert "leaked" not in out.stderr, out.stderr


def leftover(*cmd: str) -> tuple[int, dict]:
    out = subprocess.run(
        [sys.executable, "-m",
         "smoothed_particle_hydrodynamics_tpu_torch.utils.leftover", "--",
         *cmd], cwd=ROOT, capture_output=True, text=True, timeout=240)
    return out.returncode, json.loads(out.stdout.splitlines()[-1])


def test_leftover_reports_a_process_that_outlives_its_command():
    rc, rep = leftover("sh", "-c", "sleep 1 & exit 0")
    left = rep["after_exit"][0]["left"]
    assert rc == 1 and rep["rc"] == 0
    assert [line for _, _, line in left.values()] == ["sleep 1"]
    assert not rep["after_exit"][-1]["left"]


def test_leftover_passes_a_command_that_leaves_nothing():
    rc, rep = leftover("sh", "-c", "sleep 0.3; exit 3")
    assert rc == 3 and rep["rc"] == 3
    assert rep["after_exit"] == [{"t": 0.0, "left": {}}]
    assert "sleep 0.3" in rep["seen"].values()


def test_chip_smoke_without_cuda_exits_1_and_leaves_nothing():
    rc, rep = leftover(sys.executable, "chip_smoke.py")
    assert rc == 1 and rep["rc"] == 1
    assert rep["after_exit"] == [{"t": 0.0, "left": {}}]


def test_floor_kernels_are_listed_with_the_tpu_kernel_they_replace():
    """The floor probe's two kernels in ``KERNELS`` and ``PROBE_KERNELS``:
    built from ``csrc/floor_t.cu`` (in ``LIBRARIES``), each wrapper counted,
    and ``replaces`` naming the line of the JAX tool's ``_probe_kernel``."""
    import chip_smoke as cs

    assert "floor_t" in cs.LIBRARIES
    for name in cs.FLOOR_KERNELS:
        k = cs.KERNELS[name]
        assert name in cs.PROBE_KERNELS and k.module == "floor"
        assert (ROOT / k.source).exists() and k.source == cs.SOURCE_FLOOR
        path, line = k.replaces.split(":")
        src = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert src.startswith("def _probe_kernel("), src
        assert hasattr(cs.wrapper(name), "launches")
        assert callable(getattr(cs._module(name), k.twin))


# ---------------------------------------------------------------------------
# phase 17's helpers on the CPU, at small sizes (on the card they compare
# the card's results with the CPU's; here both sides run on the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    """``chip_smoke`` with the card's fences stubbed and the CLI and the
    benchmark on the CPU."""
    import torch

    import chip_smoke
    from smoothed_particle_hydrodynamics_tpu_torch import __main__ as tmain
    from smoothed_particle_hydrodynamics_tpu_torch.utils import benchmark

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tmain, "_device", lambda name: torch.device("cpu"))
    monkeypatch.setattr(benchmark, "_device",
                        lambda name: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "EXAMPLE_ARGS", ["--device", "cpu"])
    return chip_smoke, torch.device("cpu")


def test_phase17_renders_agree_across_devices(smoke, monkeypatch, capsys):
    cs, dev = smoke
    monkeypatch.setattr(cs, "RENDER_SCENE", dict(num_particles=20_000))
    monkeypatch.setattr(cs, "RENDER_REPS", 1)
    ms = cs.render_checks(dev)
    assert set(ms) == {"ortho", "voxels", "persp", "persp az135",
                       "persp no box"}
    out = capsys.readouterr().out
    assert "'persp az135': 0" in out and "cloud 20000" in out


def test_phase17_compat_and_parity(smoke, monkeypatch, tmp_path, capsys):
    """The compat checks at 2,048 particles: tables and steps on the two
    sides, ``run --compat --exact-ic`` and ``parity`` on dumps of the
    trajectory (profile_step needs the card: its line is stood in)."""
    import json as _json

    from smoothed_particle_hydrodynamics_tpu_torch.utils import profile_step

    cs, dev = smoke
    monkeypatch.setattr(cs, "COMPAT_N", 2048)
    monkeypatch.setattr(cs, "COMPAT_STEPS", 2)
    monkeypatch.setattr(cs, "CLI_COMPAT_STEPS", 3)
    monkeypatch.setattr(cs, "CLI_COMPAT", ["--compat", "--exact-ic",
                                           "--steps", "3", "-n", "2048"])
    monkeypatch.setattr(profile_step, "main", lambda argv: print(_json.dumps(
        {"untraced_ms_per_step": [1.0], "traced_ms_per_step": 1.0,
         "device_busy_ms_per_step": 0.5, "device_busy_share": 0.5,
         "host_aten_ops_per_step": 1.0, "top_kernels_ms_per_step": {}})))
    cs.compat_checks(dev, str(tmp_path))
    out = capsys.readouterr().out
    assert "PASS" in out and "neighbor ids, counts and stored distances" \
        in out


def test_phase17_examples(smoke, tmp_path, capsys):
    import os

    cs, dev = smoke
    here = os.getcwd()
    cs.examples_checks(dev, str(tmp_path))
    assert os.getcwd() == here and "SPH_EXAMPLE_QUICK" not in os.environ
    out = capsys.readouterr().out
    assert "[examples] quickstart" in out and "[examples] custom_scene" in out
    assert (tmp_path / "quickstart" / "quickstart_final.png").exists()


# ---------------------------------------------------------------------------
# phase 18's helpers on the CPU, at small sizes: gloo ranks on the CPU, the
# slab kernels' twins (uncounted) in place of the kernels
# ---------------------------------------------------------------------------

def test_phase18_runs_three_way_and_staging(smoke, monkeypatch, tmp_path,
                                            capsys):
    cs, dev = smoke
    monkeypatch.setattr(cs, "DEV_N", 2048)
    monkeypatch.setattr(cs, "DEV_SCENE_NAME", "dam_break")
    monkeypatch.setattr(cs, "DEV_SCENE", dict(
        cell_size_factor=1.25, grid_nx=16, grid_ny=16, grid_nz=16,
        pallas_window_t=64))
    monkeypatch.setattr(cs, "DEV_STEPS", 4)
    monkeypatch.setattr(cs, "DEV_BLOCK", 2)
    monkeypatch.setattr(cs, "DEV_RESUME", 2)
    monkeypatch.setattr(cs, "DEV_HALO_STEPS", 2)
    monkeypatch.setattr(cs, "STAGING_STEPS", 2)
    ms = cs.dev_cli_checks(dev, str(tmp_path))
    cs.dev_library_checks(dev)
    cs.dev_nccl(dev, str(tmp_path))
    out = capsys.readouterr().out
    assert set(ms) == {"slab exact", "slab capped", "slab fused", "turns",
                       "halo"}
    assert [k for k, _ in ms["turns"]] == ["single", "slab", "slab",
                                           "single"]
    for label in ("slab exact", "slab capped", "slab fused",
                  "slab fused resume", "halo"):
        assert f"[devices {label}]" in out
    assert "derived slab sub_len=" in out
    assert out.count("[devices three-way 1M]") == 2
    assert out.count("[devices staging] rank") == 2
    assert "NCCL at --devices 2: not run (0 cards" in out


# ---------------------------------------------------------------------------
# phase 15's floor checks and phase 19's probes on the CPU, at small sizes
# (the plain versions on both sides; the CPU launches no kernel, so the
# launch checks are the ones left to fail)
# ---------------------------------------------------------------------------

def test_phase15_floor_checks_and_phase19_probes(smoke, monkeypatch, capsys):
    import functools

    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_cond, probe_dispatch, probe_dma_floor, probe_scan, probe_tally)

    cs, dev = smoke
    failed = []
    monkeypatch.setattr(cs, "check", lambda ok, what: ok or failed.append(
        what))
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=1, warmup=0: (
        fn(), 1.0)[1])
    monkeypatch.setattr(cs, "FLOOR_CASES", ((1024, 0, None, (2,)),
                                            (1024, 4, None, (2,)),
                                            (2048, 0, ("full", "nostage"),
                                             (2,))))
    errs, recs = cs.floor_vs_plain(dev)
    assert not failed and set(errs) == set(recs) == set(cs.FLOOR_KERNELS)
    for rec in recs.values():
        assert rec["library_ms"] is None and rec["bound_ms"] > 0
        assert rec["bound_by"] in ("bytes", "operations")
    small = dict(n=512, iters=1)
    for mod, kw in ((probe_dma_floor, small), (probe_cond, dict(
            n=512, rounds=1)), (probe_dispatch, small), (probe_tally, small)):
        monkeypatch.setattr(mod, "main", functools.partial(mod.main, **kw))
    monkeypatch.setattr(probe_scan, "main", functools.partial(
        probe_scan.main, k=2, rounds=1))
    monkeypatch.setattr(cs, "SCAN_CASES", ((512, "disk"), (512, "splash")))
    r = cs.tools_probes(dev)
    assert failed == [f"probe_dma_floor: {n} launched"
                      for n in cs.FLOOR_KERNELS]
    assert set(r["probes"]) == {
        "probe_dma_floor K_c=0", "probe_dma_floor K_c=4", "probe_cond",
        "probe_scan disk", "probe_scan splash", "probe_dispatch",
        "probe_tally"}
    out = capsys.readouterr().out
    assert out.count("[probe floor") == 3 * 3 + 3 * 3 + 3 * 2


def test_floor_bounds_are_the_tools_issue_count(smoke, monkeypatch, capsys):
    """The kernels line's bound of both floor kernels: the floor probe's
    own count (``ladder_ops``, K + 2 lane instructions a tested lane-row)
    at the card's issue rate (``issue_ms``), beside each input read once;
    the tool's row at the same case carries the same number.  The card is
    stood in by an H100's 132 SMs at 1.98 GHz."""
    import torch

    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_dma_floor as pf)

    cs, dev = smoke
    card = dict(name="NVIDIA H100 80GB HBM3", sms=132, clock_hz=1.98e9)
    monkeypatch.setattr(pf, "card", lambda index=0: card)
    issue = pf.issue_ms
    monkeypatch.setattr(pf, "issue_ms", lambda ops, d: issue(
        ops, torch.device("cuda")))
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=1, warmup=0: (
        fn(), 1.0)[1])
    monkeypatch.setattr(cs, "FLOOR_CASES", ((2048, 0, ("full",), (2,)),))
    _, recs = cs.floor_vs_plain(dev)
    r = pf.main(n=2048, k_c=0, device=dev, iters=1)
    cfg, p = pf.setup(2048, 0, dev)
    walks = pf.walks(cfg, p)
    rate = 128 * 132 * 1.98e9
    for name, walk in (("floor_window_t", "window"),
                       ("floor_band_t", "band W4")):
        rec, tool = recs[name], r["rows"][f"{walk} full K=2"]["issue_ms"]
        assert tool == pytest.approx(walks[walk]["tested"] * 4 / rate * 1e3,
                                     rel=1e-12)
        assert rec["bound_ops_ms"] == pytest.approx(tool, rel=1e-12)
        assert rec["bound_ms"] == max(rec["bound_ops_ms"],
                                      rec["bound_bytes_ms"])
        assert rec["bound_by"] == ("operations" if rec["bound_ops_ms"]
                                   > rec["bound_bytes_ms"] else "bytes")


# ---------------------------------------------------------------------------
# phase 19's strong-scaling projection and phase 20's 10M checks on the
# CPU, at small sizes (phase 20's wrappers run their twins here, so its
# launch checks are the ones left to fail)
# ---------------------------------------------------------------------------

def test_phase19_scale_projection(smoke, monkeypatch, tmp_path, capsys):
    cs, dev = smoke
    small = ":grid_nx=16:grid_ny=16:scan_block=2"
    monkeypatch.setattr(cs, "PROJECTION_SIZES", "2048")
    monkeypatch.setattr(cs, "PROJECTION_ROWS",
                        f"slab_1dev{small},slab_capped_k4{small}")
    doc = cs.tools_projection(dev, str(tmp_path))
    assert [r["row"].split("+")[0] for r in doc["rows"]] == [
        "slab_1dev", "slab_capped_k4"]
    out = capsys.readouterr().out
    assert out.count("[tools] scale_projection slab_") == 2
    assert "[tools] scale_projection " in out.splitlines()[-1]


def test_phase20_tenm_checks(smoke, monkeypatch, capsys):
    cs, dev = smoke
    failed = []
    monkeypatch.setattr(cs, "check", lambda ok, what: ok or failed.append(
        what))
    grid = dict(num_particles=4096, grid_nx=16, grid_ny=16, grid_nz=16)
    steps = ["--steps", "3", "--warmup", "2"]
    monkeypatch.setattr(cs, "TENM", {
        name: (scene, dict(ov, **grid), steps, kernels)
        for name, (scene, ov, _, kernels) in cs.TENM.items()})
    out = cs.tenm_phase(dev)
    assert failed == [f"10M {name}: {k} launched 0 times in 5 steps"
                      for name, t in cs.TENM.items() for k in t[3]]
    for name, r in out.items():
        assert r["bench"]["steps"] == 3 and r["bench"]["finite"]
        assert r["bench"]["truncated_ranges"] == 0
        assert set(r["twins"]["errs"]) == set(cs.TENM[name][3])
    assert out["capped_k4_10m"]["bench"]["capped_sub_len"] > 0
    assert out["dam_break_10m"]["bench"]["window_t"] == 208
    text = capsys.readouterr().out
    assert text.count("counts_equal=True") == 2
    assert "[p20] phase 20 took" in text


def test_phase21_integrate_checks(smoke, monkeypatch, capsys):
    """Phase 21 on the CPU at 4,096 particles, ``integrate_t``'s launcher
    writing the twin's results (the kernel runs only on the card)."""
    import torch

    from smoothed_particle_hydrodynamics_tpu_torch.ops import integrate

    cs, dev = smoke
    calls = []

    def launch(cfg, state, acc, pos, vel, partials, tally, blocks):
        new, t = integrate.kdk_integrate_plain(cfg, state, acc)
        pos.copy_(new.position)
        vel.copy_(new.velocity)
        tally.copy_(torch.stack([t.kinetic, t.potential, *t.l_vec,
                                 t.angular_momentum]))
        calls.append(blocks)

    monkeypatch.setattr(integrate, "_launch", launch)
    monkeypatch.setattr(integrate, "_grid_cap", lambda index: 3)
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=1, warmup=0: (
        fn(), 1.0)[1])
    grid = dict(num_particles=4096, grid_nx=16, grid_ny=16, grid_nz=16)
    monkeypatch.setattr(cs, "INTEGRATE", {
        name: (scene, dict(ov, **grid))
        for name, (scene, ov) in cs.INTEGRATE.items()})
    out = cs.integrate_phase(dev)
    assert set(out) == {"splash_1m", "dam_break_10m"}
    for r in out.values():
        assert r["n"] == 4096 and r["ms"] == r["plain_ms"] == 1.0
        assert r["bound_ms"] == 64 * 4096 / 3.35e12 * 1e3
        for case in ("cell", "gravity"):
            assert r[case]["position_differ"] == 0
            assert all(e["ok"] for e in r[case]["tally"].values())
    # two calls a comparison, two comparisons and one timed call a case
    assert calls == [3] * 10
    text = capsys.readouterr().out
    assert text.count("two calls' tallies equal True") == 4
    assert "[p21] phase 21 took" in text


def test_phase21_tally_bar(smoke):
    """A kernel tally term is held to twice the twin's distance from the
    float64 sum, or to 1e-6 relative where the twin's is 0."""
    import torch

    from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig

    cs, _ = smoke
    terms = torch.tensor([[1.0, 2.0, 3.0, 0.0, 4.0]], dtype=torch.float64)
    ref = torch.tensor([1.0, -2.0, 3.0, 0.0, 4.0, 5.0], dtype=torch.float64)

    def errs(kernel, twin, cfg=SphConfig()):
        return cs.tally_errors(cfg, ref + torch.tensor(kernel).double(),
                               ref + torch.tensor(twin).double(), terms)

    zero = [0.0] * 6
    assert all(e["ok"] and e["twin_dist"] == 0
               for e in errs(zero, zero).values())
    twin = [0, 0, 1e-3, 0, 0, 0]
    assert errs([0, 1e-6, 2e-3, 0, 0, 0], twin)["Lx"]["ok"]
    assert errs([0, 1e-6, 2e-3, 0, 0, 0], twin)["PE"]["ok"]
    assert not errs([0, 3e-6, 0, 0, 0, 0], twin)["PE"]["ok"]
    assert not errs([0, 0, 3e-3, 0, 0, 0], twin)["Lx"]["ok"]
    assert not errs([0, 0, 1e-3, 0, 0, 0], zero)["Lx"]["ok"]
    compat = cs.tally_errors(SphConfig(compat=True), torch.zeros(6),
                             torch.zeros(6), terms)["|L|"]
    assert compat["ref"] == 0.0 and compat["ok"]


def test_phase22_cand_checks(smoke, monkeypatch, capsys):
    """Phase 22 on the CPU at 4,096 particles (the slab frame on a 16^3
    grid), ``cand_cols_t``'s launcher writing the twin's columns (the
    kernel runs only on the card) and the counted solves stood in."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    cs, dev = smoke
    calls, solved = [], []

    def launch(cfg, pos, vel, rho, mass, index, out):
        if index is not None:
            rows = index.long()
            pos, vel, rho = pos[rows], vel[rows], rho[rows]
        out.copy_(sw.fused_cand_cols_plain(cfg, pos, vel, rho, mass))
        calls.append(index is not None)

    monkeypatch.setattr(sw, "_launch_cand_cols", launch)
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=1, warmup=0: (
        fn(), 1.0)[1])
    monkeypatch.setattr(cs, "cand_solve_launches", lambda dev_, name: (
        solved.append(name), cs.CAND_STEPS)[1])
    grid = dict(num_particles=4096, grid_nx=16, grid_ny=16, grid_nz=16)
    monkeypatch.setattr(cs, "CAND", {
        name: (scene, dict(ov, **grid))
        for name, (scene, ov) in cs.CAND.items()})
    monkeypatch.setattr(cs, "CAND_SLAB_N", 4096)
    monkeypatch.setattr(cs, "SLAB", dict(cs.SLAB, grid_nx=16, grid_ny=16,
                                         grid_nz=16))
    out = cs.cand_phase(dev)
    assert set(out) == {"splash_1m", "dam_break_10m", "capped_k4_10m",
                        "slab_1m"}
    for name, r in out.items():
        assert r["differ"] == 0 and r["solve_launches"] == cs.CAND_STEPS
        assert r["ms"] == r["plain_ms"] == 1.0
    for name in ("splash_1m", "dam_break_10m"):
        assert out[name]["m"] == 4096
        assert out[name]["bound_ms"] == 68 * 4096 / 3.35e12 * 1e3
    capped = out["capped_k4_10m"]
    assert capped["differ_exact"] == 0 and 0 < capped["m"] < 4096
    # gathered sectors of x, v and rho at most all of them, 44 B a row more
    assert capped["bound_ms"] <= (4096 * 28 + 44 * capped["m"] + 96) \
        / 3.35e12 * 1e3
    # a comparison and a timed call a case; the capped case's unindexed
    # comparison
    assert calls == [False, False, False, False, True, False, True, False,
                     False]
    assert solved == ["splash_1m", "dam_break_10m", "capped_k4_10m",
                      "slab_1m"]
    text = capsys.readouterr().out
    assert text.count("elements differing 0") == 5
    assert "[p22] phase 22 took" in text
