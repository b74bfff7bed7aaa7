"""The port's strong-scaling projection (``smoothed_particle_hydrodynamics_
tpu_torch/tools/scale_projection.py``) against the JAX tool
(``tools/scale_projection.py``) and ``bench.py``'s slab rows, on the CPU.

The JAX tool and ``bench.py`` are loaded by path (neither imports JAX at
module level); the JAX tool's ``run_row`` and the JAX package's
``utils.benchmark.run_slab_benchmark`` are replaced by recorders, so what
each would run is compared without running it.  The hop model's bytes and
collectives are counted from the port's slab code itself, and the tool runs
once end to end on the CPU at a small size.
"""

import argparse
import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.tools import scale_projection as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "smoothed_particle_hydrodynamics_tpu_torch"
SIZES = (125_000, 250_000, 250_001, 500_000, 500_001, 1_000_000, 1_250_000)
SPECS = ("slab_1dev,slab_capped_k4,slab_capped_k4:cell_size_factor=2.5:"
         "capped_fused=1:scan_block=64,slab_capped_k4:cell_size_factor=3.0,"
         "slab_1dev:scan_block=4:pallas_block_t=256")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_tool():
    return _load(os.path.join(REPO, "tools", "scale_projection.py"),
                 "jax_scale_projection")


def _jax_run(tool, monkeypatch, tmp_path, sizes, rows, chips=8,
             fake=None) -> tuple[list, dict]:
    """The JAX tool's main with ``run_row`` recorded: (its calls, the record
    it wrote)."""
    calls = []
    fake = fake or {"ms_per_step": 2.0, "h_cap": 1024, "m_cap": 1152,
                    "rebins": 3, "steps": 30}

    def run_row(row, n, grid_nz=0, timeout=1800, scan_block=0, ovs=None):
        calls.append((row, n, grid_nz, scan_block, list(ovs or [])))
        return dict(fake)

    out = tmp_path / "jax.json"
    monkeypatch.setattr(tool, "run_row", run_row)
    monkeypatch.setattr(sys, "argv", [
        "scale_projection.py", "--sizes", ",".join(map(str, sizes)),
        "--chips", str(chips), "--rows", rows, "--out", str(out)])
    assert tool.main() == 0
    return calls, json.loads(out.read_text())


def test_noise_ladder_is_the_jax_tools():
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "scale_projection.py")).read())
    found = [ast.literal_eval(node.value) for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and any(getattr(t, "id", "") == "NOISE" for t in node.targets)]
    assert found == [sp.NOISE]


def test_specs_policy_labels_and_noise_are_the_jax_tools(
        jax_tool, monkeypatch, tmp_path, capsys):
    calls, doc = _jax_run(jax_tool, monkeypatch, tmp_path, SIZES, SPECS)
    want = []
    for n in SIZES:
        for name, ovs, sb in sp.parse_rows(SPECS):
            want.append((name, n, sp.grid_nz_for(8), sp.scan_block_for(n, sb),
                         ovs))
    assert calls == want
    for rec, (name, n, grid_nz, sb, ovs) in zip(doc["rows"], want):
        assert rec["row"] == name + "".join("+" + o for o in ovs)
        assert (rec["n_per_chip"], rec["grid_nz"], rec["scan_block"]) == (
            n, grid_nz, sb)
        assert rec.get("noise_rel_l2_1m") == sp.noise(name, ovs)


@pytest.mark.parametrize("chips", (1, 2, 3, 4, 5, 8, 16, 64, 128, 256))
def test_grid_nz_rule_is_the_jax_tools(jax_tool, monkeypatch, tmp_path,
                                       capsys, chips):
    calls, _ = _jax_run(jax_tool, monkeypatch, tmp_path, (125_000,),
                        "slab_1dev", chips=chips)
    assert calls[0][2] == sp.grid_nz_for(chips)


@pytest.mark.parametrize("h_cap, m_cap", ((9728, 9728), (68352, 68352),
                                          (1024, 1152)))
def test_hop_bytes_equal_the_jax_models(jax_tool, monkeypatch, tmp_path,
                                        capsys, h_cap, m_cap):
    """The port sends what the JAX engine sends: 40 bytes a halo row and 32
    a migrated row, each way (the collectives' counts differ)."""
    _, doc = _jax_run(jax_tool, monkeypatch, tmp_path, (125_000,),
                      "slab_1dev", fake={"ms_per_step": 2.0, "h_cap": h_cap,
                                         "m_cap": m_cap, "rebins": 3,
                                         "steps": 30})
    rec = doc["rows"][0]
    got = sp.hop_bytes(h_cap, m_cap)
    for k in ("halo_bytes_per_step", "migration_bytes_per_rebin"):
        assert got[k] == rec[k]


def test_link_model_arithmetic():
    launch = 0.012
    r = sp.link_ms(9728, 9728, rebins=10, steps=40, launch_ms=launch)
    step = 2 * 9728 * 40 / 450e9 * 1e3 + 7 * launch
    rebin = 2 * 9728 * 32 / 450e9 * 1e3 + 4 * launch
    assert r["link_ms_per_step"] == pytest.approx(step + rebin * 10 / 40,
                                                  rel=1e-12)
    assert sp.link_ms(9728, 9728, 0, 0, launch)["link_ms_per_step"] == (
        pytest.approx(step, rel=1e-12))


# ---------------------------------------------------------------------------
# each row's settings: what bench.py's _compute_row hands the JAX package's
# run_slab_benchmark, against what the port's CLI hands the port's
# ---------------------------------------------------------------------------

SLAB_KEYS = ("value", "ms_per_step", "p_cap", "h_cap", "m_cap", "window_t",
             "rebins", "migration_dropped", "halo_dropped", "steps",
             "scan_block")


def _recorder(calls: list):
    def run_slab_benchmark(**kw):
        calls.append(kw)
        return dict.fromkeys(SLAB_KEYS, 0)
    return run_slab_benchmark


@pytest.mark.parametrize("spec, n", [
    ("slab_1dev", 125_000), ("slab_capped_k4", 125_000),
    ("slab_1dev", 500_000), ("slab_capped_k4", 1_250_000),
    ("slab_capped_k4:cell_size_factor=2.5:capped_fused=1:scan_block=64",
     250_000),
    ("slab_1dev:pallas_block_t=256:scan_block=8", 2048)])
def test_row_settings_are_bench_pys(monkeypatch, capsys, spec, n):
    from smoothed_particle_hydrodynamics_tpu.utils import (
        benchmark as jax_benchmark)

    from smoothed_particle_hydrodynamics_tpu_torch import __main__ as tmain
    from smoothed_particle_hydrodynamics_tpu_torch.utils import benchmark

    bench = _load(os.path.join(REPO, "bench.py"), "jax_bench")
    (name, ovs, sb_spec), = sp.parse_rows(spec)
    sb = sp.scan_block_for(n, sb_spec)
    grid_nz = sp.grid_nz_for(8)
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_benchmark, "run_slab_benchmark",
                        _recorder(jax_calls))
    monkeypatch.setattr(benchmark, "run_slab_benchmark",
                        _recorder(port_calls))
    # what the JAX tool's run_row asks bench.py for
    args = argparse.Namespace(
        scene="splash", num_particles=n, steps=max(9 * sb, 50), warmup=5,
        slab_sweeps="pallas", grid_nz=grid_nz, scan_block=sb, ov=ovs)
    bench._compute_row(name, args)
    assert tmain.main(sp.bench_argv(name, n, grid_nz, sb, ovs, "cpu")) == 0
    (j,), (p,) = jax_calls, port_calls
    for k in ("n", "steps", "sweeps", "scan_block"):
        assert p[k] == j[k], k
    # both run_slab_benchmarks start from 1.25h cells and apply these last
    assert {"cell_size_factor": 1.25, **j["overrides"]} == p["overrides"]
    # bench.py leaves the JAX run's warmup at its default, 3: the same
    # warmup calls of K steps as the port's 5
    k = max(sb, 1)
    assert max(-(-3 // k), 1) == max(-(-p["warmup"] // k), 1)


# ---------------------------------------------------------------------------
# the hop model's counts from the port's slab code
# ---------------------------------------------------------------------------

class _Counted:
    """Records what a ``SlabGroup``'s collectives carry."""

    def __init__(self):
        self.shifts, self.reduces = [], 0

    def patch(self, monkeypatch, cls):
        for name in ("shift_up", "shift_down"):
            orig = getattr(cls, name)

            def shift(group, t, orig=orig):
                self.shifts.append(t.numel() * t.element_size())
                return orig(group, t)
            monkeypatch.setattr(cls, name, shift)
        for name in ("psum", "pmax"):
            orig = getattr(cls, name)

            def reduce(group, t, orig=orig):
                self.reduces += 1
                return orig(group, t)
            monkeypatch.setattr(cls, name, reduce)


@pytest.mark.parametrize("overrides", [
    dict(grid_nx=16, grid_ny=16, grid_nz=16),
    dict(grid_nx=16, grid_ny=16, grid_nz=16, capped_candidates=4,
         pallas_window_t=0, pallas_block_t=256),
    dict(grid_nx=16, grid_ny=16, grid_nz=16, capped_candidates=4,
         pallas_window_t=0, pallas_block_t=256, capped_fused=True)])
def test_step_sends_the_modeled_halo_and_collectives(monkeypatch, overrides):
    """A step without a rebin: the halo's bytes both ways and
    ``STEP_COLLECTIVES`` collectives; a rebin adds the migration's pending
    count (at world 1 no row moves, so no hop)."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm, slabs
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        slab_setup)

    dev = torch.device("cpu")
    cfg, state, zsplit, (p_cap, h_cap, m_cap), sub_len = slab_setup(
        2048, overrides, 1.05, dev)
    seen = _Counted()
    seen.patch(monkeypatch, comm.SlabGroup)
    with comm.local_group(dev) as group:
        carry = slabs.distribute(cfg, state, group, p_cap, zsplit=zsplit)
        step = slabs.make_slab_step(cfg, group, p_cap, h_cap, m_cap,
                                    sweeps="pallas", zsplit=zsplit,
                                    sub_len=sub_len)
        carry, _ = step(carry)                    # the first step rebins
        assert carry.rebin_count == 1
        assert len(seen.shifts) == 4 and seen.reduces == 3 + 1
        for _ in range(8):                        # to a step that does not
            seen.shifts, seen.reduces = [], 0
            before = carry.rebin_count
            carry, _ = step(carry)
            if carry.rebin_count == before:
                break
    assert carry.rebin_count == before
    assert len(seen.shifts) + seen.reduces == sp.STEP_COLLECTIVES
    assert sum(seen.shifts) == sp.hop_bytes(h_cap, m_cap)[
        "halo_bytes_per_step"]


def test_migration_hop_sends_the_modeled_rows(monkeypatch):
    """One hop of ``_migrate`` on rank 0 of two: its two shifts carry
    ``migration_bytes_per_rebin``, with the pending count before and after
    it ``REBIN_COLLECTIVES`` collectives."""
    from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs

    cfg = SphConfig(grid_nx=8, grid_ny=8, grid_nz=16, cell_size_factor=1.25)

    class Group:
        rank, world, device = 0, 2, torch.device("cpu")
        pending = 0

        def psum(self, t):
            self.pending += 1
            return t if self.pending == 1 else torch.zeros_like(t)

        def shift_up(self, t):
            shifts.append(t.numel() * t.element_size())
            return t

        shift_down = shift_up

    shifts, p_cap, m_cap = [], 512, 256
    fields = slabs._inert(p_cap, "cpu")
    z = torch.linspace(0.05, 0.95, 300) * cfg.box_max[2]
    fields[:300, 0:2] = 0.5
    fields[:300, 2] = z
    fields[:300, 7] = torch.arange(300, dtype=torch.float32)
    group = Group()
    slabs._migrate(cfg, group, fields, (0, 8, 16), p_cap, m_cap)
    assert len(shifts) + group.pending == sp.REBIN_COLLECTIVES
    assert sum(shifts) == sp.hop_bytes(1024, m_cap)[
        "migration_bytes_per_rebin"]


# ---------------------------------------------------------------------------
# the tool end to end on the CPU
# ---------------------------------------------------------------------------

def test_tool_runs_on_the_cpu(tmp_path):
    out = tmp_path / "sp.json"
    r = subprocess.run(
        [sys.executable, "-m", f"{PKG}.tools.scale_projection", "--device",
         "cpu", "--sizes", "2048", "--chips", "8", "--rows",
         "slab_capped_k4:grid_nx=16:grid_ny=16:scan_block=2", "--out",
         str(out)],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[0] == "cpu (host times, not the card's)"
    doc = json.loads(out.read_text())
    assert doc["chips"] == 8 and not doc["failed"]
    assert doc["link"]["bytes_per_s"] == 450e9
    assert "datasheet" in doc["link"]["source"]
    assert doc["launch"]["ms"] > 0 and "probe_dispatch" in doc["launch"][
        "source"]
    assert "24 MB" in doc["launch"]["source"]
    assert "bytes term is a lower bound" in doc["link"]["source"]
    assert doc["runs_per_row"] == 1
    (rec,) = doc["rows"]
    assert rec["row"] == "slab_capped_k4+grid_nx=16+grid_ny=16"
    assert (rec["n_per_chip"], rec["grid_nz"], rec["scan_block"]) == (
        2048, 16, 2)
    for k in ("ms_per_step", "pps_per_chip", "aggregate_n",
              "projected_pps_x8", "rebins", "h_cap", "m_cap",
              "halo_bytes_per_step", "migration_bytes_per_rebin",
              "link_ms_per_step", "ms_per_step_with_link",
              "projected_pps_x8_with_link", "noise_rel_l2_1m"):
        assert k in rec, k
    assert rec["migration_dropped"] == rec["halo_dropped"] == 0
    assert rec["truncated_ranges"] == 0 and rec["finite"]
    assert rec["steps"] == sp.bench_steps(2)
    assert "| slab_capped_k4+grid_nx=16+grid_ny=16 | 2,048 |" in r.stdout


def test_rows_run_on_the_card_that_was_asked_for(monkeypatch, tmp_path):
    """A row's process gets the tool's device whole (``cuda:1``), not its
    type, so the rows and the launch price come from one card."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import probe_dispatch

    asked = torch.device("cuda", 1)
    seen = []
    monkeypatch.setattr(sp, "start", lambda device: asked)
    monkeypatch.setattr(sp, "card_line", lambda dev: "stand-in card")
    monkeypatch.setattr(probe_dispatch, "one_launch_ms",
                        lambda n, dev: seen.append(("launch", dev)) or 0.01)

    def run_row(row, n, grid_nz, scan_block, ovs, device, timeout):
        seen.append(("row", device))
        return None, {"rc": 1, "tail": ""}

    monkeypatch.setattr(sp, "run_row", run_row)
    doc = sp.main(sizes="125000", rows="slab_1dev",
                  out=str(tmp_path / "sp.json"), device="cuda:1")
    assert seen == [("launch", asked), ("row", "cuda:1")]
    assert doc["failed"][0]["rc"] == 1 and not doc["rows"]
