"""The capped 10M splash's configuration (``bench_port/configs/
splash_10m_capped_k4.json``), shrunk, against the benchmark's plain
reference (``bench_port/reference.py``: plain PyTorch, nothing of the port),
on the CPU, where the port's kernels run as their plain twins.

The shrunk cell keeps the file's K_c, reweighting and 256-row blocks and
derives its window and sub frame as the file does, at 3,000 particles on a
16^3 grid, 30 steps in blocks of 3, the drop released just over the pool so
that it strikes it within the solve.  Whole through the harness
(``run.run_cell``), it is correct with no failed step, and a checked step's
bins come from a rebin; the bfloat16 control (``control.readings``) on the
same cell breaks a limit.  Stepped through the port's lazy driver with a
forced rebin, every step's counts, densities, accelerations, positions and
velocities hold to the limits file against the reference handed the bins
the step used (``LazyCarry.pos_bin`` and ``LazyCarry.bin_from``).
"""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "bench_port"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import compare  # noqa: E402
import control  # noqa: E402
import core  # noqa: E402
import port  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402
import scene  # noqa: E402
import spec  # noqa: E402

from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy  # noqa: E402

torch.set_num_threads(1)

CONFIG = "splash_10m_capped_k4"
CELL = "tiny_capped.solve"
SEED = 2400000017
SHRUNK = dict(num_particles=3000, grid_nx=16, grid_ny=16, grid_nz=16)
STEPS, BLOCK, CHECKED = 30, 3, 10


def _config() -> dict:
    config = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    sph = config["sph"]
    sph.update(SHRUNK, total_time=STEPS * sph["dt"])
    config["initial"]["drop_height"] = 0.2
    return config


def _limits() -> dict:
    return json.loads((BENCH / "limits" / f"{CONFIG}.json").read_text())


def test_the_shrunk_cell_keeps_the_configuration_s_capped_settings():
    sph = _config()["sph"]
    assert (sph["capped_candidates"], sph["capped_reweight"],
            sph["capped_fused"], sph["pallas_block_t"]) == (4, True, False,
                                                            256)
    assert sph["pallas_window_t"] == 0 and sph["capped_sub_len"] == 0


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout holding the harness and one cell: the configuration
    shrunk, the solve traffic at 30 steps in blocks of 3 with 10 checked
    steps in its first solve, the configuration's own limits."""
    root = tmp_path_factory.mktemp("capped_cell")
    here = root / "bench_port"
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (here / "configs" / "tiny_capped.json").write_text(json.dumps(_config()))
    (here / "traffic" / "tiny_capped.json").write_text(json.dumps(
        {"why": "tests", "block": BLOCK, "checked_steps": CHECKED,
         "checked_solves": 1}))
    shutil.copy(here / "limits" / f"{CONFIG}.json",
                here / "limits" / "tiny_capped.json")
    bench = core.load_bench(BENCH.parent)
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    bench["configs"].append(dict(entry, name="tiny_capped",
                                 file="bench_port/configs/tiny_capped.json"))
    bench["workloads"].append({"name": CELL, "config": "tiny_capped",
                               "traffic": "tiny_capped", "chips": 1,
                               "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, here


def test_the_shrunk_cell_is_correct_through_the_harness(tiny, monkeypatch):
    root, here = tiny
    copies = []
    check_steps = run.check_steps

    def spy(config, sink, mass, control=False):
        copies.extend(s["after"] for s in sink)
        return check_steps(config, sink, mass, control)

    monkeypatch.setattr(run, "check_steps", spy)
    out = run.run_cell(core.load_bench(root), CELL, SEED, 0.0, False,
                       torch.device("cpu"), time.perf_counter(), root=root,
                       here=here)
    res, info = out["result"], out["info"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == STEPS
    assert all(t["value"] <= t["limit"] for t in res["checks"].values())
    assert info["block_t"] == 256 and info["window_t"] > 0
    assert 0 < info["capped_sub_len"] < SHRUNK["num_particles"]
    assert len(copies) == CHECKED
    # some checked step's bins came from a rebin: another frame than the
    # callers' order
    ids = torch.arange(SHRUNK["num_particles"])
    assert any(not torch.equal(a["bin_from"], ids) for a in copies)


def test_the_bfloat16_control_breaks_a_limit(tiny):
    root, here = tiny
    cell = core.cell(core.load_bench(root), CELL, root, here)
    rec = control.readings(cell, SEED, torch.device("cpu"), True, False)
    limits = _limits()
    assert compare.judge(rec["program"], limits)[0] is True
    ok, table = compare.judge(rec["control"], limits)
    assert ok is False
    assert any(t["value"] > t["limit"] for t in table.values())


def _unsort(x, order):
    out = x.new_empty(x.shape)
    out[order] = x
    return out


def test_lazy_steps_match_the_reference_through_a_forced_rebin():
    config = _config()
    c = spec.constants(config["sph"])
    pos, vel, mass = scene.draw(config, SEED, torch.device("cpu"))
    cfg, init = port.make_config(config["sph"], pos, vel, mass)
    n = init.position.shape[0]
    ids = torch.arange(n)
    carry = lazy.init_lazy(cfg, init)
    assert carry.bin_from is None
    limits, forced, rebins = _limits(), 3, []
    for k in range(6):
        if k == forced:   # one particle's bin position far off: a rebin
            far = carry.pos_bin.clone()
            far[0] += 4.0 * cfg.cell_size
            carry = carry._replace(pos_bin=far)
        x0 = _unsort(carry.state.position, carry.order)
        v0 = _unsort(carry.state.velocity, carry.order)
        before = carry.rebin_count
        carry, _ = lazy.lazy_step(cfg, carry)
        rebins.append(carry.rebin_count > before)
        # the bins the step used: a step that rebins does so before its
        # sweeps, so the carry it returns holds them
        frame = ids if carry.bin_from is None else carry.bin_from
        bins = {"pos": _unsort(carry.pos_bin, carry.order),
                "row": _unsort(ids, frame)}
        ref = reference.step(c, x0, v0, mass, bins=bins)
        st = carry.state
        out = {k2: _unsort(v, carry.order) for k2, v in (
            ("count", st.neighbor_count), ("rho", st.density),
            ("acc", st.acceleration), ("pos", st.position),
            ("vel", st.velocity))}
        ok, table = compare.judge(compare.step_numbers(out, ref, c["h"]),
                                  limits)
        assert ok, (k, table)
    assert rebins[forced] and not rebins[0]
    assert carry.bin_from is not None
