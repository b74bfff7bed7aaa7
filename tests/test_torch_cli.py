"""The torch package's CLI resolves scenes and overrides as the JAX CLI does
(``smoothed_particle_hydrodynamics_tpu/cli.py:26-72``, ``:100``):

* ``-n`` and ``--seed`` default to the scene's own size and seed;
* ``run`` and ``bench`` validate the resolved config before any step;
* ``--set`` values parse as JSON (the raw string otherwise), and a key that
  is not a config field is refused.

* the defaults are the JAX CLI's: ``--scene disk``, ``run`` steps
  ``cfg.num_steps + 1`` in blocks of 50, ``bench`` 100 steps after 10
  warmup steps; ``utils.benchmark.run_benchmark`` and ``ops/step.py``
  default to the ``celllist`` backend, as the JAX package's do.

``run`` and ``bench`` resolve their scene through one function,
``utils.benchmark.resolve_scene``; the tests that must not step the scene
(the disk's 32,768 particles) record what it returns and stop there, or
record the step loop's and the benchmark's arguments in place of running
them.
"""

import inspect
import json
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu import cli as jcli
from smoothed_particle_hydrodynamics_tpu.models import make_scene as jmake_scene
from smoothed_particle_hydrodynamics_tpu.ops import step as jstep
from smoothed_particle_hydrodynamics_tpu.utils import benchmark as jbench
from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import step as tstep
from smoothed_particle_hydrodynamics_tpu_torch.state import StepDiagnostics
from smoothed_particle_hydrodynamics_tpu_torch.utils import benchmark

torch.set_num_threads(1)


class _Resolved(Exception):
    """Raised by the recorder once the scene is resolved: no step runs."""


@pytest.fixture
def resolved(monkeypatch):
    """Record every (cfg, state) that ``resolve_scene`` hands the CLI,
    then stop the command."""
    seen = []
    real = benchmark.resolve_scene

    def record(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        raise _Resolved

    monkeypatch.setattr(benchmark, "resolve_scene", record)
    return seen


@pytest.mark.parametrize("cmd", ["run", "bench"])
def test_scene_size_and_seed_default_to_the_scene(cmd, resolved):
    """``--scene disk`` without ``-n`` or ``--seed`` is the disk's own
    32,768 particles drawn with its own seed (42), as in the JAX CLI."""
    with pytest.raises(_Resolved):
        main([cmd, "--scene", "disk", "--device", "cpu"])
    (cfg, state), = resolved
    want_cfg, want = make_scene("disk", device="cpu")
    assert cfg.num_particles == state.n == 32768 == want_cfg.num_particles
    assert torch.equal(state.position, want.position)
    assert torch.equal(state.velocity, want.velocity)
    # a given -n and --seed still reach the scene
    with pytest.raises(_Resolved):
        main([cmd, "--scene", "disk", "--device", "cpu", "-n", "300",
              "--seed", "3"])
    cfg, state = resolved[-1]
    assert state.n == 300
    assert torch.equal(state.position,
                       make_scene("disk", device="cpu", seed=3,
                                  num_particles=300)[1].position)


def test_slab_bench_keeps_its_million_particles(monkeypatch):
    seen = {}

    def record(**kwargs):
        seen.update(kwargs)
        return {}

    monkeypatch.setattr(benchmark, "run_slab_benchmark", record)
    assert main(["bench", "--partition", "slab", "--device", "cpu"]) == 0
    assert seen["n"] == 1_000_000 and seen["seed"] is None
    assert "num_particles" not in seen["overrides"]


@pytest.mark.parametrize("cmd", ["run", "bench"])
def test_invalid_config_stops_before_a_step(cmd):
    """Cells smaller than h would silently miss pairs; ``validate`` stops
    the command with its message."""
    with pytest.raises(ValueError, match="cell_size must cover"):
        main([cmd, "--scene", "splash", "-n", "300", "--steps", "1",
              "--device", "cpu", "--set", "cell_size_factor=0.5"])


def test_set_values_parse_as_json(resolved):
    with pytest.raises(_Resolved):
        main(["run", "--scene", "splash", "-n", "300", "--device", "cpu",
              "--set", "gravity=[0,-9.81,0]", "--set", "softening=null",
              "--set", "capped_fused=true", "--set", "pallas_layout=lane",
              "--set", "viscosity=0.125"])
    (cfg, _), = resolved
    assert cfg.gravity == (0.0, -9.81, 0.0)
    assert cfg.softening is None
    assert cfg.capped_fused is True and cfg.pallas_layout == "lane"
    assert cfg.viscosity == 0.125


def test_unknown_config_field_is_refused():
    with pytest.raises(SystemExit, match="unknown config field: no_such"):
        main(["run", "--scene", "splash", "-n", "300", "--device", "cpu",
              "--set", "no_such_field=1"])


def test_run_prints_the_resolved_scene(capsys, tmp_path):
    """A whole ``run`` of a small splash: the banner names the size given,
    its one step is written and ``run.json`` holds the window given."""
    out = str(tmp_path / "o")
    assert main(["run", "--scene", "splash", "-n", "384", "--steps", "1",
                 "--block", "1", "--out", out,
                 "--device", "cpu", "--set", "cell_size_factor=1.25",
                 "--set", "pallas_window_t=64"]) == 0
    text = capsys.readouterr().out.splitlines()
    assert text[0].startswith("scene=splash n=384 steps=1 ")
    assert text[1].startswith("step 1/1  ")
    assert [r["step"] for r in _jsonl(out)] == [0]
    meta = json.load(open(f"{out}/run.json"))
    assert meta["config"]["num_particles"] == 384
    assert meta["config"]["pallas_window_t"] == 64


# ---------------------------------------------------------------------------
# The defaults: the JAX CLI's and the JAX package's
# ---------------------------------------------------------------------------

def _jax_args(cmd: str, monkeypatch):
    """The JAX CLI's parsed arguments of ``cmd`` with no flags: its command
    function is replaced by a recorder, so nothing runs."""
    seen = []
    name = {"run": "cmd_run", "bench": "cmd_bench"}[cmd]
    monkeypatch.setattr(jcli, name, lambda args: seen.append(args) or 0)
    assert jcli.main([cmd]) == 0
    return seen[0]


@pytest.mark.parametrize("cmd", ["run", "bench"])
def test_scene_default_is_the_jax_clis(cmd, resolved, monkeypatch):
    """No ``--scene``: the disk, the JAX CLI's default, at its own size
    and seed."""
    assert _jax_args(cmd, monkeypatch).scene == "disk"
    with pytest.raises(_Resolved):
        main([cmd, "--device", "cpu"])
    (cfg, state), = resolved
    want_cfg, want = make_scene("disk", device="cpu")
    assert cfg == want_cfg and cfg.num_particles == 32768
    assert torch.equal(state.position, want.position)


def _record_run(monkeypatch) -> list[int]:
    """Replace the eager step loop ``run`` drives on the CPU by a recorder
    of each block's step count; it returns the state and the block's
    diagnostics (zeros), so the 32k disk is never stepped."""
    blocks = []

    def drive_loop(cfg, state, k, backend):
        blocks.append(k)
        z = torch.zeros(k)
        return state, StepDiagnostics(
            kinetic_energy=z, potential_energy=z, angular_momentum=z,
            neighbor_mean=z, neighbor_min=z.int(), neighbor_max=z.int(),
            overflow_cells=z.int(), truncated_ranges=z.int(),
            halo_dropped=z.int(), migration_dropped=z.int())

    monkeypatch.setattr(tstep, "drive_loop", drive_loop)
    return blocks


def _jsonl(out: str) -> list[dict]:
    with open(f"{out}/diagnostics.jsonl") as fh:
        return [json.loads(x) for x in fh]


def _progress(text: str) -> list[int]:
    """The steps done at each block's ``step k/total`` line."""
    return [int(x.split()[1].split("/")[0]) for x in text.splitlines()
            if x.startswith("step ")]


def test_run_steps_default_is_the_jax_clis(monkeypatch, capsys, tmp_path):
    """No ``--steps``: ``run`` takes ``cfg.num_steps + 1`` steps of the
    resolved config, as the JAX CLI's ``run`` does (``cli.py:130``)."""
    assert _jax_args("run", monkeypatch).steps is None
    blocks = _record_run(monkeypatch)
    out = str(tmp_path / "a")
    assert main(["run", "--device", "cpu", "--out", out]) == 0
    cfg, _ = make_scene("disk", device="cpu")
    assert cfg.num_steps == jmake_scene("disk", num_particles=64)[0].num_steps
    assert sum(blocks) == cfg.num_steps + 1
    assert _progress(capsys.readouterr().out)[-1] == cfg.num_steps + 1
    assert [r["step"] for r in _jsonl(out)] == list(range(cfg.num_steps + 1))
    # a given --steps still counts
    blocks.clear()
    assert main(["run", "--device", "cpu", "--steps", "7", "--out",
                 str(tmp_path / "b")]) == 0
    assert sum(blocks) == 7


def test_run_block_default_is_the_jax_clis(monkeypatch, capsys, tmp_path):
    """No ``--block``: blocks of 50 steps (``cli.py:746``), the last one
    the rest."""
    block = _jax_args("run", monkeypatch).block
    assert block == 50
    blocks = _record_run(monkeypatch)
    out = str(tmp_path / "o")
    assert main(["run", "--device", "cpu", "--steps", "120", "--out",
                 out]) == 0
    assert blocks == [block, block, 20]
    assert _progress(capsys.readouterr().out) == [50, 100, 120]
    assert [r["step"] for r in _jsonl(out)] == list(range(120))


def _record_bench(monkeypatch) -> dict:
    seen = {}

    def record(**kwargs):
        seen.update(kwargs)
        return {}

    monkeypatch.setattr(benchmark, "run_benchmark", record)
    monkeypatch.setattr(benchmark, "run_slab_benchmark", record)
    return seen


@pytest.mark.parametrize("partition", ["single", "slab"])
def test_bench_steps_default_is_the_jax_clis(partition, monkeypatch):
    """No ``--steps``: ``bench`` times 100 steps (``args.steps or 100``,
    ``cli.py:467``), on one device and on the slab engine."""
    assert _jax_args("bench", monkeypatch).steps is None
    seen = _record_bench(monkeypatch)
    assert main(["bench", "--device", "cpu", "--partition", partition]) == 0
    assert seen["steps"] == 100
    assert main(["bench", "--device", "cpu", "--partition", partition,
                 "--steps", "7"]) == 0
    assert seen["steps"] == 7


@pytest.mark.parametrize("partition", ["single", "slab"])
def test_bench_warmup_default_is_the_jax_clis(partition, monkeypatch):
    warmup = _jax_args("bench", monkeypatch).warmup
    assert warmup == 10
    seen = _record_bench(monkeypatch)
    assert main(["bench", "--device", "cpu", "--partition", partition]) == 0
    assert seen["warmup"] == warmup


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_run_benchmark_defaults_are_the_jax_packages():
    """``run_benchmark``: the disk on the ``celllist`` backend, eager, 100
    steps after 10 warmup steps (``utils/benchmark.py:27-29``)."""
    got, want = _defaults(benchmark.run_benchmark), _defaults(
        jbench.run_benchmark)
    assert got["backend"] == want["backend"] == "celllist"
    for k in ("scene", "steps", "warmup", "lazy"):
        assert got[k] == want[k], k
    assert (got["scene"], got["steps"], got["warmup"], got["lazy"]) == (
        "disk", 100, 10, False)


@pytest.mark.parametrize("name", ["compute_forces", "step", "drive_loop",
                                  "run_steps", "simulate"])
def test_step_default_backend_is_the_jax_packages(name):
    """``ops/step.py``'s entry points default to ``celllist``, as the JAX
    package's do; a call without a backend computes what ``celllist``
    does."""
    assert _defaults(getattr(tstep, name))["backend"] == "celllist"
    assert _defaults(getattr(jstep, name))["backend"] == "celllist"
    if name == "compute_forces":
        cfg, st = make_scene("disk", device="cpu", num_particles=256)
        got = tstep.compute_forces(cfg, st)
        want = tstep.compute_forces(cfg, st, backend="celllist")
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b)
