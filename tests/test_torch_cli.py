"""The torch package's CLI resolves scenes and overrides as the JAX CLI does
(``smoothed_particle_hydrodynamics_tpu/cli.py:26-72``, ``:100``):

* ``-n`` and ``--seed`` default to the scene's own size and seed;
* ``run`` and ``bench`` validate the resolved config before any step;
* ``--set`` values parse as JSON (the raw string otherwise), and a key that
  is not a config field is refused.

``run`` and ``bench`` resolve their scene through one function,
``utils.benchmark.resolve_scene``; the tests that must not step the scene
(the disk's 32,768 particles) record what it returns and stop there.
"""

import json

import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
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
        main([cmd, "-n", "300", "--steps", "1", "--device", "cpu",
              "--set", "cell_size_factor=0.5"])


def test_set_values_parse_as_json(resolved):
    with pytest.raises(_Resolved):
        main(["run", "-n", "300", "--device", "cpu",
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
        main(["run", "-n", "300", "--device", "cpu",
              "--set", "no_such_field=1"])


def test_run_prints_the_resolved_scene(capsys):
    """A whole ``run`` of a small splash: the line names the size given."""
    assert main(["run", "-n", "384", "--steps", "1", "--block", "1",
                 "--device", "cpu", "--set", "cell_size_factor=1.25",
                 "--set", "pallas_window_t=64"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["step"] == 1 and line["window_t"] == 64
