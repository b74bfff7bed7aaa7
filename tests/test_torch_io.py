"""The port's run outputs against the JAX package's (``utils/diagnostics.py``,
``utils/io.py``, ``utils/native.py``, ``init.load_state`` and
``utils/profiling.py``).

The same numpy diagnostics, configs and states go through both packages:
the diagnostics files, checkpoints, ``run.json`` and snapshots must be
byte-equal, and a file written by either package must load in the other
with every array bit-equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu import init as jinit
from smoothed_particle_hydrodynamics_tpu.config import SphConfig as JConfig
from smoothed_particle_hydrodynamics_tpu.state import ParticleState as JState
from smoothed_particle_hydrodynamics_tpu.state import (
    StepDiagnostics as JDiags)
from smoothed_particle_hydrodynamics_tpu.utils import diagnostics as jdiag
from smoothed_particle_hydrodynamics_tpu.utils import io as jio
from smoothed_particle_hydrodynamics_tpu.utils import native as jnative
from smoothed_particle_hydrodynamics_tpu.utils import profiling as jprof
from smoothed_particle_hydrodynamics_tpu_torch import init as tinit
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops.step import drive_loop
from smoothed_particle_hydrodynamics_tpu_torch.state import (
    StepDiagnostics, state_from_numpy, state_to_numpy)
from smoothed_particle_hydrodynamics_tpu_torch.utils import diagnostics
from smoothed_particle_hydrodynamics_tpu_torch.utils import io as tio
from smoothed_particle_hydrodynamics_tpu_torch.utils import native
from smoothed_particle_hydrodynamics_tpu_torch.utils import profiling

torch.set_num_threads(1)

FILES = ("energy.txt", "angularmomentum.txt", "timing.txt", "neighbors.txt",
         "diagnostics.jsonl")
STATE_KEYS = ("position", "velocity", "mass", "density", "acceleration",
              "neighbor_count")


def _diag_block(rng, n: int) -> dict[str, np.ndarray]:
    """A block of per-step diagnostics: negative PE, a NaN row, a mean of
    x.9 (truncated to x in neighbors.txt) and nonzero loss counters."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    ke = f32(rng.uniform(0.0, 2.0, n) * 10.0 ** rng.integers(-6, 6, n))
    ke[1] = np.nan
    nmean = f32(rng.uniform(20.0, 40.0, n))
    nmean[0] = np.float32(33.9)
    return {
        "kinetic_energy": ke,
        "potential_energy": f32(-rng.uniform(0.0, 1.0, n)
                                * 10.0 ** rng.integers(-7, 7, n)),
        "angular_momentum": f32(rng.uniform(0.0, 1e4, n)),
        "neighbor_mean": nmean,
        "neighbor_max": i32(rng.integers(40, 90, n)),
        "neighbor_min": i32(rng.integers(0, 20, n)),
        "overflow_cells": i32(rng.integers(0, 3, n)),
        "truncated_ranges": i32(rng.integers(0, 3, n)),
        "halo_dropped": i32(rng.integers(0, 2, n)),
        "migration_dropped": i32(rng.integers(0, 2, n)),
    }


@pytest.mark.parametrize("as_tensors", [False, True])
@pytest.mark.parametrize("use_native", [True, False])
def test_diagnostics_files_are_byte_equal(tmp_path, use_native, as_tensors):
    """Two blocks through both writers (the port's fed numpy arrays or
    tensors): the five files byte-equal, and ``write_block`` returns the
    block as float32 and int32 host arrays."""
    if use_native:
        assert native.have_native() and jnative.have_native()
    rng = np.random.default_rng(3)
    blocks = [_diag_block(rng, 5), _diag_block(rng, 3)]
    phases = [dict(step=12.5), dict(voxelize=1.25, neighbors=0.5,
                                    density=2.0, pressure=0.0,
                                    acceleration=3.0, integrate=0.25,
                                    step=7.0)]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    with jdiag.DiagnosticsWriter(jout, use_native=use_native) as jw, \
            diagnostics.DiagnosticsWriter(tout, use_native=use_native) as tw:
        first = 0
        for block, ms in zip(blocks, phases):
            jw.write_block(first, JDiags(**block), ms)
            given = ({k: torch.from_numpy(v) for k, v in block.items()}
                     if as_tensors else block)
            host = tw.write_block(first, StepDiagnostics(**given), ms)
            for k, v in block.items():
                np.testing.assert_array_equal(getattr(host, k), v)
                assert getattr(host, k).dtype == v.dtype, k
            first += len(block["kinetic_energy"])
    for name in FILES:
        with open(os.path.join(jout, name), "rb") as a, \
                open(os.path.join(tout, name), "rb") as b:
            ja, tb = a.read(), b.read()
        assert ja == tb, name
    rows = open(os.path.join(tout, "neighbors.txt")).read().splitlines()
    assert len(rows) == 8 and rows[0].startswith("33, ")
    assert "NaN" in open(os.path.join(tout, "diagnostics.jsonl")).read()


def test_native_writer_gets_one_job_per_file_and_block(tmp_path,
                                                       monkeypatch):
    """A block reaches the writer's thread as one job per file (five), not
    one per row: each job opens, appends to and closes its file beside
    the next block's steps."""
    assert native.have_native()
    jobs = []
    real = native.AsyncFileWriter.write

    def counted(self, path, data, append=True):
        jobs.append(os.path.basename(path))
        return real(self, path, data, append)

    monkeypatch.setattr(native.AsyncFileWriter, "write", counted)
    block = _diag_block(np.random.default_rng(4), 10)
    with diagnostics.DiagnosticsWriter(str(tmp_path),
                                       use_native=True) as w:
        headers = len(jobs)
        w.write_block(0, StepDiagnostics(**block), {"step": 1.0})
        assert sorted(jobs[headers:]) == sorted(FILES)


def test_total_energy_is_the_float32_sum(tmp_path):
    """0.1234567 + (-0.0000123) in float32 (the JAX package's sum), not
    the float64 sum of the two floats."""
    block = _diag_block(np.random.default_rng(0), 2)
    block["kinetic_energy"][0] = np.float32(0.1234567)
    block["potential_energy"][0] = np.float32(-0.0000123)
    with diagnostics.DiagnosticsWriter(str(tmp_path),
                                       use_native=False) as w:
        w.write_block(0, StepDiagnostics(**block))
    row = json.loads(open(tmp_path / "diagnostics.jsonl").readline())
    want = float(np.float32(0.1234567) + np.float32(-0.0000123))
    assert row["total_energy"] == want == 0.12344440072774887


def test_host_diagnostics_of_a_run_and_a_single_step():
    """A stepped block crosses as f32/i32 rows equal to its tensors; a
    single step's 0-d fields give one row."""
    cfg, st = make_scene("disk", device="cpu", num_particles=256)
    _, d = drive_loop(cfg, st, 3)
    host = diagnostics.host_diagnostics(d)
    for k in d._fields:
        np.testing.assert_array_equal(getattr(host, k),
                                      getattr(d, k).numpy())
    one = diagnostics.host_diagnostics(StepDiagnostics(
        *(getattr(d, k)[0] for k in d._fields)))
    assert all(getattr(one, k).shape == (1,) for k in d._fields)


@pytest.mark.parametrize("case", ["clean", "nan", "inf_pe", "runaway",
                                  "truncated", "halo", "migration", "all"])
def test_detect_blowup_and_truncation_match_jax(case):
    block = _diag_block(np.random.default_rng(1), 4)
    block["kinetic_energy"][1] = 1.0
    for k in ("truncated_ranges", "halo_dropped", "migration_dropped"):
        block[k][:] = 0
    if case == "nan":
        block["kinetic_energy"][2] = np.nan
    elif case == "inf_pe":
        block["potential_energy"][0] = -np.inf
    elif case == "runaway":
        block["kinetic_energy"][3] = 1e31
    elif case in ("truncated", "all"):
        block["truncated_ranges"][1:] = 2
    if case in ("halo", "all"):
        block["halo_dropped"][0] = 1
    if case in ("migration", "all"):
        block["migration_dropped"][3] = 5
    for fn in ("detect_blowup", "detect_truncation"):
        got = getattr(diagnostics, fn)(StepDiagnostics(**block))
        want = getattr(jdiag, fn)(JDiags(**block))
        assert got == want, fn
    assert diagnostics.detect_blowup(StepDiagnostics(**block))[0] == (
        case in ("nan", "inf_pe", "runaway"))


def _states(n: int = 200, seed: int = 5):
    rng = np.random.default_rng(seed)
    d = {"position": rng.uniform(0, 3, (n, 3)).astype(np.float32),
         "velocity": rng.normal(size=(n, 3)).astype(np.float32),
         "mass": rng.uniform(0.5, 1.5, n).astype(np.float32),
         "density": rng.uniform(0, 2, n).astype(np.float32),
         "acceleration": rng.normal(size=(n, 3)).astype(np.float32),
         "neighbor_count": rng.integers(0, 60, n).astype(np.int32)}
    return d, JState.from_numpy(d), state_from_numpy(d, "cpu")


CONFIGS = [dict(), dict(num_particles=200, viscosity=0.25,
                        gravity=(0.0, -9.81, 0.0), softening=0.05,
                        capped_candidates=4, pallas_window_t=0)]


def _assert_state(got: dict, want: dict) -> None:
    assert set(got) == set(STATE_KEYS)
    for k in STATE_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kw", CONFIGS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, kw):
    d, js, _ = _states()
    path = jio.save_checkpoint(str(tmp_path), 37, JConfig(**kw), js)
    step, cfg, st = tio.load_checkpoint(path, device="cpu")
    assert step == 37 and cfg == SphConfig(**kw)
    assert cfg.to_json() == JConfig(**kw).to_json()
    assert st.position.device.type == "cpu"
    _assert_state(state_to_numpy(st), d)


@pytest.mark.parametrize("kw", CONFIGS)
def test_port_checkpoint_loads_in_jax(tmp_path, kw):
    d, _, ts = _states()
    path = tio.save_checkpoint(str(tmp_path), 1000, SphConfig(**kw), ts)
    assert os.path.basename(path) == "ckpt_00001000.npz"
    step, cfg, st = jio.load_checkpoint(path)
    assert step == 1000 and cfg == JConfig(**kw)
    _assert_state(st.to_numpy(), d)


@pytest.mark.parametrize("kw", CONFIGS)
def test_checkpoints_are_byte_equal(tmp_path, kw):
    _, js, ts = _states()
    a = jio.save_checkpoint(str(tmp_path / "jax"), 500, JConfig(**kw), js)
    b = tio.save_checkpoint(str(tmp_path / "torch"), 500, SphConfig(**kw), ts)
    assert open(a, "rb").read() == open(b, "rb").read()
    jio.save_state(str(tmp_path / "j.npz"), js)
    tio.save_state(str(tmp_path / "t.npz"), ts)
    assert (open(tmp_path / "j.npz", "rb").read()
            == open(tmp_path / "t.npz", "rb").read())


def test_saved_state_loads_both_ways(tmp_path):
    d, js, ts = _states()
    jio.save_state(str(tmp_path / "j.npz"), js)
    tio.save_state(str(tmp_path / "t.npz"), ts)
    _assert_state(state_to_numpy(tinit.load_state(str(tmp_path / "j.npz"),
                                                  device="cpu")), d)
    _assert_state(jinit.load_state(str(tmp_path / "t.npz")).to_numpy(), d)
    # a checkpoint is a state file too
    path = jio.save_checkpoint(str(tmp_path), 4, JConfig(), js)
    _assert_state(state_to_numpy(tinit.load_state(path, device="cpu")), d)


def test_latest_checkpoint_and_fingerprint_match_jax(tmp_path):
    _, _, ts = _states()
    assert tio.latest_checkpoint(str(tmp_path / "none")) is None
    assert jio.latest_checkpoint(str(tmp_path / "none")) is None
    for step in (7, 120, 45):
        tio.save_checkpoint(str(tmp_path), step, SphConfig(), ts)
    (tmp_path / "ckpt_00009999.npz.tmp").write_bytes(b"torn")
    (tmp_path / "notes.txt").write_text("x")
    got = tio.latest_checkpoint(str(tmp_path))
    assert got == jio.latest_checkpoint(str(tmp_path))
    assert got.endswith("ckpt_00000120.npz")
    for kw in CONFIGS + [dict(num_particles=1_000_000, grid_nx=128)]:
        f = tio.config_fingerprint(SphConfig(**kw))
        assert f == jio.config_fingerprint(JConfig(**kw)) and len(f) == 16


def test_run_metadata_is_byte_equal(tmp_path):
    kw = CONFIGS[1]
    extra = {"scene": "disk", "backend": "pallas",
             "phase_ms": {"voxelize": 0.25}, "lazy": True, "device": "cpu"}
    jio.write_run_metadata(str(tmp_path / "jax"), JConfig(**kw), extra)
    tio.write_run_metadata(str(tmp_path / "torch"), SphConfig(**kw), extra)
    assert (open(tmp_path / "jax" / "run.json", "rb").read()
            == open(tmp_path / "torch" / "run.json", "rb").read())


def test_snapshots_are_byte_equal_and_crc_checked(tmp_path):
    """The native snapshot of the same arrays: byte-equal between the
    packages, verified, and a flipped byte fails the CRC."""
    assert native.have_native()
    rng = np.random.default_rng(9)
    arrays = {"pos": rng.random((64, 3), dtype=np.float32),
              "count": np.arange(64, dtype=np.int32),
              "as_f32": np.arange(8, dtype=np.float64)}
    a, b = str(tmp_path / "j.sphs"), str(tmp_path / "t.sphs")
    jnative.write_snapshot(a, arrays)
    native.write_snapshot(b, arrays)
    data = open(b, "rb").read()
    assert open(a, "rb").read() == data
    assert native.verify_snapshot(b)
    with open(b, "r+b") as f:
        f.seek(20)
        f.write(bytes([data[20] ^ 0xFF]))
    assert not native.verify_snapshot(b)
    assert not jnative.verify_snapshot(b)


def test_async_writer(tmp_path):
    w = native.AsyncFileWriter()
    p = str(tmp_path / "log.txt")
    w.write(p, "a", append=False)
    for _ in range(100):
        w.write(p, "b")
    w.flush()
    assert open(p).read() == "a" + "b" * 100
    assert w.stats()["native"] is native.have_native()
    w.close()


def test_python_fallback_writer(tmp_path, monkeypatch):
    """Without the library: the thread writer, and .npz snapshots."""
    monkeypatch.setattr(native, "_LIB", False)
    assert not native.have_native()
    w = native.AsyncFileWriter()
    p = str(tmp_path / "log.txt")
    w.write(p, "xy", append=False)
    w.write(p, b"z")
    w.flush()
    assert open(p).read() == "xyz"
    assert w.stats()["native"] is False
    w.close()
    snap = str(tmp_path / "s.npz")
    native.write_snapshot(snap, {"a": np.arange(3, dtype=np.int32)})
    assert native.verify_snapshot(snap)
    np.testing.assert_array_equal(np.load(snap)["a"], np.arange(3))
    # the diagnostics writer runs on it too
    with diagnostics.DiagnosticsWriter(str(tmp_path / "o")) as dw:
        assert dw.use_native is False
        dw.write_block(0, StepDiagnostics(**_diag_block(
            np.random.default_rng(2), 2)))
    assert len(open(tmp_path / "o" / "energy.txt").readlines()) == 3


def test_profile_phases_vocabulary():
    """The reference's timing.txt phases, as the JAX package names them,
    each a non-negative time; ``profile_step`` times a whole step."""
    cfg, st = make_scene("disk", device="cpu", num_particles=256)
    got = profiling.profile_phases(cfg, st, iters=1)
    jcfg = JConfig(num_particles=256)
    jst = JState.from_numpy(state_to_numpy(st))
    want = jprof.profile_phases(jcfg, jst, iters=1)
    assert list(got) == list(want)
    assert got["pressure"] == 0.0
    assert all(v >= 0.0 for v in got.values())
    assert profiling.profile_step(cfg, st, iters=1) > 0.0
