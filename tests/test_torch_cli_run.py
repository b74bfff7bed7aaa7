"""The port's ``run``, ``info``, ``watch`` and ``sweep`` against the JAX CLI's
(``smoothed_particle_hydrodynamics_tpu/cli.py``), on the CPU.

* A resumed run from one JAX checkpoint, through both CLIs, writes the same
  diagnostics (steps, neighbor counts and rows equal, energies and |L|
  within 1e-5 relative) and the same final state (positions and
  velocities rel-L2 <= 1e-6, rho <= 1e-6, acc <= 1e-4).
* The rest of ``run``: checkpoints and resume, ``--apply`` and
  ``<out>/apply.json``, a blow-up (exit 2 and a checkpoint), the one-time
  truncation warning, SIGINT (exit 130 and a checkpoint) and SIGUSR1
  (pause) in a subprocess, the caller's signal handlers restored; the
  multi-device flags parse as the JAX CLI's (their runs:
  ``tests/test_torch_cli_devices.py``).
* ``info`` and ``watch --once`` print what the JAX CLI prints;
  ``sweep`` keeps its record schema and the honey corner is stable.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu import cli as jcli
from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import celllist as jcelllist
from smoothed_particle_hydrodynamics_tpu.ops import step as jstep
from smoothed_particle_hydrodynamics_tpu.utils import io as jio
from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main
from smoothed_particle_hydrodynamics_tpu_torch import init as tinit
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene as tscene
from smoothed_particle_hydrodynamics_tpu_torch.models import scenes
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy as tlazy
from smoothed_particle_hydrodynamics_tpu_torch.ops import step as tstep
from smoothed_particle_hydrodynamics_tpu_torch.state import StepDiagnostics
from smoothed_particle_hydrodynamics_tpu_torch.utils import io as tio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISK = ["--scene", "disk", "-n", "512", "--device", "cpu"]
# a small disk whose particles interact (h-sized support over a coarse
# grid), so the hydro sweeps carry the comparison
DENSE = dict(num_particles=512, h=0.5, grid_nx=8, grid_ny=8, grid_nz=8)
ENERGY_BAR = 1e-5


@contextlib.contextmanager
def kept_signals():
    """The JAX CLI's ``run`` installs SIGINT/SIGUSR1 handlers and leaves
    them; put the test process's back."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGUSR1)}
    try:
        yield
    finally:
        for s, h in saved.items():
            signal.signal(s, h)


def _rows(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def _lines(path: str) -> list[str]:
    with open(path) as fh:
        return fh.read().splitlines()


def _untimed(text: str) -> list[str]:
    """``run``'s stdout without the banner's device list (each package
    names its own) and the ``done:`` line's time and directory."""
    lines = []
    for ln in text.splitlines():
        if ln.startswith("scene="):
            ln = ln.partition(" devices=")[0]
        elif ln.startswith("done: "):
            ln = ln.partition(" in ")[0]
        lines.append(ln)
    return lines


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the slice as a whole: one JAX checkpoint resumed through both CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(num_particles=512), DENSE],
                         ids=["disk", "dense"])
def test_resumed_run_matches_jax(tmp_path, kw, capsys):
    # window and slice left to derive, so both CLIs print their lines
    cfg, st = jscene("disk", pallas_window_t=0, range_slice=0, **kw)
    cfg = cfg.replace(range_slice=jcelllist.derive_range_slice(cfg, st))
    st, _ = jstep.drive_loop(cfg, st, 2, backend="celllist")
    cfg = cfg.replace(range_slice=0)
    ck = str(tmp_path / "ck")
    jio.save_checkpoint(ck, 2, cfg, st)
    argv = ["run", "--resume", "--checkpoint-dir", ck, "--backend",
            "celllist", "--steps", "6", "--block", "2", "--quiet"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    capsys.readouterr()
    with kept_signals():
        assert jcli.main(argv + ["--out", jout]) == 0
    jtext = capsys.readouterr().out
    assert main(argv + ["--out", tout, "--device", "cpu"]) == 0
    ttext = capsys.readouterr().out
    # the same lines, the banner's device list and the run's time left out
    assert _untimed(ttext) == _untimed(jtext)
    assert "derived range_slice=" in jtext
    assert "derived pallas_window_t=" not in ttext

    jr = _rows(f"{jout}/diagnostics.jsonl")
    tr = _rows(f"{tout}/diagnostics.jsonl")
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [2, 3, 4, 5]
    for a, b in zip(tr, jr):
        for k in ("neighbor_max", "neighbor_min", "overflow_cells",
                  "truncated_ranges"):
            assert a[k] == b[k], k
        for k in ("kinetic_energy", "potential_energy", "total_energy",
                  "angular_momentum"):
            assert abs(a[k] - b[k]) <= ENERGY_BAR * abs(b[k]), (k, a, b)
    assert _lines(f"{tout}/neighbors.txt") == _lines(f"{jout}/neighbors.txt")
    if kw is DENSE:
        assert jr[-1]["neighbor_max"] > 10
    t, j = (np.load(f"{d}/final_state.npz") for d in (tout, jout))
    assert sorted(t.files) == sorted(j.files)
    for k, bar in (("position", 1e-6), ("velocity", 1e-6), ("density", 1e-6),
                   ("acceleration", 1e-4)):
        assert _rel_l2(t[k], j[k]) <= bar, k
    np.testing.assert_array_equal(t["neighbor_count"], j["neighbor_count"])
    np.testing.assert_array_equal(t["mass"], j["mass"])
    tmeta = json.load(open(f"{tout}/run.json"))
    jmeta = json.load(open(f"{jout}/run.json"))
    assert tmeta["config"] == jmeta["config"]
    assert tmeta["fingerprint"] == jmeta["fingerprint"]
    assert (tmeta["scene"], tmeta["backend"], tmeta["lazy"],
            tmeta["device"]) == ("disk", "celllist", False, "cpu")


# ---------------------------------------------------------------------------
# the rest of run
# ---------------------------------------------------------------------------

def test_run_writes_every_output(tmp_path, capsys):
    out = str(tmp_path / "o")
    assert main(["run"] + DISK + ["--steps", "5", "--block", "2", "--out",
                                   out]) == 0
    text = capsys.readouterr().out.splitlines()
    assert text[0] == "scene=disk n=512 steps=5 backend=celllist devices=[cpu]"
    assert [ln.split()[1] for ln in text[1:4]] == ["2/5", "4/5", "5/5"]
    assert text[-1].startswith("done: 5 steps in ")
    for name, header in (("energy.txt", "Step, Kinetic Energy"),
                         ("angularmomentum.txt", "Step, Angular Momentum"),
                         ("timing.txt", "Step, Voxelize")):
        rows = _lines(f"{out}/{name}")
        assert rows[0].startswith(header) and len(rows) == 6, name
        assert [r.split(",")[0] for r in rows[1:]] == list("01234")
    assert len(_lines(f"{out}/neighbors.txt")) == 5
    assert [r["step"] for r in _rows(f"{out}/diagnostics.jsonl")] == list(
        range(5))
    meta = json.load(open(f"{out}/run.json"))
    cfg = scenes.scene_config("disk", num_particles=512)
    assert meta["fingerprint"] == tio.config_fingerprint(cfg)
    assert meta["phase_ms"] == {} and meta["device"] == "cpu"
    assert set(np.load(f"{out}/final_state.npz").files) == {
        "position", "velocity", "mass", "density", "acceleration",
        "neighbor_count"}


def test_checkpoint_every_and_resume_start_at_their_rows(tmp_path, capsys):
    """Checkpoints at the block boundaries of every 2 steps; a resume
    starts at the newest one's row and steps as the straight run does."""
    ck, out = str(tmp_path / "ck"), str(tmp_path / "a")
    assert main(["run"] + DISK + ["--steps", "4", "--block", "2", "--out",
                                   out, "--checkpoint-every", "2",
                                   "--checkpoint-dir", ck, "--quiet"]) == 0
    assert sorted(os.listdir(ck)) == ["ckpt_00000002.npz",
                                      "ckpt_00000004.npz"]
    step, cfg, _ = tio.load_checkpoint(f"{ck}/ckpt_00000004.npz", "cpu")
    assert step == 4 and cfg.num_particles == 512
    out2 = str(tmp_path / "b")
    capsys.readouterr()
    assert main(["run", "--resume", "--checkpoint-dir", ck, "--device", "cpu",
                 "--steps", "6", "--block", "2", "--out", out2,
                 "--quiet"]) == 0
    assert capsys.readouterr().out.startswith(
        f"resumed from {ck}/ckpt_00000004.npz at step 4\n")
    resumed = _lines(f"{out2}/energy.txt")[1:]
    assert resumed[0].startswith("4, ") and len(resumed) == 2
    straight = str(tmp_path / "c")
    assert main(["run"] + DISK + ["--steps", "6", "--block", "2", "--out",
                                   straight, "--quiet"]) == 0
    assert _lines(f"{straight}/energy.txt")[5:] == resumed


def test_resume_without_a_checkpoint_stops(tmp_path):
    with pytest.raises(SystemExit, match="--resume: no checkpoint under"):
        main(["run", "--resume", "--checkpoint-dir", str(tmp_path / "none"),
              "--device", "cpu", "--out", str(tmp_path / "o")])


def _recording(monkeypatch, module, name):
    """Wrap ``module.name`` (a step loop) to record each call's config,
    step count and whether it got a carry."""
    calls = []
    real = getattr(module, name)

    def wrapped(cfg, state, k, *args, **kwargs):
        calls.append((cfg, k, kwargs.get("carry") is not None))
        return real(cfg, state, k, *args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_apply_lands_at_its_step(tmp_path, capsys, monkeypatch):
    """The block before the step ends there and the next one steps the
    new config (the eager loop)."""
    calls = _recording(monkeypatch, tstep, "drive_loop")
    out = str(tmp_path / "o")
    assert main(["run"] + DISK + ["--steps", "6", "--block", "4", "--out",
                                   out, "--apply", "3:viscosity=0.5",
                                   "--quiet"]) == 0
    assert "applied at step 3: viscosity=0.5" in capsys.readouterr().out
    assert [(c.viscosity, k) for c, k, _ in calls] == [(0.01, 3), (0.5, 3)]
    assert _lines(f"{out}/energy.txt")[-1].startswith("5, ")


def test_apply_rebuilds_the_lazy_carry(tmp_path, capsys, monkeypatch):
    """Under the lazy driver an apply starts a fresh carry from the
    current state; the blocks after it keep theirs."""
    calls = _recording(monkeypatch, tlazy, "drive_loop_lazy")
    assert main(["run", "--scene", "splash", "-n", "384", "--device", "cpu",
                 "--backend", "pallas", "--set", "cell_size_factor=1.25",
                 "--set", "pallas_window_t=64", "--steps", "8", "--block",
                 "3", "--out", str(tmp_path / "o"), "--apply",
                 "3:viscosity=0.5", "--quiet"]) == 0
    assert "applied at step 3: viscosity=0.5" in capsys.readouterr().out
    assert [(c.viscosity, k, carried) for c, k, carried in calls] == [
        (0.05, 3, False), (0.5, 3, False), (0.5, 2, True)]


def test_lazy_run_unsorts_only_where_the_state_is_read(tmp_path,
                                                       monkeypatch):
    """The lazy run keeps its carry across blocks and brings the state in
    the caller's order up to date only for a checkpoint and the end: each
    holds the state of one straight lazy loop to its step, bit for bit."""
    ov = dict(num_particles=384, cell_size_factor=1.25, pallas_window_t=64)
    cfg, st = tscene("splash", device="cpu", **ov)
    want = {k: tlazy.drive_loop_lazy(cfg, st, k)[0] for k in (4, 6)}
    unsorts = _counting(monkeypatch, tlazy, "unsort_carry")
    ck, out = str(tmp_path / "ck"), str(tmp_path / "o")
    assert main(["run", "--scene", "splash", "-n", "384", "--device", "cpu",
                 "--backend", "pallas", "--set", "cell_size_factor=1.25",
                 "--set", "pallas_window_t=64", "--steps", "6", "--block",
                 "2", "--out", out, "--checkpoint-every", "4",
                 "--checkpoint-dir", ck, "--quiet"]) == 0
    assert len(unsorts) == 2   # the checkpoint at 4 and final_state.npz
    step, _, got = tio.load_checkpoint(f"{ck}/ckpt_00000004.npz", "cpu")
    assert step == 4
    final = tinit.load_state(f"{out}/final_state.npz", "cpu")
    for have, ref in ((got, want[4]), (final, want[6])):
        for a, b in zip(have, ref):
            assert torch.equal(a, b)


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_apply_behind_the_resume_step_lands_at_the_first_block(
        tmp_path, capsys):
    """An apply at or behind the current step lands at the next block
    boundary (the JAX CLI's ``k <= done``)."""
    ck = str(tmp_path / "ck")
    assert main(["run"] + DISK + ["--steps", "4", "--block", "4", "--out",
                                   str(tmp_path / "a"), "--checkpoint-every",
                                   "4", "--checkpoint-dir", ck,
                                   "--quiet"]) == 0
    assert main(["run", "--resume", "--checkpoint-dir", ck, "--device", "cpu",
                 "--steps", "6", "--out", str(tmp_path / "b"), "--apply",
                 "1:viscosity=0.3", "--quiet"]) == 0
    assert "applied at step 4: viscosity=0.3" in capsys.readouterr().out


def test_apply_json_is_consumed_once(tmp_path, capsys):
    out = str(tmp_path / "o")
    os.makedirs(out)
    with open(f"{out}/apply.json", "w") as fh:
        json.dump({"viscosity": 0.25, "gravity": [0, -1, 0]}, fh)
    assert main(["run"] + DISK + ["--steps", "4", "--block", "2", "--out",
                                   out, "--quiet"]) == 0
    assert ("applied at step 0 (apply.json): viscosity=0.25, "
            "gravity=[0, -1, 0]") in capsys.readouterr().out
    assert os.path.exists(f"{out}/apply.json.applied")
    assert not os.path.exists(f"{out}/apply.json")


@pytest.mark.parametrize("payload", [{"bogus_field": 1}, [1, 2],
                                     {"cell_size_factor": 0.5}],
                         ids=["unknown", "not_object", "invalid"])
def test_apply_json_rejected(tmp_path, capsys, payload):
    """A payload that is not an object of config fields, or that gives an
    invalid config, is renamed .rejected and the run goes on."""
    out = str(tmp_path / "o")
    os.makedirs(out)
    with open(f"{out}/apply.json", "w") as fh:
        json.dump(payload, fh)
    assert main(["run"] + DISK + ["--steps", "2", "--block", "2", "--out",
                                   out, "--quiet"]) == 0
    assert "apply.json rejected at step 0: " in capsys.readouterr().err
    assert os.path.exists(f"{out}/apply.json.rejected")
    assert len(_lines(f"{out}/energy.txt")) == 3


def _fake_loop(monkeypatch, fields):
    """Replace the eager loop: the state stays, each block's diagnostics
    are zeros but for ``fields(block_index, k)``."""
    blocks = []

    def drive_loop(cfg, state, k, backend="celllist"):
        d = {n: torch.zeros(k, dtype=torch.float32 if i < 4 else torch.int32)
             for i, n in enumerate(StepDiagnostics._fields)}
        d.update(fields(len(blocks), k))
        blocks.append(k)
        return state, StepDiagnostics(**d)

    monkeypatch.setattr(tstep, "drive_loop", drive_loop)
    return blocks


def test_blowup_exits_2_with_a_checkpoint(tmp_path, capsys, monkeypatch):
    def nan_in_second_block(i, k):
        ke = torch.ones(k)
        if i == 1:
            ke[1] = float("nan")
        return {"kinetic_energy": ke}

    blocks = _fake_loop(monkeypatch, nan_in_second_block)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "o")
    assert main(["run"] + DISK + ["--steps", "10", "--block", "2", "--out",
                                   out, "--checkpoint-dir", ck,
                                   "--quiet"]) == 2
    assert blocks == [2, 2]
    assert ("ABORT at step 4: non-finite energy (checkpoint saved)"
            in capsys.readouterr().err)
    assert tio.load_checkpoint(f"{ck}/ckpt_00000004.npz", "cpu")[0] == 4
    assert len(_rows(f"{out}/diagnostics.jsonl")) == 4
    assert not os.path.exists(f"{out}/final_state.npz")


def test_truncation_warns_once(tmp_path, capsys, monkeypatch):
    _fake_loop(monkeypatch, lambda i, k: {
        "truncated_ranges": torch.full((k,), 3, dtype=torch.int32)})
    out = str(tmp_path / "o")
    assert main(["run"] + DISK + ["--steps", "6", "--block", "2", "--out",
                                   out, "--quiet"]) == 0
    err = capsys.readouterr().err
    assert err.count("WARNING") == 1
    assert ("WARNING at step 2: 6 candidate ranges truncated by capacity "
            "(raise range_slice / kernel window) — interactions are being "
            "dropped") in err
    assert [r["truncated_ranges"] for r in _rows(
        f"{out}/diagnostics.jsonl")] == [3] * 6


def test_signal_handlers_are_restored(tmp_path):
    def mine(signum, frame):
        pass

    with kept_signals():
        signal.signal(signal.SIGUSR1, mine)
        before = signal.getsignal(signal.SIGINT)
        assert main(["run"] + DISK + ["--steps", "2", "--block", "2",
                                       "--out", str(tmp_path / "o"),
                                       "--quiet"]) == 0
        assert signal.getsignal(signal.SIGUSR1) is mine
        assert signal.getsignal(signal.SIGINT) is before


def _spawn(tmp_path):
    """A long CPU run in a subprocess; returns the process once its banner
    (printed after the handlers are installed) is out."""
    out, ck = str(tmp_path / "o"), str(tmp_path / "ck")
    argv = ["run", "--scene", "disk", "-n", "256", "--device", "cpu",
            "--steps", "1000000", "--block", "2", "--out", out,
            "--checkpoint-dir", ck, "--quiet"]
    code = ("import sys\nimport torch\ntorch.set_num_threads(1)\n"
            "from smoothed_particle_hydrodynamics_tpu_torch.__main__ import "
            f"main\nsys.exit(main({argv!r}))\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    banner = p.stdout.readline()
    assert banner.startswith("scene=disk n=256"), (banner, p.poll())
    return p, out, ck


def _wait_rows(path: str, more_than: int, timeout: float = 60.0) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path) and len(_lines(path)) > more_than:
            return len(_lines(path))
        time.sleep(0.05)
    raise AssertionError(f"{path}: no more than {more_than} rows")


def test_sigint_checkpoints_and_exits_130(tmp_path):
    p, out, ck = _spawn(tmp_path)
    try:
        _wait_rows(f"{out}/diagnostics.jsonl", 2)
        p.send_signal(signal.SIGINT)
        stdout, stderr = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 130, stderr
    assert "interrupt: will checkpoint" in stderr
    line = stdout.strip().splitlines()[-1]
    assert line.startswith("interrupted at step "), stdout
    step = int(line.split()[3].rstrip(";"))
    assert step > 0 and step % 2 == 0
    got, cfg, st = tio.load_checkpoint(f"{ck}/ckpt_{step:08d}.npz", "cpu")
    assert got == step and cfg.num_particles == 256 == st.n
    assert len(_rows(f"{out}/diagnostics.jsonl")) == step


def _settled(path: str, quiet: float = 2.0, timeout: float = 60.0) -> int:
    """The row count once it has not changed for ``quiet`` seconds."""
    deadline = time.monotonic() + timeout
    n, since = len(_lines(path)), time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.1)
        m = len(_lines(path))
        if m != n:
            n, since = m, time.monotonic()
        elif time.monotonic() - since >= quiet:
            return n
    raise AssertionError(f"{path}: rows still growing")


def test_sigusr1_pauses_and_resumes(tmp_path):
    """SIGUSR1 pauses at the next block boundary (the block in flight, 2
    rows, may still land) and again resumes."""
    p, out, _ = _spawn(tmp_path)
    rows = f"{out}/diagnostics.jsonl"
    try:
        _wait_rows(rows, 4)                     # past the first blocks
        p.send_signal(signal.SIGUSR1)           # pause
        for line in p.stderr:
            if "paused" in line:
                break
        else:
            raise AssertionError(f"no pause acknowledged: {p.poll()}")
        at_signal = len(_lines(rows))
        held = _settled(rows)
        assert held <= at_signal + 2
        time.sleep(2.0)
        assert len(_lines(rows)) == held and p.poll() is None
        p.send_signal(signal.SIGUSR1)           # resume
        _wait_rows(rows, held)
        p.send_signal(signal.SIGINT)
        _, stderr = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 130, stderr
    assert "resumed" in stderr




class _Parsed(Exception):
    """Raised by the recorder in place of a command: the parse is done."""


def _parsed(monkeypatch, module, name, argv, run):
    seen = []

    def record(args):
        seen.append(args)
        raise _Parsed

    monkeypatch.setattr(module, name, record)
    with pytest.raises(_Parsed):
        run(argv)
    return seen[0]


# the flags this slice ported and the scene flags they go with
SLICE_FLAGS = {"compat", "backend", "exact_ic", "render", "render_every",
               "live", "live_term", "perspective", "camera", "no_box",
               "voxels", "output", "state", "golden", "steps",
               "cell_capacity", "scene", "num_particles"}


@pytest.mark.parametrize("flags", [
    ["run", "--render"], ["run", "--render-every", "5"],
    ["run", "--live", "x.png"], ["run", "--live-term"],
    ["run", "--compat"], ["run", "--exact-ic"],
    ["run", "--backend", "compat"], ["bench", "--compat"],
    ["sweep", "--compat", "--backend", "compat"], ["info", "--compat"],
    ["render", "s.npz", "--compat", "--voxels", "-o", "f.png"],
    ["render", "s.npz", "--camera", "1,2,3", "--no-box", "--perspective"],
    ["parity", "g", "--steps", "3", "--cell-capacity", "96"]])
def test_flags_of_this_slice_parse_as_jax(flags, monkeypatch):
    """``--compat``, ``--backend compat``, ``--exact-ic``, the picture
    flags of ``run`` and the ``render`` and ``parity`` subcommands parse to
    the JAX CLI's values, overrides and resolved backend."""
    from smoothed_particle_hydrodynamics_tpu_torch import __main__ as tmain

    cmd = "cmd_" + flags[0]
    targs = _parsed(monkeypatch, tmain, cmd, flags, tmain.main)
    jargs = _parsed(monkeypatch, jcli, cmd, flags, jcli.main)
    shared = SLICE_FLAGS & set(vars(jargs))
    assert shared <= set(vars(targs)) and shared
    assert {k: vars(targs)[k] for k in shared} == {
        k: vars(jargs)[k] for k in shared}
    if flags[0] == "parity":
        return
    assert tmain._overrides(targs) == jcli._apply_overrides(jargs)
    jcli._resolve_backend(jargs)
    assert tmain._backend(targs.backend, torch.device("cpu"),
                          targs.compat) == jargs.backend


@pytest.mark.parametrize("flag", [["--devices", "2"],
                                  ["--partition", "halo"],
                                  ["--rebalance-threshold", "0.75"]])
def test_multi_device_flags_parse_as_jax(flag, monkeypatch):
    """``--devices``, ``--partition`` and ``--rebalance-threshold`` parse
    to the JAX CLI's values, given and left at their defaults."""
    from smoothed_particle_hydrodynamics_tpu_torch import __main__ as tmain

    argv = ["run"] + flag
    targs = _parsed(monkeypatch, tmain, "cmd_run", argv, tmain.main)
    jargs = _parsed(monkeypatch, jcli, "cmd_run", argv, jcli.main)
    for k in ("devices", "partition", "rebalance_threshold"):
        assert getattr(targs, k) == getattr(jargs, k), k


def test_exact_ic_is_for_the_disk_only(capsys):
    argv = ["run", "--scene", "splash", "--exact-ic"]
    with pytest.raises(SystemExit) as jerr:
        jcli.main(argv)
    with pytest.raises(SystemExit) as terr:
        main(argv + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value) == (
        "--exact-ic only applies to the disk scene")


def test_compat_exact_ic_run_matches_jax(tmp_path, capsys):
    """``run --compat --exact-ic`` on a 2048-particle disk, both CLIs: the
    same stdout, neighbor counts and compat tallies (KE and PE of the
    moving particles, |L| 0)."""
    argv = ["run", "--compat", "--exact-ic", "-n", "2048", "--steps", "6",
            "--block", "3"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    capsys.readouterr()
    with kept_signals():
        assert jcli.main(argv + ["--out", jout]) == 0
    jtext = capsys.readouterr().out
    assert main(argv + ["--out", tout, "--device", "cpu"]) == 0
    ttext = capsys.readouterr().out
    assert [ln.split("  ")[0] for ln in _untimed(ttext)] == [
        ln.split("  ")[0] for ln in _untimed(jtext)]
    assert "backend=compat" in ttext
    jr, tr = (_rows(f"{d}/diagnostics.jsonl") for d in (jout, tout))
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == list(range(6))
    for a, b in zip(tr, jr):
        for k in ("neighbor_max", "neighbor_min", "neighbor_mean"):
            assert a[k] == b[k], k
        for k in ("kinetic_energy", "potential_energy"):
            assert abs(a[k] - b[k]) <= ENERGY_BAR * abs(b[k]), (k, a, b)
        assert a["angular_momentum"] == b["angular_momentum"] == 0.0
    t, j = (np.load(f"{d}/final_state.npz") for d in (tout, jout))
    np.testing.assert_array_equal(t["neighbor_count"], j["neighbor_count"])
    assert _rel_l2(t["position"], j["position"]) <= 1e-6
    meta = json.load(open(f"{tout}/run.json"))
    assert meta["config"]["compat"] and meta["backend"] == "compat"


def test_lazy_flag_and_scan_block(tmp_path):
    """``--no-lazy`` runs the eager loop; ``--scan-block`` changes nothing;
    ``--lazy`` on a backend other than pallas is refused."""
    base = ["run", "--scene", "splash", "-n", "384", "--device", "cpu",
            "--backend", "pallas", "--set", "cell_size_factor=1.25",
            "--set", "pallas_window_t=64", "--steps", "3", "--block", "2",
            "--quiet"]
    outs = {}
    for name, extra in (("lazy", []), ("scan", ["--scan-block", "4"]),
                        ("eager", ["--no-lazy"])):
        outs[name] = str(tmp_path / name)
        assert main(base + ["--out", outs[name]] + extra) == 0
    lazy = [json.load(open(f"{outs[k]}/run.json"))["lazy"] for k in outs]
    assert lazy == [True, True, False]
    a, b = (np.load(f"{outs[k]}/final_state.npz") for k in ("lazy", "scan"))
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    assert _lines(f"{outs['lazy']}/energy.txt") == _lines(
        f"{outs['scan']}/energy.txt")
    with pytest.raises(SystemExit, match="--lazy drives the pallas sweeps"):
        main(["run"] + DISK + ["--backend", "celllist", "--lazy", "--out",
                                str(tmp_path / "x")])


def test_profile_phases_reach_timing_and_run_json(tmp_path, capsys):
    out = str(tmp_path / "o")
    assert main(["run"] + DISK + ["--steps", "2", "--block", "2", "--out",
                                   out, "--profile-phases", "--quiet"]) == 0
    assert "per-phase [ms]: voxelize=" in capsys.readouterr().out
    phases = json.load(open(f"{out}/run.json"))["phase_ms"]
    assert list(phases) == ["voxelize", "neighbors", "density", "pressure",
                            "acceleration", "integrate"]
    row = _lines(f"{out}/timing.txt")[1].split(", ")
    assert float(row[1]) == phases["voxelize"] and float(row[3]) > 0


# ---------------------------------------------------------------------------
# info, watch, sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", sorted(scenes.SCENES))
def test_info_prints_what_jax_prints(scene, capsys):
    argv = ["info", "--scene", scene, "-n", "512", "--set", "viscosity=0.5",
            "--set", "gravity=[0,-2.5,0]"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    assert capsys.readouterr().out == want


def test_info_draws_no_particles(monkeypatch, capsys):
    """``info`` resolves the config alone: the 1M splash's particles are
    never drawn."""
    def refuse(*args, **kwargs):
        raise AssertionError("info drew the particles")

    for name in ("init_splash", "init_dam_break", "init_rotating_sphere"):
        monkeypatch.setattr(scenes, name, refuse)
    assert main(["info", "--scene", "splash"]) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["num_particles"] == 1_000_000 and cfg["grid_nx"] == 128


def _synthetic_jsonl(out: str) -> None:
    """Rows with a blown-up energy, loss counters and a torn last row."""
    os.makedirs(out)
    rows = []
    for s in range(6):
        rows.append(json.dumps({
            "step": s, "kinetic_energy": 1.0 + s,
            "potential_energy": -3.0, "total_energy":
            float("nan") if s == 4 else -2.0 + 0.5 * s,
            "angular_momentum": 10.0 - s, "neighbor_mean": 30.25 + s,
            "neighbor_max": 60 + s, "neighbor_min": s,
            "overflow_cells": 0, "truncated_ranges": 2 * s,
            "halo_dropped": 0, "migration_dropped": 1, "step_ms": 3.5}))
    with open(f"{out}/diagnostics.jsonl", "w") as fh:
        fh.write("\n".join(rows) + '\n{"step": 6, "kin')


@pytest.mark.parametrize("source", ["run", "synthetic"])
def test_watch_once_prints_what_jax_prints(tmp_path, capsys, source):
    out = str(tmp_path / "o")
    if source == "run":
        assert main(["run"] + DISK + ["--steps", "4", "--block", "2",
                                       "--out", out, "--quiet"]) == 0
    else:
        _synthetic_jsonl(out)
    capsys.readouterr()
    assert jcli.main(["watch", "--out", out, "--once"]) == 0
    want = capsys.readouterr().out
    assert main(["watch", "--out", out, "--once"]) == 0
    got = capsys.readouterr().out
    assert got == want and "E_total" in got
    assert ("WARN" in got) == (source == "synthetic")


def test_watch_without_diagnostics_exits_1(tmp_path, capsys):
    missing = str(tmp_path / "nope")
    assert jcli.main(["watch", "--out", missing, "--once"]) == 1
    want = capsys.readouterr().err
    assert main(["watch", "--out", missing, "--once"]) == 1
    assert capsys.readouterr().err == want


SWEEP_KEYS = ["viscosity", "stiffness", "steps", "blowup_step",
              "energy_drift", "neighbor_mean", "stable"]


def test_sweep_schema_and_the_honey_corner(tmp_path, capsys):
    """One record per cell with the JAX CLI's keys; the reference's own
    regime (mu = 10, k = 1e-4) is stable."""
    out = str(tmp_path / "sweep.json")
    assert main(["sweep", "--scene", "honey", "-n", "512", "--device", "cpu",
                 "--steps", "6", "--block", "3", "--viscosity", "0.01,10",
                 "--stiffness", "1e-4", "--out", out]) == 0
    rows = json.load(open(out))
    assert [list(r) for r in rows] == [SWEEP_KEYS] * 2
    by_mu = {r["viscosity"]: r for r in rows}
    assert by_mu[10.0]["stable"] and by_mu[10.0]["blowup_step"] is None
    for r in rows:
        assert r["steps"] == 6 and r["neighbor_mean"] >= 0
        assert np.isfinite(r["energy_drift"])
    text = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in text[:2]] == rows
    assert text[3] == "honey n=512 steps=6 backend=celllist"
    assert text[-1] == f"wrote {out}"


def test_sweep_records_the_blowup_step(tmp_path, monkeypatch):
    def nan_in_second_block(i, k):
        ke = torch.ones(k)
        if i % 2 == 1:
            ke[1] = float("nan")
        return {"kinetic_energy": ke}

    _fake_loop(monkeypatch, nan_in_second_block)
    out = str(tmp_path / "sweep.json")
    assert main(["sweep", "--scene", "honey", "-n", "512", "--device", "cpu",
                 "--steps", "9", "--block", "3", "--viscosity", "1",
                 "--stiffness", "1e-4", "--out", out]) == 0
    (row,) = json.load(open(out))
    assert row["blowup_step"] == 4 and row["steps"] == 6
    assert not row["stable"] and np.isnan(row["energy_drift"])
