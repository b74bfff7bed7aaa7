"""``run --devices N --partition {slab,halo} --rebalance-threshold T`` on
the CPU (gloo ranks of a ``parallel.comm.RankPool``) against the JAX CLI's
multi-device run on its virtual CPU mesh.

* The JAX README's case (``dam_break``, ``-n 2048``, 16^3 grid, 2 steps in
  a block of 2), its state drawn by the JAX package and saved as a
  checkpoint that both CLIs resume, slab and halo: the same lines on
  stdout (the banner's device list and the run's time left out),
  ``neighbors.txt`` equal, ``energy.txt``, ``angularmomentum.txt`` and the
  diagnostics records within 1e-5 relative; ``run.json`` records the
  ranks' devices and the comm backend.
* ``--resume`` and ``--apply`` (and ``<out>/apply.json``) at ``--devices
  2`` against the JAX CLI's same runs; a rebalance that fires (a low
  threshold once the dam break's mass has moved) prints the JAX CLI's
  line, split and capacity; the pictures and ``--profile-phases`` at
  ``--devices 2``.
* The backend refusals in the JAX CLI's words, and ``auto`` resolving to
  celllist on the halo partition.
* A blow-up (exit 2) and SIGINT to the whole process group (exit 130, a
  checkpoint) leave no process of the run behind.
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
from smoothed_particle_hydrodynamics_tpu.utils import io as jio
from smoothed_particle_hydrodynamics_tpu_torch.__main__ import _backend, main
from smoothed_particle_hydrodynamics_tpu_torch.utils import io as tio
from smoothed_particle_hydrodynamics_tpu_torch.utils.leftover import (
    session_processes)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = ["--scene", "dam_break", "-n", "2048", "--set", "grid_nx=16",
        "--set", "grid_ny=16", "--set", "grid_nz=16"]
BAR = 1e-5


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


def _lines(path) -> list[str]:
    with open(path) as fh:
        return fh.read().splitlines()


def _rows(path) -> list[dict]:
    return [json.loads(x) for x in _lines(path) if x.strip()]


def _untimed(text: str) -> list[str]:
    out = []
    for ln in text.splitlines():
        if ln.startswith("scene="):
            ln = ln.partition(" devices=")[0]
        elif ln.startswith("done: "):
            ln = ln.partition(" in ")[0]
        elif ln.startswith("step ") and " ms/step" in ln:
            ln = ln.partition("  ")[0]
        out.append(ln)
    return out


def _numbers(path) -> np.ndarray:
    """The comma-separated numbers of a reference text file, header out."""
    rows = [ln for ln in _lines(path) if ln and not ln.startswith("Step")]
    return np.asarray([[float(x) for x in ln.split(",")] for ln in rows])


def _same_files(tout, jout) -> None:
    assert _lines(f"{tout}/neighbors.txt") == _lines(f"{jout}/neighbors.txt")
    for name in ("energy.txt", "angularmomentum.txt"):
        t, j = _numbers(f"{tout}/{name}"), _numbers(f"{jout}/{name}")
        np.testing.assert_array_equal(t[:, 0], j[:, 0])   # the steps
        # the files print 6 significant digits: half a unit of the last on
        # each side on top of the bar
        np.testing.assert_allclose(t[:, 1:], j[:, 1:], rtol=BAR + 1e-5,
                                   atol=1e-30)
    tr, jr = _rows(f"{tout}/diagnostics.jsonl"), _rows(f"{jout}/diagnostics.jsonl")
    assert [r["step"] for r in tr] == [r["step"] for r in jr]
    for a, b in zip(tr, jr):
        for k in ("neighbor_max", "neighbor_min", "overflow_cells",
                  "truncated_ranges", "halo_dropped", "migration_dropped"):
            assert a[k] == b[k], k
        for k in ("kinetic_energy", "potential_energy", "angular_momentum",
                  "neighbor_mean"):
            assert abs(a[k] - b[k]) <= BAR * max(abs(b[k]), 1e-30), k


def _start(tmp_path, tag: str) -> dict:
    """The case's state, drawn by the JAX package, as a step-0 checkpoint
    in a directory of each CLI's (the two packages draw their scenes from
    different generators): {"jax": dir, "torch": dir}."""
    cfg, st = jscene("dam_break", num_particles=2048, grid_nx=16,
                     grid_ny=16, grid_nz=16)
    dirs = {}
    for who in ("jax", "torch"):
        dirs[who] = str(tmp_path / f"{tag}_ck_{who}")
        jio.save_checkpoint(dirs[who], 0, cfg, st)
    return dirs


def _both(tmp_path, capsys, argv, tag="run"):
    """``argv`` through the JAX CLI and the port's, each resuming the
    case's checkpoint from its own directory; outputs and stdouts."""
    ck = _start(tmp_path, tag)
    jout, tout = str(tmp_path / f"{tag}_jax"), str(tmp_path / f"{tag}_torch")
    argv = argv + ["--resume"]
    capsys.readouterr()
    with kept_signals():
        assert jcli.main(argv + ["--out", jout, "--checkpoint-dir",
                                 ck["jax"]]) == 0
    jtext = capsys.readouterr().out.replace(ck["jax"], ck["torch"])
    assert main(argv + ["--out", tout, "--device", "cpu", "--checkpoint-dir",
                        ck["torch"]]) == 0
    ttext = capsys.readouterr().out
    return jout, tout, jtext, ttext


@pytest.mark.parametrize("partition", ["slab", "halo"])
def test_run_matches_the_jax_cli(tmp_path, capsys, partition):
    argv = ["run", *CASE, "--steps", "2", "--block", "2", "--devices", "2",
            "--partition", partition]
    jout, tout, jtext, ttext = _both(tmp_path, capsys, argv)
    assert _untimed(ttext) == _untimed(jtext)
    assert ("scene=dam_break n=2048 steps=2 backend=celllist "
            "devices=[cpu, cpu] comm=gloo") in ttext
    _same_files(tout, jout)
    meta = json.load(open(f"{tout}/run.json"))
    assert meta["devices"] == ["cpu", "cpu"] and meta["comm"] == "gloo"
    assert meta["partition"] == partition and meta["backend"] == "celllist"
    st = np.load(f"{tout}/final_state.npz")
    assert st["position"].shape == (2048, 3)
    assert np.isfinite(st["position"]).all()


def test_resume_and_apply_match_the_jax_cli(tmp_path, capsys):
    """A checkpointed slab run, then ``--resume`` with an ``--apply`` and an
    ``apply.json`` waiting in the output directory, through both CLIs."""
    base = ["run", *CASE, "--devices", "2", "--block", "2", "--quiet",
            "--checkpoint-every", "2"]
    _both(tmp_path, capsys, base + ["--steps", "2"], "a")
    for tag in ("jax", "torch"):
        out = tmp_path / f"b_{tag}"
        out.mkdir()
        (out / "apply.json").write_text(json.dumps({"damping": 0.4}))
    ck = {who: str(tmp_path / f"a_ck_{who}") for who in ("jax", "torch")}
    resume = base + ["--resume", "--steps", "6", "--apply",
                     "3:viscosity=0.2"]
    capsys.readouterr()
    with kept_signals():
        assert jcli.main(resume + ["--checkpoint-dir", ck["jax"], "--out",
                                   str(tmp_path / "b_jax")]) == 0
    jtext = capsys.readouterr().out.replace(ck["jax"], ck["torch"])
    assert main(resume + ["--checkpoint-dir", ck["torch"], "--out",
                          str(tmp_path / "b_torch"), "--device", "cpu"]) == 0
    ttext = capsys.readouterr().out
    assert "resumed from" in ttext and "at step 2" in ttext
    assert "applied at step 2 (apply.json): damping=0.4" in ttext
    assert "applied at step 3: viscosity=0.2" in ttext
    assert _untimed(ttext) == _untimed(jtext)
    _same_files(tmp_path / "b_torch", tmp_path / "b_jax")
    assert _numbers(tmp_path / "b_torch" / "energy.txt")[0, 0] == 2
    assert os.path.exists(tmp_path / "b_torch" / "apply.json.applied")
    got, cfg, _ = tio.load_checkpoint(f"{ck['torch']}/ckpt_00000006.npz",
                                      "cpu")
    assert got == 6 and cfg.viscosity == 0.2 and cfg.damping == 0.4


def test_rebalance_fires_as_in_the_jax_cli(tmp_path, capsys):
    """The dam break's column falls: after a block the per-rank counts
    drift off the t=0 split, and a threshold just above 1 re-partitions
    it at the same step, with the same split and store capacity."""
    argv = ["run", *CASE, "--steps", "4", "--block", "2", "--devices", "2",
            "--rebalance-threshold", "1.01", "--quiet"]
    jout, tout, jtext, ttext = _both(tmp_path, capsys, argv, "reb")
    moved = [ln for ln in ttext.splitlines() if ln.startswith("rebalanced")]
    assert moved and moved == [ln for ln in jtext.splitlines()
                               if ln.startswith("rebalanced")]
    _same_files(tout, jout)


def test_pictures_and_phases_with_ranks(tmp_path, capsys):
    """``--render``, ``--live``, ``--live-term`` and ``--profile-phases``
    read the ranks' state at block boundaries as on one device."""
    out, live = tmp_path / "pic", tmp_path / "live.png"
    assert main(["run", *CASE, "--steps", "4", "--block", "2", "--devices",
                 "2", "--partition", "halo", "--render", "--render-every",
                 "2", "--live", str(live), "--live-term", "--profile-phases",
                 "--out", str(out), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "wrote" in text and "sph_anim.gif (2 frames)" in text
    assert "per-phase [ms]:" in text and "\x1b[2J\x1b[H" in text
    assert live.read_bytes().startswith(b"\x89PNG")
    assert (out / "sph_anim.gif").read_bytes().startswith(b"GIF")
    timing = _numbers(out / "timing.txt")
    assert timing.shape == (4, 7) and (timing[:, 1:6] > 0).any()


@pytest.mark.parametrize("partition,backend", [("slab", "pairwise"),
                                               ("halo", "pallas")])
def test_backends_refused_in_the_jax_words(partition, backend):
    argv = ["run", *CASE, "--steps", "2", "--devices", "2", "--partition",
            partition, "--backend", backend, "--quiet"]
    with kept_signals(), pytest.raises(SystemExit) as jerr:
        jcli.main(argv + ["--out", "/nonexistent/never"])
    with pytest.raises(SystemExit) as terr:
        main(argv + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value)
    assert backend in str(terr.value)


def test_auto_backend_on_the_halo_partition_is_celllist():
    """As the JAX CLI's ``_resolve_backend``: the halo-sharded step has
    only the cell-list sweeps, on the card too; the slab engine runs the
    kernels there; one device keeps the single-device rule."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _backend("auto", cuda, False, 2, "halo") == "celllist"
    assert _backend("auto", cuda, False, 2, "slab") == "pallas"
    assert _backend("auto", cuda, False, 1, "halo") == "pallas"
    assert _backend("auto", cpu, False, 2, "slab") == "celllist"
    assert _backend("auto", cuda, True, 2, "halo") == "compat"
    for devices, partition in ((2, "halo"), (2, "slab"), (0, "halo")):
        ns = jcli.argparse.Namespace(backend="auto", compat=False,
                                     devices=devices, partition=partition)
        jcli._resolve_backend(ns)
        assert ns.backend == _backend("auto", cpu, False, devices, partition)


def test_one_device_takes_the_single_device_path(tmp_path, capsys):
    assert main(["run", *CASE, "--steps", "2", "--block", "2", "--devices",
                 "1", "--partition", "halo", "--out", str(tmp_path / "o"),
                 "--device", "cpu", "--quiet"]) == 0
    banner = capsys.readouterr().out.splitlines()[0]
    assert banner.endswith("backend=celllist devices=[cpu]")
    assert "comm" not in json.load(open(tmp_path / "o" / "run.json"))


def test_blocks_wait_in_proportion_and_scan_block_changes_nothing(
        tmp_path, capsys, monkeypatch):
    """A block of n steps waits n times the pool's limit (the other
    commands wait it once); ``--scan-block`` is accepted on the ranks and
    gives the same files."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm

    calls, call = [], comm.RankPool.call

    def spy(self, name, *a, limit_s=None):
        calls.append((name, a, limit_s and limit_s / self.timeout_s))
        return call(self, name, *a, limit_s=limit_s)

    monkeypatch.setattr(comm.RankPool, "call", spy)
    argv = ["run", *CASE, "--steps", "5", "--block", "3", "--devices", "2",
            "--device", "cpu", "--quiet"]
    for tag, extra in (("plain", []), ("scan", ["--scan-block", "4"])):
        assert main(argv + extra + ["--out", str(tmp_path / tag)]) == 0
    capsys.readouterr()
    steps = [c for c in calls if c[0] == "step"]
    assert steps == [("step", (3,), 3), ("step", (2,), 2)] * 2
    assert all(c[2] is None for c in calls if c[0] != "step")
    for name in ("energy.txt", "neighbors.txt", "diagnostics.jsonl"):
        if name == "diagnostics.jsonl":
            key = lambda r: {k: v for k, v in r.items() if k != "step_ms"}
            assert ([key(r) for r in _rows(tmp_path / "scan" / name)]
                    == [key(r) for r in _rows(tmp_path / "plain" / name)])
        else:
            assert (_lines(tmp_path / "scan" / name)
                    == _lines(tmp_path / "plain" / name))


def _spawn(tmp_path, extra: list[str]):
    out, ck = str(tmp_path / "out"), str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    p = subprocess.Popen(
        [sys.executable, "-m", "smoothed_particle_hydrodynamics_tpu_torch",
         "run", *CASE, "--devices", "2", "--device", "cpu", "--block", "2",
         "--out", out, "--checkpoint-dir", ck, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    return p, out, ck


def _session_empties(sid: int, timeout: float = 10.0) -> dict:
    """The run's session once it is empty, or what is left at the time
    limit."""
    deadline = time.monotonic() + timeout
    while (left := session_processes(sid)) and time.monotonic() < deadline:
        time.sleep(0.1)
    return left


def test_blowup_exits_2_and_leaves_no_process(tmp_path):
    p, out, ck = _spawn(tmp_path, ["--steps", "6", "--set",
                                   "gravity=[0,-Infinity,0]"])
    try:
        _, stderr = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 2, stderr
    assert "ABORT at step 2: non-finite energy" in stderr
    assert os.path.exists(f"{ck}/ckpt_00000002.npz")
    assert _session_empties(p.pid) == {}


def test_sigint_to_the_process_group_exits_130(tmp_path):
    """Ctrl-C reaches the whole foreground process group: the ranks ignore
    it, the CLI checkpoints at the end of the block and stops them."""
    p, out, ck = _spawn(tmp_path, ["--steps", "100000"])
    try:
        rows = f"{out}/diagnostics.jsonl"
        deadline = time.monotonic() + 240
        while not (os.path.exists(rows) and len(_lines(rows)) >= 2):
            assert p.poll() is None and time.monotonic() < deadline, (
                p.poll(), p.stderr.read() if p.poll() is not None else "")
            time.sleep(0.05)
        os.killpg(p.pid, signal.SIGINT)
        stdout, stderr = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert p.returncode == 130, stderr
    line = stdout.strip().splitlines()[-1]
    assert line.startswith("interrupted at step "), stdout
    step = int(line.split()[3].rstrip(";"))
    got, cfg, st = tio.load_checkpoint(f"{ck}/ckpt_{step:08d}.npz", "cpu")
    assert got == step and st.n == 2048 and np.isfinite(
        st.position.numpy()).all()
    assert _session_empties(p.pid) == {}
