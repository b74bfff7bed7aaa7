"""The four host-side probes of the port (``tools/probe_{cond,scan,
dispatch,tally}.py`` of the torch package) against the JAX tools of the
same names, loaded by path.

- ``probe_cond``: the production ``lazy_step`` pinned frozen (A) and the
  tool's ``frozen_step`` (B) give the same carry and diagnostics bit for
  bit, exact and capped; B against the JAX tool's ``frozen_step`` (kernels
  in interpreter mode) on one state: counts equal, rho rel-L2 <= 1e-6, acc
  rel-L2 <= 1e-4 (the sweeps' own bars against JAX);
- ``probe_scan``: its K-step body bit-equal to K ``lazy_step`` calls on
  frozen bins, the spreads it records the ones ``lazy_step`` tests;
- ``probe_dispatch``: its kdk variants against the JAX tool's (its
  ``bench`` patched to keep what each program returns) on one state:
  positions and velocities rel-L2 <= 1e-6, tallies rel <= 1e-6 (XLA's CPU
  compiler contracts multiply-adds into FMAs; the port rounds each op);
- ``probe_tally``: the five formulations and the production reference
  against each other and against the JAX tool's, rel <= 1e-6 (f32 sums of
  the same terms in other orders);
- each tool's ``main`` runs on the CPU.

The state is the disk's (central gravity, so the potential and the
angular momentum are not zero), made by the JAX package and handed to
both as numpy arrays.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import lazy as jlazy
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from smoothed_particle_hydrodynamics_tpu_torch.tools import (probe_cond,
                                                             probe_dispatch,
                                                             probe_scan,
                                                             probe_tally)

# The twins gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores.
torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.cache
def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(scene: str, **kw):
    """(JAX cfg, JAX state, port cfg, port state) of one scene state."""
    jc, js = jscene(scene, **kw)
    return (jc, js, TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device="cpu"))


@functools.cache
def _splash(k_c: int = 0):
    """The lazy tests' 768-particle splash at 1.25h cells, window 64."""
    kw = dict(num_particles=768, cell_size_factor=1.25, pallas_window_t=64,
              pallas_interpret=True)
    if k_c:
        kw.update(capped_candidates=k_c)
    return _pair("splash", **kw)


@functools.cache
def _disk():
    return _pair("disk", num_particles=2048)


def _same(a, b) -> bool:
    """Equal NamedTuples of tensors (or ints, or None), field by field."""
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif isinstance(x, tuple):
            if not _same(x, y):
                return False
        elif x != y:
            return False
    return True


# ---------------------------------------------------------------------------
# probe_cond
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_c", (0, 4), ids=("exact", "capped"))
def test_cond_production_and_frozen_step_bit_equal(k_c):
    _, _, tc, ts = _splash(k_c)
    carry = probe_cond.pin_frozen(lazy.init_lazy(tc, ts))
    a, da = lazy.lazy_step(tc, carry)
    b, db = probe_cond.frozen_step(tc, carry)
    assert a.rebin_count == 0 and a.steps_since == b.steps_since == 1
    assert _same(a, b) and _same(da, db)


def test_cond_frozen_step_matches_the_jax_tools():
    jc, js, tc, ts = _splash()
    jcarry = jax.jit(functools.partial(jlazy.init_lazy, jc))(js)
    jout, _ = jax.jit(functools.partial(_jax_tool("probe_cond").frozen_step,
                                        jc))(jcarry)
    out, _ = probe_cond.frozen_step(tc, lazy.init_lazy(tc, ts))
    np.testing.assert_array_equal(out.order.numpy(), np.asarray(jout.order))
    np.testing.assert_array_equal(out.state.neighbor_count.numpy(),
                                  np.asarray(jout.state.neighbor_count))
    assert _rel(out.state.density, jout.state.density) <= 1e-6
    assert _rel(out.state.acceleration, jout.state.acceleration) <= 1e-4


def test_cond_nosweeps_step_keeps_the_machinery():
    _, _, tc, ts = _splash()
    carry = lazy.init_lazy(tc, ts)
    c, d = probe_cond.frozen_step_nosweeps(tc, carry)
    assert c.steps_since == 1 and int(d.neighbor_max) == 0
    assert torch.isfinite(c.state.position).all()
    assert torch.equal(c.state.density, torch.ones_like(ts.mass))


# ---------------------------------------------------------------------------
# probe_scan
# ---------------------------------------------------------------------------

def test_scan_body_equals_k_lazy_steps():
    _, _, tc, ts = _splash()
    k = 2
    carry = lazy.init_lazy(tc, ts)
    c, spreads, ys = probe_scan.k_steps(tc, carry, k, ys=True)
    ref, diags, want = carry, [], []
    for _ in range(k):
        want.append(float(lazy.drift_spread(ref.state.position,
                                            ref.pos_bin)))
        ref, d = lazy.lazy_step(tc, ref)
        diags.append(d)
    assert ref.rebin_count == 0, "the K steps must stay on frozen bins"
    assert max(want) <= probe_scan.threshold(tc)
    assert _same(c, ref)
    assert spreads.tolist() == want
    assert all(torch.equal(y, torch.stack(f)) for y, f in
               zip(ys, zip(*diags)))
    assert probe_scan.k_steps(tc, carry, k, ys=False)[2] is None


def test_scan_rebinned_and_load():
    _, _, tc, ts = _splash()
    carry = lazy.init_lazy(tc, ts)
    moved = probe_scan.k_steps(tc, carry, 2)[0]
    fresh = probe_scan.rebinned(tc, moved)
    assert float(lazy.drift_spread(fresh.state.position, fresh.pos_bin)) == 0
    assert fresh.rebin_count == carry.rebin_count + 1
    static = lazy.init_lazy(tc, ts)
    probe_scan.load(static, fresh)
    assert _same(static.state, fresh.state)
    assert all(torch.equal(getattr(static, f), getattr(fresh, f))
               for f in ("order", "pos_bin", "cid", "cell_start"))


def test_device_constants_leave_host_tensors_alone():
    with probe_scan.DeviceConstants() as consts:
        a = torch.tensor([1.0, 2.0], dtype=torch.float32, device="cpu")
        b = torch.tensor([1.0, 2.0], dtype=torch.float32, device="cpu")
    assert a is not b and not consts.cache
    assert torch.tensor is consts._orig


# ---------------------------------------------------------------------------
# probe_dispatch and probe_tally against the JAX tools
# ---------------------------------------------------------------------------

def _jax_outputs(name: str, monkeypatch) -> list:
    """What each program of the JAX tool's ``main`` returns, in its order,
    on the disk state (its ``make_scene`` and ``bench`` patched)."""
    jc, js, _, _ = _disk()
    mod = _jax_tool(name)
    got = []

    def bench(label, fn, *args, iters=20):
        got.append((label, jax.jit(fn)(*args)))
        return 0.0

    monkeypatch.setattr(mod, "make_scene", lambda *a, **k: (jc, js))
    monkeypatch.setattr(mod, "bench", bench)
    mod.main(js.position.shape[0])
    return got


def _tally_close(a, b, rel=1e-6) -> None:
    for x, y in zip(a, b):
        x, y = float(x), float(y)
        assert abs(x - y) <= rel * max(abs(y), 1e-30), (x, y)


def test_dispatch_kdk_variants_match_the_jax_tools(monkeypatch):
    _, _, tc, ts = _disk()
    jax_out = _jax_outputs("probe_dispatch", monkeypatch)
    acc = torch.zeros_like(ts.position)
    port = list(probe_dispatch.variants(tc, ts, acc).items())
    assert len(port) == len(jax_out) == 9
    for (pname, call), (jname, jres) in zip(port[4:], jax_out[4:]):
        got = call()
        if jname.startswith("energy_tally"):
            _tally_close(got[:3], jres[:3])
            continue
        if isinstance(got[0], torch.Tensor):        # (pos, vel)
            (pos, vel), (jpos, jvel) = got, jres
        else:                                       # (state, tally)
            (st, tally), (jst, jtally) = got, jres
            pos, vel, jpos, jvel = (st.position, st.velocity, jst.position,
                                    jst.velocity)
            _tally_close(tally[:3], jtally[:3])
        assert _rel(pos, jpos) <= 1e-6, pname
        assert _rel(vel, jvel) <= 1e-6, pname
    for (_, call), (_, jres) in zip(port[:4], jax_out[:4]):
        assert _rel(call(), jres) <= 1e-6


def test_tally_formulations_match_each_other_and_the_jax_tools(monkeypatch):
    _, _, tc, ts = _disk()
    jax_out = _jax_outputs("probe_tally", monkeypatch)
    acc = torch.zeros_like(ts.position)
    port = [fn(tc, ts, acc) for fn in probe_tally.VARIANTS.values()]
    assert len(port) == len(jax_out) == 6
    ref = port[-1]
    for got, (jname, jres) in zip(port, jax_out):
        if jname.startswith("kdk production"):
            jres = (jres[0].position, jres[0].velocity,
                    jres[1].kinetic, jres[1].potential,
                    jres[1].angular_momentum)
        _tally_close(got[2:], ref[2:])
        _tally_close(got[2:], jres[2:])
        assert _rel(got[0], jres[0]) <= 1e-6 and _rel(got[1], jres[1]) <= 1e-6
    assert float(ref[3]) < 0 and float(ref[4]) > 0


# ---------------------------------------------------------------------------
# each tool's main on the CPU
# ---------------------------------------------------------------------------

def test_mains_run_on_the_cpu(capsys):
    r = probe_dispatch.main(2048, device="cpu", iters=1)
    assert len(r["ms"]) == 9
    r = probe_tally.main(2048, device="cpu", iters=1)
    assert len(r["values"]) == 6
    r = probe_cond.main(512, 4, 1, device="cpu")
    assert set(r["median"]) == {"A lazy_step (host read)",
                                "B frozen, no read", "C frozen, no sweeps"}
    r = probe_scan.main(512, "splash", k=2, rounds=1, device="cpu")
    assert set(r["ms"]) == {"host loop", "loop K=2, diag ys",
                            "loop K=2, no ys"}
    out = capsys.readouterr().out
    assert out.count("cpu (host times") == 4 and "A - B" in out
