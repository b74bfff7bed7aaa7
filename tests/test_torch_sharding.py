"""The torch package's row-sharded steps (``parallel/sharding.py``) on 1, 2
and 4 gloo ranks (one spawned process each, ``parallel.comm.spawn_ranks``)
against the JAX package's ``step_sharded`` / ``step_sharded_halo`` on
virtual CPU meshes of the same size: the cases of ``tests/test_sharding.py``
and ``tests/test_halo.py``.

The states are drawn by the JAX side from its seeds and handed over as
numpy.  Bars against JAX's sharded step on the same mesh size: positions
rtol 1e-6 / atol 1e-7, densities and velocities (what the force sweep
writes) rel-L2 1e-6, neighbor counts,
``neighbor_max`` and the loss counters equal, KE rtol 1e-5.  Densities are
held elementwise (rtol 1e-6, atol 1e-8 on the dilute sphere and 1e-6 on
the packed dam break, as the JAX tests) against the port's own
single-device step, and velocities so at rtol 1e-5 / atol 1e-6: XLA's CPU
compiler contracts poly6's ``h2 - d*d`` into a fused multiply-add, which
moves a pair near the kernel's edge by up to ~1e-4 relative, and the
velocities of a few particles by up to ~5e-5 relative with it (the
single-device steps of the two packages differ so too).  Three gather
steps stay within rtol 1e-5 / atol 1e-6 of JAX's single-device step in
position, and within rel-L2 1e-5 in velocity; the halo step equals the gather oracle (counts,
positions 1e-6); the candidate rows an undersized halo cuts are counted as
the JAX step counts them; every rank's replicated binning sorts alike.

Each world size's runs share one spawn (a module-scoped fixture) with a
time limit; the JAX steps are compiled once per mesh size and variant.
"""

import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.config import SphConfig as JCfg
from smoothed_particle_hydrodynamics_tpu.init import init_rotating_sphere
from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops.step import step as jstep
from smoothed_particle_hydrodynamics_tpu.parallel import sharding as js
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops.step import step as tstep
from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.parallel import sharding as ts
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy

torch.set_num_threads(1)

TIMEOUT_S = 300.0
WORLDS = [1, 2, 4]
DAM = dict(num_particles=4096, grid_nx=32, grid_ny=32, grid_nz=64,
           cell_capacity=16, range_slice=48)


def sphere(n=2048, seed=0):
    cfg = JCfg(num_particles=n, cell_capacity=64, range_slice=96)
    return cfg, init_rotating_sphere(jax.random.PRNGKey(seed), cfg)


def tcfg(jc) -> TCfg:
    return TCfg.from_json(jc.to_json())


def _jax(fn, mesh, state):
    s, d = jax.jit(fn)(js.shard_state(mesh, state))
    return s.to_numpy(), {k: np.asarray(v) for k, v in d._asdict().items()}


CASES = {
    # name: (JAX config and state, steps, variant, halo_rows)
    "halo": (partial(sphere, seed=0), 1, "halo", None),
    "gather": (partial(sphere, seed=0), 1, "gather", None),
    "dam": (lambda: jscene("dam_break", **DAM), 1, "halo", "derived"),
    "three": (partial(sphere, seed=5), 3, "gather", None),
    "halo8": (partial(sphere, seed=2), 1, "halo", 8),
}


@pytest.fixture(scope="module")
def runs():
    """Every world size's port runs, one spawn each: {world: {case: rank
    results}}."""
    out = {}
    for world in WORLDS:
        jobs = []
        for name, (make, steps, variant, halo) in CASES.items():
            jc, jst = make()
            if halo == "derived":
                halo = js.derive_halo_rows(jc, jst, world)
            jobs.append(dict(cfg=tcfg(jc), state=jst.to_numpy(), steps=steps,
                             variant=variant, halo_rows=halo))
        outs = comm.spawn_ranks(world, ts.run_sharded_jobs, jobs,
                                backend="gloo", threads=1,
                                timeout_s=TIMEOUT_S)
        out[world] = {name: [o[i] for o in outs]
                      for i, name in enumerate(CASES)}
    return out


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _single(jc, jst) -> dict:
    """The port's single-device step on the same state."""
    st, _ = tstep(tcfg(jc), state_from_numpy(jst.to_numpy(), "cpu"),
                  backend="celllist")
    return {k: v.numpy() for k, v in st._asdict().items()}


def _check(got: dict, ref_state: dict, ref_diag: dict | None, single: dict,
           rho_atol: float):
    s = got["state"]
    np.testing.assert_allclose(s["position"], ref_state["position"],
                               rtol=1e-6, atol=1e-7)
    assert _rel_l2(s["density"], ref_state["density"]) <= 1e-6
    np.testing.assert_allclose(s["density"], single["density"], rtol=1e-6,
                               atol=rho_atol)
    np.testing.assert_allclose(s["position"], single["position"], rtol=1e-6,
                               atol=1e-7)
    # the force sweep's output (positions move by it only as dt**2)
    assert _rel_l2(s["velocity"], ref_state["velocity"]) <= 1e-6
    np.testing.assert_allclose(s["velocity"], single["velocity"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(s["neighbor_count"],
                                  ref_state["neighbor_count"])
    if ref_diag is not None:
        d = got["diags"]
        np.testing.assert_allclose(d["kinetic_energy"][-1],
                                   ref_diag["kinetic_energy"], rtol=1e-5)
        assert int(d["neighbor_max"][-1]) == int(ref_diag["neighbor_max"])
        for k in ("truncated_ranges", "halo_dropped", "overflow_cells"):
            assert int(d[k][-1]) == int(ref_diag[k]), k


@pytest.mark.parametrize("world", WORLDS)
def test_halo_step_matches_jax(runs, world):
    """The production factory (halo, derived halo) against JAX's."""
    jc, jst = sphere(seed=0)
    mesh = js.make_mesh(world)
    step = js.make_sharded_step(jc, mesh, donate=False)
    s, d = step(js.shard_state(mesh, jst))
    _check(runs[world]["halo"][0], s.to_numpy(),
           {k: np.asarray(v) for k, v in d._asdict().items()},
           _single(jc, jst), 1e-8)
    assert runs[world]["halo"][0]["diags"]["halo_dropped"][0] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_gather_step_matches_jax(runs, world):
    jc, jst = sphere(seed=0)
    mesh = js.make_mesh(world)
    ref = _jax(lambda st: js.step_sharded(jc, mesh, st), mesh, jst)
    _check(runs[world]["gather"][0], *ref, _single(jc, jst), 1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_derived_halo_on_the_packed_dam_break_matches_jax(runs, world):
    """The halo derived from the plane occupancy is a proper subset of the
    slab, drops nothing, and the step matches JAX's at that halo."""
    jc, jst = jscene("dam_break", **DAM)
    halo = js.derive_halo_rows(jc, jst, world)
    mesh = js.make_mesh(world)
    ref = _jax(lambda st: js.step_sharded_halo(jc, mesh, st, halo_rows=halo),
               mesh, jst)
    got = runs[world]["dam"][0]
    assert got["diags"]["halo_dropped"][0] == 0
    _check(got, *ref, _single(jc, jst), 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_halo_equals_gather(runs, world):
    h, g = runs[world]["halo"][0], runs[world]["gather"][0]
    np.testing.assert_array_equal(h["state"]["neighbor_count"],
                                  g["state"]["neighbor_count"])
    np.testing.assert_allclose(h["state"]["position"], g["state"]["position"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(h["state"]["velocity"], g["state"]["velocity"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h["state"]["density"], g["state"]["density"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_three_steps_stay_with_the_single_device_step(runs, world):
    jc, st = sphere(seed=5)
    single = jax.jit(lambda s: jstep(jc, s))
    for _ in range(3):
        st, _ = single(st)
    got = runs[world]["three"][0]
    assert got["diags"]["kinetic_energy"].shape == (3,)
    np.testing.assert_allclose(got["state"]["position"],
                               np.asarray(st.position), rtol=1e-5, atol=1e-6)
    assert _rel_l2(got["state"]["velocity"], st.velocity) <= 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_sorts_alike(runs, world):
    """The replicated binning: every rank's permutation is the same, and a
    permutation of all rows."""
    for name, ranks in runs[world].items():
        order = ranks[0]["order"]
        assert np.array_equal(np.sort(order), np.arange(order.shape[0]))
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["order"], order)
        # every rank gathers the same state and diagnostics
        for r in ranks[1:]:
            for k, v in ranks[0]["diags"].items():
                np.testing.assert_array_equal(r["diags"][k], v)


def test_undersized_halo_is_counted_as_jax_counts_it(runs):
    jc, jst = sphere(seed=2)
    mesh = js.make_mesh(4)
    _, d = _jax(lambda st: js.step_sharded_halo(jc, mesh, st, halo_rows=8),
                mesh, jst)
    got = runs[4]["halo8"][0]["diags"]
    assert got["halo_dropped"][0] > 0
    assert int(got["halo_dropped"][0]) == int(d["halo_dropped"])
    assert int(got["truncated_ranges"][0]) == int(d["truncated_ranges"])


@pytest.mark.parametrize("world", WORLDS + [8])
def test_derive_halo_rows_is_jax(world):
    jc, jst = jscene("dam_break", **DAM)
    tst = state_from_numpy(jst.to_numpy(), "cpu")
    halo = ts.derive_halo_rows(tcfg(jc), tst, world)
    assert halo == js.derive_halo_rows(jc, jst, world)
    assert halo < jc.num_particles // world, "derived halo should be < rows"
    jc2, jst2 = sphere(n=1024, seed=1)
    assert ts.derive_halo_rows(
        tcfg(jc2), state_from_numpy(jst2.to_numpy(), "cpu"), world
    ) == js.derive_halo_rows(jc2, jst2, world)


def test_indivisible_particle_count_rejected():
    jc, jst = sphere(n=1001)
    st = state_from_numpy(jst.to_numpy(), "cpu")
    with pytest.raises(ValueError, match="divisible"):
        ts.shard_state(comm.SlabGroup(0, 8, "cpu"), st)
    with pytest.raises(ValueError, match="divisible"):
        js.step_sharded(jc, js.make_mesh(8), jst)


def test_halo_rows_validation():
    """A halo longer than a rank's rows is refused before any message."""
    jc, jst = sphere()
    group = comm.SlabGroup(0, 8, "cpu")
    local = ts.shard_state(group, state_from_numpy(jst.to_numpy(), "cpu"))
    with pytest.raises(ValueError, match="halo_rows"):
        ts.step_sharded_halo(tcfg(jc), group, local, halo_rows=10_000)
    with pytest.raises(ValueError, match="unknown sharded-step variant"):
        ts.make_sharded_step(tcfg(jc), group, variant="ring")


def test_make_mesh_places_ranks():
    layout = ts.make_mesh(4, "cpu")
    assert layout.devices == ("cpu",) * 4 and layout.backend == "gloo"
    assert layout.world == 4
    assert layout.threads == max(1, (os.cpu_count() or 1) // 4)
    assert layout.describe() == "devices=[cpu, cpu, cpu, cpu] comm=gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.make_mesh(2, "cuda")


def test_make_mesh_shares_fewer_cards_round_robin(monkeypatch):
    """Two cards: NCCL with one rank each up to 2 ranks, gloo round-robin
    beyond (NCCL refuses two ranks on one device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ts.make_mesh(2, "cuda") == (("cuda:0", "cuda:1"), "nccl")
    assert ts.make_mesh(3, "cuda") == (("cuda:0", "cuda:1", "cuda:0"),
                                       "gloo")
    assert ts.make_mesh(None, "cuda").world == 2
    assert ts.make_mesh(3, "cuda").threads == 1


def test_run_steps_sharded_and_the_pool_on_one_rank():
    """``run_steps_sharded`` in an in-process group of one, against the
    single-device step; then a ``RankPool`` of the halo worker, whose
    failing command raises with the rank's traceback and leaves no rank
    alive."""
    from smoothed_particle_hydrodynamics_tpu_torch.state import state_to_numpy

    jc, jst = sphere(n=512, seed=4)
    cfg, st = tcfg(jc), state_from_numpy(jst.to_numpy(), "cpu")
    with comm.local_group("cpu") as group:
        local, d = ts.run_steps_sharded(cfg, group, ts.shard_state(group, st),
                                        2)
    ref = st
    for _ in range(2):
        ref, _ = tstep(cfg, ref, backend="celllist")
    assert d.kinetic_energy.shape == (2,)
    torch.testing.assert_close(local.position, ref.position, rtol=1e-6,
                               atol=1e-7)
    pool = comm.RankPool(2, ts.HaloRanks, cfg.to_json(), state_to_numpy(st),
                         backend="gloo", threads=1, timeout_s=TIMEOUT_S)
    procs = list(pool._procs)
    try:
        rows = pool.call("step", 1)
        assert rows[1] is None and rows[0]["kinetic_energy"].shape == (1,)
        with pytest.raises(RuntimeError, match="AttributeError"):
            pool.call("no_such_command")
        assert not any(p.is_alive() for p in procs)
    finally:
        pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.call("step", 1)


def test_pool_call_waits_its_own_limit():
    """A call's ``limit_s`` replaces the pool's for that wait: a limit
    already past raises ``TimeoutError`` and leaves no rank alive."""
    from smoothed_particle_hydrodynamics_tpu_torch.state import state_to_numpy

    jc, jst = sphere(n=512, seed=4)
    pool = comm.RankPool(2, ts.HaloRanks, tcfg(jc).to_json(),
                         state_to_numpy(state_from_numpy(jst.to_numpy(),
                                                         "cpu")),
                         backend="gloo", threads=1, timeout_s=TIMEOUT_S)
    procs = list(pool._procs)
    try:
        assert pool.call("step", 2, limit_s=2 * TIMEOUT_S)[0][
            "kinetic_energy"].shape == (2,)
        with pytest.raises(TimeoutError, match="RankPool step"):
            pool.call("step", 1, limit_s=1e-9)
        assert not any(p.is_alive() for p in procs)
    finally:
        pool.close()
