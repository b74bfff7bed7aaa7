"""The torch package's distributed slab engine on 2 and 4 gloo ranks (one
process each, ``parallel.comm.spawn_ranks``) against the JAX package's slab
engine on 2- and 4-device virtual CPU meshes.

Whole steps: the 4096-particle dam break on a 32^3 grid of 1.25h cells
(the multi-chip dry run's scene, ``__graft_entry__.py``), its
occupancy-weighted split, one rebuild step and one frozen step, in each
sweep mode: cell-list, exact kernels, capped (K_c = 4) and capped fused.
Bars: neighbor mean, max and min, rebins and every counted loss equal; KE
and PE rel <= 1e-5; collected positions rel-L2 <= 1e-6 and velocities
<= 1e-4.

Counted losses and routing (the JAX engine's ``tests/test_slabs.py``
cases, on the 16^3 dam break at 4 ranks): migration conserves particles, a
mover crossing several slabs between rebins is delivered, an undersized
halo window, migration buffer or slab store is counted exactly as the JAX
engine counts it, a uniformly translating cloud does not rebin, and
``maybe_rebalance`` re-partitions an overloaded split without drops.

Every spawned run has its own time limit and fails instead of hanging.
"""

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops.lazy import skin_half
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs as ts
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from test_torch_slabs import MODES, SCENE, check_steps_match, jax_slab_run

torch.set_num_threads(1)

TIMEOUT_S = 300.0


def _spawn(world: int, jobs: list[dict]) -> list[dict]:
    outs = comm.spawn_ranks(world, ts.run_slab_jobs, jobs, backend="gloo",
                            threads=1, timeout_s=TIMEOUT_S)
    # every rank collects the same store
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0]["position"], outs[0][0]["position"])
    return outs[0]


def _parity_jobs(world: int):
    jc, jst = jscene("dam_break", **SCENE)
    tc = TCfg.from_json(jc.to_json())
    tst = state_from_numpy(jst.to_numpy(), device="cpu")
    zs = ts.derive_zsplit(tc, tst, world)
    caps = ts.derive_slab_caps(tc, tst, world, zsplit=zs)
    jobs, refs = [], []
    for mode, (sweeps, kw) in MODES.items():
        cfg = tc.replace(**kw)
        sub = ts.derive_sub_len_slab(cfg, tst, world, zs) or None
        jobs.append(dict(cfg=cfg, state=jst.to_numpy(), caps=caps, zsplit=zs,
                         steps=2, sweeps=sweeps, sub_len=sub))
        refs.append(lambda kw=kw, sweeps=sweeps, sub=sub: jax_slab_run(
            jc.replace(pallas_interpret=True, **kw), jst, world, caps, zs, 2,
            sweeps, sub))
    return jobs, refs


# ---------------------------------------------------------------------------
# Counted losses and routing, 4 ranks
# ---------------------------------------------------------------------------

def _case(name: str):
    """(JAX config, JAX state, caps, zsplit, steps, rebalance) of a routing
    case on the 16^3 dam break (4 z planes per rank)."""
    n = 2048 if name in ("multi_hop", "small_m") else 4096
    kw = dict(num_particles=n, grid_nx=16, grid_ny=16, grid_nz=16,
              cell_capacity=32, range_slice=64)
    if name == "translation":
        kw["cell_size_factor"] = 1.25
    jc, jst = jscene("dam_break", **kw)
    cells = jc.cell_size / jc.dt * jc.sim_scale   # 1 cell/step, as a speed
    vz = {"migration": 0.4 * cells, "multi_hop": 2.5 * cells,
          "small_m": 0.4 * cells, "small_p": -0.3 * cells,
          "rebalance": -0.3 * cells, "small_h": None,
          "translation": skin_half(jc) / (jc.dt / jc.sim_scale)}[name]
    if name == "translation":   # one full skin of common-mode drift a step
        jst = jst._replace(velocity=jst.velocity * 0.0)
    if vz is not None:
        jst = jst._replace(velocity=jst.velocity.at[:, 2].set(vz))
    tc = TCfg.from_json(jc.to_json())
    tst = state_from_numpy(jst.to_numpy(), device="cpu")
    zs = (ts.derive_zsplit(tc, tst, 4) if name in ("small_p", "rebalance")
          else ts.uniform_zsplit(tc, 4))
    headroom = {"multi_hop": 4.0, "small_h": 1.5}.get(name, 2.0)
    p_cap, h_cap, m_cap = ts.derive_slab_caps(tc, tst, 4, headroom, zs)
    if name == "small_h":
        h_cap = 64       # below the densest plane's population
    if name == "small_m":
        m_cap = 64       # starves the migration buffers
    if name in ("small_p", "rebalance"):
        # just above the initial densest slab: the flow overloads it
        zp = ts._zplane(tc, tst.position[:, 2]).numpy()
        plane = np.bincount(zp, minlength=16)
        pop = max(plane[a:b].sum() for a, b in zip(zs, zs[1:]))
        p_cap = -(-int(pop + 64) // 128) * 128
    steps = {"multi_hop": 2, "small_h": 1, "translation": 6, "small_p": 12,
             "rebalance": 12}.get(name, 4)
    return jc, jst, (p_cap, h_cap, m_cap), zs, steps, (
        (1, 1.2) if name == "rebalance" else None)


CASES = ["migration", "multi_hop", "small_h", "small_m", "small_p",
         "translation", "rebalance"]


@pytest.fixture(scope="module")
def ranks4():
    jobs, refs = _parity_jobs(4)
    for name in CASES:
        jc, jst, caps, zs, steps, reb = _case(name)
        jobs.append(dict(cfg=TCfg.from_json(jc.to_json()), state=jst.to_numpy(),
                         caps=caps, zsplit=zs, steps=steps, rebalance=reb))
    outs = _spawn(4, jobs)
    return dict(zip(list(MODES) + CASES, outs)), dict(zip(MODES, refs))


@pytest.fixture(scope="module")
def ranks2():
    jobs, refs = _parity_jobs(2)
    # a sub frame too short for rank 0's kept rows: rank 1 keeps rank 0's
    # top-plane rows as halo candidates that rank 0 itself dropped
    for fused in (False, True):
        jobs.append(dict(jobs[2], sub_len=768,
                         cfg=jobs[2]["cfg"].replace(capped_fused=fused)))
    names = list(MODES) + ["short_capped", "short_fused"]
    return dict(zip(names, _spawn(2, jobs))), dict(zip(MODES, refs))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_steps_match_jax(request, world, mode):
    outs, refs = request.getfixturevalue(f"ranks{world}")
    got = outs[mode]
    check_steps_match(got, refs[mode]())
    assert got["rebins"] == 1              # the second step ran frozen
    assert got["diags"]["neighbor_mean"][0] > 5.0
    assert all(sum(c) == 4096 for c in got["counts"])


def test_fused_owner_dropped_candidates_stay_bounded(ranks2):
    """A fused-pass candidate whose owner dropped it from its own sub frame
    has no pre-pass density.  The JAX engine reads rho 0 for it, and its
    pressure -rho0 k blows the run up; the port gives it zero mass: the
    same pairs counted as the two-pass path, velocities bounded."""
    outs = ranks2[0]
    capped, fused = outs["short_capped"], outs["short_fused"]
    assert (fused["diags"]["truncated_ranges"] > 0).all()
    for k in ("truncated_ranges", "neighbor_mean", "neighbor_max",
              "neighbor_min"):
        np.testing.assert_array_equal(fused["diags"][k], capped["diags"][k])
    v_f, v_c = np.abs(fused["velocity"]).max(), np.abs(capped["velocity"]).max()
    assert np.isfinite(fused["velocity"]).all() and v_f <= 1.5 * v_c


def _jax_case(name):
    jc, jst, caps, zs, steps, _ = _case(name)
    return jax_slab_run(jc, jst, 4, caps, zs, steps, "celllist")


def test_migration_conserves_particles(ranks4):
    got = ranks4[0]["migration"]
    assert all(sum(c) == 4096 for c in got["counts"])
    assert not got["diags"]["migration_dropped"].any()
    assert len({tuple(c) for c in got["counts"]}) > 1, "nobody migrated"
    check_steps_match(got, _jax_case("migration"))


def test_multi_slab_hop_is_delivered(ranks4):
    got = ranks4[0]["multi_hop"]
    assert not got["diags"]["migration_dropped"].any()
    assert all(sum(c) == 2048 for c in got["counts"])
    check_steps_match(got, _jax_case("multi_hop"))


def test_undersized_halo_is_counted(ranks4):
    got = ranks4[0]["small_h"]
    assert got["diags"]["halo_dropped"][0] > 0
    check_steps_match(got, _jax_case("small_h"))


@pytest.mark.parametrize("name", ["small_m", "small_p"])
def test_capacity_misses_are_counted_as_jax(ranks4, name):
    """A starved migration buffer (m_cap) or slab store (p_cap) loses
    particles, and every one is counted, on the same steps as the JAX
    engine counts them."""
    got = ranks4[0][name]
    dropped = np.cumsum(got["diags"]["migration_dropped"])
    n = 2048 if name == "small_m" else 4096
    assert dropped[-1] > 0
    assert all(sum(c) + k == n for c, k in zip(got["counts"], dropped))
    check_steps_match(got, _jax_case(name))


def test_uniform_translation_never_rebins(ranks4):
    got = ranks4[0]["translation"]
    assert got["rebins"] <= 1 + 6 // 4
    assert not got["diags"]["migration_dropped"].any()
    check_steps_match(got, _jax_case("translation"))


def test_maybe_rebalance_repartitions(ranks4):
    """The split frozen at t=0 overflows as the cloud streams down
    (``small_p``); rebalancing after every step (the first overflow comes
    at the second) re-derives split and caps, and the same run completes
    without a drop."""
    got, static = ranks4[0]["rebalance"], ranks4[0]["small_p"]
    assert static["diags"]["migration_dropped"].sum() > 0
    assert got["rebalanced"] > 0
    assert got["zsplit"] != _case("rebalance")[3]
    assert not got["diags"]["migration_dropped"].any()
    assert all(sum(c) == 4096 for c in got["counts"])


def test_slab_imbalance_and_spawn_failures():
    assert ts.slab_imbalance([100, 100, 100, 100]) == 1.0
    assert ts.slab_imbalance([400, 0, 0, 0]) == 4.0
    # a slab store too small for its population raises on the ranks; the
    # caller sees the error instead of a hang
    jc, jst, caps, zs, _, _ = _case("migration")
    job = dict(cfg=TCfg.from_json(jc.to_json()), state=jst.to_numpy(),
               caps=(128, 128, 128), zsplit=zs, steps=1)
    with pytest.raises(RuntimeError, match=r"(?s)raised:.*p_cap 128"):
        comm.spawn_ranks(2, ts.run_slab_jobs, [job], backend="gloo",
                         threads=1, timeout_s=60.0)
