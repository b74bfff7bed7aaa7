"""Compat mode (the C++ reference's quirks) in the torch package against
the JAX package's ``compat/``, ``ops/kernels.py`` and the compat branches
of ``ops/physics.py``, ``ops/integrate.py`` and ``ops/step.py``.

Scene: the reference's 32,768-particle disk from ``exact_ic`` (JAX's
``find_neighbors_compat`` takes ~2 s on the CPU there, so the full size is
used), and a dense Gaussian cloud on the same grid whose rows fill the
32-slot tables (the disk's rows hold 0-7 neighbors).  Bars:

* the glibc ``rand`` stream equal to libc's and JAX's; ``exact_ic`` states,
  ``_trunc_mod``, the LCG wrap and the cell tables bit-equal;
* neighbor ids, stored distances and counts bit-equal for both ``slot4``
  modes (the squared distance in XLA:CPU's fused form, ``physics.dot3``);
* the step's rho from the same state bit-equal (XLA:CPU's 8-lane slot
  sum); after steps: counts equal, positions rel-L2 <= 1e-6, acc rel-L2 <=
  1e-4 (``tests/test_golden_parity.py:93-95``), as ``s ** expo`` (quirk 2)
  rounds differently in torch and XLA;
* the compat tallies rel <= 1e-6; the ``parity`` subcommand's output lines
  and exit code equal to the JAX CLI's on synthesized golden dumps, its
  errors to 1e-3 of JAX's (they are printed to 4 digits, and the port's
  positions differ from JAX's in their last bits).
"""

import ctypes
import ctypes.util
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu import cli as jcli
from smoothed_particle_hydrodynamics_tpu.compat import crand as jcrand
from smoothed_particle_hydrodynamics_tpu.compat import exact_ic as jic
from smoothed_particle_hydrodynamics_tpu.compat import golden as jgolden
from smoothed_particle_hydrodynamics_tpu.compat import neighbors as jnb
from smoothed_particle_hydrodynamics_tpu.compat import step as jstep
from smoothed_particle_hydrodynamics_tpu.config import SphConfig as JCfg
from smoothed_particle_hydrodynamics_tpu.ops import integrate as jint
from smoothed_particle_hydrodynamics_tpu.ops import kernels as jkern
from smoothed_particle_hydrodynamics_tpu.ops import pairwise as jpair
from smoothed_particle_hydrodynamics_tpu.ops import step as jops_step
from smoothed_particle_hydrodynamics_tpu.state import ParticleState as JState
from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main
from smoothed_particle_hydrodynamics_tpu_torch.compat import crand, golden
from smoothed_particle_hydrodynamics_tpu_torch.compat import exact_ic
from smoothed_particle_hydrodynamics_tpu_torch.compat import neighbors as tnb
from smoothed_particle_hydrodynamics_tpu_torch.compat import step as tstep
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import integrate as tint
from smoothed_particle_hydrodynamics_tpu_torch.ops import kernels as tkern
from smoothed_particle_hydrodynamics_tpu_torch.ops import pairwise as tpair
from smoothed_particle_hydrodynamics_tpu_torch.ops import step as tops_step
from smoothed_particle_hydrodynamics_tpu_torch.state import (
    ParticleState, state_from_numpy)

torch.set_num_threads(1)

N = 32 * 1024
# the golden harness's config (tests/test_golden_parity.py:47), and the
# parity subcommand's default
GOLDEN_CFG = dict(num_particles=N, cell_capacity=64)
POS_BAR, ACC_BAR, TALLY_BAR = 1e-6, 1e-4, 1e-6
STEPS = 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _to_torch(js: JState) -> ParticleState:
    return state_from_numpy({k: np.asarray(v) for k, v in
                             js._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def disk():
    """The exact-IC disk in both packages (each package's own init)."""
    jc, tc = JCfg(num_particles=N), TCfg(num_particles=N)
    return jc, jic.reference_initial_state(jc), tc, \
        exact_ic.reference_initial_state(tc, device="cpu")


@pytest.fixture(scope="module")
def dense():
    """A Gaussian cloud at the box center: up to the 24-neighbor early exit
    and the 8-row blocks' four accepted lanes on many rows (and a few
    cells over capacity, whose extra rows both tables drop)."""
    rng = np.random.default_rng(0)
    pos = (3.2 + rng.normal(size=(N, 3)) * 0.4).astype(np.float32)
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    jc, tc = JCfg(num_particles=N), TCfg(num_particles=N)
    js = JState.from_arrays(jnp.asarray(pos), jnp.asarray(vel), cfg=jc)
    return jc, js, tc, _to_torch(js)


@pytest.fixture(scope="module")
def trajectory(disk):
    """STEPS compat steps of the disk under the golden harness's config,
    JAX's and the port's."""
    _, js, _, ts = disk
    jc, tc = JCfg(**GOLDEN_CFG), TCfg(**GOLDEN_CFG)
    jf = jax.jit(partial(jstep.compat_step, jc))
    out = [(js, None, ts, None)]
    for _ in range(STEPS):
        js, jd = jf(js)
        ts, td = tstep.compat_step(tc, ts)
        out.append((js, jd, ts, td))
    return out


# ---------------------------------------------------------------------------
# crand, exact_ic
# ---------------------------------------------------------------------------

def test_rand_stream_matches_libc_and_jax():
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    for seed, count in ((42, 5000), (7, 100)):
        libc.srand(seed)
        want = [libc.rand() for _ in range(count)]
        assert crand.rand_stream(seed, count) == want
        assert jcrand.rand_stream(seed, count) == want
    cur = crand.CRand(42, prefetch=10)       # refills past its prefetch
    assert [cur.next() for _ in range(25)] == crand.rand_stream(42, 25)


def test_exact_ic_bit_equal_to_jax(disk):
    jc, js, tc, ts = disk
    np.testing.assert_array_equal(ts.position.numpy(), np.asarray(js.position))
    np.testing.assert_array_equal(ts.velocity.numpy(), np.asarray(js.velocity))
    np.testing.assert_array_equal(ts.mass.numpy(), np.asarray(js.mass))
    # the disk scene's exact_ic, its first particles a prefix of the stream
    cfg, st = make_scene("disk", device="cpu", exact_ic=True,
                         num_particles=512)
    assert cfg == TCfg(num_particles=512)
    assert torch.equal(st.position, ts.position[:512])
    assert torch.equal(st.velocity, ts.velocity[:512])


# ---------------------------------------------------------------------------
# neighbors
# ---------------------------------------------------------------------------

def test_trunc_mod_matches_c_and_jax():
    """C's % truncates toward zero, the sign follows the dividend (the
    cases of ``tests/test_compat_units.py:13-27``), and the int32 edge."""
    for a, b, want in ((7, 3, 1), (-7, 3, -1), (7, 1, 0)):
        assert int(tnb._trunc_mod(torch.tensor(a), torch.tensor(b))) == want
    rng = np.random.RandomState(0)
    a = rng.randint(-2**31, 2**31 - 1, size=1000).astype(np.int32)
    b = rng.randint(1, 1000, size=1000).astype(np.int32)
    a[:3] = [-2**31, 2**31 - 1, 0]
    got = tnb._trunc_mod(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnb._trunc_mod(jnp.asarray(a), jnp.asarray(b))))
    # C semantics everywhere but -2^31, where JAX's int32 |a| wraps
    a64, b64 = a[1:].astype(np.int64), b[1:].astype(np.int64)
    np.testing.assert_array_equal(got[1:], a64 - np.fix(a64 / b64).astype(
        np.int64) * b64)


def test_lcg_wraps_in_int32():
    """``1664525 * (i + a) + 1013904223`` wraps as the reference's int32
    (``tests/test_compat_units.py:30-34``), computed in int64 and masked."""
    i = torch.tensor([0, 1, 2_000_000, 2**31 - 1])
    got = tnb.wrap32(1664525 * i + 1013904223)
    want = np.asarray(jnp.int32(1664525) * jnp.asarray(i.numpy(), jnp.int32)
                      + jnp.int32(1013904223))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[2]) == int(np.int32(
        (1664525 * 2_000_000 + 1013904223) & 0xFFFFFFFF))


@pytest.mark.parametrize("kind", ["units", "disk"])
def test_cell_table_matches_jax(kind, disk):
    if kind == "units":   # tests/test_compat_units.py:37-48
        jc, tc = (JCfg(num_particles=64, cell_capacity=16),
                  TCfg(num_particles=64, cell_capacity=16))
        pos = np.array(jax.random.uniform(jax.random.PRNGKey(1), (64, 3),
                                          jnp.float32) * 2.0 + 2.0)
    else:
        jc, js, tc, _ = disk
        pos = np.array(js.position)
    table, counts, overflow = tnb.build_cell_table(tc, torch.from_numpy(pos))
    ref = jnb.build_cell_table(jc, jnp.asarray(pos))
    for got, want in zip((table, counts, overflow), ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert table.dtype == torch.int32 and int(overflow) == 0
    c = counts.numpy()
    for cid in np.nonzero(c)[0][:200]:
        assert (np.diff(table[cid, :c[cid]].numpy()) > 0).all()


@pytest.mark.parametrize("slot4", ["skip", "bump"])
@pytest.mark.parametrize("scene", ["disk", "dense"])
def test_neighbors_bit_equal_to_jax(scene, slot4, request):
    jc, js, tc, ts = request.getfixturevalue(scene)
    ref = jax.jit(partial(jnb.find_neighbors_compat, jc, slot4=slot4))(
        js.position)
    got = tnb.find_neighbors_compat(tc, ts.position, slot4=slot4)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(_bits(got.dists.numpy()), _bits(ref.dists))
    assert int(got.overflow_cells) == int(ref.overflow_cells)
    counts = got.count.numpy()
    assert counts.max() > (24 if scene == "dense" else 4)


def test_slot4_bump_advances_the_offsets(dense):
    """``bump`` moves ``almost_a_random`` past slot 4, so later buckets
    start elsewhere: the two modes find different sets."""
    _, _, tc, ts = dense
    a = tnb.find_neighbors_compat(tc, ts.position, slot4="skip")
    b = tnb.find_neighbors_compat(tc, ts.position, slot4="bump")
    assert not torch.equal(a.ids, b.ids)


# ---------------------------------------------------------------------------
# physics, kernels, step
# ---------------------------------------------------------------------------

def test_step_quantities_from_one_state(dense):
    """From the same state: rho bit-equal to JAX's (XLA:CPU's contracted
    h^2 - d^2 and 8-lane slot sum), counts equal, acc within the bar."""
    jc, js, tc, ts = dense
    acc_j, rho_j, aux_j = jax.jit(partial(jstep.compute_compat_quantities,
                                          jc))(js)
    acc_t, rho_t, aux_t = tstep.compute_compat_quantities(tc, ts)
    np.testing.assert_array_equal(aux_t.neighbor_count.numpy(),
                                  np.asarray(aux_j.neighbor_count))
    np.testing.assert_array_equal(_bits(rho_t.numpy()), _bits(rho_j))
    # quirk 2's s^(count - n + 1) overflows on some dense rows (s > 1), in
    # both packages: the same rows are non-finite, the rest within the bar
    fin_t, fin_j = np.isfinite(acc_t.numpy()), np.isfinite(np.asarray(acc_j))
    np.testing.assert_array_equal(fin_t, fin_j)
    assert fin_t.mean() > 0.9
    assert _rel(acc_t.numpy()[fin_t], np.asarray(acc_j)[fin_j]) <= ACC_BAR


def test_compat_steps_within_the_golden_bars(trajectory):
    for k, (js, jd, ts, td) in enumerate(trajectory[1:], 1):
        np.testing.assert_array_equal(ts.neighbor_count.numpy(),
                                      np.asarray(js.neighbor_count))
        assert _rel(ts.position.numpy(), js.position) <= POS_BAR, k
        assert _rel(ts.acceleration.numpy(), js.acceleration) <= ACC_BAR, k
        for f in ("kinetic_energy", "potential_energy"):
            assert abs(float(getattr(td, f)) - float(getattr(jd, f))) <= (
                TALLY_BAR * abs(float(getattr(jd, f)))), (k, f)
        assert float(td.angular_momentum) == 0.0   # the reference logs 0
    # the first step starts from one state: rho bit-equal
    js1, _, ts1, _ = trajectory[1]
    np.testing.assert_array_equal(_bits(ts1.density.numpy()),
                                  _bits(js1.density))


def test_compat_tally_matches_jax(dense):
    """At-rest particles are left out of KE and PE; PE divides by
    (d + eps)^3 (quirk 8); |L| is 0."""
    jc, js, tc, ts = dense
    vel = ts.velocity.clone()
    vel[::3] = 0.0
    jt = jint.energy_tally(jc.replace(compat=True), js.position,
                           jnp.asarray(vel.numpy()), js.mass)
    tt = tint.energy_tally(tc.replace(compat=True), ts.position, vel, ts.mass)
    for a, b in zip(tt[:2], jt[:2]):
        assert abs(float(a) - float(b)) <= TALLY_BAR * abs(float(b))
    assert float(tt.angular_momentum) == float(jt.angular_momentum) == 0.0
    assert not tt.l_vec.any()
    # the default tally counts the at-rest particles
    assert float(tint.energy_tally(tc, ts.position, vel, ts.mass).potential) \
        < float(tt.potential) * 0


def test_step_dispatch_matches_jax(disk):
    """``step`` runs compat for ``backend="compat"`` and for ``cfg.compat``
    on every backend but pairwise; pairwise runs its own sums under the
    compat physics (quirks 1-2 and the compat tallies), as in JAX."""
    jc, js, tc, ts = disk
    n = 2048
    jc, tc = jc.replace(num_particles=n), tc.replace(num_particles=n)
    js = JState.from_arrays(js.position[:n], js.velocity[:n], cfg=jc)
    ts = ParticleState.from_arrays(ts.position[:n], ts.velocity[:n], cfg=tc)
    ref, _ = tstep.compat_step(tc, ts)
    for backend, cfg in (("compat", tc), ("celllist", tc.replace(compat=True)),
                         ("pallas", tc.replace(compat=True))):
        got, _ = tops_step.step(cfg, ts, backend)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), backend
    cj, ct = jc.replace(compat=True), tc.replace(compat=True)
    got, d = tops_step.step(ct, ts, "pairwise")
    want, dj = jops_step.step(cj, js, "pairwise")
    np.testing.assert_array_equal(got.neighbor_count.numpy(),
                                  np.asarray(want.neighbor_count))
    assert _rel(got.acceleration.numpy(), want.acceleration) <= ACC_BAR
    assert abs(float(d.potential_energy) - float(dj.potential_energy)) <= (
        TALLY_BAR * abs(float(dj.potential_energy)))
    acc, _, _ = tops_step.compute_forces(tc, ts, "compat")
    assert torch.equal(acc, ref.acceleration)


def test_pairwise_compat_physics_matches_jax(dense):
    """``sph_acceleration`` with ``cfg.compat`` (quirks 1-2) through the
    pairwise oracle, on a subset of the dense cloud."""
    jc, js, tc, ts = dense
    n = 3000
    jc, tc = jc.replace(num_particles=n, compat=True), \
        tc.replace(num_particles=n, compat=True)
    js = JState.from_arrays(js.position[:n], js.velocity[:n], cfg=jc)
    ts = ParticleState.from_arrays(ts.position[:n], ts.velocity[:n], cfg=tc)
    rho_j = jpair.compute_density(jc, js)
    rho_t = tpair.compute_density(tc, ts)
    acc_j = jpair.compute_acceleration(jc, js, rho_j)
    acc_t = tpair.compute_acceleration(tc, ts, rho_t)
    assert _rel(acc_t.numpy(), acc_j) <= ACC_BAR
    assert _rel(acc_t.numpy(), jpair.compute_acceleration(
        jc.replace(compat=False), js, rho_j)) > 1e-2   # the quirks act


def test_kernels_match_jax():
    tc, jc = TCfg(), JCfg()
    d = np.linspace(0.0, 0.12, 4001, dtype=np.float32)
    for name in ("poly6", "spiky_grad_magnitude", "visc_laplacian"):
        got = getattr(tkern, name)(tc, torch.from_numpy(d)).numpy()
        want = np.asarray(getattr(jkern, name)(jc, jnp.asarray(d)))
        assert _rel(got, want) <= 1e-6, name
        assert (got[d > tc.h_scaled] == 0).all()
    assert tkern.poly6_self(tc) == jkern.poly6_self(jc)


def test_honey_scene_stable():
    """The high-viscosity / low-stiffness regime does not blow up
    (``tests/test_compat_units.py:76-89``)."""
    cfg, state = make_scene("honey", device="cpu", num_particles=2048)
    final, diags = tops_step.run_steps(cfg, state, 30)
    ke = diags.kinetic_energy.numpy()
    assert np.isfinite(ke).all()
    assert torch.isfinite(final.position).all()
    assert ke[-1] < ke[0] * 10


# ---------------------------------------------------------------------------
# golden dumps, parity
# ---------------------------------------------------------------------------

def _dump_bytes(g) -> bytes:
    """``tools/golden_main.cpp``'s ``dump_state``, field by field."""
    out = np.int32(g.n).tobytes()
    for a, dt in ((g.mass, np.float32), (g.density, np.float32),
                  (g.position, np.float32), (g.velocity, np.float32),
                  (g.acceleration, np.float32), (g.neighbor_count, np.int32),
                  (g.neighbor_ids, np.uint32), (g.neighbor_dists, np.float32)):
        out += np.ascontiguousarray(a, dt).tobytes()
    return out


def _golden_from(js: JState, rng, rho_scale: float, nc_flip: int,
                 pos_noise: float = 1e-3):
    """A dump of ``js`` with perturbed densities, positions and counts;
    ``parity`` reads no neighbor table, so the tables are random."""
    n = js.position.shape[0]
    nc = np.asarray(js.neighbor_count).copy()
    nc[::nc_flip] += 1
    return golden.GoldenState(
        n, np.asarray(js.mass), np.asarray(js.density) * np.float32(
            1 + rho_scale * rng.uniform(-1, 1, n)).astype(np.float32),
        np.asarray(js.position) + rng.normal(0, pos_noise, (n, 3)).astype(
            np.float32), np.asarray(js.velocity),
        np.asarray(js.acceleration), nc,
        rng.integers(0, n, (n, 32)).astype(np.uint32),
        rng.random((n, 32), np.float32))


def test_load_golden_reads_the_dump_format(tmp_path, trajectory):
    rng = np.random.default_rng(1)
    js = trajectory[1][0]
    g = _golden_from(js, rng, 0.0, 7)
    (tmp_path / "a.bin").write_bytes(_dump_bytes(g))
    golden.write_golden(str(tmp_path / "b.bin"), g)
    assert (tmp_path / "a.bin").read_bytes() == \
        (tmp_path / "b.bin").read_bytes()
    got = golden.load_golden(str(tmp_path / "a.bin"))
    want = jgolden.load_golden(str(tmp_path / "a.bin"))
    assert got.n == want.n == N
    for a, b, c in zip(got[1:], want[1:], g[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(a, np.asarray(c, a.dtype))
    st = golden.to_state(got, device="cpu")
    assert torch.equal(st.position, torch.from_numpy(g.position))
    assert st.neighbor_count.dtype == torch.int32
    assert golden.golden_dir() is None or golden.golden_dir().endswith(
        "golden_m4")


_LINE = re.compile(r"^(\S+): density_L2=(\S+) pos_L2=(\S+) "
                   r"neighbor_count_match=(\S+)$")


@pytest.mark.parametrize("rho_scale,rc", [(1e-4, 0), (0.05, 1)])
def test_parity_output_matches_jax_cli(tmp_path, capsys, trajectory,
                                       rho_scale, rc):
    """Dumps 0..3 from JAX's compat trajectory; in dumps 1..3 the densities
    scaled by 1 + U(-s, s), the positions moved by N(0, 1e-3), every 50th
    count off by one: the two CLIs print the same lines, verdict and exit
    code (PASS below the 1e-3 density target, FAIL above)."""
    rng = np.random.default_rng(2)
    for k in range(4):
        # dump 0 is the start: the trajectory's own state
        golden.write_golden(str(tmp_path / f"state_{k:05d}.bin"),
                            _golden_from(trajectory[k][0], rng,
                                         rho_scale if k else 0.0, 50,
                                         1e-3 if k else 0.0))
    capsys.readouterr()
    assert jcli.main(["parity", str(tmp_path), "--steps", "3"]) == rc
    want = capsys.readouterr().out.splitlines()
    assert main(["parity", str(tmp_path), "--steps", "3",
                 "--device", "cpu"]) == rc
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    for a, b in zip(got[:3], want[:3]):
        ma, mb = _LINE.match(a), _LINE.match(b)
        assert ma and mb, (a, b)
        assert ma[1] == mb[1] and ma[4] == mb[4]
        for i in (2, 3):
            x, y = float(ma[i]), float(mb[i])
            assert abs(x - y) <= 1e-3 * abs(y) + 1e-9, (a, b)
    assert got[3].split(":")[-1] == want[3].split(":")[-1]
    assert ("PASS" if rc == 0 else "FAIL") in got[3]


def test_parity_needs_two_dumps(tmp_path):
    with pytest.raises(SystemExit, match="need >= 2 golden dumps"):
        main(["parity", str(tmp_path), "--device", "cpu"])
