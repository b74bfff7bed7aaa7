"""The integrator's kernel (``ops/integrate.integrate_t``,
``csrc/integrate_t.cu``) and its plain twin ``kdk_integrate_plain``.

On the CPU ``kdk_integrate`` takes the twin; ``integrate_t`` runs with its
launcher replaced by one that writes the twin's results, which holds the
wrapper's checks, outputs, counts and tally layout.  The ``card`` test
compares the kernel with the twin on CUDA: positions and velocities bit for
bit, the tally against a float64 sum of the twin's terms, and two calls'
tallies bit for bit.  No JAX here: the card test runs where there is none.
"""

import itertools

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
from smoothed_particle_hydrodynamics_tpu_torch.ops import integrate
from smoothed_particle_hydrodynamics_tpu_torch.ops.integrate import (
    EnergyTally, integrate_t, kdk_integrate, kdk_integrate_plain)
from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState
from smoothed_particle_hydrodynamics_tpu_torch.utils import trace

BOX = (1.0, 2.0, 1.5)
# every branch the kernel takes from the config: the closing kick, the box,
# the compat tally, and G M zero (the canary) or not (the potential)
MODES = list(itertools.product(("none", "gravity"), ("none", "reflect"),
                               (False, True), (0.0, 2.0)))
MODE_IDS = [f"{k}-{b}-{'compat' if c else 'default'}-gm{m:g}"
            for k, b, c, m in MODES]


def config(second_kick="none", boundary="reflect", compat=False,
           central_mass=0.0) -> SphConfig:
    """The box is ``BOX`` (cells of 0.1 on a 10 x 20 x 15 grid)."""
    return SphConfig(h=0.1, cell_size_factor=1.0, grid_nx=10, grid_ny=20,
                     grid_nz=15, dt=0.004, sim_scale=0.5, damping=0.5,
                     second_kick=second_kick,
                     boundary=boundary, compat=compat,
                     central_mass=central_mass)


def crafted(n_random: int = 700, seed: int = 7, device="cpu",
            finite: bool = False) -> tuple[ParticleState, torch.Tensor]:
    """Rows that take every branch of the update (state, acceleration):
    crossings below 0 and above the box on each axis, a zero displacement
    inside and outside the box, rows at rest, signed zeros, NaN and inf
    velocities, a NaN position and a NaN acceleration (``finite`` leaves
    the non-finite rows out), then ``n_random`` rows inside the box."""
    inf, nan = float("inf"), float("nan")
    rows = [  # position, velocity, acceleration
        ((0.01, 1.0, 0.7), (-9.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        ((0.5, 0.01, 0.7), (0.0, -9.0, 1.0), (0.0, -50.0, 0.0)),
        ((0.5, 1.0, 0.01), (0.0, 0.0, -9.0), (0.0, 0.0, 0.0)),
        ((0.99, 1.0, 0.7), (9.0, 0.0, 0.0), (100.0, 0.0, 0.0)),
        ((0.5, 1.99, 0.7), (0.0, 9.0, 0.0), (0.0, 0.0, 0.0)),
        ((0.5, 1.0, 1.49), (0.0, 0.0, 9.0), (0.0, 0.0, 3.0)),
        ((0.01, 1.99, 1.49), (-9.0, 9.0, 9.0), (0.0, 0.0, 0.0)),
        ((0.3, 0.4, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        ((1.2, -0.1, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        ((0.0, 2.0, 1.5), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        ((-0.0, 0.5, -0.0), (-0.0, 0.0, -0.0), (0.0, -0.0, 0.0)),
        ((0.5, 1.0, 0.75), (1.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
    ]
    if not finite:
        rows += [
            ((0.5, 1.0, 0.7), (nan, 0.0, 0.0), (0.0, 0.0, 0.0)),
            ((0.5, 1.0, 0.7), (0.0, inf, 0.0), (0.0, 0.0, 0.0)),
            ((0.5, 1.0, 0.7), (0.0, 0.0, -inf), (0.0, 0.0, 0.0)),
            ((nan, 1.0, 0.7), (1.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
            ((0.5, 1.0, 0.7), (0.0, 0.0, 0.0), (0.0, nan, 0.0)),
        ]
    g = np.random.default_rng(seed)
    pos = np.concatenate([np.array([r[0] for r in rows]),
                          g.uniform(0.0, 1.0, (n_random, 3)) * BOX])
    vel = np.concatenate([np.array([r[1] for r in rows]),
                          g.normal(0.0, 3.0, (n_random, 3))])
    acc = np.concatenate([np.array([r[2] for r in rows]),
                          g.normal(0.0, 300.0, (n_random, 3))])
    mass = g.uniform(0.5, 2.0, len(pos))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    state = ParticleState.from_arrays(t(pos), t(vel), t(mass))
    return state, t(acc)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.int32)


def tally_vec(t: EnergyTally) -> torch.Tensor:
    """[KE, PE, Lx, Ly, Lz, |L|], the kernel's layout."""
    return torch.stack([t.kinetic, t.potential, *t.l_vec,
                        t.angular_momentum])


def twin_launch(calls: list):
    """``integrate._launch`` on the CPU: the twin's results written into the
    wrapper's outputs; each call's grid is kept in ``calls``."""
    def launch(cfg, state, acc, pos, vel, partials, tally, blocks):
        assert partials.dtype == torch.float64
        assert partials.numel() == blocks * integrate.TERMS
        new, t = kdk_integrate_plain(cfg, state, acc)
        pos.copy_(new.position)
        vel.copy_(new.velocity)
        tally.copy_(tally_vec(t))
        calls.append(blocks)
    return launch


@pytest.fixture
def fake_card(monkeypatch):
    """``integrate_t`` runnable on the CPU: its launcher writes the twin's
    results; the grid cap is 3 blocks."""
    calls = []
    monkeypatch.setattr(integrate, "_launch", twin_launch(calls))
    monkeypatch.setattr(integrate, "_grid_cap", lambda index: 3)
    monkeypatch.setattr(integrate_t, "launches", 0)
    return calls


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_wrapper_takes_the_twin_on_the_cpu(mode):
    kick, boundary, compat, m = mode
    cfg = config(kick, boundary, compat, m)
    state, acc = crafted()
    launches = integrate_t.launches
    new, t = kdk_integrate(cfg, state, acc)
    new_p, t_p = kdk_integrate_plain(cfg, state, acc)
    assert integrate_t.launches == launches
    for a, b in zip(new, new_p):
        assert torch.equal(bits(a) if a.is_floating_point() else a,
                           bits(b) if b.is_floating_point() else b)
    assert torch.equal(bits(tally_vec(t)), bits(tally_vec(t_p)))


def test_crafted_rows_take_every_branch():
    cfg = config()
    state, acc = crafted()
    new, t = kdk_integrate_plain(cfg, state, acc)
    pos, vel = new.position, new.velocity
    box = torch.tensor(BOX)
    assert cfg.box_max == BOX
    for row in range(7):   # crossings: reflected inside, velocity flipped
        assert bool(((pos[row] >= 0) & (pos[row] <= box)).all())
        assert bool((vel[row] * state.velocity[row] < 0).any())
    assert torch.equal(pos[7], state.position[7])       # zero displacement
    assert torch.equal(pos[8], torch.tensor([1.0, 0.0, 0.5]))  # clamped
    assert torch.equal(pos[9], state.position[9])       # on the walls
    assert bool(torch.isnan(pos[15, 0]))                # NaN stays NaN
    assert bool(torch.isnan(vel[12, 0])) and bool(torch.isinf(vel[13, 1]))
    assert bool(torch.isnan(t.angular_momentum))        # L is not masked
    assert bool(torch.isfinite(t.kinetic))              # KE is masked
    assert bool(torch.isnan(t.potential))               # the canary


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_card_path_outputs_and_tally_layout(fake_card, mode):
    kick, boundary, compat, m = mode
    cfg = config(kick, boundary, compat, m)
    state, acc = crafted()
    new, t = integrate_t(cfg, state, acc)
    new_p, t_p = kdk_integrate_plain(cfg, state, acc)
    assert fake_card == [3] and integrate_t.launches == 1
    assert torch.equal(bits(new.position), bits(new_p.position))
    assert torch.equal(bits(new.velocity), bits(new_p.velocity))
    assert new.acceleration is acc
    assert new.mass is state.mass and new.density is state.density
    for a, b in zip(t, t_p):
        assert a.shape == b.shape and torch.equal(bits(a), bits(b))


def test_grid_blocks_cap_and_ragged_edge():
    assert integrate.grid_blocks(1, 528) == 1
    assert integrate.grid_blocks(256, 528) == 1
    assert integrate.grid_blocks(257, 528) == 2
    assert integrate.grid_blocks(10_000_000, 528) == 528


def _bad_inputs():
    state, acc = crafted(20)
    n = state.n
    yield "dtype", state._replace(position=state.position.double()), acc
    yield "shape", state, acc[:, :2].contiguous()
    yield "rows", state._replace(mass=state.mass[:-1]), acc
    yield "device", state, acc.to("meta")
    yield "contiguity", state._replace(
        velocity=state.velocity.t().contiguous().t()), acc
    yield "contiguity of a row slice", state, torch.zeros(n, 6)[:, ::2]


@pytest.mark.parametrize("case", list(_bad_inputs()),
                         ids=lambda c: c[0])
def test_card_path_refuses_what_the_kernel_does_not_take(fake_card, case):
    _, state, acc = case
    with pytest.raises(ValueError, match="need a contiguous"):
        integrate_t(config(), state, acc)
    assert fake_card == [] and integrate_t.launches == 0


def test_second_kick_full_is_refused_on_both_paths(fake_card):
    state, acc = crafted(4)
    cfg = config().replace(second_kick="full")
    for fn in (integrate_t, kdk_integrate_plain):
        with pytest.raises(ValueError, match="second_kick='full'"):
            fn(cfg, state, acc)
    assert fake_card == []


def test_no_rows_launch_nothing_and_give_zero_tallies(fake_card):
    state, acc = crafted(0, finite=True)
    state = ParticleState(*(f[:0] for f in state))
    acc = acc[:0]
    for cfg in (config(), config(compat=True, central_mass=2.0)):
        new, t = integrate_t(cfg, state, acc)
        assert new.position.shape == (0, 3) and new.velocity.shape == (0, 3)
        assert tally_vec(t).tolist() == [0.0] * 6
        assert tally_vec(kdk_integrate_plain(cfg, state, acc)[1]).tolist() \
            == [0.0] * 6
    assert fake_card == [] and integrate_t.launches == 0


def test_fused_rows_counted_while_the_profiler_records(fake_card):
    """Each ``integrate_t`` call launches the kernel once, with the
    profiler off or on; the twin launches nothing; no counter is
    counted."""
    state, acc = crafted(50)
    trace.take()
    integrate_t(config(), state, acc)
    assert integrate_t.launches == 1 and len(fake_card) == 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            integrate_t(config(), state, acc)
        kdk_integrate_plain(config(), state, acc)
    assert trace.take()["counts"] == {}
    assert integrate_t.launches == 4 and len(fake_card) == 4


def test_profile_step_reports_the_fused_share(fake_card):
    """Steps through the kernel: one launch a step, over every row."""
    state, acc = crafted(50)
    for _ in range(4):
        state, _ = integrate_t(config(), state, acc)
    assert integrate_t.launches == 4
    assert len(fake_card) == 4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
def test_kernel_against_the_twin_on_the_card():
    """Kernel and twin on CUDA: the crafted rows in every mode, then the
    1M splash's and the 10M dam break's first lazy-step inputs (the
    benchmark cells' settings, ``chip_smoke.INTEGRATE``, and with the
    gravity kick and a central mass).  Positions and velocities bit-equal
    in every mode (a NaN against a NaN counted equal); each tally term no
    farther from the float64 sum of the twin's terms than twice the twin's
    own distance or one float32 ulp of the sum (1e-6 relative where the
    twin's distance is 0; ``chip_smoke.tally_errors``); two calls' tallies
    bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import chip_smoke

    dev = torch.device("cuda")
    for mode, name in zip(MODES, MODE_IDS):
        cfg = config(*mode)
        for finite in (False, True):
            state, acc = crafted(5000, device=dev, finite=finite)
            chip_smoke.integrate_vs_twin(f"crafted {name} finite={finite}",
                                         cfg, state, acc)
    for name in chip_smoke.INTEGRATE:
        cfg, state, acc = chip_smoke.integrate_inputs(dev, name)
        chip_smoke.integrate_vs_twin(name, cfg, state, acc)
        chip_smoke.integrate_vs_twin(
            f"{name} gravity", cfg.replace(second_kick="gravity",
                                           central_mass=1.0), state, acc)
