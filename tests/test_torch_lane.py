"""The torch package's lane-layout sweeps (``ops/sweeps_lane.py``) against
the JAX package's ``ops/pallas_step.py``.

The JAX lane kernels run in interpreter mode on the CPU; on CPU tensors the
torch wrappers run their plain twins, which the CUDA kernels
(``csrc/sweep_lane.cu``) are held to on the card (``chip_smoke.py``).  Bars:
neighbor counts equal, rho rel-L2 <= 1e-6, acc rel-L2 <= 1e-4; both sides
sum pairs directly, so the tolerance covers summation order only.  The
window table (start, chunk count, chunks cut by the 127 clamp) must equal
the JAX package's bit for bit.

The pad rows differ on purpose (the port's cell id -2^30 against JAX's -10,
whose rod band reaches cell 0 on some grids); the test scenes keep away from
that corner (no particle of cell 0 has a rod delta in {-9, -10, -11}).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import grid as jgrid
from smoothed_particle_hydrodynamics_tpu.ops import pallas_step as jps
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import grid as tgrid
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_lane
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy

# The twins gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores.
torch.set_num_threads(1)

RHO_BAR, ACC_BAR = 1e-6, 1e-4
# packed dam break: window 128 on 16^3 h-cells, so windows take several
# chunks; the disk at h = 0.5 on 8^3 2h-cells (~14 neighbors each)
CASES = {
    "dam_break": dict(num_particles=1024, grid_nx=16, grid_ny=16, grid_nz=16,
                      pallas_window=128),
    "disk": dict(num_particles=1024, grid_nx=8, grid_ny=8, grid_nz=8, h=0.5),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _scenes(scene, **kw):
    jc, js = jscene(scene, pallas_interpret=True, pallas_layout="lane",
                    **dict(CASES[scene], **kw))
    return (jc, js, TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device="cpu"))


def _jax_windows(jc, js):
    g = jgrid.build_grid(jc, js.position)
    n = js.n
    b, s = jc.pallas_block_rows, jc.pallas_window
    packed, clamped = jps._block_windows(
        jc, g.cell_ids, g.cell_start, g.cell_end, -(-n // b), b, s, n,
        jps._round_up(n, jps.LANE) + s)
    packed = np.asarray(packed).reshape(-1)
    return packed & ~(jps.LANE - 1), packed & (jps.LANE - 1), int(clamped)


@pytest.mark.parametrize("scene", sorted(CASES))
def test_window_table_equals_jax(scene):
    jc, js, tc, ts = _scenes(scene)
    start, chunks, clamped = _jax_windows(jc, js)
    p = sweeps_lane.prepare_lane(tc, ts)
    np.testing.assert_array_equal(p.ws.numpy(), start)
    np.testing.assert_array_equal(p.wc.numpy(), chunks)
    assert int(p.truncated_ranges) == clamped == 0
    if scene == "dam_break":
        assert p.wc.max() > 1, "want multi-chunk windows"


def test_window_table_clamp_equals_jax():
    """Synthetic cell offsets with a few huge cells: windows of more than
    127 chunks are clamped and the cut chunks counted, as in JAX."""
    jc, _, tc, _ = _scenes("dam_break", pallas_window=128)
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4, jc.num_cells)
    counts[rng.choice(jc.num_cells, 6, replace=False)] = 20000
    cell_end = np.cumsum(counts).astype(np.int32)
    cell_start = (cell_end - counts).astype(np.int32)
    n = int(cell_end[-1])
    cid = np.repeat(np.arange(jc.num_cells, dtype=np.int32), counts)
    b, s = 128, 128
    n_pad = -(-n // 128) * 128 + s
    packed, clamped_j = jps._block_windows(
        jc, jnp.asarray(cid), jnp.asarray(cell_start), jnp.asarray(cell_end),
        -(-n // b), b, s, n, n_pad)
    packed = np.asarray(packed).reshape(-1)
    ws, wc, clamped_t = sweeps_lane._block_windows(
        tc, torch.from_numpy(cid), torch.from_numpy(cell_start),
        torch.from_numpy(cell_end), -(-n // b), b, s, n, n_pad)
    np.testing.assert_array_equal(ws.numpy(), packed & ~127)
    np.testing.assert_array_equal(wc.numpy(), packed & 127)
    assert int(clamped_t) == int(clamped_j) > 0
    assert wc.max() == sweeps_lane.CHUNK_CLAMP


@pytest.mark.parametrize("scene", sorted(CASES))
def test_lane_step_quantities_match_jax_interpret(scene):
    jc, js, tc, ts = _scenes(scene)
    acc_j, rho_j, aux_j = jps.compute_step_quantities(jc, js)
    acc_t, rho_t, aux_t = sweeps_lane.compute_step_quantities(tc, ts)
    np.testing.assert_array_equal(aux_t.neighbor_count.numpy(),
                                  np.asarray(aux_j.neighbor_count))
    assert aux_t.neighbor_count.float().mean() > 10
    assert _rel(rho_t.numpy(), rho_j) <= RHO_BAR
    assert _rel(acc_t.numpy(), acc_j) <= ACC_BAR
    assert int(aux_t.overflow_cells) == int(aux_j.overflow_cells)
    assert int(aux_t.truncated_ranges) == int(aux_j.truncated_ranges) == 0


def test_field_tables_pad_rows():
    """Pad rows [n, n_pad) carry zero fields and the NO_CELL sentinel; the
    cid row holds the sorted cell ids as int32 bits."""
    _, _, tc, ts = _scenes("disk", num_particles=300)
    p = sweeps_lane.prepare_lane(tc, ts)
    fd = sweeps_lane.density_fields(tc, p)
    n = ts.n
    assert fd.shape == (5, sweeps_lane.n_pad(tc, n))
    np.testing.assert_array_equal(fd[4].view(torch.int32)[:n].numpy(),
                                  p.cid.numpy())
    assert (fd[4].view(torch.int32)[n:] == tgrid.NO_CELL).all()
    assert (fd[:4, n:] == 0).all()
    rho = torch.rand(n)
    ff = sweeps_lane.force_fields(tc, p, rho)
    assert ff.shape == (9, fd.shape[1])
    np.testing.assert_array_equal(ff[7, :n].numpy(), rho.numpy())


def test_wrappers_take_twin_on_cpu_only():
    """CPU tensors run the twins without touching the launch counters; a
    device that is neither cpu nor cuda raises instead of falling back."""
    _, _, tc, ts = _scenes("disk", num_particles=256)
    before = [w.launches for w in sweeps_lane.WRAPPERS]
    sweeps_lane.compute_step_quantities(tc, ts)
    assert [w.launches for w in sweeps_lane.WRAPPERS] == before
    p = sweeps_lane.prepare_lane(tc, ts)
    fd = sweeps_lane.density_fields(tc, p).to("meta")
    with pytest.raises(ValueError, match="cuda"):
        sweeps_lane.density_lane(tc, fd, p.ws, p.wc, ts.n)


@pytest.mark.parametrize("kw,match", [
    (dict(compat=True), "compat"),
    (dict(pallas_window=200), "multiple"),
    (dict(grid_nx=2), "grid dims >= 3"),
    (dict(capped_candidates=4), "sublane"),
])
def test_guards_raise_like_jax(kw, match):
    """The lane path refuses what the JAX lane path refuses, with the same
    words (``tests/test_pallas.py``)."""
    jc, js, tc, ts = _scenes("disk", num_particles=256)
    with pytest.raises(ValueError, match=match):
        jps.compute_step_quantities(jc.replace(**kw), js)
    with pytest.raises(ValueError, match=match):
        sweeps_lane.compute_step_quantities(tc.replace(**kw), ts)


def test_scatter_unsort_round_trip():
    rng = np.random.default_rng(8)
    order = torch.from_numpy(rng.permutation(400))
    vals = torch.from_numpy(rng.normal(size=(400, 3)).astype(np.float32))
    back = tgrid.unsort(order, vals[order])
    np.testing.assert_array_equal(back.numpy(), vals.numpy())
    j = jgrid.unsort(jnp.asarray(order.numpy()), jnp.asarray(vals[order].numpy()))
    np.testing.assert_array_equal(back.numpy(), np.asarray(j))
