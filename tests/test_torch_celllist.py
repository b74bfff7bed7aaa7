"""The torch package's cell-list backend and grid (``ops/celllist.py``,
``ops/grid.py``) against the JAX package's, and the backend parity check.

Binning (order, offsets, coords, overflow) and the candidate ranges of both
stencils must equal the JAX package's bit for bit (a flipped octant sign
changes the neighbor set).  The sweeps: neighbor counts equal, rho rel-L2
<= 1e-6 and acc rel-L2 <= 1e-4 (summation order only), and equal
``truncated_ranges`` when ``range_slice`` cuts ranges.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import celllist as jcl
from smoothed_particle_hydrodynamics_tpu.ops import grid as jgrid
from smoothed_particle_hydrodynamics_tpu.utils import benchmark as jbench
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import celllist as tcl
from smoothed_particle_hydrodynamics_tpu_torch.ops import grid as tgrid
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from smoothed_particle_hydrodynamics_tpu_torch.utils import benchmark as tbench

# The sweeps gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores.
torch.set_num_threads(1)

RHO_BAR, ACC_BAR = 1e-6, 1e-4
# the disk with the octant stencil on its 2h cells (h = 0.5 on 8^3, ~14
# neighbors), the dam break with the 27-cell stencil on h-cells
CASES = {
    "disk": dict(num_particles=1024, grid_nx=8, grid_ny=8, grid_nz=8, h=0.5),
    "dam_break": dict(num_particles=1024, grid_nx=16, grid_ny=16, grid_nz=16),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _scenes(scene, **kw):
    jc, js = jscene(scene, **dict(CASES[scene], **kw))
    return (jc, js, TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device="cpu"))


@pytest.mark.parametrize("scene", sorted(CASES))
def test_build_grid_equals_jax(scene):
    jc, js, tc, ts = _scenes(scene, cell_capacity=6)
    gj = jgrid.build_grid(jc, js.position)
    gt = tgrid.build_grid(tc, ts.position)
    for name in ("order", "cell_ids", "cell_start", "cell_end", "coords"):
        _eq(getattr(gt, name), getattr(gj, name))
    assert int(gt.overflow_cells) == int(gj.overflow_cells) > 0


@pytest.mark.parametrize("scene", sorted(CASES))
def test_candidate_ranges_equal_jax(scene):
    """octant (disk) and cell27 (dam break) ranges, bit for bit."""
    jc, js, tc, ts = _scenes(scene)
    pj, pt = jcl.prepare(jc, js), tcl.prepare(tc, ts)
    assert tc.neighborhood == ("octant" if scene == "disk" else "cell27")
    _eq(pt.pos_s, pj.pos_s)
    _eq(pt.rng_start, pj.rng_start)
    _eq(pt.rng_end, pj.rng_end)
    assert pt.rng_start.shape[1] == (4 if scene == "disk" else 9)


def test_derive_range_slice_equals_jax():
    for scene in CASES:
        jc, js, tc, ts = _scenes(scene)
        assert (tcl.derive_range_slice(tc, ts)
                == jcl.derive_range_slice(jc, js))


@pytest.mark.parametrize("scene", sorted(CASES))
def test_celllist_matches_jax(scene):
    jc, js, tc, ts = _scenes(scene)
    acc_j, rho_j, aux_j = jcl.compute_step_quantities(jc, js)
    acc_t, rho_t, aux_t = tcl.compute_step_quantities(tc, ts)
    _eq(aux_t.neighbor_count, aux_j.neighbor_count)
    assert aux_t.neighbor_count.float().mean() > 10
    assert _rel(rho_t.numpy(), rho_j) <= RHO_BAR
    assert _rel(acc_t.numpy(), acc_j) <= ACC_BAR
    assert int(aux_t.overflow_cells) == int(aux_j.overflow_cells)
    assert int(aux_t.truncated_ranges) == int(aux_j.truncated_ranges) == 0


def test_truncated_ranges_equal_jax_small_slice():
    """A range_slice shorter than the ranges cuts candidates: the count of
    cut ranges and the (truncated) sums equal JAX's."""
    jc, js, tc, ts = _scenes("dam_break", range_slice=8)
    acc_j, rho_j, aux_j = jcl.compute_step_quantities(jc, js)
    acc_t, rho_t, aux_t = tcl.compute_step_quantities(tc, ts, chunk=300)
    assert int(aux_t.truncated_ranges) == int(aux_j.truncated_ranges) > 0
    _eq(aux_t.neighbor_count, aux_j.neighbor_count)
    assert _rel(rho_t.numpy(), rho_j) <= RHO_BAR
    assert _rel(acc_t.numpy(), acc_j) <= ACC_BAR


def test_chunking_does_not_change_results():
    _, _, tc, ts = _scenes("disk")
    a = tcl.compute_step_quantities(tc, ts, chunk=1024)
    b = tcl.compute_step_quantities(tc, ts, chunk=100)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    _eq(a[2].neighbor_count, b[2].neighbor_count.numpy())


def _jax_parity_keys() -> list[str]:
    """The keys of the JAX ``run_parity_check`` record, read from its
    source (running it costs an interpreter-mode compile)."""
    tree = ast.parse(inspect.getsource(jbench.run_parity_check))
    ret = [n for n in ast.walk(tree) if isinstance(n, ast.Return)][-1]
    return [k.value for k in ret.value.keys]


def test_parity_check_on_cpu():
    """pallas (sublane twins) against celllist on the CPU: n capped at 2048
    as in JAX, the JAX record's keys, and a pass."""
    r = tbench.run_parity_check(device="cpu")
    assert list(r) == _jax_parity_keys()
    assert r["n"] == 2048 and r["scene"] == "disk" and r["device"] == "cpu"
    assert r["neighbor_counts_equal"] and r["pass"]
    assert r["rho_rel_l2"] <= RHO_BAR and r["acc_rel_l2"] <= ACC_BAR


def test_parity_check_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run_parity_check()
