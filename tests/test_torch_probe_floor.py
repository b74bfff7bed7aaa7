"""The floor probe of the port (``tools/probe_dma_floor.py`` of the torch
package, kernels ``floor_window_t`` and ``floor_band_t`` in
``csrc/floor_t.cu``) against the JAX tool's ``_probe_kernel``.

The JAX kernel runs in interpreter mode through ``pallas_step_t.
_run_chunked`` with its current signature (the JAX tool's own ``main``
calls an older one and raises), on the 4096-particle splash at 1.25h cells
and the window derived from the state; on CPU tensors the port's wrappers
run their plain versions, which the CUDA kernels are held to on the card
(``chip_smoke.py`` phase 15).  Bars, with their reasons:

- window ``full`` against JAX ``full`` at K = 2, 12: rel-L2 <= 1e-5 over
  the live rows (the same f32 ladders, one rounding a step on both sides:
  XLA's CPU compiler contracts the JAX ladder into FMAs, the plain version
  emulates the kernel's FMA in f64; the sums differ in order);
- window ``halfbytes`` against 2 x JAX ``full`` at window s_t / 2 over the
  same tables: rel-L2 <= 1e-5 (the JAX kernel's own ``halfbytes`` reads
  scratch rows that nothing wrote);
- window ``nostage`` against its closed form 9 s_t (-x_i c^K), c^K taken
  step by step in f32: rel-L2 <= 1e-6 (a sum of equal terms);
- the band walk's plain version against a float64 numpy sum of the same
  ladders over ``sweeps_t.band_ranges``: rel-L2 <= 1e-5 (K f32 roundings
  of the ladder against none).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as pst
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from smoothed_particle_hydrodynamics_tpu_torch.tools import (
    probe_dma_floor as pf)
from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
    band_rows_per_lane)

# The plain versions gain nothing from intra-op threads at these sizes, and
# under pytest-xdist eight torch threads per worker oversubscribe the cores.
torch.set_num_threads(1)

N = 4096
TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.cache
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_dma_floor", TOOLS / "probe_dma_floor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _exact():
    """The JAX tool's exact setup at N, both sides from one state: (JAX
    cfg, JAX prepared, port cfg, port prepared)."""
    jc, js = jscene("splash", num_particles=N, cell_size_factor=1.25,
                    pallas_interpret=True)
    jc = jc.replace(pallas_window_t=pst.derive_window_t(jc, js))
    jp = jax.jit(functools.partial(pst.prepare_t, jc))(js)
    tc = TCfg.from_json(jc.to_json())
    tp = sweeps_t.prepare_t(tc, state_from_numpy(js.to_numpy(),
                                                 device="cpu"))
    return jc, jp, tc, tp


def _jax_probe(jc, jp, k: int, mode: str) -> np.ndarray:
    """``_probe_kernel`` over the JAX tool's frame, through the current
    ``_run_chunked``: out [N]."""
    iota = jnp.arange(N, dtype=jnp.int32).astype(jnp.float32)
    cand = jnp.concatenate([jp.pos_s, jp.cid_f[:, None], jp.mass_s[:, None],
                            iota[:, None]], axis=1)
    cand = jnp.concatenate(
        [cand, jnp.zeros((pst._n_pad_rows(jc, N) - N, 6), jnp.float32)])
    selfc = jnp.concatenate([jp.pos_s, jp.mass_s[:, None],
                             jp.cid_f[:, None]], axis=1)
    out = pst._run_chunked(
        jc, (jp.ws, jp.wc, jp.ref), N,
        functools.partial(_jax_tool()._probe_kernel, k, mode), cand, selfc,
        out_specs=pl.BlockSpec((1, pst.BLANE), lambda i, *_: (0, i)),
        make_out_shape=lambda rows: jax.ShapeDtypeStruct((1, rows),
                                                         jnp.float32))
    return np.asarray(out)[0, :N]


def _window(tc, tp, mode: str, k: int) -> np.ndarray:
    frame = pf.window_frame(tc, tp)
    return pf.floor_window_t(frame, tp.pos_s[:, 0].contiguous(),
                             pf.window_tables(tc, tp)[0], tc.pallas_window_t,
                             sweeps_t._blane(tc), mode, k).numpy()


def test_window_tables_equal_jax():
    """The probe builds its own window tables (no sweep of the port reads
    one): the JAX package's, value for value."""
    jc, jp, tc, tp = _exact()
    ws, wc = pf.window_tables(tc, tp)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jp.ws))
    np.testing.assert_array_equal(wc.numpy(), np.asarray(jp.wc))
    assert pf.window_frame(tc, tp).shape == (pst._n_pad_rows(jc, N), 6)


@pytest.mark.parametrize("k", (2, 12))
def test_window_full_matches_the_jax_probe_kernel(k):
    jc, jp, tc, tp = _exact()
    assert _rel(_window(tc, tp, "full", k), _jax_probe(jc, jp, k, "full")) \
        <= 1e-5


def test_window_halfbytes_is_twice_full_at_half_the_window():
    jc, jp, tc, tp = _exact()
    half = jc.replace(pallas_window_t=jc.pallas_window_t // 2)
    want = 2.0 * _jax_probe(half, jp, 2, "full").astype(np.float64)
    assert _rel(_window(tc, tp, "halfbytes", 2), want) <= 1e-5


@pytest.mark.parametrize("k", pf.KS)
def test_window_nostage_closed_form(k):
    _, _, tc, tp = _exact()
    v = -tp.pos_s[:, 0].numpy()
    for _ in range(k):
        v = (v * np.float32(pf.C_FMA)).astype(np.float32)
    want = sweeps_t.NRODS * tc.pallas_window_t * v.astype(np.float64)
    assert _rel(_window(tc, tp, "nostage", k), want) <= 1e-6


def _band_f64(cfg, cand, x, cid, cell_start, k, zero=False) -> np.ndarray:
    """The band walk's sums in float64 numpy: the ladder without rounding
    on every row of each self row's bands."""
    a, e = (t.numpy() for t in sweeps_t.band_ranges(cfg, cid, cell_start))
    e = np.minimum(e, cand.shape[0])
    lens = np.maximum(e - a, 0).ravel()
    owner = np.repeat(np.repeat(np.arange(x.shape[0]), sweeps_t.NRODS), lens)
    start = np.repeat(a.ravel(), lens)
    rows = start + np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens,
                                                     lens)
    c = cand.numpy().astype(np.float64)
    xj, yj = (np.zeros(rows.size), np.zeros(rows.size)) if zero \
        else (c[rows, 0], c[rows, 1])
    u = xj - x.numpy().astype(np.float64)[owner]
    for _ in range(k):
        u = u * np.float64(pf.C_FMA) + yj
    return np.bincount(owner, weights=u, minlength=x.shape[0])


@functools.cache
def _capped():
    """The port's capped setup at N (K_c 4, 256-row blocks)."""
    return pf.setup(N, 4, torch.device("cpu"))


def _prepared(capped: bool):
    if capped:
        return _capped()
    _, _, tc, tp = _exact()
    return tc, tp


@pytest.mark.parametrize("capped", (False, True), ids=("exact", "capped"))
@pytest.mark.parametrize("width", pf.WIDTHS)
@pytest.mark.parametrize("mode,k", (("full", 2), ("full", 12),
                                    ("nostage", 2)))
def test_band_plain_matches_numpy_f64(capped, width, mode, k):
    cfg, p = _prepared(capped)
    cand = pf.band_frame(cfg, p, width)
    x = p.pos_s[:, 0].contiguous()
    got = pf.floor_band_t(cfg, cand, x, p.cid, p.cell_start, mode, k)
    want = _band_f64(cfg, cand, x, p.cid, p.cell_start, k,
                     zero=mode == "nostage")
    assert _rel(got.numpy(), want) <= 1e-5
    if mode == "full":
        half = pf.floor_band_t(cfg, cand, x, p.cid, p.cell_start,
                               "halfbytes", k)
        assert torch.equal(half, got)


@pytest.mark.parametrize("capped", (False, True), ids=("exact", "capped"))
def test_band_tests_the_rows_walk_stats_counts(capped):
    """``nostage`` sums (-x_i c^K) once a tested row: its rows a self row
    are those ``walk_stats.band_rows_per_lane`` counts, and the frame's
    ``band_frame`` columns are K1's staged words."""
    cfg, p = _prepared(capped)
    m = p.sub_perm.shape[0] if capped else p.pos_s.shape[0]
    cand = pf.band_frame(cfg, p, 4)
    x = p.pos_s[:, 0].contiguous()
    out = pf.floor_band_t(cfg, cand, x, p.cid, p.cell_start, "nostage", 2)
    v = -x.double()
    for _ in range(2):
        v = (v * pf.C_FMA).float().double()
    rows = torch.round(out.double() / v)
    stats = band_rows_per_lane(cfg, p.cid, p.cell_start, m)
    assert rows.mean().item() == pytest.approx(stats["mean"], rel=1e-12)
    walk = pf.walks(cfg, p)["band W4"]
    assert walk["rows"] == stats["mean"]
    assert walk["tested"] == pytest.approx(stats["mean"] * x.shape[0])
    if not capped:
        assert torch.equal(cand, torch.cat([p.pos_s, p.mass_s[:, None]], 1))


def test_wrappers_take_the_plain_version_on_cpu_and_refuse_other_devices():
    _, _, tc, tp = _exact()
    x = tp.pos_s[:, 0].contiguous()
    frame = pf.window_frame(tc, tp)
    block = sweeps_t._blane(tc)
    ws, _ = pf.window_tables(tc, tp)
    before = pf.floor_window_t.launches
    assert torch.equal(
        pf.floor_window_t(frame, x, ws, tc.pallas_window_t, block,
                          "nostage", 2),
        pf.floor_window_t_plain(frame, x, ws, tc.pallas_window_t, block,
                                "nostage", 2))
    assert pf.floor_window_t.launches == before
    meta = x.to("meta")
    with pytest.raises(ValueError, match="cuda"):
        pf.floor_window_t(frame, meta, ws, tc.pallas_window_t, block,
                          "full", 2)
    with pytest.raises(ValueError, match="cuda"):
        pf.floor_band_t(tc, pf.band_frame(tc, tp, 4), meta, tp.cid,
                        tp.cell_start, "full", 2)
    with pytest.raises(ValueError, match="mode"):
        pf._mode_k("nodma", 2)
    with pytest.raises(ValueError, match="mode"):
        pf._mode_k("full", 3)


@pytest.mark.parametrize("k_c", (0, 4))
def test_main_runs_on_the_cpu(k_c, capsys):
    r = pf.main(512, k_c, device="cpu", iters=1)
    out = capsys.readouterr().out
    assert out.startswith("cpu (host times")
    assert len(r["rows"]) == 3 * len(pf.MODES) * len(pf.KS)
    assert set(r["decomposition"]) == {"window", "band W4", "band W9"}
    assert len(r["real"]) == 2 and "intercept at K=0" in out
    assert r["cfg"].pallas_block_t == (256 if k_c else 128)
