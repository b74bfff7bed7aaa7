"""K2's candidate columns: the kernel ``cand_cols_t`` (``ops/sweeps_t.py``,
``csrc/cand_cols_t.cu``) and its plain twin ``fused_cand_cols_plain``.

On the CPU ``fused_cand_cols`` takes the twin (after the gather where it
is given an index), and its columns equal the twin's and the JAX
package's lanes.  ``cand_cols_t`` runs with its library replaced by
``FakeLib``, which reads the inputs through the pointers and strides the
launcher passes and writes the kernel's arithmetic in float32: that holds
the wrapper's checks, argument order, strides, grid and counts.  The
``card`` test compares the kernel with the twin on CUDA bit for bit.  JAX
is imported only inside the test that compares with it: the card test
runs where there is none.
"""

import ctypes

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
from smoothed_particle_hydrodynamics_tpu_torch.ops.sweeps_t import (
    cand_cols_t, fused_cand_cols, fused_cand_cols_plain)
from smoothed_particle_hydrodynamics_tpu_torch.utils import trace
from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
    resolve_sweep_settings)

torch.set_num_threads(1)

CFG = SphConfig(rho0=1000.0, stiffness=3.0)
# the density guard's rows: zero, negative zero, negative, NaN, infinity,
# subnormal (the JAX comparison leaves the subnormal out: XLA's CPU code
# may flush it)
SPECIAL = (0.0, -0.0, -1.5, float("nan"), float("inf"), 1e-40)


def frame(m: int, rows: int | None = None, seed: int = 0, width: int = 0,
          special: tuple = SPECIAL, device="cpu"):
    """(pos, vel, rho, mass, index): ``m`` candidates over ``rows`` frame
    rows (``index`` None where ``rows`` is None: then ``rows = m``), an
    ascending ``index`` as ``sub_perm`` is; the special densities at the
    first rows an index names.  With ``width`` the positions, velocities
    and masses are row-strided views of one [rows, width] store and the
    densities a column of a [rows, 2] one, as the slab engine passes
    them."""
    g = np.random.default_rng(seed)
    r = m if rows is None else rows
    index = None
    if rows is not None:
        index = np.sort(g.choice(rows, m, replace=False)).astype(np.int32)
    pos = g.uniform(0.0, 2.0, (r, 3)).astype(np.float32)
    vel = g.normal(0.0, 3.0, (r, 3)).astype(np.float32)
    rho = g.uniform(500.0, 2000.0, r).astype(np.float32)
    mass = g.uniform(0.5, 2.0, m).astype(np.float32)
    at = np.arange(r) if index is None else index
    rho[at[:len(special)]] = special

    def t(a):
        return torch.tensor(a, device=device)

    idx = None if index is None else t(index)
    if not width:
        return t(pos), t(vel), t(rho), t(mass), idx
    store = torch.zeros(r, width, device=device)
    store[:, 0:3], store[:, 3:6] = t(pos), t(vel)
    mstore = torch.zeros(m, width, device=device)
    mstore[:, 6] = t(mass)
    rstore = torch.zeros(r, 2, device=device)
    rstore[:, 1] = t(rho)
    return store[:, 0:3], store[:, 3:6], rstore[:, 1], mstore[:, 6], idx


# name -> frame() arguments: exact rows, more tiles than the grid's blocks
# and a partial last tile, the capped gather, the slab's column views with
# and without the gather
CASES = {
    "exact": dict(m=1000),
    "tiles": dict(m=4 * 256 + 17),
    "one-row": dict(m=1, special=()),
    "indexed": dict(m=700, rows=1500),
    "strided": dict(m=600, width=8),
    "strided-indexed": dict(m=513, rows=900, width=8),
}


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.int32)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, a NaN against a NaN counted equal."""
    return a.shape == b.shape and bool(
        ((bits(a) == bits(b)) | (torch.isnan(a) & torch.isnan(b)).reshape(-1)
         ).all())


def twin(cfg, pos, vel, rho, mass, index):
    if index is not None:
        rows = index.long()
        pos, vel, rho = pos[rows], vel[rows], rho[rows]
    return fused_cand_cols_plain(cfg, pos, vel, rho, mass)


class FakeLib:
    """``csrc/cand_cols_t.cu``'s C interface on CPU memory: reads every
    input through the pointer and stride it is handed, checks the grid and
    the output's alignment, and writes the kernel's columns in float32
    (each operation rounding once, in the kernel's order)."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(ptr, rows, stride, width, dtype=np.float32, write=False):
        size = np.dtype(dtype).itemsize
        count = (rows - 1) * stride + width if rows else 0
        buf = (ctypes.c_char * (count * size)).from_address(ptr)
        flat = np.frombuffer(buf, dtype=dtype, count=count)
        v = np.lib.stride_tricks.as_strided(
            flat, (rows, width), (stride * size, size), writeable=write)
        return v

    def sph_cand_cols_t(self, pos, vel, rho, mass, idx, out, pos_stride,
                        vel_stride, rho_stride, mass_stride, m, nblocks,
                        rho0, stiffness, stream):
        self.calls.append(dict(m=m, nblocks=nblocks, indexed=idx is not None))
        if m <= 0 or nblocks <= 0 or out % 16:
            return 1
        j = (np.arange(m) if idx is None
             else self._view(idx, 1, 0, m, np.int32)[0].astype(np.int64))
        rows = int(j.max()) + 1
        x = self._view(pos, rows, pos_stride, 3)[j]
        v = self._view(vel, rows, vel_stride, 3)[j]
        r = self._view(rho, rows, rho_stride, 1)[j, 0]
        mm = self._view(mass, m, mass_stride, 1)[:, 0]
        o = self._view(out, m, 9, 9, write=True)
        f32 = np.float32
        with np.errstate(all="ignore"):
            inv = f32(1.0) / np.where(r > 0, r, f32(1.0))
            p = (r - f32(rho0)) * f32(stiffness)
            rimj = inv * mm
            o[:, 0:3] = x
            o[:, 3:6] = rimj[:, None] * v
            o[:, 6] = rimj
            o[:, 7] = mm
            o[:, 8] = mm * ((p * inv) * inv)
        return 0

    @staticmethod
    def sph_error_string(code):
        return b"invalid argument"


@pytest.fixture
def fake_card(monkeypatch):
    """``cand_cols_t`` runnable on the CPU through ``FakeLib``; the grid
    cap is 3 blocks."""
    lib = FakeLib()
    monkeypatch.setattr(sw, "_cand_kernels", lambda: lib)
    monkeypatch.setattr(sw, "_cand_grid_cap", lambda index: 3)
    monkeypatch.setattr(sw, "_stream", lambda dev: 0)
    monkeypatch.setattr(cand_cols_t, "launches", 0)
    return lib


@pytest.mark.parametrize("name", CASES)
def test_wrapper_takes_the_twin_on_the_cpu(name):
    pos, vel, rho, mass, idx = frame(**CASES[name])
    launches = cand_cols_t.launches
    got = fused_cand_cols(CFG, pos, vel, rho, mass, index=idx)
    assert cand_cols_t.launches == launches
    assert got.shape == (mass.shape[0], 9) and got.is_contiguous()
    assert same(got, twin(CFG, pos, vel, rho, mass, idx))


@pytest.mark.parametrize("name", CASES)
def test_card_path_through_the_kernel_interface(fake_card, name):
    """The launcher's pointers, strides and grid read by ``FakeLib``: the
    columns bit-equal to the twin's, and the guard's rows what the guard
    gives (a NaN density: inverse 1, the pressure column NaN)."""
    pos, vel, rho, mass, idx = frame(**CASES[name])
    got = cand_cols_t(CFG, pos, vel, rho, mass, idx)
    want = twin(CFG, pos, vel, rho, mass, idx)
    assert same(got, want)
    m = mass.shape[0]
    assert fake_card.calls == [dict(m=m, nblocks=min(-(-m // 256), 3),
                                    indexed=idx is not None)]
    assert cand_cols_t.launches == 1
    if CASES[name].get("special", SPECIAL):
        assert got[0, 6] == mass[0] and got[3, 6] == mass[3]  # 0 and NaN
        assert bool(torch.isnan(got[3, 8])) and got[4, 6] == 0.0


def test_columns_match_jax_lanes():
    """Exact and indexed frames against the JAX package's
    ``fused_cand_cols`` on the gathered rows: its lanes 0:3, 4:8, 9, 10."""
    import jax.numpy as jnp

    from smoothed_particle_hydrodynamics_tpu.config import (
        SphConfig as JaxConfig)
    from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jpt

    jc = JaxConfig(rho0=CFG.rho0, stiffness=CFG.stiffness)
    lanes = [0, 1, 2, 4, 5, 6, 7, 9, 10]
    for kw in (dict(m=1000), dict(m=700, rows=1500), dict(m=513, rows=900,
                                                          width=8)):
        pos, vel, rho, mass, idx = frame(**kw, special=SPECIAL[:-1])
        got = fused_cand_cols(CFG, pos, vel, rho, mass, index=idx).numpy()
        rows = slice(None) if idx is None else idx.long()
        zeros = jnp.zeros(mass.shape[0], jnp.float32)
        cols = np.asarray(jpt.fused_cand_cols(
            jc, *(jnp.asarray(t[rows].numpy()) for t in (pos, vel, rho)),
            jnp.asarray(mass.numpy()), zeros, zeros))
        np.testing.assert_array_equal(got, cols[:mass.shape[0], lanes])


def test_no_rows_launch_nothing(fake_card):
    pos, vel, rho, mass, _ = frame(8)
    got = cand_cols_t(CFG, pos[:0], vel[:0], rho[:0], mass[:0])
    assert got.shape == (0, 9) and fake_card.calls == []
    assert cand_cols_t.launches == 0
    idx = torch.zeros(0, dtype=torch.int32)
    assert cand_cols_t(CFG, pos, vel, rho, mass[:0], idx).shape == (0, 9)
    assert fused_cand_cols(CFG, pos[:0], vel[:0], rho[:0],
                           mass[:0]).shape == (0, 9)


def test_grid_blocks_cap_and_ragged_edge():
    assert sw.cand_blocks(1, 1056) == 1
    assert sw.cand_blocks(256, 1056) == 1
    assert sw.cand_blocks(257, 1056) == 2
    assert sw.cand_blocks(10_000_000, 1056) == 1056


def _bad_inputs():
    pos, vel, rho, mass, _ = frame(20)
    ipos, ivel, irho, imass, idx = frame(8, rows=20)
    yield "pos dtype", (pos.double(), vel, rho, mass, None)
    yield "vel dtype", (pos, vel.half(), rho, mass, None)
    yield "rho dtype", (pos, vel, rho.double(), mass, None)
    yield "mass dtype", (pos, vel, rho, mass.double(), None)
    yield "pos shape", (pos[:, :2], vel, rho, mass, None)
    yield "rho rows", (pos, vel, rho[:-1], mass, None)
    yield "mass rank", (pos, vel, rho, mass[:, None], None)
    yield "rows without an index", (pos, vel, rho, mass[:-1], None)
    yield "last stride", (pos.t().contiguous().t(), vel, rho, mass, None)
    yield "device", (pos, vel.to("meta"), rho, mass, None)
    yield "index dtype", (ipos, ivel, irho, imass, idx.long())
    yield "index length", (ipos, ivel, irho, imass, idx[:-1])
    yield "index contiguity", (ipos, ivel, irho, imass,
                               torch.stack([idx, idx], 1)[:, 0])
    yield "indexed rows", (ipos, ivel, irho[:-1], imass, idx)


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=lambda c: c[0])
def test_card_path_refuses_what_the_kernel_does_not_take(fake_card, case):
    _, args = case
    with pytest.raises(ValueError, match="need"):
        cand_cols_t(CFG, *args)
    assert fake_card.calls == [] and cand_cols_t.launches == 0


def test_counters_record_rows_on_the_plain_path():
    """On the CPU ``fused_cand_cols`` builds every column with its twin:
    ``cand_cols_t`` launches nothing, and nothing is counted, with the
    profiler off or on."""
    trace.take()
    launches = cand_cols_t.launches
    fused_cand_cols(CFG, *frame(50)[:4])
    assert trace.take()["counts"] == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in ("exact", "indexed", "strided"):
            pos, vel, rho, mass, idx = frame(**CASES[name])
            fused_cand_cols(CFG, pos, vel, rho, mass, index=idx)
    assert trace.take()["counts"] == {}
    assert cand_cols_t.launches == launches


def test_counters_record_the_kernel_s_rows(fake_card, monkeypatch):
    """Through the kernel every call launches ``cand_cols_t`` once, over
    all its rows; the plain path launches nothing; neither counts a
    counter while the profiler records."""
    pos, vel, rho, mass, idx = frame(**CASES["indexed"])
    trace.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with monkeypatch.context() as mp:
            mp.setattr(sw, "_use_plain", lambda x: False)
            for _ in range(2):
                fused_cand_cols(CFG, pos, vel, rho, mass, index=idx)
        assert cand_cols_t.launches == 2
        assert [c["m"] for c in fake_card.calls] == [700, 700]
        for _ in range(2):
            fused_cand_cols(CFG, pos, vel, rho, mass, index=idx)
    assert trace.take()["counts"] == {}
    assert cand_cols_t.launches == 2 and len(fake_card.calls) == 2


def _capped(fused=False):
    kw = dict(num_particles=768, cell_size_factor=1.25, pallas_window_t=0,
              capped_candidates=4, capped_fused=fused)
    cfg, st = make_scene("splash", device="cpu", **kw)
    cfg = resolve_sweep_settings(cfg, st, kw)
    return cfg, sw.prepare_t(cfg, st)


def test_capped_force_sweep_folds_the_gather_in(monkeypatch):
    """Capped K2 takes its columns from ``fused_cand_cols`` indexed by
    ``sub_perm`` over the sorted frame, with the sub frame's masses: the
    same columns as the twin over the gathered rows, so the same
    accelerations bit for bit; K1 gathers positions only, and only the
    fused path gathers velocities (``gather_sub_pv``)."""
    cfg, p = _capped()
    rho, _ = sw.density_sweep_t(cfg, p)
    seen = []

    def cols(cfg_, pos, vel, rho_, mass, index=None):
        seen.append((pos, vel, rho_, mass, index))
        return fused_cand_cols(cfg_, pos, vel, rho_, mass, index=index)

    with monkeypatch.context() as mp:
        mp.setattr(sw, "fused_cand_cols", cols)
        acc = sw.force_sweep_t(cfg, p, rho)
    [(pos, vel, rho_c, mass, index)] = seen
    assert pos is p.pos_s and vel is p.vel_s and rho_c is rho
    assert mass is p.wm_sub and index is p.sub_perm
    rows = p.sub_perm.long()
    cand = fused_cand_cols_plain(cfg, p.pos_s[rows], p.vel_s[rows],
                                 rho[rows], p.wm_sub)
    want = sw.force_t_plain(cfg, p.pos_s, p.vel_s, rho, cand, p.cid,
                            p.cell_start, p.sub_perm)
    assert torch.equal(bits(acc), bits(want))

    def no_gather(p_):
        raise AssertionError("the two-pass path gathered velocities")

    with monkeypatch.context() as mp:
        mp.setattr(sw, "gather_sub_pv", no_gather)
        acc2, rho2, _ = sw.sweeps_sorted(cfg, p)
    assert torch.equal(rho2, rho)
    calls = []
    cfg_f, p_f = _capped(fused=True)
    with monkeypatch.context() as mp:
        mp.setattr(sw, "gather_sub_pv",
                   lambda p_: calls.append(1) or (p_.pos_s[p_.sub_perm],
                                                  p_.vel_s[p_.sub_perm]))
        sw.sweeps_sorted(cfg_f, p_f)
    assert calls == [1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
def test_kernel_against_the_twin_on_the_card():
    """Kernel and twin on CUDA, every column bit-equal (a NaN against a NaN
    counted equal): each case above (partial last tiles at 1,000, 1,041,
    1, 700, 600 and 513 rows), and a capped 20k splash's K2 columns
    against ``fused_cand_cols_plain(pos_s[idx], vel_s[idx], rho_s[idx],
    wm_sub)`` (``chip_smoke.cand_vs_twin``)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import chip_smoke

    dev = torch.device("cuda")
    for name, kw in CASES.items():
        pos, vel, rho, mass, idx = frame(**kw, device=dev)
        assert chip_smoke.cand_vs_twin(name, CFG, pos, vel, rho, mass,
                                       idx) == 0
    kw = dict(num_particles=20_000, cell_size_factor=1.25,
              pallas_window_t=0, capped_candidates=4)
    cfg, st = make_scene("splash", device=dev, **kw)
    cfg = resolve_sweep_settings(cfg, st, kw)
    p = sw.prepare_t(cfg, st)
    rho, _ = sw.density_sweep_t(cfg, p)
    assert chip_smoke.cand_vs_twin("capped 20k", cfg, p.pos_s, p.vel_s, rho,
                                   p.wm_sub, p.sub_perm) == 0
