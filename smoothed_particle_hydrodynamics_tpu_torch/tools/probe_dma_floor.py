"""Floor probe of the neighbor sweeps: what a sweep pays for staged bytes,
for its walk and for its arithmetic, on the card.  Counterpart of
``tools/probe_dma_floor.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_dma_floor \\
        [N] [K_c] [--device cpu]

The JAX tool's arguments and defaults: the splash of N particles (1M) at
1.25h cells, window derived from the state, K_c 0 (exact); K_c > 0 runs
capped over the sub frame, on the capped main path's 256-row blocks
(``utils.benchmark.resolve_sweep_settings``; the JAX tool kept 128).

Kernels (``csrc/floor_t.cu``), which replace ``_probe_kernel``
(``tools/probe_dma_floor.py:61``, a Pallas TPU kernel run through
``pallas_step_t._run_chunked``):

* ``floor_window_t`` (wrapper; plain version ``floor_window_t_plain``): the
  TPU kernel's walk.  For self row i of block b and each rod r, the rows
  ``[ws[9 b + r], + L)`` of the padded candidate frame (``window_frame``:
  the JAX tool's columns x y z cid m iota, exact, or the sub frame's,
  capped, ``n_pad`` rows) give u = x_j - x_i, then K times
  u = u c + y_j (one rounding, an FMA) with c = 0.9999999; out[i] sums u.
  The window starts ``ws`` are the JAX package's (``window_tables``: no
  sweep of the port reads a window table, so the probe builds its own).
* ``floor_band_t`` (``floor_band_t_plain``): the port's production walk
  (``csrc/band_walk.cuh``, K1's, K2's and K3's) with the same ladder on
  every row of each lane's own bands, over a frame of W words a row
  (``band_frame``: W 4 as K1 stages, W 9 as exact K2 does).

Modes: ``full`` stages what the sweep stages; ``halfbytes`` stages half
(the window walk L = s_t / 2 rows, its ladder run over them twice; the band
walk the first W / 2 words of each row); ``nostage`` stages nothing and
runs the ladder over a zero-filled slot (window: s_t rows; band: the same
pieces and rows).  On the TPU the JAX kernel's ``halfbytes`` and ``nodma``
read scratch rows that nothing wrote: their outputs are undefined there.
Here they are defined: window ``halfbytes`` = 2 x ``full`` at window s_t/2
over the same starts, window ``nostage`` = 9 s_t (-x_i c^K), band
``halfbytes`` = band ``full``, band ``nostage`` = (rows tested)(-x_i c^K).
The JAX tool's own ``main`` calls ``_run_chunked`` with a signature the
function no longer has (it raises ``TypeError``); its kernel runs when
called with the current one.

The probe prints the card's line, the swept volume, then per walk (window;
band at W 4; band at W 9), mode and K in (2, 12, 24) the kernel's time
(``tools.timing``: queued CUDA events) beside its bound (``tools.bound``:
the bytes staged over 3.35 TB/s, or the ladder's lane operations, K + 2 a
tested row, over the card's 128 lanes a clock a SM) and that issue bound
alone (``chip_smoke.py``'s kernels line bounds the floor kernels by it and
each input read once).  Per walk and K, the
JAX tool's decomposition: bytes(half) = full - halfbytes, staging = full -
nostage, walk + ladder = nostage; the FMA slope of nostage over K and the
rate it implies, and its intercept at K = 0: the walk alone.  Last, real K1
and K2 (``density_t``/``force_t``, capped: ``density_capped_t``/
``force_capped_t``) in the same process.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from ..models import make_scene
from ..ops import sweeps_t
from ..ops.grid import rod_deltas
from ..ops.launch import check, raise_on, stream, use_plain
from ..utils import build
from . import ISSUE_PER_CLK, bound, card, host_tag, start, sync, timing

MODES = ("full", "halfbytes", "nostage")
KS = (2, 12, 24)
WIDTHS = (4, 9)     # band walk words a row: K1's x y z m, exact K2's 9
C_FMA = float(np.float32(0.9999999))
FRAME_COLS = 6      # window frame: x y z cid m iota
# pair elements per plain-version chunk, bounding its memory
_BUDGET = 1 << 24


@functools.cache
def _kernels() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/floor_t.cu``."""
    lib = build.load_library("floor_t")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.floor_window.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.floor_window.restype = i
    lib.floor_band.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.floor_band.restype = i
    lib.sph_error_string.argtypes = [i]
    lib.sph_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def _cand_columns(cfg, p) -> list[torch.Tensor]:
    """x y z, cid, m, src of the candidates: the sorted frame (exact) or
    the sub frame (capped: its positions, cids, reweighted masses and
    sorted rows)."""
    if cfg.capped_candidates:
        pos, _ = sweeps_t.gather_sub_pv(p)
        return [pos, p.cand_cid.float()[:, None], p.wm_sub[:, None],
                p.sub_perm.float()[:, None]]
    iota = torch.arange(p.pos_s.shape[0], device=p.pos_s.device)
    return [p.pos_s, p.cid.float()[:, None], p.mass_s[:, None],
            iota.float()[:, None]]


def n_pad(cfg, rows: int) -> int:
    """The JAX package's padded length of a candidate frame of ``rows``
    rows: its window starts clip to ``n_pad - window``."""
    return -(-(rows + cfg.pallas_window_t) // sweeps_t.LANE) * sweeps_t.LANE


def window_tables(cfg, p) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's window tables of ``p``'s self rows over its
    candidates (``pallas_step_t._block_windows_t``): per (block, group,
    rod), flattened, the 8-aligned window start and the count of
    ``pallas_window_t``-row chunks.  A group's rod window spans the cells
    from (first cid + delta - 1) to (last cid + delta + 1) of its rows,
    looked up in one bincount + cumsum of the candidates' cids (the capped
    sub frame's tail at num_cells, past every window)."""
    cid, n = p.cid, p.cid.shape[0]
    if cfg.capped_candidates:
        search = torch.where(p.cand_cid == sweeps_t.TAIL_CID, cfg.num_cells,
                             p.cand_cid)
    else:
        search = cid
    b, window, last = sweeps_t._blane(cfg), cfg.pallas_window_t, \
        cfg.num_cells - 1
    nblocks = -(-n // b)
    deltas = torch.tensor(rod_deltas(cfg), dtype=torch.int64,
                          device=cid.device)
    blocks = torch.nn.functional.pad(cid.long(), (0, nblocks * b - n),
                                     value=last).view(
        nblocks * cfg.pallas_groups, -1)
    lo = (blocks[:, :1] + deltas - 1).clamp(0, last)
    hi = (blocks[:, -1:] + deltas + 1).clamp(0, last)
    cum = torch.nn.functional.pad(torch.bincount(
        search.long().clamp(0, cfg.num_cells),
        minlength=cfg.num_cells + 1).cumsum(0), (1, 0))
    start = (cum[lo] & ~(sweeps_t.SUB - 1)).clamp(
        0, max(n_pad(cfg, search.shape[0]) - window, 0))
    length = (cum[hi + 1] - start).clamp(min=0)
    chunks = torch.where(length > 0, -(-length // window), 0)
    return (start.to(torch.int32).reshape(-1),
            chunks.to(torch.int32).reshape(-1))


def window_frame(cfg, p) -> torch.Tensor:
    """[n_pad, 6] padded candidate frame of the window walk: x y z cid m
    iota (capped: the sub frame's, src for iota), zero rows to ``n_pad``
    of the candidates (the JAX tool's frame)."""
    cols = torch.cat(_cand_columns(cfg, p), dim=1)
    pad = n_pad(cfg, cols.shape[0]) - cols.shape[0]
    return torch.nn.functional.pad(cols, (0, 0, 0, pad)).contiguous()


def band_frame(cfg, p, width: int) -> torch.Tensor:
    """[m, width] candidate frame of the band walk: x y z m cid src, cut
    or zero-padded to ``width`` (4: K1's staged words)."""
    pos, cid, m, src = _cand_columns(cfg, p)
    cols = torch.cat([pos, m, cid, src], dim=1)[:, :width]
    return torch.nn.functional.pad(
        cols, (0, width - cols.shape[1])).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _ladder(xj: torch.Tensor, yj: torch.Tensor, xi: torch.Tensor,
            k: int) -> torch.Tensor:
    """u = xj - xi, then ``k`` times u = u c + yj rounded once to f32 (the
    kernel's FMA: in f64 the product of two f32 values is exact and the
    sum rounds once, then to f32), in place in one f64 buffer."""
    u = (xj - xi).double()
    y, c = yj.double(), torch.tensor(C_FMA, dtype=torch.float64,
                                     device=u.device)
    for _ in range(k):
        torch.addcmul(y, u, c, out=u)
        u.copy_(u.float())
    return u.float()


def floor_window_t_plain(frame: torch.Tensor, x: torch.Tensor,
                         ws: torch.Tensor, s_t: int, block: int, mode: str,
                         k: int) -> torch.Tensor:
    """out [n]: ``floor_window_t``'s sums, chunked over blocks."""
    n = x.shape[0]
    nblocks = -(-n // block)
    length = s_t // 2 if mode == "halfbytes" else s_t
    xs = torch.nn.functional.pad(x, (0, nblocks * block - n)).view(
        nblocks, 1, 1, block)
    starts = ws.view(nblocks, sweeps_t.NRODS).long()
    lane = torch.arange(length, device=x.device)
    out = torch.empty(nblocks, block, dtype=torch.float32, device=x.device)
    step = max(1, _BUDGET // (sweeps_t.NRODS * length * block))
    for b0 in range(0, nblocks, step):
        bl = slice(b0, min(nblocks, b0 + step))
        if mode == "nostage":
            xj = yj = torch.zeros(1, 1, 1, 1, device=x.device)
        else:
            rows = starts[bl, :, None] + lane              # [nb, 9, L]
            xj, yj = frame[rows, 0][..., None], frame[rows, 1][..., None]
        u = _ladder(xj, yj, xs[bl], k)
        if mode == "nostage":
            u = u.expand(-1, sweeps_t.NRODS, length, -1)
        s = u.sum(2)                                       # [nb, 9, b]
        if mode == "halfbytes":
            s = s + s
        out[bl] = s.sum(1)
    return out.view(-1)[:n]


def floor_band_t_plain(cfg, cand: torch.Tensor, x: torch.Tensor,
                       cid: torch.Tensor, cell_start: torch.Tensor,
                       mode: str, k: int) -> torch.Tensor:
    """out [n]: ``floor_band_t``'s sums over each row's bands
    (``sweeps_t.band_ranges``), chunked over rows."""
    m = cand.shape[0]
    a, e = sweeps_t.band_ranges(cfg, cid, cell_start)
    e = e.clamp(max=m)
    lens = (e - a).clamp(min=0)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    lmax = max(int(lens.max()), 1) if n else 1
    lane = torch.arange(lmax, device=x.device)
    step = max(1, _BUDGET // (sweeps_t.NRODS * lmax))
    for r0 in range(0, n, step):
        rs = slice(r0, min(n, r0 + step))
        rows = a[rs, :, None] + lane                       # [nr, 9, L]
        valid = rows < e[rs, :, None]
        if mode == "nostage":
            xj = yj = torch.zeros((), device=x.device)
        else:
            rows = rows.clamp(max=m - 1)
            xj, yj = cand[rows, 0], cand[rows, 1]
        u = _ladder(xj, yj, x[rs, None, None], k)
        u = torch.where(valid, u, torch.zeros_like(u))
        out[rs] = u.sum(2).sum(1)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _mode_k(mode: str, k: int) -> int:
    if mode not in MODES or k not in KS:
        raise ValueError(f"the floor kernels take mode in {MODES} and k in "
                         f"{KS}, got {mode!r}, {k}")
    return MODES.index(mode)


def floor_window_t(frame: torch.Tensor, x: torch.Tensor, ws: torch.Tensor,
                   s_t: int, block: int, mode: str, k: int) -> torch.Tensor:
    """The window walk's sums [n] over the padded frame ``frame`` [n_pad,
    6] at the window starts ``ws`` [ceil(n / block) * 9] (multiples of 8,
    as ``window_tables`` builds them); CPU tensors take the plain
    version."""
    if use_plain(x):
        return floor_window_t_plain(frame, x, ws, s_t, block, mode, k)
    code = _mode_k(mode, k)
    n, dev = x.shape[0], x.device
    check(dev, frame=(frame, torch.float32, (frame.shape[0], FRAME_COLS)),
          x=(x, torch.float32, (n,)),
          ws=(ws, torch.int32, (-(-n // block) * sweeps_t.NRODS,)))
    if frame.shape[0] % sweeps_t.LANE or frame.shape[0] < s_t:
        raise ValueError(f"the frame holds {frame.shape[0]} rows: need the "
                         f"padded length (a multiple of {sweeps_t.LANE}, "
                         f"at least the window {s_t})")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _kernels()
    err = lib.floor_window(frame.data_ptr(), x.data_ptr(), ws.data_ptr(),
                           out.data_ptr(), n, block, s_t, code, k,
                           stream(dev))
    raise_on(lib, err, f"floor_window_t<{mode}, {k}>")
    floor_window_t.launches += 1
    return out


def floor_band_t(cfg, cand: torch.Tensor, x: torch.Tensor, cid: torch.Tensor,
                 cell_start: torch.Tensor, mode: str, k: int) -> torch.Tensor:
    """The band walk's sums [n] over the candidate frame ``cand`` [m, W]
    (W 4 or 9) and its cell-start table; CPU tensors take the plain
    version."""
    if use_plain(x):
        return floor_band_t_plain(cfg, cand, x, cid, cell_start, mode, k)
    code = _mode_k(mode, k)
    n, (m, width), dev = x.shape[0], cand.shape, x.device
    if width not in WIDTHS:
        raise ValueError(f"floor_band_t stages {WIDTHS} words a row, got "
                         f"{width}")
    check(dev, cand=(cand, torch.float32, (m, width)),
          x=(x, torch.float32, (n,)), cid=(cid, torch.int32, (n,)),
          cell_start=(cell_start, torch.int32, (cfg.num_cells + 1,)))
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _kernels()
    err = lib.floor_band(cand.data_ptr(), x.data_ptr(), cid.data_ptr(),
                         cell_start.data_ptr(), out.data_ptr(), n, m, width,
                         cfg.num_cells, cfg.grid_nx, cfg.grid_ny, code, k,
                         stream(dev))
    raise_on(lib, err, f"floor_band_t<{mode}, {k}, {width}>")
    floor_band_t.launches += 1
    return out


WRAPPERS = (floor_window_t, floor_band_t)
for _w in WRAPPERS:
    _w.launches = 0


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------

def setup(n: int, k_c: int, dev: torch.device):
    """(cfg, p): the JAX tool's splash at 1.25h cells, window derived
    (capped: K_c, 256-row blocks, sub frame bound derived)."""
    ov = dict(num_particles=n, cell_size_factor=1.25, pallas_window_t=0)
    if k_c:
        ov.update(capped_candidates=k_c, pallas_block_t=256)
    cfg, state = make_scene("splash", device=dev, **ov)
    if k_c:
        cfg = cfg.replace(
            capped_sub_len=sweeps_t.derive_sub_len(cfg, state))
    cfg = cfg.replace(pallas_window_t=sweeps_t.derive_window_t(cfg, state))
    return cfg, sweeps_t.prepare_t(cfg, state)


def walks(cfg, p) -> dict:
    """The probe's three walks on ``p``: name -> dict(run=(mode, k) -> the
    wrapper's out, plain=(mode, k) -> the plain version's, reads=the
    tensors the kernel reads, bytes=mode -> staged bytes, tested=the
    lane-rows the ladder runs on (it spends K + 2 lane operations on each),
    rows=tested rows a self row)."""
    from ..utils.walk_stats import band_stats

    n = p.pos_s.shape[0]
    block = sweeps_t._blane(cfg)
    s_t = cfg.pallas_window_t
    x = p.pos_s[:, 0].contiguous()
    frame = window_frame(cfg, p)
    ws, _ = window_tables(cfg, p)
    nblocks = -(-n // block)
    win_rows = nblocks * sweeps_t.NRODS * s_t       # rows the blocks stage
    out = {"window": dict(
        run=lambda mode, k: floor_window_t(frame, x, ws, s_t, block, mode,
                                           k),
        plain=lambda mode, k: floor_window_t_plain(frame, x, ws, s_t,
                                                   block, mode, k),
        reads=(frame, x, ws),
        bytes=dict(full=win_rows * FRAME_COLS * 4,
                   halfbytes=win_rows // 2 * FRAME_COLS * 4, nostage=0),
        tested=nblocks * block * sweeps_t.NRODS * s_t,
        rows=sweeps_t.NRODS * s_t)}
    m = p.sub_perm.shape[0] if cfg.capped_candidates else n
    a, e = sweeps_t.band_ranges(cfg, p.cid, p.cell_start)
    st = band_stats(a, e.clamp(max=m), m)
    staged = st["warp_union"] * -(-n // 32)          # rows the warps stage
    tested = st["mean"] * n
    for width in WIDTHS:
        cand = band_frame(cfg, p, width)
        out[f"band W{width}"] = dict(
            run=lambda mode, k, c=cand: floor_band_t(cfg, c, x, p.cid,
                                                     p.cell_start, mode, k),
            plain=lambda mode, k, c=cand: floor_band_t_plain(
                cfg, c, x, p.cid, p.cell_start, mode, k),
            reads=(cand, x, p.cid, p.cell_start),
            bytes=dict(full=int(staged * width * 4),
                       halfbytes=int(staged * (width // 2) * 4), nostage=0),
            tested=tested, rows=st["mean"])
    return out


def real_sweeps(cfg, p) -> dict:
    """name -> call: the sweeps' K1 and K2 wrappers on ``p``'s tensors
    (exact, or capped over the sub frame), the force sweep at K1's rho."""
    if cfg.capped_candidates:
        pos_c, vel_c = sweeps_t.gather_sub_pv(p)
        args = (p.pos_s, p.mass_s, p.cid, p.cell_start, pos_c, p.wm_sub,
                p.sub_perm)
        rho = sweeps_t.density_capped_t(cfg, *args)[0]
        cand = sweeps_t.fused_cand_cols(cfg, pos_c, vel_c, rho[p.sub_perm],
                                        p.wm_sub)
        return {"K1 density_capped_t": lambda: sweeps_t.density_capped_t(
                    cfg, *args),
                "K2 force_capped_t": lambda: sweeps_t.force_capped_t(
                    cfg, p.pos_s, p.vel_s, rho, cand, p.cid, p.cell_start,
                    p.sub_perm)}
    rho = sweeps_t.density_t(cfg, p.pos_s, p.mass_s, p.cid, p.cell_start)[0]
    cand = sweeps_t.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho, p.mass_s)
    return {"K1 density_t": lambda: sweeps_t.density_t(
                cfg, p.pos_s, p.mass_s, p.cid, p.cell_start),
            "K2 force_t": lambda: sweeps_t.force_t(
                cfg, p.pos_s, p.vel_s, rho, cand, p.cid, p.cell_start)}


def ladder_ops(walk: dict, k: int) -> float:
    """The lane instructions of a walk's ladders at depth ``k``: per tested
    lane-row one FSUB (u = x_j - x_i), K FFMAs and one FADD (the sum), each
    a full issue slot (``csrc/floor_t.cu``, ``ladder`` and the sums around
    it).  The bound of both floor kernels here and in ``chip_smoke.py``."""
    return walk["tested"] * (k + 2)


def issue_ms(ops: float, dev: torch.device) -> float:
    """Least ms for ``ops`` lane operations at the card's issue rate (128
    lanes a clock a SM); NaN on the CPU."""
    if dev.type != "cuda":
        return float("nan")
    c = card(dev.index or 0)
    return ops / (ISSUE_PER_CLK * c["sms"] * c["clock_hz"]) * 1e3


def decompose(ms: dict) -> dict:
    """The JAX tool's decomposition of one walk's times ``ms[(mode, k)]``:
    per k, bytes(half), staging, walk + ladder; the nostage FMA slope (ms a
    ladder step), its intercept at K = 0."""
    out = {k: dict(bytes_half=ms[("full", k)] - ms[("halfbytes", k)],
                   staging=ms[("full", k)] - ms[("nostage", k)],
                   walk_ladder=ms[("nostage", k)]) for k in KS}
    slope = (ms[("nostage", KS[-1])] - ms[("nostage", KS[0])]) / (
        KS[-1] - KS[0])
    out["slope_ms"] = slope
    out["intercept_ms"] = ms[("nostage", KS[0])] - slope * KS[0]
    return out


def main(n=1_000_000, k_c=0, device="cuda", iters=20) -> dict:
    dev = start(device)
    cfg, p = setup(n, k_c, dev)
    host = host_tag(dev)
    w = walks(cfg, p)
    win = w["window"]
    _, wc = window_tables(cfg, p)
    print(f"n={n} K_c={k_c} window_t={cfg.pallas_window_t} block_t="
          f"{sweeps_t._blane(cfg)} device={dev}")
    print(f"probe swept: window walk {win['rows']} rows a self row, "
          f"{win['tested'] / 1e9:.3f} G lane-rows, staged "
          f"{win['bytes']['full'] / 1e6:.1f} MB (the JAX tables' chunks "
          f"{int(wc.sum())}, windows {int((wc > 0).sum())} of "
          f"{wc.numel()}); band walk {w['band W4']['rows']:.1f} rows a "
          f"self row, staged {w['band W4']['bytes']['full'] / 1e6:.1f} MB "
          f"at W 4, {w['band W9']['bytes']['full'] / 1e6:.1f} MB at W 9")
    rows, decomp = {}, {}
    for name, walk in w.items():
        ms = {}
        for mode in MODES:
            for k in KS:
                t = timing(lambda: walk["run"](mode, k), dev, iters)["ms"]
                ms[(mode, k)] = t
                ops_ms = issue_ms(ladder_ops(walk, k), dev)
                b_ms, by = bound(walk["bytes"][mode], ops_ms)
                rows[f"{name} {mode} K={k}"] = dict(
                    ms=t, bound_ms=b_ms, bound_by=by, issue_ms=ops_ms)
                print(f"{name:8s} {mode:10s} {k:3d} FMA/lane {t:9.4f} ms"
                      f"{host}  bound {b_ms:.4f} ms ({by}; issue "
                      f"{ops_ms:.4f} ms)", flush=True)
        decomp[name] = decompose(ms)
    print()
    for name, d in decomp.items():
        for k in KS:
            print(f"{name:8s} K={k:3d}: bytes(half)={d[k]['bytes_half']:8.4f}"
                  f" ms  staging={d[k]['staging']:8.4f} ms  walk+ladder="
                  f"{d[k]['walk_ladder']:8.4f} ms{host}")
        rate = (w[name]["tested"] / (d["slope_ms"] * 1e-3) / 1e12
                if d["slope_ms"] > 0 else float("inf"))
        print(f"{name:8s} nostage FMA slope {d['slope_ms'] * 1e3:.3f} us/FMA "
              f"-> {rate:.2f} T lane-FMA/s over the tested rows; intercept "
              f"at K=0 (the walk alone) {d['intercept_ms']:.4f} ms{host}")
        d["rate_tfma"] = rate
    real = {}
    for name, fn in real_sweeps(cfg, p).items():
        real[name] = timing(fn, dev, iters)["ms"]
        print(f"real {name:24s} {real[name]:9.4f} ms{host}")
    sync(dev)
    return dict(cfg=cfg, rows=rows, decomposition=decomp, real=real,
                volume={name: dict(rows=v["rows"], bytes=v["bytes"])
                        for name, v in w.items()})


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "probe_dma_floor")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
