"""The JAX package's window tables: the CPU tests' yardstick for the port's
cell bands.

The JAX kernels walk, for each block of sorted self rows (each group of a
block at ``pallas_groups`` G > 1) and each of the 9 rods, one row window
``[ws, ws + wc * pallas_window_t)`` of the candidate frame and mask it by
cell id.  The port's sweeps walk per-lane cell bands instead, and a band
must hold exactly the rows of its block's window that pass the mask (in the
slab engine, the live ones), in the window's order.  These helpers return
the JAX package's own tables, as int64 numpy arrays of shape [blocks * G,
9], for the tests to hold the bands to by brute force.  JAX is imported
inside each helper, so a test module that the engine's spawned ranks
import stays free of it.
"""

import numpy as np

LANE = 128   # the JAX package's padded-frame granule


def jax_cfg(cfg):
    """The JAX package's ``SphConfig`` of a port config."""
    from smoothed_particle_hydrodynamics_tpu.config import SphConfig

    return SphConfig.from_json(cfg.to_json())


def as_table(ws, wc) -> tuple[np.ndarray, np.ndarray]:
    """A JAX table pair as int64 numpy arrays [blocks * G, 9]."""
    return (np.asarray(ws).reshape(-1, 9).astype(np.int64),
            np.asarray(wc).reshape(-1, 9).astype(np.int64))


def single_chip(cfg, cid, cid_search=None) -> tuple[np.ndarray, np.ndarray]:
    """``pallas_step_t._block_windows_t`` of the sorted self cids ``cid``
    over the candidates' cids ``cid_search`` (default ``cid``; the capped
    sub frame's tail at ``num_cells`` or above), as ``prepare_t`` there
    builds them: the candidate frame padded to a multiple of 128 rows past
    one window."""
    import jax.numpy as jnp

    from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jpt

    cid = np.asarray(cid, np.int32)
    search = cid if cid_search is None else np.asarray(cid_search, np.int32)
    n, m = cid.shape[0], search.shape[0]
    block = cfg.pallas_block_t or LANE
    n_pad = -(-(m + cfg.pallas_window_t) // LANE) * LANE
    return as_table(*jpt._block_windows_t(
        jax_cfg(cfg), jnp.asarray(cid), -(-n // block), cfg.pallas_window_t,
        n, n_pad, jnp.asarray(search)))


def sub_search(cfg, cand_cid) -> np.ndarray:
    """The capped sub frame's search cids: its kept rows' cids, the tail
    (``TAIL_CID``, any negative id here) at ``num_cells``."""
    cand = np.asarray(cand_cid, np.int64)
    return np.where(cand < 0, cfg.num_cells, cand).astype(np.int32)


def slab(cfg, cid_s, cid_ext, h_cap: int, p_cap: int, cnt: int,
         slab_hi: int, base=None, loc=None) -> tuple[np.ndarray, np.ndarray]:
    """The JAX slab engine's exact tables over a rank's raw extended frame
    (``parallel/slabs.py::_pallas_tables``: dead-row aware, plane-local from
    ``base`` over ``loc`` cells)."""
    import jax.numpy as jnp

    from smoothed_particle_hydrodynamics_tpu.parallel import slabs as js

    return as_table(*js._pallas_tables(
        jax_cfg(cfg), jnp.asarray(np.asarray(cid_s, np.int32)),
        jnp.asarray(np.asarray(cid_ext, np.int32)), h_cap, p_cap,
        jnp.int32(cnt), jnp.int32(slab_hi),
        None if base is None else jnp.int32(base), loc))


def slab_sub(cfg, cid_loc, cid_search, sub_len: int, cnt: int, base=None,
             loc=None) -> tuple[np.ndarray, np.ndarray]:
    """The JAX slab engine's tables over a rank's capped sub frame
    (``parallel/slabs.py::_pallas_sub_tables``) for the self cids
    ``cid_loc``: the own slab's (``cnt`` its live rows), or, for the fused
    pre-pass, the sub frame's own search cids padded with ``num_cells`` to
    whole blocks (``cnt`` its kept rows)."""
    import jax.numpy as jnp

    from smoothed_particle_hydrodynamics_tpu.parallel import slabs as js

    return as_table(*js._pallas_sub_tables(
        jax_cfg(cfg), jnp.asarray(np.asarray(cid_loc, np.int32)),
        jnp.asarray(np.asarray(cid_search, np.int32)), sub_len, cnt,
        None if base is None else jnp.int32(base), loc))


def prepass_self(cfg, cid_search) -> np.ndarray:
    """The fused pre-pass's self cids as the JAX engine lays them out: the
    sub frame's search cids padded with ``num_cells`` to whole blocks."""
    b = cfg.pallas_block_t or LANE
    s = np.asarray(cid_search, np.int32)
    return np.concatenate([s, np.full(-(-s.shape[0] // b) * b - s.shape[0],
                                      cfg.num_cells, np.int32)])


def _cell_xyz(cfg, cid):
    nx, ny = cfg.grid_nx, cfg.grid_ny
    return np.stack([cid % nx, (cid // nx) % ny, cid // (nx * ny)], axis=-1)


def assert_bands(cfg, ws, wc, cid_self, cand_cid, a, e, m: int, rows=None,
                 valid=None, n: int | None = None) -> int:
    """Brute force over the first ``n`` self rows (default all) and every
    rod: the band ``[a, e)`` (candidate rows, mapped to the windows' rows
    by ``rows``, default the same rows) holds, in order, the rows of the
    row's group's rod window ``[ws, min(ws + wc * pallas_window_t, m))``
    whose cids ``cand_cid`` pass the mask ``|cid_j - cid_i - delta| <= 1``
    (and ``valid``), and beyond them only rows of cells the linear cid band
    reaches by wrapping in x or y (no 3D neighbour of the row's cell, so
    never within h), which a plane-local window table leaves out.  Rows of
    one group and cell share windows and bands, so each (group, cell) is
    checked once.  Returns how many such wrapped rows the bands hold."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import rod_deltas

    b = (cfg.pallas_block_t or LANE) // cfg.pallas_groups
    s_t = cfg.pallas_window_t
    cid_self = np.asarray(cid_self, np.int64)
    cand = np.asarray(cand_cid, np.int64)
    a, e = np.asarray(a), np.asarray(e)
    n = cid_self.shape[0] if n is None else n
    rows = np.arange(cand.shape[0]) if rows is None else np.asarray(rows)
    ok = (np.ones(cand.shape[0], bool) if valid is None
          else np.asarray(valid, bool))
    deltas = np.asarray(rod_deltas(cfg))
    _, first = np.unique(np.stack([np.arange(n) // b, cid_self[:n]]), axis=1,
                         return_index=True)
    wrapped = 0
    for i in first:
        ci = int(cid_self[i])
        for r, delta in enumerate(deltas):
            lo = int(ws[i // b, r])
            hi = min(lo + int(wc[i // b, r]) * s_t, m)
            win = np.arange(lo, max(lo, hi))
            keep = win[(np.abs(cand[win] - ci - delta) <= 1) & ok[win]]
            band = rows[a[i, r]:max(a[i, r], e[i, r])]
            inside = np.isin(band, keep)
            np.testing.assert_array_equal(band[inside], keep,
                                          f"row {i} rod {r}")
            far = np.abs(_cell_xyz(cfg, cand[band[~inside]])
                         - _cell_xyz(cfg, ci)) > 1
            assert far.any(axis=1).all(), f"row {i} rod {r}"
            wrapped += int((~inside).sum())
    return wrapped


def assert_prepared(cfg, p, ws, wc, ws_sub=None, wc_sub=None) -> None:
    """A port ``PreparedT`` (or lazy carry) ``p`` against the JAX package's
    tables of the same bins: each self row's bands (``band_ranges`` of
    ``p.cid`` in ``p.cell_start``) over the sorted frame, or the capped sub
    frame, are the masked rows of its group's windows ``ws``, ``wc``; with
    ``ws_sub``, ``wc_sub`` (fused), each kept sub row's bands are the
    masked rows of its sub block's windows and the tail's are empty."""
    import torch

    from smoothed_particle_hydrodynamics_tpu_torch.ops.sweeps_t import (
        band_ranges)

    ws, wc = as_table(ws, wc)
    cand = p.cid if p.sub_perm is None else p.cand_cid
    a, e = band_ranges(cfg, p.cid, p.cell_start)
    assert_bands(cfg, ws, wc, p.cid.numpy(), cand.numpy(), a.numpy(),
                 e.numpy(), cand.shape[0])
    if ws_sub is None:
        return
    ws_sub, wc_sub = as_table(ws_sub, wc_sub)
    kept = int(p.cell_start[-1])
    a, e = band_ranges(cfg, p.cand_cid, p.cell_start)
    assert_bands(cfg, ws_sub, wc_sub, p.cand_cid.numpy(), p.cand_cid.numpy(),
                 a.numpy(), e.numpy(), cand.shape[0], n=kept)
    assert bool(torch.all(e[kept:] <= a[kept:]))
