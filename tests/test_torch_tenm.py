"""The index arithmetic of the single-card 10M configurations, on the CPU
with 10M-sized values: the capped sort's key and order at 10M rows on the
grids of ``chip_smoke.py``'s phase 20 (the splash's 128^3 cells, where the
cell id and 10 hash bits pack into one key, and the 10M dam break's 256^3,
where 7 spare bits send both packages to the two-key sort), against the
JAX package's ``lax.sort`` of the same keys (``ops/pallas_step_t.py``,
``prepare_t``'s capped branch).  The port's key is an int64 on both paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jst

from smoothed_particle_hydrodynamics_tpu_torch.models import scene_config
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t

N = 10_000_000


def _jax_order(cid: np.ndarray, hb: int):
    """The JAX capped branch's (cid_sorted, order)."""
    c = jnp.asarray(cid)
    iota = jnp.arange(cid.shape[0], dtype=jnp.int32)
    if hb >= 8:
        packed = (c << hb) | (jst._hash32(iota) >> (31 - hb))
        packed_s, order = jax.lax.sort((packed, iota), num_keys=1)
        return np.asarray(packed_s >> hb), np.asarray(order)
    cid_s, _, order = jax.lax.sort((c, jst._hash32(iota), iota), num_keys=2)
    return np.asarray(cid_s), np.asarray(order)


@pytest.mark.parametrize("scene, overrides, hb", [
    ("splash", dict(cell_size_factor=1.25, capped_candidates=4), 10),
    ("dam_break_10m", dict(cell_size_factor=1.25, capped_candidates=4), 7)])
def test_capped_order_at_10m_rows_is_jaxs(scene, overrides, hb):
    cfg = scene_config(scene, num_particles=N, **overrides)
    assert sweeps_t._hash_bits(cfg) == hb
    # the key's largest value fits an int64 with room to spare
    bits = hb if hb >= 8 else 31
    assert ((cfg.num_cells - 1) << bits | (2 ** bits - 1)) < 2 ** 62
    rng = np.random.default_rng(10)
    # ~15 rows a cell over the occupied cells, as the splash's pool packs
    cid = rng.integers(0, N // 15, N, dtype=np.int32) * 13 % cfg.num_cells
    cid_t, order_t = sweeps_t._capped_order(torch.from_numpy(cid), hb)
    cid_j, order_j = _jax_order(cid, hb)
    assert order_t.dtype == torch.int64 and cid_t.dtype == torch.int32
    np.testing.assert_array_equal(cid_t.numpy(), cid_j)
    np.testing.assert_array_equal(order_t.numpy(), order_j)
