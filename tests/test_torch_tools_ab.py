"""The A/B tools of the port (``ab_engines``, ``ab_dials``, ``ab_slab``) and
``microbench``, on the CPU at small sizes.

``ab_engines``: the single-device lazy step and the one-rank slab step on
the 2048-particle splash, positions read as the JAX tool reads them (slab
rows by their original id, field 7): capped K_c 4, rel-L2 <= 1e-5 over 8
steps; exact, equal.  (Capped, the two engines keep different candidates
after the first rebin: the slab hashes original ids, the lazy driver the
rows of its sorted frame, as in the JAX package; from there the rel-L2
grows ~7e-6 a step at this size, while before it the two agree to ~3e-9.)

``ab_dials`` and ``ab_slab``, two variants for one round: each variant's
``fp`` equals that of the same steps run alone.  ``microbench``: each op
equals numpy's result on the same inputs.
"""

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.tools import (ab_dials,
                                                             ab_engines,
                                                             ab_slab,
                                                             microbench)

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("k_c", [0, 4])
def test_ab_engines_agree(k_c, capsys):
    r = ab_engines.main(2048, k_c, 8, device="cpu")
    rel = r["rel_l2"]
    assert len(rel) == 8
    if k_c:
        assert max(rel) <= 1e-5, rel
    else:
        assert max(rel) == 0.0, rel
    out = capsys.readouterr().out
    assert out.count("relL2 ") == 8
    assert any(r["rebinned_single"]) and r["rebinned_slab"][0]


def test_ab_dials_fingerprints_match_runs_alone():
    only = ["baseline", "csf1.5"]
    got = ab_dials.main(1024, 4, rounds=1, block=2, only=only, device="cpu",
                        settle=2)
    assert list(got) == only
    for name, extra in ab_dials.VARIANTS:
        if name in only:
            v = ab_dials.Variant(name, extra, 1024, 4, CPU, settle=2)
            v.measure_block(2)
            assert ab_dials.fingerprint(v.carry) == got[name]["fp"], name
    assert got["baseline"]["fp"] != got["csf1.5"]["fp"]


def test_ab_slab_fingerprints_match_runs_alone(capsys):
    only = ["baseline", "csf1.25+sb16"]
    got = ab_slab.main(1024, 4, rounds=1, block_calls=1, grid_nz=16,
                       scan_block=1, only=only, device="cpu",
                       settle_calls=1)
    assert list(got) == only
    assert ab_slab.SCAN_BLOCK_NOTE in capsys.readouterr().out
    with comm.local_group(CPU) as group:
        for name, extra in ab_slab.VARIANTS:
            if name in only:
                v = ab_slab.Variant(name, extra, 1024, 4, 16, 1, group, CPU,
                                    settle_calls=1)
                v.measure_block(1)
                assert ab_slab.slab_fingerprint(v.carry) == got[name]["fp"]
                assert v.carry.rebin_count == got[name]["rebins"]


def test_ab_slab_keeps_the_jax_variants():
    """The JAX tool's variant list, ``_scan_block`` ones included."""
    from test_torch_tools_fullrun import jax_tool

    assert ab_slab.VARIANTS == jax_tool("ab_slab").VARIANTS
    assert ab_dials.VARIANTS == jax_tool("ab_dials").VARIANTS


def test_microbench_ops_equal_numpy(capsys):
    sizes = dict(n=512, k_total=512 * 16, cands=16, sort_sizes=(512, 4096),
                 slice_rows=64)
    ops = microbench.ops(CPU, **sizes)
    assert len(ops) == 10
    for label, call, ref in ops:
        got, want = call().numpy(), ref()
        assert got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)
    times = microbench.main("cpu", **sizes)
    assert list(times) == [label for label, _, _ in ops]
    assert capsys.readouterr().out.count(" ms host") == len(ops)
