"""The port's harness entry points (``smoothed_particle_hydrodynamics_tpu_
torch/graft_entry.py``) on the CPU: ``dryrun_multichip(2)`` runs its four
multi-rank paths on two gloo ranks, passes the JAX dry run's checks and
prints its ok line; ``entry()`` gives the disk step."""

import torch

from smoothed_particle_hydrodynamics_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_dryrun_multichip_two_ranks(capsys):
    res = graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "dryrun_multichip(2): devices=[cpu, cpu] comm=gloo"
    assert out[-1].startswith("dryrun_multichip(2): ok — halo-vs-slab MATCH "
                              "after 2 steps")
    assert out[-1].endswith("(n=4096)")
    # the kernel paths ran the slab sweeps' wrappers (their twins here)
    assert res["pallas"]["neighbor_mean"] > 1.0
    assert res["capped"]["neighbor_mean"] <= res["slab"]["neighbor_mean"]
    assert not any(res["launches"].values())   # no card, nothing launched


def test_entry_is_the_disk_step():
    fn, (state,) = graft_entry.entry(device="cpu")
    assert state.n == 8192
    new, diag = fn(state)
    assert new.position.shape == (8192, 3)
    assert torch.isfinite(diag.kinetic_energy)
