"""The distributed slab engine on 8 ranks.

Each rank owns a contiguous run of z-planes of the grid (mass-balanced by
``derive_zsplit``), holds only its own particles (O(N/D) memory, fixed
capacity ``p_cap``), exchanges one-plane halos with its ring neighbours
every step, and migrates boundary-crossing particles at rebins.  The
reference has no multi-device story at all; this is the layer the JAX
package's ``examples/distributed.py`` shows on an 8-device mesh, with the
same output lines.

    python -m smoothed_particle_hydrodynamics_tpu_torch.examples.distributed
    python -m smoothed_particle_hydrodynamics_tpu_torch.examples.distributed \\
        --device cpu

Each rank is a process on ``torch.distributed`` (``parallel.make_mesh``
places them): NCCL on a host with 8 cards, else 8 gloo ranks sharing the
cards (on a one-card host, all 8 on it), or 8 gloo ranks on the CPU with
``--device cpu``.  The placement is printed.  ``SPH_EXAMPLE_QUICK=1``
gives a tiny run.
"""

import argparse
import os

import numpy as np
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
    make_mesh, slabs, spawn_ranks)
from smoothed_particle_hydrodynamics_tpu_torch.state import state_to_numpy

NDEV = 8
STEPS = 20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (--device cpu runs "
                         "on the CPU)")

    layout = make_mesh(NDEV, dev)
    _quick = os.environ.get("SPH_EXAMPLE_QUICK") == "1"   # tiny run for CI
    cfg, state = make_scene("dam_break", device="cpu",
                            num_particles=4096 if _quick else 32768)

    zsplit = slabs.derive_zsplit(cfg, state, NDEV)        # mass-balanced planes
    caps = slabs.derive_slab_caps(cfg, state, NDEV, zsplit=zsplit)
    p_cap, h_cap, m_cap = caps
    print(f"devices={NDEV}  n={cfg.num_particles}  z-split={list(zsplit)}")
    print(f"per-device capacities: particles={p_cap} halo={h_cap} "
          f"migration={m_cap}  (store is O(N/D): {p_cap}/{cfg.num_particles})")
    print(f"placement: {layout.describe()}")

    # every rank distributes the same state, steps its slab and collects
    run = spawn_ranks(NDEV, slabs.run_slab_steps, cfg, state_to_numpy(state),
                      caps, zsplit, STEPS, backend=layout.backend,
                      devices=list(layout.devices),
                      threads=layout.threads)[0]

    # physics diagnostics are summed over the ranks: one number per step
    d = run["diags"]
    print(f"after {STEPS} steps: KE={float(d['kinetic_energy'][-1]):.5g}  "
          f"neighbors mean={float(d['neighbor_mean'][-1]):.1f}  "
          f"migration_dropped={int(d['migration_dropped'][-1])}  "
          f"halo_dropped={int(d['halo_dropped'][-1])}")

    # gathered back into one array; the particle count is conserved
    pos = run["position"]
    if not (np.isfinite(pos).all() and run["ids_once"]):
        raise SystemExit("collected positions not finite, or a particle "
                         "lost")
    print(f"collected [{pos.shape[0]}, 3] positions — "
          "all particles accounted for")


if __name__ == "__main__":
    main()
