"""Build a scene from scratch with the library API (no scene catalogue).

Two fluid blobs on a collision course inside a reflective box, a setup the
reference cannot express (its scene is hardcoded in its constructor; here
``SphConfig`` and any [N, 3] tensors work).  The counterpart of the JAX
package's ``examples/custom_scene.py``, with the same output lines.

Shows the core objects: ``SphConfig`` (frozen physics and capacities),
``ParticleState`` (a NamedTuple of flat tensors, the reference's
structure-of-arrays store) and ``ops.step.step`` (one step; the JAX
example's ``make_step`` is a jit wrapper, which this package has no use
for).

    python -m smoothed_particle_hydrodynamics_tpu_torch.examples.custom_scene
    python -m smoothed_particle_hydrodynamics_tpu_torch.examples.custom_scene \\
        --device cpu

On the card the step runs the sweep kernels (``backend="pallas"``), on the
CPU the cell-list sweeps.  ``SPH_EXAMPLE_QUICK=1`` gives a tiny run.
"""

import argparse
import os

import torch

from smoothed_particle_hydrodynamics_tpu_torch import ParticleState, SphConfig
from smoothed_particle_hydrodynamics_tpu_torch.ops.step import step


def blob(gen, n, center, radius, velocity, dev):
    """n particles uniform in a sphere, all moving with ``velocity``."""
    pts = torch.randn(n, 3, generator=gen)
    pts = pts / torch.linalg.norm(pts, dim=1, keepdim=True)
    r = radius * torch.rand(n, 1, generator=gen) ** (1.0 / 3.0)
    pos = torch.tensor(center) + pts * r
    vel = torch.tensor(velocity, dtype=torch.float32).expand(n, 3)
    return pos.to(dev), vel.to(dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (--device cpu runs "
                         "on the CPU)")

    _quick = os.environ.get("SPH_EXAMPLE_QUICK") == "1"   # tiny run for CI

    cfg = SphConfig(
        num_particles=2048 if _quick else 16384,
        h=0.1,                    # smoothing length [pc]
        # the box is grid * cell: 32 cells x (2.0*h) = 6.4 per axis
        grid_nx=32, grid_ny=32, grid_nz=32,
        rho0=0.1,
        stiffness=2.0,            # stiff enough that the impact couples
        viscosity=1.0,
        dt=1e-3,
        central_mass=0.0,         # no point mass: pure fluid
        boundary="reflect",       # the reference's dead reflection, rebuilt
    )
    cfg.validate()

    gen = torch.Generator().manual_seed(7)
    n_half = cfg.num_particles // 2
    pa, va = blob(gen, n_half, (2.2, 3.2, 3.2), 0.8, (+15.0, 0.0, 0.0), dev)
    pb, vb = blob(gen, cfg.num_particles - n_half, (4.2, 3.2, 3.2), 0.8,
                  (-15.0, 0.0, 0.0), dev)
    state = ParticleState.from_arrays(torch.cat([pa, pb]),
                                      torch.cat([va, vb]), cfg=cfg)

    backend = "pallas" if dev.type == "cuda" else "celllist"
    for i in range(12 if _quick else 120):
        state, diag = step(cfg, state, backend)
        if i % 30 == 0:
            print(f"step {i:3d}: KE={float(diag.kinetic_energy):10.4g}  "
                  f"neighbors mean={float(diag.neighbor_mean):5.1f} "
                  f"max={int(diag.neighbor_max)}")

    print(f"final KE: {float(diag.kinetic_energy):.4g} "
          f"(viscosity dissipates bulk KE as the blobs collide)")


if __name__ == "__main__":
    main()
