"""Quickstart: the reference's rotating gas disk in ~20 lines.

Runs the astrophysical disk scene (the C++ reference's only workload:
32,768 particles around a central point mass) at a laptop-friendly size,
prints the conservation diagnostics the reference writes to
``out/energy.txt``, and renders the final state to ``quickstart_final.png``
in the working directory.  The counterpart of the JAX package's
``examples/quickstart.py``, with the same output lines.

    python -m smoothed_particle_hydrodynamics_tpu_torch.examples.quickstart
    python -m smoothed_particle_hydrodynamics_tpu_torch.examples.quickstart \\
        --device cpu

On the card the step runs the sweep kernels (``backend="pallas"``), on the
CPU the cell-list sweeps, as the CLI's ``--backend auto``.
``SPH_EXAMPLE_QUICK=1`` gives a tiny run.
"""

import argparse
import os

import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops.step import simulate
from smoothed_particle_hydrodynamics_tpu_torch.utils.render import (
    render_frame, save_png)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (--device cpu runs "
                         "on the CPU)")

    # Any SphConfig field can be overridden by keyword.  Scenes: disk, honey,
    # dam_break, splash, dam_break_10m.  num_steps is total_time/dt, as in the
    # reference (totalSteps = round(time/dt)); simulate runs num_steps + 1.
    _quick = os.environ.get("SPH_EXAMPLE_QUICK") == "1"   # tiny run for CI
    cfg, state = make_scene("disk", device=dev,
                            num_particles=2048 if _quick else 8192,
                            total_time=0.01 if _quick else 0.1)

    print(f"scene=disk n={cfg.num_particles} steps={cfg.num_steps} "
          f"device={dev}")

    final, diags = simulate(
        cfg, state, backend="pallas" if dev.type == "cuda" else "celllist")

    ke = diags.kinetic_energy.cpu().numpy()
    pe = diags.potential_energy.cpu().numpy()
    ang = diags.angular_momentum.cpu().numpy()
    e = ke + pe
    print(f"step   0: KE={ke[0]:.4g} PE={pe[0]:.4g} |L|={ang[0]:.4g}")
    print(f"step {len(ke) - 1}: KE={ke[-1]:.4g} PE={pe[-1]:.4g} "
          f"|L|={ang[-1]:.4g}")
    drift = abs(float(e[-1] - e[0]) / float(e[0]))
    print(f"total-energy drift: {drift:.3%}")
    print(f"neighbor count mean at end: {float(diags.neighbor_mean[-1]):.1f}")

    save_png(render_frame(cfg, final), "quickstart_final.png")
    print("wrote quickstart_final.png")


if __name__ == "__main__":
    main()
