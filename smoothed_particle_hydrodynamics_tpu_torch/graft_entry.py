"""Entry points of the port for a harness (counterpart of the repository's
``__graft_entry__.py``).

* ``entry()``: the single-device step on the flagship scene, the
  reference's rotating gas disk at 8,192 particles, on the cell-list
  sweeps.
* ``dryrun_multichip(n)``: ``n`` ranks (``parallel.make_mesh``: NCCL on
  ``n`` cards, gloo ranks sharing fewer cards, or gloo on the CPU with
  ``device="cpu"``) each run two steps of four multi-rank paths on the
  packed dam break: the halo-sharded step, the slab engine on cell-list
  sweeps, on the sweep kernels (their plain twins on the CPU) and capped
  (K_c 4) on the kernels.  It checks what the JAX dry run checks and prints
  its ``dryrun_multichip(n): ok`` line.

    python -m smoothed_particle_hydrodynamics_tpu_torch.graft_entry 4
    python -m smoothed_particle_hydrodynamics_tpu_torch.graft_entry 2 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import math
from functools import partial

import torch


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): one step of the 8,192-particle disk."""
    from .models import make_scene
    from .ops.step import step

    cfg, state = make_scene("disk", device=device, num_particles=8192)
    return partial(step, cfg, backend="celllist"), (state,)


def _scene(n_devices: int):
    """The dry run's scene: a packed lattice (every interior particle has
    ~20-30 neighbors) on 1.25h cells, so the lazy engines' second step
    runs their frozen-structure branch."""
    from .models import make_scene

    return make_scene("dam_break", device="cpu",
                      num_particles=max(4096, 512 * n_devices),
                      grid_nx=32, grid_ny=32, grid_nz=32,
                      cell_size_factor=1.25, cell_capacity=32,
                      range_slice=64)


def _two_steps(step, carry):
    carry, _ = step(carry)
    return step(carry)


def dryrun_rank(group, n_devices: int) -> dict:
    """One rank of ``dryrun_multichip``: two steps of each path from the
    same state; the last step's diagnostics as plain values."""
    from .parallel import (derive_slab_caps, derive_sub_len_slab,
                           derive_zsplit, distribute, make_sharded_step,
                           make_slab_step, shard_state)
    from .parallel import slab_sweeps

    cfg, state = _scene(n_devices)
    dev_state = state._replace(**{k: v.to(group.device)
                                  for k, v in state._asdict().items()})
    out = {}
    _, d = _two_steps(make_sharded_step(cfg, group),
                      shard_state(group, dev_state))
    out["halo"] = d
    zsplit = derive_zsplit(cfg, state, n_devices)
    caps = derive_slab_caps(cfg, state, n_devices, zsplit=zsplit)
    runs = {"slab": (cfg, "celllist", None),
            "pallas": (cfg.replace(pallas_window_t=64), "pallas", None)}
    cfg_c = cfg.replace(pallas_window_t=32, capped_candidates=4)
    runs["capped"] = (cfg_c, "pallas",
                      derive_sub_len_slab(cfg_c, state, n_devices, zsplit))
    for name, (c, sweeps, sub_len) in runs.items():
        step = make_slab_step(c, group, *caps, zsplit=zsplit, sweeps=sweeps,
                              sub_len=sub_len)
        _, out[name] = _two_steps(step, distribute(c, dev_state, group,
                                                   caps[0], zsplit))
    res = {name: {k: v.item() for k, v in d._asdict().items()}
           for name, d in out.items()}
    res["p_cap"] = caps[0]
    res["launches"] = {w.__name__: w.launches for w in slab_sweeps.WRAPPERS}
    return res


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda",
                     timeout_s: float = 900.0) -> dict:
    """Run the four multi-rank paths on ``n_devices`` ranks, check them as
    the JAX dry run does, print the ok line; returns rank 0's results."""
    from .parallel import make_mesh, spawn_ranks

    layout = make_mesh(n_devices, device)
    print(f"dryrun_multichip({n_devices}): {layout.describe()}", flush=True)
    res = spawn_ranks(n_devices, dryrun_rank, n_devices,
                      backend=layout.backend, devices=list(layout.devices),
                      timeout_s=timeout_s, threads=layout.threads)[0]
    halo, slab, pal, cap = (res[k] for k in ("halo", "slab", "pallas",
                                             "capped"))
    ke, nmean = halo["kinetic_energy"], halo["neighbor_mean"]
    ske, snm = slab["kinetic_energy"], slab["neighbor_mean"]
    cnm = cap["neighbor_mean"]
    _expect(math.isfinite(ke), "the halo step's KE is not finite")
    _expect(nmean > 1.0, f"the scene is not packed (neighbor mean {nmean})")
    _expect(math.isfinite(ske), "the slab step's KE is not finite")
    _expect(snm > 1.0, f"slab neighbor mean {snm}")
    _expect(slab["migration_dropped"] == 0, "the slab engine lost particles")
    # the same two steps of the same exact sweeps: the engines agree to f32
    # reduction-order noise
    _expect(abs(ske - ke) <= 1e-3 * max(abs(ke), 1e-30),
            f"halo vs slab KE after 2 steps: {ke} vs {ske}")
    _expect(abs(snm - nmean) < 1e-2,
            f"halo vs slab neighbor mean: {nmean} vs {snm}")
    _expect(abs(pal["neighbor_mean"] - snm) < 1e-3,
            "slab kernel sweeps disagree with the cell-list sweeps")
    _expect(math.isfinite(cap["kinetic_energy"]), "capped KE not finite")
    _expect(1.0 < cnm <= snm + 1e-3,
            f"capped slab neighbor mean {cnm} vs exact {snm}")
    n = max(4096, 512 * n_devices)
    print(f"dryrun_multichip({n_devices}): ok — halo-vs-slab MATCH after 2 "
          f"steps (KE {ke:.4g} vs {ske:.4g}, rel "
          f"{abs(ske - ke) / max(abs(ke), 1e-30):.2e}; nmean {nmean:.2f} vs "
          f"{snm:.2f}); p_cap={res['p_cap']} capped nmean={cnm:.2f} "
          f"(n={n})")
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.graft_entry",
        description="the multi-rank dry run")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (--device cpu runs "
                         "gloo ranks on the CPU)")
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
