"""The system under test: the port's lazy driver, as a user's run of a
scene drives it.

This is the one module of the benchmark that imports the port
(``smoothed_particle_hydrodynamics_tpu_torch``).  It takes from it the
configuration type, the settings that ``run`` resolves, the driver
(``ops.lazy.drive_loop_lazy``) and the host read of a block's diagnostics
(``utils.diagnostics.host_diagnostics``), and nothing else; in capped mode
it also watches the driver's binnings (``BinFrames``).
"""

from __future__ import annotations

import numpy as np
import torch

from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy
from smoothed_particle_hydrodynamics_tpu_torch.state import (ParticleState,
                                                             StepDiagnostics)
from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
    resolve_sweep_settings)
from smoothed_particle_hydrodynamics_tpu_torch.utils.diagnostics import (
    host_diagnostics)

# the diagnostics that count a step as failed when above 0
LOSS_FIELDS = ("truncated_ranges", "overflow_cells")
FLOAT_FIELDS = ("kinetic_energy", "potential_energy", "angular_momentum",
                "neighbor_mean")


def make_config(sph: dict, pos, vel, mass) -> tuple[SphConfig, ParticleState]:
    """The config as ``run`` resolves it for the pallas backend (every
    field of ``sph`` set by the user) and the initial state."""
    fields = dict(sph, gravity=tuple(sph["gravity"]))
    cfg = SphConfig(**fields)
    state = ParticleState.from_arrays(pos, vel, mass)
    cfg = resolve_sweep_settings(cfg, state, fields, backend="pallas")
    cfg.validate()
    return cfg, state


def fresh(state: ParticleState) -> ParticleState:
    """A solve's own copy of the initial state, on the device."""
    return ParticleState(*(t.clone() for t in state))


def advance(cfg: SphConfig, state: ParticleState, carry, steps: int):
    """``steps`` steps of the lazy driver: from ``state`` when ``carry``
    is None (its first step bins it), else from ``carry``.  Returns
    (carry, stacked diagnostics on the device)."""
    return lazy.drive_loop_lazy(cfg, state if carry is None else None, steps,
                                carry=carry, keep_carry=True)


def concat(parts: list[StepDiagnostics]) -> StepDiagnostics:
    return StepDiagnostics(*(torch.cat(f) for f in zip(*parts)))


def read_block(diags: StepDiagnostics) -> dict:
    """The host's read of a block's diagnostics: {field: numpy [steps]}."""
    return host_diagnostics(diags)._asdict()


def failed_steps(host: dict) -> int:
    """Steps that lost a candidate or a cell, or ended non-finite."""
    bad = np.zeros(len(host["kinetic_energy"]), dtype=bool)
    for k in LOSS_FIELDS:
        bad |= np.asarray(host[k]) > 0
    for k in FLOAT_FIELDS:
        bad |= ~np.isfinite(np.asarray(host[k], dtype=np.float64))
    return int(bad.sum())


def rebins(carry) -> int:
    """Rebins so far in a solve (its initial binning not counted)."""
    return carry.rebin_count


def before(state: ParticleState, carry) -> dict:
    """A copy of the state a step starts from: positions and velocities,
    and the original particle id of each row."""
    if carry is None:
        n = state.position.shape[0]
        return {"pos": state.position.clone(), "vel": state.velocity.clone(),
                "order": torch.arange(n, device=state.position.device)}
    st = carry.state
    return {"pos": st.position.clone(), "vel": st.velocity.clone(),
            "order": carry.order.clone()}


class BinFrames:
    """Capped mode: the frame that each binning of the lazy driver sorted.

    The kept set hashes each particle's row in the frame that the bins were
    built from, and the carry keeps only the composed order.  While this
    context is open in capped mode, ``lazy._bin(cfg, state, order, ...)``
    is wrapped to remember, for the carry it built last, the ``order`` it
    was given: the original id of each row of ``state`` (None: the
    caller's own order).  That tensor already exists, so the watch adds no
    device work; it holds it until the next binning.  In exact mode the
    context does nothing.
    """

    def __init__(self, cfg: SphConfig):
        self.capped = bool(cfg.capped_candidates)
        self._last = None

    def __enter__(self) -> "BinFrames":
        if self.capped:
            self._inner = lazy._bin
            lazy._bin = self._bin
        return self

    def __exit__(self, *exc) -> None:
        if self.capped:
            lazy._bin = self._inner
        self._last = None

    def _bin(self, cfg, state, order, *args):
        carry = self._inner(cfg, state, order, *args)
        self._last = (carry.order, order)
        return carry

    def of(self, carry) -> torch.Tensor:
        """A copy of the original id of each row of the frame that
        ``carry``'s bins were built from."""
        built, frame = self._last or (None, None)
        if built is not carry.order:
            raise RuntimeError("the carry's bins are not the driver's "
                               "latest binning")
        if frame is None:
            return torch.arange(built.shape[0], device=built.device)
        return frame.clone()


def after(carry, frames: BinFrames) -> dict:
    """A copy of what a step produced: its neighbor counts, densities and
    accelerations, the positions and velocities it ends with, and the
    original particle id of each row; in capped mode (``frames``) also the
    bins its sweeps used: the positions they were built from (``bin_pos``,
    in the carry's frame) and the frame they sorted (``bin_from``).  A step
    that rebins does so before its sweeps, so the carry it returns holds
    them."""
    st = carry.state
    out = {"count": st.neighbor_count.clone(), "rho": st.density.clone(),
           "acc": st.acceleration.clone(), "pos": st.position.clone(),
           "vel": st.velocity.clone(), "order": carry.order.clone()}
    if frames.capped:
        out["bin_pos"] = carry.pos_bin.clone()
        out["bin_from"] = frames.of(carry)
    return out
