"""Lazy rebinning: keep state sorted, rebuild the cell structure only on drift.

Counterpart of ``smoothed_particle_hydrodynamics_tpu/ops/lazy.py``; its
module docstring derives the bound.  In short: the state lives in the
sorted frame, and the candidates' cell-start table and the cell ids stay
frozen between rebins.  The kernels' pair mask tests
current distances, so frozen bins change only which candidates are
considered, and they still cover every true pair while the per-axis
displacement spread since binning stays within ``cell_size - h``.  ``lazy_step`` checks that bound against the positions
the sweeps are about to use and rebuilds first when it would be broken.
In capped mode the sub frame (kept set, reweighted masses, its cell-start
table) is frozen and rebuilt with the bins; its positions and velocities
are gathered fresh every step.

The JAX package decides inside the compiled step with ``lax.cond``; here
the decision is one host read of the drift test per step.

While a ``torch.profiler`` session runs, ``lazy_step`` records the spans of
``utils/trace.py`` that tile it: ``driver.step`` around
``driver.drift_read`` (the drift test and its host read), on a rebin
``binning.prepare`` and ``trace.rows_tested``, ``sweeps.sorted``
(``sweeps_sorted``), ``integrate.kdk`` and ``diagnostics.step``.  Each
bin made while recording keeps ``sweeps_t.band_rows_t``'s lane-rows, which
the sweeps count (``sweeps.rows_tested``) at each band sweep over the bin,
and in capped mode ``sweeps_t.kept_rows_t``'s kept rows, which each step
counts once (``capped.kept_rows``); where K2 runs (not the fused path), it
also keeps a zeroed [2] counter to which each K2 launch over the bin adds
its pairs and drain rounds, counted once at the bin
(``sweeps.force_pairs``, ``sweeps.force_rounds``).  In capped mode
``binning.prepare`` is tiled by ``binning.sort`` (cell ids, the (cell,
hash) sort, the sorted fields), ``binning.capped_sub`` (the sub frame) and
``binning.tables`` (the cell starts, the carry), and ``sweeps.sorted`` by
its own children (``sweeps_t.sweeps_sorted``); in exact mode both are
leaves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SphConfig, _f32
from ..state import (ParticleState, StepDiagnostics, make_step_diagnostics,
                     stack_diagnostics)
from ..utils import trace
from .grid import inverse_order, unsort_stacked
from .integrate import kdk_integrate
from .sweeps_t import (FORCE_PAIRS, FORCE_ROUNDS, SUB_FIELDS, PreparedT,
                       band_rows_t, capped_span, kept_rows_t, sort_frame_t,
                       sub_frame_t, sweeps_sorted, tables_t,
                       truncated_ranges)


class LazyCarry(NamedTuple):
    """Sorted-frame state + frozen binning structure."""

    state: ParticleState    # sorted frame
    order: torch.Tensor     # [N] i64: state[i] == initial_state[order[i]]
    pos_bin: torch.Tensor   # [N, 3] sorted-frame positions at bin time
    cid: torch.Tensor       # [N] i32 frozen cell ids
    steps_since: int        # steps since the last rebin
    rebin_count: int        # rebins so far (the initial binning excluded)
    # capped mode only (None otherwise), frozen with the bins:
    sub_perm: torch.Tensor | None = None     # [S] i32 sub row -> sorted row
    cand_cid: torch.Tensor | None = None     # [S] i32 sub cids
    wm_sub: torch.Tensor | None = None       # [S] reweighted cand masses
    sub_dropped: torch.Tensor | None = None  # i32 kept rows beyond S
    # frozen with the bins: [num_cells + 1] i32 cell starts of the
    # candidates (exact: the sorted frame; capped: the sub frame)
    cell_start: torch.Tensor | None = None
    # binned while recording (utils/trace.py): 0-d i64 lane-rows that one
    # band sweep over these bins tests; capped, 0-d i64 kept rows
    rows_tested: torch.Tensor | None = None
    kept_rows: torch.Tensor | None = None
    # binned while recording, where K2 runs: [2] i64 that its launches over
    # these bins add their pairs and drain rounds to
    force_stats: torch.Tensor | None = None
    # capped mode only: [N] i64 original id of each row of the frame these
    # bins sorted, which the kept set hashes (None: the caller's own order,
    # as after ``init_lazy``)
    bin_from: torch.Tensor | None = None


def skin_half(cfg: SphConfig) -> float:
    """Half the tolerated per-axis displacement spread (world units); the
    full budget is ``2 * skin_half = cell_size - h``."""
    return max(0.5 * (cfg.cell_size - cfg.h), 0.0)


def drift_spread(position: torch.Tensor, pos_bin: torch.Tensor) -> torch.Tensor:
    """Max over axes of the displacement spread (max_k d^a - min_k d^a)."""
    delta = position - pos_bin
    return (delta.amax(0) - delta.amin(0)).max()


def _validate(cfg: SphConfig) -> None:
    if cfg.compat:
        raise ValueError("the lazy loop supports default mode only")
    if cfg.second_kick == "full":
        raise ValueError("the lazy loop requires second_kick in ('gravity', "
                         "'none'): 'full' re-evaluates forces inside the "
                         "integrator")
    if cfg.pallas_layout != "sublane":
        raise ValueError("the lazy loop uses the sublane sweep layout")


def _bin(cfg: SphConfig, state: ParticleState, order: torch.Tensor | None,
         steps_since: int, rebin_count: int) -> LazyCarry:
    """Sort ``state`` and build fresh tables (``sweeps_t.prepare_t``'s
    phases); ``order`` is the permutation already applied to ``state``
    (None for the caller's own order)."""
    dev = state.position.device
    capped = bool(cfg.capped_candidates)
    with trace.span("binning.prepare", dev):
        with capped_span(cfg, "binning.sort", dev):
            f = sort_frame_t(cfg, state)
        with capped_span(cfg, "binning.capped_sub", dev):
            sub, cid_search = sub_frame_t(cfg, f)
        with capped_span(cfg, "binning.tables", dev):
            p = tables_t(cfg, f, sub, cid_search)
            sorted_state = state._replace(
                position=p.pos_s, velocity=p.vel_s, mass=p.mass_s,
                density=torch.zeros_like(p.mass_s),
                acceleration=torch.zeros_like(p.pos_s),
                neighbor_count=torch.zeros_like(p.cid))
            carry = LazyCarry(sorted_state,
                              p.order if order is None else order[p.order],
                              p.pos_s, p.cid, steps_since,
                              rebin_count, cell_start=p.cell_start,
                              bin_from=order if capped else None,
                              **{k: getattr(p, k) for k in SUB_FIELDS})
    if trace.recording():
        with trace.span("trace.rows_tested", dev), trace.hidden():
            m = (p.pos_s if p.sub_perm is None else p.sub_perm).shape[0]
            carry = carry._replace(
                rows_tested=band_rows_t(cfg, p.cid, p.cell_start, m),
                kept_rows=kept_rows_t(cfg, p) if capped else None)
            if not (capped and cfg.capped_fused):
                stats = torch.zeros(2, dtype=torch.int64, device=dev)
                trace.count(FORCE_PAIRS, stats[0])
                trace.count(FORCE_ROUNDS, stats[1])
                carry = carry._replace(force_stats=stats)
    return carry


def init_lazy(cfg: SphConfig, state: ParticleState) -> LazyCarry:
    """Sort the initial state and build the first binning structure."""
    _validate(cfg)
    return _bin(cfg, state, None, 0, 0)


def lazy_step(cfg: SphConfig, carry: LazyCarry
              ) -> tuple[LazyCarry, StepDiagnostics]:
    """One physics step under frozen bins, rebuilding first if drift demands.

    The drift test is float32, as in the JAX package, so both rebin on the
    same steps.
    """
    dev = carry.state.position.device
    with trace.span("driver.step", dev):
        with trace.span("driver.drift_read", dev):
            spread = drift_spread(carry.state.position, carry.pos_bin)
            rebin = bool(spread > _f32(2.0 * skin_half(cfg)))
        if rebin:
            carry = _bin(cfg, carry.state, carry.order, 0,
                         carry.rebin_count + 1)
        else:
            carry = carry._replace(steps_since=carry.steps_since + 1)

        st = carry.state
        p = PreparedT(order=carry.order, pos_s=st.position, vel_s=st.velocity,
                      mass_s=st.mass, cid=carry.cid,
                      cell_start=carry.cell_start,
                      rows_tested=carry.rows_tested,
                      kept_rows=carry.kept_rows,
                      force_stats=carry.force_stats,
                      **{k: getattr(carry, k) for k in SUB_FIELDS})
        acc_s, rho_s, ncount_s = sweeps_sorted(cfg, p)
        st = st._replace(density=rho_s, neighbor_count=ncount_s)
        with trace.span("integrate.kdk", dev):
            new_state, tally = kdk_integrate(cfg, st, acc_s)
        with trace.span("diagnostics.step", dev):
            # the sublane frame has no per-cell capacity: no cell overflows
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            diags = make_step_diagnostics(tally, ncount_s, zero,
                                          truncated_ranges(p))
    return carry._replace(state=new_state), diags


def unsort_carry(carry: LazyCarry) -> ParticleState:
    """Recover the original particle indexing from a lazy run's carry."""
    st = carry.state
    return ParticleState(*unsort_stacked(inverse_order(carry.order), list(st)))


def drive_loop_lazy(cfg: SphConfig, state: ParticleState | None,
                    num_steps: int, collect_diags: bool = True,
                    carry: LazyCarry | None = None, keep_carry: bool = False,
                    scan_block: int = 0):
    """Host-driven lazy loop (the production path).

    Returns ``(state, diags)`` with the state in the caller's particle
    order, or ``(carry, diags)`` with ``keep_carry=True`` for chained
    blocks.  ``scan_block`` is accepted for the JAX package's signature; the
    steps run one by one here either way.
    """
    del scan_block
    if carry is None:
        carry = init_lazy(cfg, state)
    diags = []
    for _ in range(num_steps):
        carry, d = lazy_step(cfg, carry)
        if collect_diags:
            diags.append(d)
    stacked = stack_diagnostics(diags) if collect_diags and diags else None
    if keep_carry:
        return carry, stacked
    return unsort_carry(carry), stacked
