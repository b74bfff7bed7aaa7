"""Diagnostics writers: the reference's ``out/*.txt`` schema and a JSONL log.

Counterpart of ``smoothed_particle_hydrodynamics_tpu/utils/diagnostics.py``:
the same five files, byte for byte from the same diagnostics.

* ``energy.txt``: "Step, Kinetic Energy, Potential Energy, Total Energy"
* ``angularmomentum.txt``: "Step, Angular Momentum"
* ``timing.txt``: "Step, Voxelize, Find Neighbors, Compute Density, Compute
  Pressure, Compute Acceleration, Integrate"
* ``neighbors.txt``: "mean, max, min" per step (no header, as in the
  reference; the mean truncated to an integer)
* ``diagnostics.jsonl``: one record per step

A step runs as one sequence of kernels, so ``timing.txt`` carries the whole
step's time in its "Integrate" column and zeros elsewhere unless a
per-phase profile is given (``utils.profiling.profile_phases``).

A block's diagnostics cross to the host once: ``host_diagnostics`` stacks
the float fields and the int fields on the device and copies each stack
once.  The energies stay float32 on the host, so the total energy is the
float32 sum, as in the JAX package.  With the native library
(``utils.native``) the rows go to its background-thread writer, one job
per file and block.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import IO

import numpy as np
import torch

from ..state import StepDiagnostics

_FLOATS = ("kinetic_energy", "potential_energy", "angular_momentum",
           "neighbor_mean")
_INTS = ("neighbor_max", "neighbor_min", "overflow_cells", "truncated_ranges",
         "halo_dropped", "migration_dropped")


def host_diagnostics(diags: StepDiagnostics) -> StepDiagnostics:
    """A block of per-step diagnostics (tensors on any device, or arrays)
    as numpy arrays of one row per step: float32 and int32, two copies."""

    def stack(names, dtype):
        rows = [torch.as_tensor(getattr(diags, k)).reshape(-1).to(dtype)
                for k in names]
        return torch.stack(rows).cpu().numpy()

    f, i = stack(_FLOATS, torch.float32), stack(_INTS, torch.int32)
    return StepDiagnostics(**dict(zip(_FLOATS, f)), **dict(zip(_INTS, i)))


@dataclass
class DiagnosticsWriter:
    """Streams per-step diagnostics to the reference-compatible files.

    With ``use_native=True`` (default: whether the native library loads)
    rows are handed to the background-thread writer of
    ``native/sphio.cpp``.
    """

    out_dir: str = "out"
    use_native: bool | None = None
    _files: dict[str, IO] = field(default_factory=dict, repr=False)
    _native: object = field(default=None, repr=False)

    def __post_init__(self):
        from . import native

        os.makedirs(self.out_dir, exist_ok=True)
        if self.use_native is None:
            self.use_native = native.have_native()
        if self.use_native:
            self._native = native.AsyncFileWriter()
        self._files["energy"] = self._open("energy.txt")
        self._files["energy"].write(
            "Step, Kinetic Energy, Potential Energy, Total Energy\n")
        self._files["angmom"] = self._open("angularmomentum.txt")
        self._files["angmom"].write("Step, Angular Momentum\n")
        self._files["timing"] = self._open("timing.txt")
        self._files["timing"].write(
            "Step, Voxelize, Find Neighbors, Compute Density, "
            "Compute Pressure, Compute Acceleration, Integrate\n")
        self._files["neighbors"] = self._open("neighbors.txt")
        self._files["jsonl"] = self._open("diagnostics.jsonl")

    def _open(self, name: str) -> IO:
        path = os.path.join(self.out_dir, name)
        if self._native is not None:
            return _NativeStream(self._native, path)
        return open(path, "w", buffering=1 << 16)

    def write_block(self, first_step: int, diags: StepDiagnostics,
                    phase_ms: dict[str, float] | None = None
                    ) -> StepDiagnostics:
        """Write a block of per-step diagnostics (one row per step, the
        first at ``first_step``); returns the block's host copy
        (``host_diagnostics``) for the caller's checks."""
        host = host_diagnostics(diags)
        ke, pe, am, nmean = (getattr(host, k) for k in _FLOATS)
        nmax, nmin, overflow, truncated, halo, mig = (getattr(host, k)
                                                      for k in _INTS)
        ms = phase_ms or {}
        step_ms = ms.get("step", 0.0)
        rows = {k: [] for k in self._files}
        for i in range(ke.shape[0]):
            s = first_step + i
            total = ke[i] + pe[i]   # float32, as the JAX package sums it
            rows["energy"].append(f"{s}, {ke[i]:g}, {pe[i]:g}, {total:g}\n")
            rows["angmom"].append(f"{s}, {am[i]:g}\n")
            # reference columns; the step's time lands in Integrate
            rows["timing"].append(
                f"{s}, {ms.get('voxelize', 0)}, {ms.get('neighbors', 0)}, "
                f"{ms.get('density', 0)}, {ms.get('pressure', 0)}, "
                f"{ms.get('acceleration', 0)}, {step_ms:g}\n")
            # the reference's rows (src/sph.cpp:232): the mean truncated by
            # integer division
            rows["neighbors"].append(
                f"{int(nmean[i])}, {int(nmax[i])}, {int(nmin[i])}\n")
            rows["jsonl"].append(json.dumps({
                "step": s,
                "kinetic_energy": float(ke[i]),
                "potential_energy": float(pe[i]),
                "total_energy": float(total),
                "angular_momentum": float(am[i]),
                "neighbor_mean": float(nmean[i]),
                "neighbor_max": int(nmax[i]),
                "neighbor_min": int(nmin[i]),
                "overflow_cells": int(overflow[i]),
                "truncated_ranges": int(truncated[i]),
                "halo_dropped": int(halo[i]),
                "migration_dropped": int(mig[i]),
                "step_ms": step_ms,
            }) + "\n")
        # one write per file and block: a native write is a job that opens,
        # appends to and closes its file on the writer's thread, beside the
        # next block's steps
        for k, lines in rows.items():
            self._files[k].write("".join(lines))
        return host

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        if self._native is not None:
            self._native.close()
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _NativeStream:
    """File-like shim routing writes through the native async writer."""

    def __init__(self, writer, path: str):
        self._writer = writer
        self._path = path
        self._first = True

    def write(self, text: str) -> None:
        self._writer.write(self._path, text, append=not self._first)
        self._first = False

    def close(self) -> None:
        self._writer.flush()


def detect_blowup(diags: StepDiagnostics) -> tuple[bool, str]:
    """NaN/Inf or runaway kinetic energy in a block of diagnostics (host
    arrays, ``host_diagnostics``), so the run can stop with a checkpoint."""
    ke = np.asarray(diags.kinetic_energy)
    pe = np.asarray(diags.potential_energy)
    if not np.isfinite(ke).all() or not np.isfinite(pe).all():
        return True, "non-finite energy"
    if ke.size and np.abs(ke).max() > 1e30:
        return True, "kinetic energy blow-up"
    return False, ""


def detect_truncation(diags: StepDiagnostics) -> tuple[bool, str]:
    """Interactions dropped by static capacities in a block of diagnostics
    (host arrays): candidate ranges cut (``truncated_ranges``), halo
    candidates dropped or particles lost to migration.  The run goes on;
    the caller warns."""
    trunc = int(np.asarray(diags.truncated_ranges).sum())
    halo = int(np.asarray(diags.halo_dropped).sum())
    mig = int(np.asarray(diags.migration_dropped).sum())
    msgs = []
    if trunc:
        msgs.append(f"{trunc} candidate ranges truncated by capacity "
                    "(raise range_slice / kernel window)")
    if halo:
        msgs.append(f"{halo} candidates dropped outside the halo band "
                    "(raise halo_rows)")
    if mig:
        msgs.append(f"{mig} particles lost to migration/slab capacity "
                    "(raise m_cap / p_cap)")
    return bool(msgs), "; ".join(msgs)
