"""The sweeps' work in a step, counted from the equations and the state's
size, never from a kernel's layout, and the card's peaks.

Pairs within h: N times the step's mean neighbor count (ordered pairs; each
particle sums over its own neighbors).  Operations of one pair, as the
equations need them:

- the offset and distance: dx, dy, dz (3), d^2 (3 multiplies, 2 adds): 8;
- the density term: t = h_s^2 - d^2 s^2 (2), poly6 t^3 (3), times m_j
  (1), the sum (1): 7;
- the force term: d = sqrt(d^2) s (2), hd = h_s - d (1), hd^2 (1),
  m_j (pw_i + pw_j) (2), times hd^2 (1), over (d + eps) (2), times s (1),
  three components times the offset and summed (6), the viscosity weight
  hd m_j / rho_j (1, m_j / rho_j being one per particle), three components
  of (v_j - v_i) times the weight, summed (9): 26.

41 operations a pair; a square root or a division counts as one.  Bytes:
each particle's inputs read once (position 12, velocity 12, mass 4) and
its outputs written once (density 4, neighbor count 4, acceleration 12):
48 a particle.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet at 700 W: float32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

PAIR_FLOPS = 8 + 7 + 26
PARTICLE_BYTES = 12 + 12 + 4 + 4 + 4 + 12


def sweeps_bound(n: int, neighbor_mean: float) -> dict:
    """The least time one step's sweeps could take on the card: the larger
    of its operations over the float32 peak and its bytes over the HBM
    bandwidth, and which of the two it is."""
    flops = n * neighbor_mean * PAIR_FLOPS
    nbytes = n * PARTICLE_BYTES
    t_flops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes, "flops_s": t_flops,
            "bytes_s": t_bytes, "bound_s": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes"}
