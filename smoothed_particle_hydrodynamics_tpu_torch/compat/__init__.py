"""Bit-faithful reproduction of the C++ reference's behavior (counterpart of
``smoothed_particle_hydrodynamics_tpu/compat/``).

This package exists for golden parity.  The reference's neighbor search is
stochastic (LCG-offset subsampling), order-dependent and buggy (octant-table
slot overwrite, boundary-plane exclusion); its force loop has an
order-dependent viscosity rescale.  Default mode fixes all of that; this
package reproduces it, so densities and forces can be compared with dumps
of the compiled reference (``tools/golden_main.cpp``).  Everything here is
plain PyTorch on the state's device.
"""

from .neighbors import find_neighbors_compat
from .step import compat_step, compute_compat_quantities

__all__ = ["find_neighbors_compat", "compat_step", "compute_compat_quantities"]
