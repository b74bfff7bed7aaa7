"""PyTorch + CUDA port of ``smoothed_particle_hydrodynamics_tpu``.

The JAX package beside this one is the reference: modules here carry the
same names where they have a counterpart there.  Plain tensor code is
PyTorch; the TPU's Pallas sweep kernels are hand-written CUDA kernels for
Hopper (``csrc/``), built with nvcc on first use, each with a plain PyTorch
twin that the wrapper runs on CPU tensors.  This package never imports JAX.
"""

from .config import SphConfig
from .models import make_scene
from .state import ParticleState, state_from_numpy, state_to_numpy

__all__ = ["ParticleState", "SphConfig", "make_scene", "state_from_numpy",
           "state_to_numpy"]
