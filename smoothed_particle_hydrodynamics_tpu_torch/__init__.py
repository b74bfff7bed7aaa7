"""PyTorch + CUDA port of ``smoothed_particle_hydrodynamics_tpu``.

The JAX package beside this one is the reference: modules here carry the
same names where they have a counterpart there.  Plain tensor code is
PyTorch; the TPU's Pallas sweep kernels are hand-written CUDA kernels for
Hopper (``csrc/``), built with nvcc on first use, each with a plain PyTorch
twin that the wrapper runs on CPU tensors.  This package never imports JAX.

The top-level names are the JAX package's (``make_step``, a ``jax.jit``
wrapper, has no counterpart: ``step`` is already the step) and the port's
own ``make_scene``, ``state_from_numpy`` and ``state_to_numpy``.  Importing
them builds no kernel.
"""

from .config import SphConfig
from .init import init_dam_break, init_rotating_sphere, init_splash, load_state
from .models import make_scene
from .ops.step import compute_forces, run_steps, simulate, step
from .state import (ParticleState, StepDiagnostics, state_from_numpy,
                    state_to_numpy)

__version__ = "0.1.0"

__all__ = [
    "SphConfig",
    "ParticleState",
    "StepDiagnostics",
    "init_rotating_sphere",
    "init_dam_break",
    "init_splash",
    "load_state",
    "step",
    "run_steps",
    "simulate",
    "compute_forces",
    "__version__",
    "make_scene",
    "state_from_numpy",
    "state_to_numpy",
]
