"""Runnable examples: ``python -m smoothed_particle_hydrodynamics_tpu_torch.
examples.quickstart`` and ``.custom_scene`` (the card by default,
``--device cpu`` on the CPU; ``SPH_EXAMPLE_QUICK=1`` for a tiny run)."""
