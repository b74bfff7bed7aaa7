"""Checkpoint / resume (counterpart of
``smoothed_particle_hydrodynamics_tpu/utils/io.py``).

A checkpoint is one ``.npz``: the step, the config's JSON as bytes and the
six state arrays (``state.state_to_numpy``), written under a temporary
name and renamed, so a crash mid-write never corrupts the newest one.  The
layout is the JAX package's: a checkpoint of either package loads in the
other, and both write the same bytes for the same step, config and state.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

import numpy as np
import torch

from ..config import SphConfig
from ..state import ParticleState, state_from_numpy, state_to_numpy

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _arrays(state: ParticleState) -> dict[str, np.ndarray]:
    return {k: np.ascontiguousarray(v)
            for k, v in state_to_numpy(state).items()}


def save_checkpoint(ckpt_dir: str, step: int, cfg: SphConfig,
                    state: ParticleState) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, step=np.int64(step), config=np.frombuffer(
            cfg.to_json().encode(), dtype=np.uint8), **_arrays(state))
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best


def load_checkpoint(path: str, device: torch.device | str = "cuda"
                    ) -> tuple[int, SphConfig, ParticleState]:
    """(step, config, state on ``device``) of a checkpoint of either
    package."""
    with np.load(path) as d:
        step = int(d["step"])
        cfg = SphConfig.from_json(bytes(d["config"].tobytes()).decode())
        state = state_from_numpy({k: d[k] for k in d.files
                                  if k not in ("step", "config")}, device)
    return step, cfg, state


def save_state(path: str, state: ParticleState) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_arrays(state))
    os.replace(tmp, path)


def config_fingerprint(cfg: SphConfig) -> str:
    return hashlib.sha256(cfg.to_json().encode()).hexdigest()[:16]


def write_run_metadata(out_dir: str, cfg: SphConfig,
                       extra: dict | None = None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    meta = {"config": json.loads(cfg.to_json()),
            "fingerprint": config_fingerprint(cfg)}
    if extra:
        meta.update(extra)
    with open(os.path.join(out_dir, "run.json"), "w") as f:
        json.dump(meta, f, indent=2)
