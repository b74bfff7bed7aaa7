"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
one nvcc call builds it in seconds.  The shared library goes to ``_build/``
inside the package (listed in ``.gitignore``) under a name that carries the
hash of the sources and flags: a changed source builds anew on first use,
an unchanged one loads the library already built.  nvcc's stderr, which
holds ptxas's register and spill report (``-Xptxas -v``), is kept beside the
library as ``<library>.log``.

``--fmad=false`` keeps nvcc from contracting a multiply and an add into one
FMA anywhere in the kernels, so every product and sum rounds as the plain
PyTorch versions' separate tensor ops do (the neighbor mask ``d^2 < h^2``
is decided on those bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine that runs them")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the hash of every
    source in ``csrc/`` and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's stderr from the build of ``csrc/<name>.cu`` (ptxas report)."""
    return library_path(name).with_suffix(".log").read_text()


def build_libraries(names: list[str]) -> None:
    """Build each missing library of ``csrc/<name>.cu``: one nvcc process
    per source, all started together.

    Raises RuntimeError with nvcc's stderr when a build fails.
    """
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       so, tmp)
    failed = []
    for name, (proc, so, tmp) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}) on "
                          f"{name}.cu:\n{err}")
            continue
        so.with_suffix(".log").write_text(err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it.

    Raises RuntimeError with nvcc's stderr when the build fails.
    """
    build_libraries([name])
    return ctypes.CDLL(str(library_path(name)))
