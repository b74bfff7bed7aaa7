"""ctypes bindings for the native IO runtime (``native/sphio.cpp``).

Counterpart of ``smoothed_particle_hydrodynamics_tpu/utils/native.py``,
over the same library: ``native/libsphio.so`` at the repository root
(``make -C native`` builds it).  Every entry point has a pure-Python
fallback for when the library is absent, the JAX package's own behaviour;
the native path keeps file IO off the thread that drives the card and adds
CRC-verified snapshots.  ``AsyncFileWriter().stats()["native"]`` says which
writer runs.
"""

from __future__ import annotations

import ctypes
import os
import queue as _queue
import threading

import numpy as np

_LIB = None


def _find_lib():
    """The loaded library, or False when it is absent (cached either way)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (os.path.join(here, "native", "libsphio.so"), "libsphio.so"):
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        lib.sphio_writer_create.restype = ctypes.c_void_p
        lib.sphio_writer_enqueue.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_int]
        lib.sphio_writer_flush.argtypes = [ctypes.c_void_p]
        lib.sphio_writer_destroy.argtypes = [ctypes.c_void_p]
        lib.sphio_writer_dropped.argtypes = [ctypes.c_void_p]
        lib.sphio_writer_dropped.restype = ctypes.c_uint64
        lib.sphio_writer_written.argtypes = [ctypes.c_void_p]
        lib.sphio_writer_written.restype = ctypes.c_uint64
        lib.sphio_snapshot_create.restype = ctypes.c_void_p
        lib.sphio_snapshot_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_uint64]
        lib.sphio_snapshot_finish.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p]
        lib.sphio_snapshot_finish.restype = ctypes.c_int
        lib.sphio_snapshot_verify.argtypes = [ctypes.c_char_p]
        lib.sphio_snapshot_verify.restype = ctypes.c_int
        _LIB = lib
        return lib
    _LIB = False
    return False


def have_native() -> bool:
    return bool(_find_lib())


class AsyncFileWriter:
    """Background-thread file writer: native if available, Python otherwise."""

    def __init__(self):
        lib = _find_lib()
        self._lib = lib if lib else None
        if self._lib:
            self._handle = self._lib.sphio_writer_create()
        else:
            self._q: _queue.Queue = _queue.Queue(maxsize=65536)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def write(self, path: str, data: bytes | str, append: bool = True) -> None:
        if isinstance(data, str):
            data = data.encode()
        if self._lib:
            self._lib.sphio_writer_enqueue(
                self._handle, path.encode(), data, len(data), int(append))
        else:
            self._q.put((path, data, append))

    def flush(self) -> None:
        if self._lib:
            self._lib.sphio_writer_flush(self._handle)
        else:
            self._q.join()

    def stats(self) -> dict:
        if self._lib:
            return {"dropped": self._lib.sphio_writer_dropped(self._handle),
                    "written": self._lib.sphio_writer_written(self._handle),
                    "native": True}
        return {"dropped": 0, "written": -1, "native": False}

    def close(self) -> None:
        self.flush()
        if self._lib:
            self._lib.sphio_writer_destroy(self._handle)
            self._lib = None

    def _run(self):
        while True:
            path, data, append = self._q.get()
            try:
                with open(path, "ab" if append else "wb") as f:
                    f.write(data)
            finally:
                self._q.task_done()


def write_snapshot(path: str, arrays: dict[str, np.ndarray]) -> None:
    """CRC-checked binary snapshot (native) or .npz fallback."""
    lib = _find_lib()
    if not lib:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        return
    snap = lib.sphio_snapshot_create()
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float32:
            dtype = 0
        elif arr.dtype == np.int32:
            dtype = 1
        else:
            arr = arr.astype(np.float32)
            dtype = 0
        lib.sphio_snapshot_add(
            snap, name.encode(), dtype,
            arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
    rc = lib.sphio_snapshot_finish(snap, path.encode())
    if rc != 0:
        raise IOError(f"sphio snapshot write failed: {rc}")


def verify_snapshot(path: str) -> bool:
    """CRC check a native snapshot; True for npz fallback files too."""
    lib = _find_lib()
    if not lib or path.endswith(".npz"):
        return os.path.exists(path)
    return lib.sphio_snapshot_verify(path.encode()) == 0
