"""Rank group and collectives of the distributed slab engine.

The JAX package runs its slab engine as one ``shard_map`` program over a
device mesh (``parallel/sharding.make_mesh``) and moves data with
``lax.ppermute``, ``psum`` and ``pmax``.  Here every rank is one process on
``torch.distributed`` (NCCL between GPUs, gloo on the CPU), and
``SlabGroup`` carries what the mesh gave the JAX body:

* ``rank``, ``world`` and ``device``: ``axis_index``, the mesh size and the
  rank's device;
* ``shift_up(t)`` / ``shift_down(t)``: ship ``t`` to the next / previous rank
  around the ring and return what the previous / next rank shipped
  (``ppermute`` with the JAX engine's ``_perm(ndev, +1)`` / ``(ndev, -1)``),
  one ``batch_isend_irecv`` each.  Up and down messages carry distinct tags,
  so at world 2, where both neighbours are the same rank, they cannot cross.
  At world 1 nothing is sent: the tensor comes back as it is (JAX's
  one-device ``ppermute`` is the identity too) and the engine's chain-end
  masking supplies the inert halos;
* ``psum(t)`` / ``pmax(t)`` / ``all_gather(t)``: ``all_reduce`` and
  ``all_gather`` over the group.

A gloo group holding CUDA tensors stages every message through host memory
(gloo has no CUDA point-to-point); that is decided by the group's backend.

Every collective must be issued by every rank in the same order.  The
engine keeps that by branching only on values all ranks read from one
all-reduced tensor.

``spawn_ranks`` runs a function on ``world`` local ranks (the counterpart of
the JAX package's virtual CPU mesh in its tests); ``local_group`` is a
one-rank group in this process.  Both rendezvous through a ``FileStore``
and bind gloo and NCCL to the loopback interface unless the environment
says otherwise: they start ranks on this host only.  On a multi-GPU host,
``torchrun`` (one process per GPU) and ``SlabGroup.from_default`` do the
same job.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

_TAG_UP, _TAG_DOWN = 1, 2


class SlabGroup:
    """One rank's view of the group: its index, the group size, its device
    and the ``torch.distributed`` process group (None: a lone rank that
    issues no collective at all)."""

    def __init__(self, rank: int, world: int, device: torch.device | str,
                 group=None):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.group = group
        self.backend = None if group is None else dist.get_backend(group)
        self._staged = self.backend == "gloo" and self.device.type == "cuda"

    @classmethod
    def from_default(cls, device: torch.device | str) -> "SlabGroup":
        """The default process group (e.g. under ``torchrun``)."""
        return cls(dist.get_rank(), dist.get_world_size(), device,
                   dist.group.WORLD)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._staged else t.contiguous()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged else t

    def _ring(self, t: torch.Tensor, shift: int, tag: int) -> torch.Tensor:
        if self.world == 1:
            return t
        send = self._out(t)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (self.rank + shift) % self.world,
                          self.group, tag),
               dist.P2POp(dist.irecv, recv, (self.rank - shift) % self.world,
                          self.group, tag)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._back(recv)

    def shift_up(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to rank + 1; return rank - 1's (ring order)."""
        return self._ring(t, 1, _TAG_UP)

    def shift_down(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to rank - 1; return rank + 1's (ring order)."""
        return self._ring(t, -1, _TAG_DOWN)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return t
        x = self._out(t.clone())
        dist.all_reduce(x, op=op, group=self.group)
        return self._back(x)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[world, *t.shape]: every rank's ``t`` in rank order."""
        if self.group is None:
            return t[None]
        x = self._out(t)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.group)
        return self._back(torch.stack(parts))


def _loopback_env() -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")


def _init(rank: int, world: int, backend: str, store_path: str,
          timeout_s: float, device: torch.device) -> SlabGroup:
    _loopback_env()
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return SlabGroup(rank, world, device, dist.group.WORLD)


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


@contextlib.contextmanager
def local_group(device: torch.device | str, backend: str | None = None,
                timeout_s: float = 600.0):
    """A one-rank process group in this process (NCCL on a card, gloo on
    the CPU unless ``backend`` says otherwise), destroyed on exit."""
    device = torch.device(device)
    store_dir = tempfile.mkdtemp(prefix="slab_store_")
    try:
        grp = _init(0, 1, backend or _default_backend(device),
                    os.path.join(store_dir, "store"), timeout_s, device)
        try:
            yield grp
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _rank_main(rank, world, backend, store_path, timeout_s, device, threads,
               fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        grp = _init(rank, world, backend, store_path, timeout_s,
                    torch.device(device))
        out = fn(grp, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(world: int, fn, *args, backend: str = "nccl",
                devices: list | None = None, store_dir: str | None = None,
                timeout_s: float = 600.0, threads: int | None = None) -> list:
    """Run ``fn(group, *args)`` on ``world`` local ranks, one spawned process
    each; return their results in rank order.

    ``fn`` must be importable by name (a module-level function), its
    arguments and results picklable (numpy, not tensors).  ``devices`` gives
    each rank's device (default: ``cuda:<rank>`` for NCCL, the CPU for
    gloo; gloo ranks may share one card).  ``threads`` sets each rank's
    torch intra-op threads.  A rank that raises, or exits without a result,
    or a run past ``timeout_s`` kills every rank and raises here: nothing
    waits forever.
    """
    if devices is None:
        devices = [f"cuda:{r}" if backend == "nccl" else "cpu"
                   for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {devices}")
    own_dir = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="slab_store_")
    store_path = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, store_path, timeout_s,
                               str(devices[r]), threads, fn, args, results))
             for r in range(world)]
    out: list = [None] * world
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        pending = set(range(world))
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: ranks {sorted(pending)} gave "
                                   f"no result within {timeout_s} s")
            # a rank that exited has flushed its result, if it sent one
            dead = [r for r in pending if procs[r].exitcode is not None]
            try:
                rank, ok, value = results.get(timeout=1.0 if dead else 0.2)
            except queue.Empty:
                if dead:
                    raise RuntimeError(
                        f"spawn_ranks: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"spawn_ranks: rank {rank} raised:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    return out
