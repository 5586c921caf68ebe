"""Serving meshes and the rank processes under them (port of
``repro/launch/mesh.py``).

``make_serving_mesh(spec)`` and ``make_host_mesh(data, model)`` build a
:class:`~repro_torch.parallel.sharding.ServingMesh` over the ranks of the
initialised process group (every rank calls them, in the same order).
``run_ranks`` starts the ranks themselves: ``world`` spawned processes in a
group whose backend follows ``parallel.sharding.pick_backend`` (NCCL when
each rank gets a card of its own, gloo when they share one or run on the
CPU), meeting through a ``file://`` rendezvous in a temporary directory.
``RankPool`` starts such ranks once and runs functions on all of them as often
as asked (the tests and the smoke run reuse one set of ranks across meshes).
``init_distributed`` joins the group a launcher such as ``torchrun`` describes
in its environment (the counterpart of ``jax.distributed.initialize()``), or
takes the group that already exists. The TPU pod shape of the JAX package's
``make_production_mesh`` comes with the dry-run slice.
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..parallel.sharding import ServingMesh, pick_backend

__all__ = ["make_serving_mesh", "make_host_mesh", "init_rank", "init_distributed",
           "run_ranks", "RankPool"]


def make_serving_mesh(spec: str) -> ServingMesh:
    """``"model=N,data=M"`` -> the mesh over the first N * M ranks."""
    return ServingMesh.from_spec(spec)


def make_host_mesh(data: int | None = None, model: int = 1) -> ServingMesh:
    """A mesh over every rank of the group (``data`` defaults to the world
    size over ``model``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return ServingMesh.create(data=data or world // model, model=model)


def init_rank(rank: int, world: int, backend: str, init_method: str,
              threads: int | None = None) -> None:
    """Join the group as ``rank``; under NCCL the rank takes card ``rank``
    as its current device first. Ranks on one host split its cores
    (``threads`` torch threads each, by default an equal share)."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)


def init_distributed(device=None) -> torch.device:
    """Join the process group that ``torchrun`` (or any launcher setting
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``) describes, through ``env://``; where a group exists
    already (the ranks of a ``RankPool``), that one. The backend follows
    ``pick_backend`` over the ranks of this host, and under NCCL each rank
    binds card ``LOCAL_RANK``. Returns the device this rank runs on
    (``device``, by default the card, or the rank's own card under NCCL)."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if not dist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
        backend = pick_backend(local, dev)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
    if dev.type == "cuda" and dev.index is None and dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _rank_main(rank, fn, world, backend, init_method, args):
    init_rank(rank, world, backend, init_method)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, device, *args) -> str:
    """Run ``fn(rank, *args)`` in ``world`` spawned rank processes joined in
    one group (``fn`` must be importable by name); returns once every rank
    has finished, raising if one failed. Returns the backend used."""
    backend = pick_backend(world, device)
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(fn, world, backend, init_method, args),
                           nprocs=world, start_method="spawn")
    return backend


def _pool_main(rank, world, backend, init_method, threads, conn):
    init_rank(rank, world, backend, init_method, threads)
    try:
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, args = task
            try:
                conn.send(("ok", fn(rank, *args)))
            except BaseException:     # the parent re-raises it with the rank's traceback
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class RankPool:
    """``world`` rank processes in one group, started once: ``submit(fn,
    *args)`` runs ``fn(rank, *args)`` on every rank (``fn`` importable by
    name), ``collect()`` waits and returns the results in rank order,
    raising if a rank failed (or, with ``timeout``, when a rank has not
    answered within that many seconds); ``run`` is both. The parent can work
    while the ranks run. ``close`` (or leaving the ``with`` block) ends
    them."""

    def __init__(self, world: int, device, threads: int | None = None):
        self.world = world
        self.backend = pick_backend(world, device)
        self._tmp = tempfile.TemporaryDirectory(prefix="ranks_")
        init_method = "file://" + os.path.join(self._tmp.name, "rendezvous")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_pool_main, daemon=True,
                               args=(rank, world, self.backend, init_method, threads,
                                     child))
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)

    def submit(self, fn, *args) -> None:
        for conn in self._conns:
            conn.send((fn, args))

    def collect(self, timeout: float | None = None) -> list:
        deadline = None if timeout is None else time.monotonic() + timeout
        results: dict[int, tuple] = {}
        while len(results) < self.world:
            for rank, conn in enumerate(self._conns):
                if rank not in results and conn.poll(0.05):
                    results[rank] = conn.recv()
                    if results[rank][0] == "error":   # the others may wait on it forever
                        raise RuntimeError(f"rank {rank} failed:\n{results[rank][1]}")
            if deadline is not None and time.monotonic() > deadline:
                late = sorted(set(range(self.world)) - set(results))
                raise TimeoutError(f"rank(s) {late} did not answer within {timeout} s")
        return [results[r][1] for r in range(self.world)]

    def run(self, fn, *args, timeout: float | None = None) -> list:
        self.submit(fn, *args)
        return self.collect(timeout)

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self._tmp.cleanup()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
