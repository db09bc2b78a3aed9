"""The serving mesh on ``torch.distributed``: one process per rank.

The port's twin of ``repro.launch.mesh.make_serving_mesh``. The reference
is one JAX controller that lays a ``(data, model)`` mesh over its devices;
here each point of the mesh is a process (a rank), and the mesh is the
grid of process groups over the ranks: rank ``d * model + m`` sits at data
index ``d`` and model index ``m``. Its model group (the ranks sharing
``d``) is one tensor-parallel group: the collective the sharded paged path
pays is one ``all_reduce`` over it (``AxisGroup.all_reduce``). Its data
group (the ranks sharing ``m``) replicates the batch and runs no
collective on the serving path.

``make_serving_mesh`` initializes the default process group from the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
``spawn_ranks`` sets them) unless the caller already did, with the backend
the caller names: ``nccl`` (the default: one card per rank) or ``gloo``
(ranks may share a card, or run on the CPU; gloo all-reduces CUDA tensors
by staging them through the host). It switches nothing on its own: a
backend that cannot place the ranks raises and says what to ask for
instead. Each rank serves on ``cuda:{local rank % cards}`` unless the
caller gives a device (``cpu`` in the tests).

``spawn_ranks`` runs a function on every rank of a fresh world of
processes on this host (``launch/serve.py --tp``, ``chip_smoke.py``'s
phase 11, the CPU tests) and returns each rank's result.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class AxisGroup:
    """This rank's process group along one mesh axis: ``ranks`` in axis
    order, this rank at ``index``. ``all_reduce`` sums a tensor over the
    group in place and counts the calls and their bytes; with ``timed`` set
    it also synchronizes the device around each call and adds the wall time
    to ``seconds`` (the measurement of the collectives' share of a step)."""

    def __init__(self, name: str, ranks: Sequence[int], rank: int, group):
        self.name = name
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.group = group
        self.all_reduces = 0
        self.all_reduce_bytes = 0
        self.seconds = 0.0
        self.timed = False

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        self.all_reduces += 1
        self.all_reduce_bytes += x.numel() * x.element_size()
        if not self.timed:
            dist.all_reduce(x, group=self.group)
            return x
        cuda = x.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.all_reduce(x, group=self.group)
        if cuda:
            torch.cuda.synchronize(x.device)
        self.seconds += time.perf_counter() - t0
        return x

    def reset_counts(self) -> None:
        self.all_reduces = self.all_reduce_bytes = 0
        self.seconds = 0.0


@dataclasses.dataclass
class ServingMesh:
    """One rank's view of the ``(data, model)`` mesh."""
    shape: Dict[str, int]
    rank: int
    backend: str
    device: torch.device
    data: AxisGroup
    model: AxisGroup

    def barrier(self) -> None:
        """Every rank of the world waits here for the others."""
        dist.barrier()


# one mesh per shape in this process: its groups were made collectively by
# every rank, as the process group they live in was
_MESHES: Dict[Tuple[int, int], ServingMesh] = {}


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(
            f"no process group is initialized and {name} is not set: a rank needs "
            "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (spawn_ranks and "
            "launch/serve.py --tp set them)")
    return int(value)


def normalize_device(device) -> torch.device:
    """``device`` with the index a bare "cuda" stands for (the current
    device), so two names of one card compare equal; raises for a CUDA
    device where CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _rank_device(device, backend: str, local_rank: int, local_world: int) -> torch.device:
    if device is None:  # the rank's card (normalize_device raises without CUDA)
        device = torch.device("cuda", local_rank % max(1, torch.cuda.device_count()))
    device = normalize_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"nccl runs on CUDA devices, not {device}; pass "
                             "backend='gloo' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"nccl puts each rank on a card of its own: {local_world} ranks on "
                f"this host but {cards} card(s) visible; run at most {cards} ranks, "
                "or pass backend='gloo' to share a card (its all-reduce stages "
                "CUDA tensors through the host)")
        if device.index != local_rank:
            raise ValueError(f"nccl rank {local_rank} of this host must serve on "
                             f"cuda:{local_rank}, not {device}")
    return device


def make_serving_mesh(data_axis: int = 1, model_axis: int = 1, *,
                      backend: Optional[str] = None, device=None) -> ServingMesh:
    """This rank's ``(data, model)`` mesh over the world of processes.

    ``backend``: "nccl" or "gloo"; None takes the backend of the process
    group the caller initialized, or "nccl" where none is. The world size
    must be ``data_axis * model_axis``. ``device``: where this rank serves
    (None: ``cuda:{local rank % cards}``). A mesh of the same shape made
    earlier in this process is returned as it is (its device and backend
    must match what is asked)."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    cached = _MESHES.get((data_axis, model_axis))
    if cached is not None:
        if backend is not None and backend != cached.backend:
            raise ValueError(f"the mesh runs {cached.backend}, not {backend}")
        if device is not None and normalize_device(device) != cached.device:
            raise ValueError(f"the mesh serves on {cached.device}, not {device}")
        return cached
    need = data_axis * model_axis
    if dist.is_initialized():
        actual = dist.get_backend()
        if backend is not None and backend != actual:
            raise ValueError(f"the process group runs {actual}, not {backend}: "
                             "ask for the backend it was initialized with")
        backend, rank, world = actual, dist.get_rank(), dist.get_world_size()
    else:
        backend = backend or "nccl"
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    if world != need:
        raise ValueError(f"serving mesh (data={data_axis}, model={model_axis}) needs "
                         f"{need} ranks but the world has {world}")
    # placement is checked before the rendezvous: nccl with two ranks on one
    # card fails there, or hangs
    dev = _rank_device(device, backend, int(os.environ.get("LOCAL_RANK", rank)),
                       int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            raise ValueError("MASTER_ADDR is not set")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{_env_int('MASTER_PORT')}",
                                rank=rank, world_size=world, **kw)

    def groups(name, members):
        """Every rank makes every group, in one order; returns this rank's."""
        mine = None
        for ranks in members:
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = AxisGroup(name, ranks, rank, group)
        return mine

    model_groups = [[d * model_axis + m for m in range(model_axis)] for d in range(data_axis)]
    data_groups = [[d * model_axis + m for d in range(data_axis)] for m in range(model_axis)]
    mesh = ServingMesh(shape={"data": data_axis, "model": model_axis}, rank=rank,
                       backend=backend, device=dev, model=groups("model", model_groups),
                       data=groups("data", data_groups))
    _MESHES[(data_axis, model_axis)] = mesh
    return mesh


# ---------------------------------------------------------------------------
# spawning the ranks on this host
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on localhost no socket holds right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank: int, world: int, port: int, args, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        results.put(("ok", rank, fn(*args)))
    except BaseException:  # reported to the parent, which stops every rank
        results.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world_size: int, *args,
                timeout: float = 3600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` fresh processes (``spawn``), each
    with the environment of one rank of a world on this host; returns the
    ranks' results in rank order. ``fn`` and ``args`` travel by pickle, so
    ``fn`` must be importable by name. The first rank that fails, dies or
    outlives ``timeout`` stops them all and raises with its traceback."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world_size, port, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                kind, rank, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} before it reported")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"did not finish in {timeout:.0f} s")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world_size else 0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world_size)]
