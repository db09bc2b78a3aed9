"""The mesh on ``torch.distributed``: one process per rank.

The port's twin of ``repro.launch.mesh``. The reference is one JAX
controller that lays a mesh over its devices; here each point of the mesh
is a process (a rank), and the mesh is the grid of process groups over the
ranks. Its axes come in the reference's order, ``("data", "model")`` or
``("pod", "data", "model")``, and rank ``((p * D) + d) * M + m`` sits at
pod index ``p``, data index ``d`` and model index ``m``. Each axis gives
the rank one ``AxisGroup`` (the ranks that differ from it along that axis
alone), and the batch axes (pod, data) together give one more, ``batch``:
the ranks that hold the other rows of a batch. ``world`` is every rank.

Serving (``make_serving_mesh``, the reference's twin): the model group is
one tensor-parallel group, whose one collective is an ``all_reduce`` per
layer; the data group replicates the batch. Training (``make_debug_mesh``,
``make_production_mesh``, ``launch/train.py --dp/--tp``): weights are cut
over data (FSDP) and model (tensor and expert parallelism), the batch over
(pod, data) (``train/sharding.py``).

``make_mesh`` initializes the default process group from the environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``spawn_ranks``
sets them) unless the caller already did, with the backend the caller
names: ``nccl`` (the default: one card per rank) or ``gloo`` (ranks may
share a card, or run on the CPU). It switches nothing on its own: a backend
that cannot place the ranks raises and says what to ask for instead. Gloo
all-reduces, all-gathers and reduce-scatters CUDA tensors itself, through
the host (``chip_smoke.py`` phases 11 and 12 check each on the card). Each rank
runs on ``cuda:{local rank % cards}`` unless the caller gives a device
(``cpu`` in the tests). A world may hold several meshes of its size (their
groups are made collectively by every rank, as the world was).

``make_virtual_mesh`` is one rank's view of a mesh of any shape in this
one process, with no process group (the dry-run's, on the meta device):
its groups count each collective as a real group does and move nothing.

``spawn_ranks`` runs a function on every rank of a fresh world of
processes on this host (``launch/serve.py --tp``, ``launch/train.py --dp
--tp``, ``chip_smoke.py``'s phases 11 and 12, the CPU tests) and returns
each rank's result.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# the reference's mesh axes, in its order
AXES = ("pod", "data", "model")
# the axes a batch's rows are split over (the rules' "batch")
BATCH_AXES = ("pod", "data")


class AxisGroup:
    """This rank's process group along one mesh axis (or the batch axes
    together, or the world): ``ranks`` in axis order, this rank at
    ``index``. ``all_reduce`` sums a tensor over the group in place (or
    takes its maximum); ``all_gather`` concatenates every rank's tensor
    along a dimension, in group order; ``reduce_scatter`` sums the group's
    tensors and keeps this rank's block of a dimension. Each call is
    counted with its bytes: the tensor for an all-reduce, the gathered
    result for an all-gather, the summed input for a reduce-scatter. A
    group of one rank runs and counts nothing. With ``timed`` set each call
    synchronizes the device around it and adds its wall time to
    ``seconds`` (the collectives' share of a step)."""

    def __init__(self, name: str, ranks: Sequence[int], rank: int, group):
        self.name = name
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.group = group
        self.timed = False
        self.reset_counts()

    def reset_counts(self) -> None:
        self.all_reduces = self.all_reduce_bytes = 0
        self.all_gathers = self.all_gather_bytes = 0
        self.reduce_scatters = self.reduce_scatter_bytes = 0
        self.seconds = 0.0

    def _call(self, fn, x: torch.Tensor):
        if not self.timed:
            return fn()
        cuda = x.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(x.device)
        self.seconds += time.perf_counter() - t0
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.size == 1:
            return x
        self.all_reduces += 1
        self.all_reduce_bytes += x.numel() * x.element_size()
        return self._all_reduce(x, op)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return x
        src = x.movedim(dim, 0).contiguous()
        out_shape = (self.size * src.shape[0],) + tuple(src.shape[1:])
        self.all_gathers += 1
        self.all_gather_bytes += math.prod(out_shape) * x.element_size()
        return self._all_gather(src, out_shape).movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return x
        src = x.movedim(dim, 0).contiguous()
        if src.shape[0] % self.size:
            raise ValueError(f"reduce_scatter over {self.size} ranks: dimension {dim} of "
                             f"{tuple(x.shape)} does not divide")
        out_shape = (src.shape[0] // self.size,) + tuple(src.shape[1:])
        self.reduce_scatters += 1
        self.reduce_scatter_bytes += src.numel() * src.element_size()
        return self._reduce_scatter(src, out_shape).movedim(0, dim)

    # ---- the collectives themselves (a virtual group runs none) -----------
    def _all_reduce(self, x, op):
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self._call(lambda: dist.all_reduce(x, op=red, group=self.group), x)
        return x

    def _all_gather(self, src, out_shape):
        out = src.new_empty(out_shape)
        self._call(lambda: dist.all_gather_into_tensor(out, src, group=self.group), src)
        return out

    def _reduce_scatter(self, src, out_shape):
        out = src.new_empty(out_shape)
        self._call(lambda: dist.reduce_scatter_tensor(out, src, group=self.group), src)
        return out


class VirtualAxisGroup(AxisGroup):
    """An ``AxisGroup`` of a virtual mesh (``make_virtual_mesh``): one
    process stands for one rank of a group of ``size`` and runs no
    collective, returning tensors of the right shape: ``all_reduce`` its
    input, ``all_gather`` ``size`` copies of it concatenated,
    ``reduce_scatter`` this rank's block. Calls and bytes are counted by
    ``AxisGroup``'s own code, so they equal a real group's."""

    def _all_reduce(self, x, op):
        return x

    def _all_gather(self, src, out_shape):
        return torch.cat([src] * self.size, dim=0)

    def _reduce_scatter(self, src, out_shape):
        return src.narrow(0, self.index * out_shape[0], out_shape[0]).clone()


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh. ``shape``: axis name -> size, in axis
    order; ``groups``: this rank's ``AxisGroup`` per axis, and ``batch``
    (the batch axes together) and ``world``."""
    shape: Dict[str, int]
    rank: int
    backend: str
    device: torch.device
    groups: Dict[str, AxisGroup]

    @property
    def data(self) -> AxisGroup:
        return self.groups["data"]

    @property
    def model(self) -> AxisGroup:
        return self.groups["model"]

    @property
    def batch(self) -> AxisGroup:
        return self.groups["batch"]

    @property
    def world(self) -> AxisGroup:
        return self.groups["world"]

    def axis(self, name: str) -> Optional[AxisGroup]:
        """The group along one axis; None where the mesh has no such axis."""
        return self.groups.get(name)

    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        return {name: self.groups[name].index for name in self.shape}

    def barrier(self) -> None:
        """Every rank of the world waits here for the others (a virtual
        mesh's one process has none to wait for)."""
        if self.world.size > 1 and self.backend != "virtual":
            dist.barrier()


# one mesh per shape in this process: its groups were made collectively by
# every rank, as the process group they live in was
_MESHES: Dict[Tuple[Tuple[str, int], ...], Mesh] = {}


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


def _describe(shape: Mapping[str, int]) -> str:
    return ", ".join(f"{k}={v}" for k, v in shape.items())


def make_mesh(shape: Mapping[str, int], *, backend: Optional[str] = None, device=None,
              kind: str = "mesh") -> Mesh:
    """This rank's mesh of axis sizes ``shape`` (axis name -> size; the
    axes a subsequence of ("pod", "data", "model"), in that order) over
    the world of processes.

    ``backend``: "nccl" or "gloo"; None takes the backend of the process
    group the caller initialized, or "nccl" where none is. The world size
    must be the product of the sizes. ``device``: where this rank runs
    (None: ``cuda:{local rank % cards}``). A mesh of the same shape made
    earlier in this process is returned as it is (its device and backend
    must match what is asked). ``kind`` names the mesh in errors."""
    shape = dict(shape)
    names = tuple(shape)
    if names != tuple(a for a in AXES if a in shape):
        raise ValueError(f"mesh axes {names}: a subsequence of {AXES}, in that order")
    if any(n < 1 for n in shape.values()):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    key = tuple(shape.items())
    cached = _MESHES.get(key)
    if cached is not None:
        if backend is not None and backend != cached.backend:
            raise ValueError(f"the mesh runs {cached.backend}, not {backend}")
        if device is not None and normalize_device(device) != cached.device:
            raise ValueError(f"the mesh runs on {cached.device}, not {device}")
        return cached
    need = math.prod(shape.values())
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
        raise ValueError(f"{kind} ({_describe(shape)}) needs {need} ranks but the "
                         f"world has {world}")
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

    made: Dict[tuple, Any] = {}

    def group_of(name, axes):
        """Every rank makes every group, in one order; returns this rank's.
        Groups over the same ranks are made once."""
        mine = None
        for ranks in _members(shape, axes):
            key = tuple(ranks)
            if key not in made:
                made[key] = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = AxisGroup(name, ranks, rank, made[key])
        return mine

    groups = {name: group_of(name, (name,)) for name in names}
    groups["batch"] = group_of("batch", tuple(a for a in BATCH_AXES if a in shape))
    groups["world"] = AxisGroup("world", range(world), rank, dist.group.WORLD)
    mesh = Mesh(shape=shape, rank=rank, backend=backend, device=dev, groups=groups)
    _MESHES[key] = mesh
    return mesh


def _members(shape: Mapping[str, int], axes) -> List[List[int]]:
    """The groups of ranks of a mesh of ``shape`` (rank order row-major over
    its axes) that differ only along ``axes``, each in row-major order over
    those axes; groups in order of their first rank."""
    names = tuple(shape)
    out: Dict[tuple, List[int]] = {}
    for r, c in enumerate(itertools.product(*(range(n) for n in shape.values()))):
        fixed = tuple(v for n, v in zip(names, c) if n not in axes)
        out.setdefault(fixed, []).append(r)
    return list(out.values())


def make_virtual_mesh(shape: Mapping[str, int], rank: int = 0, device="meta") -> Mesh:
    """Rank ``rank``'s view of a mesh of ``shape`` in this one process, with
    no process group: its groups are ``VirtualAxisGroup``s of the sizes and
    members a real mesh's would have, which return tensors of the right
    shape and count each collective as a real group counts it. The dry-run
    (``launch/dryrun.py``) builds rank 0's step over the production mesh so,
    on the meta device (the default; ``cpu`` runs real tensors through
    collectives that move nothing)."""
    shape = dict(shape)
    names = tuple(shape)
    if names != tuple(a for a in AXES if a in shape):
        raise ValueError(f"mesh axes {names}: a subsequence of {AXES}, in that order")
    world = math.prod(shape.values())
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a mesh of {world} ranks")

    def group_of(name, axes):
        return next(VirtualAxisGroup(name, ranks, rank, None)
                    for ranks in _members(shape, axes) if rank in ranks)

    groups = {name: group_of(name, (name,)) for name in names}
    groups["batch"] = group_of("batch", tuple(a for a in BATCH_AXES if a in shape))
    groups["world"] = VirtualAxisGroup("world", range(world), rank, None)
    dev = torch.device(device)
    if dev.type == "cuda":
        raise ValueError("a virtual mesh runs on the meta device or the CPU, never a card")
    return Mesh(shape=shape, rank=rank, backend="virtual", device=dev, groups=groups)


def make_local_mesh(device="cuda") -> Mesh:
    """A mesh of one rank, (data 1, model 1), in this process and with no
    process group: each of its groups holds this rank alone, so it runs
    and counts no collective (``launch/steps.py::build_step`` on one
    process). ``device``: where the rank runs (raises for CUDA where CUDA
    is not available)."""
    shape = {"data": 1, "model": 1}
    groups = {n: AxisGroup(n, (0,), 0, None) for n in (*shape, "batch", "world")}
    return Mesh(shape=shape, rank=0, backend="local", device=normalize_device(device),
                groups=groups)


def make_serving_mesh(data_axis: int = 1, model_axis: int = 1, *,
                      backend: Optional[str] = None, device=None) -> Mesh:
    """This rank's ``(data, model)`` serving mesh (``make_mesh``): rank
    ``d * model + m``; its model group is the tensor-parallel group."""
    return make_mesh({"data": data_axis, "model": model_axis}, backend=backend,
                     device=device, kind="serving mesh")


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *, backend: Optional[str] = None,
                    device=None) -> Mesh:
    """A small ``(data, model)`` mesh for tests and ``launch/train.py --debug``."""
    return make_mesh({"data": n_data, "model": n_model}, backend=backend, device=device,
                     kind="debug mesh")


def production_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh: (data 16, model 16) = 256 ranks, or
    with ``multi_pod`` (pod 2, data 16, model 16) = 512."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, backend: Optional[str] = None,
                         device=None) -> Mesh:
    """The reference's production mesh (``production_shape``); raises with
    the world size it needs when the world is another."""
    return make_mesh(production_shape(multi_pod=multi_pod), backend=backend, device=device,
                     kind="production mesh")


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
