"""A per-op cost counter over a step run once: the port's twin of
``repro.launch.hlo_cost``.

The reference lowers a step to post-SPMD HLO and walks its text
(``analyze_hlo``): dots and convolutions for flops, the other arithmetic
for elementwise work and transcendentals, operand + result bytes per
instruction, while bodies multiplied by their trip counts. Here a rank's
step runs once, usually on the meta device (``launch/dryrun.py``), under
``OpCost``, a ``TorchDispatchMode`` that sees every aten op the step
issues and counts, per op:

* ``flops``: the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, the attention ops) by ``torch.utils.flop_counter``'s
  formulas (2 flops a multiply-add), and a registered kernel's own
  formula (``flash_prefill``: ``kernels/flash_attention/ops.py``);
* ``eltwise``: elements of every other arithmetic op (a reduction counts
  its input's elements);
* ``transcendentals``: elements of exp, log, tanh, sigmoid, rsqrt and the
  like (each also counted under ``eltwise``);
* ``bytes``: operand bytes plus result bytes of every op that is not a
  view, unfused: HloCostAnalysis's convention. A scatter into a buffer
  (``index_put_``, ``index_copy_``, ``index_add_``, a ``copy_`` into a
  slice) counts twice its update plus its indices, a gather twice its
  result plus its indices (the reference's dynamic-(update-)slice rule).
  Fusion on the card reads fewer: an elementwise chain fused into one
  kernel reads its inputs once, so ``bytes`` is an upper bound of the
  card's traffic.

``peak_bytes`` is the peak of the bytes of live storages made inside the
mode: each storage an op makes is held by a ``weakref.finalize`` on every
tensor that views it, and autograd's saved tensors are kept as Python
tensors while the graph holds them (``saved_tensors_hooks``), so a view or
a saved tensor counts once per storage, as long as it lives. The twin of
``memory_analysis().temp_size_in_bytes``. Arguments made before the mode
(parameters, cache) are not counted there.

Loops: the state mixers' time loops (``models/common.py::time_loop``) run
one step under the counter, their counts multiplied by the trip count
(``scale``), so a 32 768-position scan costs one step's dispatches; the
trip counts are known, so ``unknown_loops`` is 0. Collectives are counted
by the mesh's groups (``launch/mesh.py``: a virtual mesh counts calls and
bytes as a real one does), not here.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention.ops import flash_prefill_cost
from repro_torch.models.common import counted_loops

TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "rsqrt",
                  "sqrt", "pow", "erf", "erfinv", "sin", "cos", "silu", "gelu",
                  "log_sigmoid_forward", "softplus", "_softmax", "_log_softmax", "reciprocal"}
ELTWISE = {"add", "sub", "mul", "div", "maximum", "minimum", "neg", "abs", "where", "clamp",
           "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
           "logical_or", "logical_not", "bitwise_and", "bitwise_or", "floor_divide",
           "remainder", "fmod", "sign", "floor", "ceil", "round", "rsub", "addcmul",
           "addcdiv", "lerp", "masked_fill", "relu", "threshold_backward", "sigmoid_backward",
           "tanh_backward", "silu_backward", "gelu_backward", "log_sigmoid_backward",
           "_softmax_backward_data", "native_layer_norm", "native_layer_norm_backward"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "cumsum", "cummax", "prod",
              "var_mean", "var", "argmax", "argmin", "norm", "linalg_vector_norm", "sort",
              "topk", "searchsorted", "bincount"}
# scatters into a buffer: (the update's argument index, the indices' index)
SCATTERS = {"index_put_": (2, 1), "index_put": (2, 1), "index_copy_": (3, 2),
            "index_copy": (3, 2), "index_add_": (3, 2), "index_add": (3, 2),
            "scatter_": (3, 2), "scatter": (3, 2), "scatter_add_": (3, 2),
            "scatter_add": (3, 2)}
GATHERS = {"index_select": 2, "gather": 2, "index": 1, "embedding": 1}
FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
        "lift_fresh", "_local_scalar_dense", "set_", "resize_", "_to_copy_meta"}

# kernels registered with a cost of their own: op -> cost(args, out) dict
KERNEL_COSTS = {
    "repro_torch::flash_prefill": lambda args, out: flash_prefill_cost(
        args[0], args[1], args[2], out, int(args[4]) if len(args) > 4 else 0),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCost(TorchDispatchMode):
    """Counts every op dispatched while it is active (see the module
    docstring): ``flops``, ``eltwise``, ``transcendentals``, ``bytes``,
    ``peak_bytes``, and ``calls`` by op (loops multiplied out, as the
    flops are). ``scale(n)``
    multiplies the counts inside it by n; entering the counter also makes
    ``time_loop`` run one step under it (``counted_loops``), unless
    ``fold_loops`` is False (every step runs: the same counts, slower)."""

    def __init__(self, fold_loops: bool = True):
        super().__init__()
        self.fold_loops = fold_loops
        self.flops = self.eltwise = self.transcendentals = self.bytes = 0.0
        self.calls: Counter = Counter()
        self.dispatches = 0  # ops this process ran, loops folded or not
        self.live = self.peak_bytes = 0
        self._mult = 1
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self._stack = contextlib.ExitStack()

    @contextlib.contextmanager
    def scale(self, n: int):
        prev, self._mult = self._mult, self._mult * n
        try:
            yield
        finally:
            self._mult = prev

    def __enter__(self):
        self._stack.enter_context(counted_loops(self.scale if self.fold_loops else None))
        # a saved tensor stays a live Python tensor while the graph holds it
        self._stack.enter_context(torch.autograd.graph.saved_tensors_hooks(
            lambda t: t, lambda t: t))
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    def totals(self) -> Dict[str, float]:
        return {"flops": self.flops, "eltwise": self.eltwise,
                "transcendentals": self.transcendentals, "bytes": self.bytes,
                "peak_bytes": float(self.peak_bytes)}

    # ---- live storages -------------------------------------------------
    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._size.pop(key)

    def _track(self, func, args, out) -> None:
        inputs = {_key(t) for t in _tensors(args)}
        for t in _tensors(out):
            key = _key(t)
            if key not in self._refs:
                if func.is_view or key in inputs:
                    continue  # a view or an in-place result of an argument
                self._refs[key] = 0
                self._size[key] = t.untyped_storage().nbytes()
                self.live += self._size[key]
                self.peak_bytes = max(self.peak_bytes, self.live)
            self._refs[key] += 1
            weakref.finalize(t, self._release, key)

    # ---- counts ---------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        qual = func.name().split(".")[0]
        m = self._mult
        self.calls[name] += m
        if qual in KERNEL_COSTS:
            c = KERNEL_COSTS[qual](args, out)
            self.flops += m * c["flops"]
            self.eltwise += m * c["eltwise"]
            self.transcendentals += m * c["transcendentals"]
            self.bytes += m * c["bytes"]
            return
        if func.is_view or name in FREE:
            return
        if packet in flop_registry:
            self.flops += m * flop_registry[packet](*args, **kwargs, out_val=out)
        base = name.rstrip("_")
        elems = sum(t.numel() for t in _tensors(out))
        if base in TRANSCENDENTAL:
            self.transcendentals += m * elems
            self.eltwise += m * elems
        elif base in ELTWISE:
            self.eltwise += m * elems
        elif base in REDUCTIONS:
            self.eltwise += m * max((t.numel() for t in _tensors(args)), default=0)
        if name in SCATTERS:
            upd, idx = SCATTERS[name]
            self.bytes += m * (2 * _nbytes(args[upd] if len(args) > upd else None)
                               + _nbytes(args[idx] if len(args) > idx else None))
        elif name in GATHERS:
            idx = GATHERS[name]
            self.bytes += m * (2 * _nbytes(out) + _nbytes(args[idx] if len(args) > idx
                                                          else None))
        elif name == "copy_":
            self.bytes += m * 2 * _nbytes(args[1])
        else:
            self.bytes += m * (sum(_nbytes(t) for t in _tensors(args)) + _nbytes(
                _tensors(out)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.dispatches += 1
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        self._track(func, args, out)
        return out
