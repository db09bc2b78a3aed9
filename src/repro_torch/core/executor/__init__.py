"""Execution backends of the port's serving engine.

``make_runners`` wires them for a model/config pair, as the reference's
``repro.core.executor.make_runners`` does:
  * ``GatheredRunner`` always exists: the parity reference, and the only
    backend for stacks without a paged family (sliding-window and chunked
    attention, MLA, state mixers: no paged runner is built for a store
    with a state leaf) and for ``kv_quant`` configs the quantized page
    layout cannot hold (a GEAR residual, non-KIVI axes);
  * ``PagedRunner`` exists when the stack is pure global attention (the
    model has ``decode_paged``, the store holds attention K/V only), the
    store can hold ``kv_quant`` (None, or KIVI pages: ``store.quantized``)
    and ``execution_backend`` is "auto", "paged" or "speculative"; the
    engine then runs every step on it.
  * ``SpeculativeRunner`` layers draft–verify decode on top of the paged
    runner; the engine builds it itself (it needs the draft model).
"""
from repro_torch.core.executor.base import (ExecBatch, ModelRunner,  # noqa: F401
                                            marshal_batch)
from repro_torch.core.executor.gathered import GatheredRunner  # noqa: F401
from repro_torch.core.executor.paged import PagedRunner  # noqa: F401
from repro_torch.core.executor.speculative import SpeculativeRunner  # noqa: F401
from repro_torch.core.executor.state import PagedModelState  # noqa: F401


def make_runners(model, params, engine_cfg, store):
    """Returns (gathered, paged_or_None) per ``engine_cfg.execution_backend``:
    "auto" | "gathered" | "paged" | "speculative". "speculative" builds the
    paged runner its speculative runner layers on; "paged" or "speculative"
    where no paged runner is eligible raises."""
    backend = engine_cfg.execution_backend
    if backend not in ("auto", "gathered", "paged", "speculative"):
        raise ValueError(f"unknown execution_backend: {backend!r}")
    gathered = GatheredRunner(model, params, engine_cfg, store)
    paged = None
    eligible = (model.decode_paged is not None and store.attn_kv_leaves()
                and not store.state_leaves
                and (engine_cfg.kv_quant is None or store.quantized))
    if backend != "gathered" and eligible:
        paged = PagedRunner(model, params, engine_cfg, store)
    if backend in ("paged", "speculative") and paged is None:
        raise ValueError(
            f"execution_backend={backend!r} but {model.cfg.name} has no paged "
            "decode path (needs a pure global-attention stack; kv_quant "
            "additionally needs the KIVI axes — keys per channel, values per "
            "token — and no GEAR residual)")
    return gathered, paged
