"""ShardedPagedRunner: tensor-parallel paged serving on a (data, model) mesh.

The port of ``repro.core.executor.sharded``. Megatron-style TP applied to
the paged hot paths (survey §IV.C): every attention head — and, where
they divide, every KV head and MLP hidden unit — lives on exactly ONE rank
of the mesh's model group. In the port a rank is a process
(``launch/mesh.py``), and SPMD runs over the whole engine: every rank
builds the same ``LLMEngine`` and receives the same requests, and runs the
scheduler, block manager, prefix cache and sampler of its own engine. The
three paged dispatches (``decode_paged`` / ``extend_paged`` /
``verify_paged``) run a shard-LOCAL copy of the model (``num_heads`` etc.
divided by the model-axis size), so on each rank the compute is the
single-device computation at 1/mp width, every kernel at its shard-local
shapes; the only collectives are one ``all_reduce`` over the model group
per layer after the attention output projection, plus one after the MLP
down-projection when the hidden axis is sharded
(``models/attention.py:proj_out_lora`` / ``models/model.py:mlp_apply``).
After the last one every rank holds the same hidden state, so the same
logits, and takes the same scheduling and sampling decisions. The data
axis replicates the batch: each model group serves all of it.

What this buys the serving engine:

  * KV pages are partitioned BY HEAD over the model axis: each rank's page
    store (``PagedModelState``, built by the engine from the local config)
    and device mirror hold its own KV heads, 1/mp of every block's bytes,
    so KV capacity at a fixed per-device budget scales with the mesh
    (``device_kv_bytes_per_block``). Under the replicated-KV fallback every
    rank holds all of them. The reference's host store is global
    (``jax.device_get`` gathers the sharded writes); a global store per
    rank here would need an all-gather of each step's writes, which the
    reference's device path does not have. Migration still moves global
    pages, as the reference's does: ``LLMEngine.export_seq`` gathers a
    sequence's pages over the model group in one all-gather, and
    ``import_seq`` keeps the rank's contiguous cut, so a sequence moves
    between engines of any layouts (``core/disagg.py``).
  * The LoRA adapter tables shard over the same axis (the B factor of q/k/v
    projections by output column, the A factor of o/down projections by
    input row), so adapter deltas stay shard-local and join the SAME
    all-reduce as the base projection: no extra collective for LoRA.
  * Weights: a sharded engine takes the rank's parameters, never the whole
    tree. ``rank_params`` draws them (``Model.init`` cutting each layer
    as soon as it is drawn), ``shard_params`` cuts them from a whole tree
    (converted weights), ``engine_params`` picks between the tree and
    its cut for an engine's sharding; a rank's device holds its slices and
    the replicated leaves (embedding, head, norms, the biases added after
    an all-reduce), and no gathered runner is built.
  * The speculative runner verifies through this runner's ``verify``; its
    draft is a whole model, replicated on every rank, so a sharded engine
    is given it (``SpeculativeConfig.draft_model`` / ``draft_params``).

Head layout subtleties, decided ONCE at construction (``paged_layout``:
``tp_layout``'s decisions, and the layouts this runner refuses as the
reference's does):

  * ``num_heads % mp != 0`` is an error here — there is no partial-head
    split under the 3D (d, H, hd) param layout (a train or step plan holds
    such heads whole on every rank instead: ``tp_layout``).
  * GQA replicated-KV fallback: when ``num_kv_heads % mp != 0`` the KV
    heads stay replicated. A CONTIGUOUS head split would then break group
    assignment — the local model maps its head ``l`` to KV head
    ``l // (G/mp)`` with G = H/KV, which only matches the global ``h // G``
    if each rank holds one head from every group-chunk. So the q-side
    params (wq, its bias, the LoRA wq-B / wo-A factors) and the wo rows
    are PERMUTED so rank i's block is
    ``[g*G + i*G/mp + t for g in range(KV) for t in range(G/mp)]``; the sum
    over ranks is permutation-invariant, K/V and the pages are untouched.
    When KV divides mp the contiguous split is exact and nothing permutes;
    where (H / mp) % KV != 0 no permutation exists and this runner raises
    (the step and train plans take a contiguous split and ``local_kv``).
  * GLU MLPs under a sharded hidden axis: ``w1`` emits 2*d_ff columns that
    ``mlp_apply`` splits in half — a contiguous column split would hand a
    rank half "up" and half "gate" columns of DIFFERENT units. ``w1``'s
    columns (+ bias + LoRA w1-B) are permuted so each rank's local block
    is ``[u_i ; g_i]``; the activated hidden slice then lands exactly on
    ``w2``'s contiguous row slice.

Which leaf splits where comes from the leaves' logical axes
(``models.model.param_axes``: "heads", "kv_heads", "ff") through
``serving_tp_rules``, never from their shapes.

``StepSharding`` is a rank's plan of ``build_step``'s tensor-parallel
prefill and decode steps: ``tp_layout``'s decisions over every width, the
rank's slices by ``train_slicer`` under the step's rules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, with_tp_whole
from repro_torch.core.executor.paged import PagedRunner
from repro_torch.core.executor.state import PagedModelState
from repro_torch.models.common import is_glu
from repro_torch.models.model import build_model, param_axes
from repro_torch.sharding import ShardingConfig, serving_tp_rules
from repro_torch.sharding.rules import Rules


@dataclasses.dataclass(frozen=True, eq=False)
class TPLayout:
    """What a model axis of ``mp`` ranks does to one model, one decision per
    width (the reference's divisibility rule): a width that does not divide
    the axis is whole on every rank, which then computes that part whole
    with no all-reduce after it. ``heads_cut``: attention, MLA and
    whisper's query heads (and the KV heads where ``kv_sharded``); under
    ``heads_cut`` without ``kv_sharded`` the KV heads are replicated and
    the query heads split in ``head_order`` (permuted, where (H / mp) % KV
    == 0) or contiguously (``kv_contiguous``: each local head reads global
    KV head h // G, ``attention.local_kv``). ``ff_sharded``: the runner's
    MLP hidden units cut. ``whole``: the logical axes held whole ("heads"
    and "kv_heads"; "ff": an MLP's d_ff or the shared experts' units;
    "experts"; "ssm_inner": Mamba's d_inner; "lstm_inner": the xLSTM's
    heads and inner widths together; "vocab"), which ``rules`` forces
    off. ``local_cfg``: the sharded
    paged runner's shard-local config (its KV heads and d_ff divided);
    ``layer_cfg``: the config a layer of the sharded train step or of a
    tensor-parallel prefill / decode step runs with (its query heads
    divided, ``tp_ff_sharded`` and ``tp_whole`` set; the KV heads' count
    global)."""
    mp: int
    kv_sharded: bool
    ff_sharded: bool
    local_cfg: ModelConfig
    head_order: Optional[np.ndarray]
    head_order_blocked: Optional[np.ndarray]  # head order over H * hd columns
    glu_order: Optional[np.ndarray]
    heads_cut: bool = True
    kv_contiguous: bool = False
    whole: Tuple[str, ...] = ()
    layer_cfg: Optional[ModelConfig] = None

    def rules(self, rules: Rules) -> Rules:
        """``rules`` with every axis of ``whole`` mapped to no mesh axis: the
        leaves of a width held whole stay whole even where their own
        dimension would divide (a GLU ``w1``'s 2 f columns, an sLSTM's 4 d
        gate columns)."""
        if not self.whole:
            return rules
        mapping = dict(rules.mapping, **{axis: None for axis in self.whole})
        return Rules(rules.mesh_shape, mapping, rules.options)


def piece_order(width: int, pieces: int, mp: int) -> np.ndarray:
    """The column order of an axis ``width`` wide that holds ``pieces``
    equal pieces side by side, over a model axis of ``mp``: rank i's block
    is its 1/mp of each piece, in piece order, so a split into the pieces
    after it stays local. A contiguous split would give a rank whole pieces
    and another rank the others: XLA's partitioner survives that by moving
    data, shard-local code does not."""
    n = width // pieces
    nl = n // mp
    return np.concatenate([p * n + np.arange(i * nl, (i + 1) * nl)
                           for i in range(mp) for p in range(pieces)])


def glu_order(width: int, mp: int) -> np.ndarray:
    """The column order of a GLU up-projection ``width`` = 2 * f wide over
    a model axis of ``mp``: rank i's block is its units' up columns, then
    their gate columns (``[u_i ; g_i]``), ``piece_order`` of two pieces."""
    return piece_order(width, 2, mp)


def _ff_widths(cfg: ModelConfig):
    """Every hidden width the logical axis "ff" names in this stack: an
    MLP's d_ff, the shared experts' units."""
    specs = cfg.layer_specs()
    out = []
    if any(s.ff == "mlp" for s in specs) or cfg.encoder_layers:
        out.append(cfg.d_ff)
    if any(s.ff == "moe" for s in specs) and cfg.num_shared_experts:
        out.append(cfg.moe_d_ff * cfg.num_shared_experts)
    return out


def tp_layout(cfg: ModelConfig, mp: int) -> TPLayout:
    """The reference's divisibility rule for a model axis of ``mp``, one
    decision per width, with the replicated-KV head order, the GLU order
    and the local configs. Nothing raises here: the sharded paged runner
    refuses the layouts it does not serve (``paged_layout``)."""
    from repro_torch.models.mamba import d_inner_of
    from repro_torch.models.xlstm import mlstm_d_inner

    H, KV, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    specs = cfg.layer_specs()
    mixers = {s.mixer for s in specs}
    heads_cut = mp == 1 or H % mp == 0
    kv_sharded = mp > 1 and heads_cut and KV % mp == 0
    kv_contiguous = mp > 1 and heads_cut and not kv_sharded and (H // mp) % KV != 0
    ff_ok = all(s.ff in ("mlp", "none") for pattern, _ in cfg.stages for s in pattern)
    ff_div = all(w % mp == 0 for w in _ff_widths(cfg))
    lstm_cut = mp == 1 or not mixers & {"mlstm", "slstm"} or (
        H % mp == 0 and (2 * cfg.d_model) % mp == 0
        and ("mlstm" not in mixers or mlstm_d_inner(cfg) % mp == 0))
    experts_cut = mp == 1 or not cfg.num_experts or cfg.num_experts % mp == 0
    ssm_cut = mp == 1 or "mamba" not in mixers or d_inner_of(cfg) % mp == 0
    vocab_cut = mp == 1 or cfg.vocab_size % mp == 0
    whole = []
    if not heads_cut:
        whole += ["heads", "kv_heads"]
    if not ff_div or not lstm_cut:  # an sLSTM's FFN runs with its heads
        whole.append("ff")
    whole += [axis for axis, cut in (("experts", experts_cut), ("ssm_inner", ssm_cut),
                                     ("lstm_inner", lstm_cut), ("vocab", vocab_cut))
              if not cut]
    whole = tuple(whole) if mp > 1 else ()
    ff_cut = "ff" not in whole
    ff_sharded = mp > 1 and ff_cut and ff_ok

    head_order = head_order_blocked = None
    if mp > 1 and heads_cut and not kv_sharded and not kv_contiguous:
        G, Hl = H // KV, H // mp
        Gl = G // mp
        order = np.empty(H, np.int64)
        for i in range(mp):
            for g in range(KV):
                for t in range(Gl):
                    order[i * Hl + g * Gl + t] = g * G + i * Gl + t
        if not np.array_equal(order, np.arange(H)):  # identity for MQA
            head_order = order
            head_order_blocked = (order[:, None] * hd + np.arange(hd)).reshape(-1)
    glu = glu_order(2 * f, mp) if ff_sharded and is_glu(cfg.activation) else None
    local_cfg = layer_cfg = cfg
    if mp > 1:
        Hl = H // mp if heads_cut else H
        local_cfg = dataclasses.replace(
            cfg, num_heads=Hl, num_kv_heads=KV // mp if kv_sharded else KV,
            d_ff=f // mp if ff_sharded else f, tp_axis="model",
            tp_ff_sharded=ff_sharded)
        layer_cfg = with_tp_whole(cfg, whole, num_heads=Hl if lstm_cut else H,
                                  tp_ff_sharded=ff_cut)
    return TPLayout(mp, kv_sharded, ff_sharded, local_cfg, head_order,
                    head_order_blocked, glu, heads_cut=heads_cut,
                    kv_contiguous=kv_contiguous, whole=whole, layer_cfg=layer_cfg)


def paged_layout(cfg: ModelConfig, mp: int) -> TPLayout:
    """``tp_layout`` for the sharded paged runner, which serves the
    layouts the reference's runner serves: every query head cut, and the
    KV heads cut or replicated under the permuted head order (raises
    otherwise, with the reference's messages)."""
    lay = tp_layout(cfg, mp)
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if not lay.heads_cut:
        raise ValueError(
            f"num_heads={H} is not divisible by the model axis ({mp}); "
            "the 3D head-split param layout cannot shard inside a head")
    if lay.kv_contiguous:
        raise ValueError(
            f"replicated-KV fallback needs the GQA group count "
            f"({H // KV}) divisible by the model axis ({mp}): each "
            f"shard's {H // mp} local heads must split evenly over the "
            f"{KV} replicated KV heads")
    return lay


def _take(t: torch.Tensor, order: np.ndarray, dim: int) -> torch.Tensor:
    return torch.index_select(t, dim, torch.from_numpy(order).to(t.device))


def _local(t: torch.Tensor, spec, index: int, size: int) -> torch.Tensor:
    """This rank's block of ``t`` under a partition spec whose sharded
    entries all name the model axis (``serving_tp_rules`` binds nothing
    else)."""
    for dim, part in enumerate(spec):
        if part is None:
            continue
        if part != "model":
            raise ValueError(f"the serving rules shard only over 'model', not {part!r}")
        n = t.shape[dim] // size
        t = t.narrow(dim, index * n, n)
    return t


def rank_slicer(cfg: ModelConfig, mesh):
    """``place(tree, axes)`` for one rank of ``mesh``: the rank's block of
    every leaf of a parameter tree (or of one layer's), split by the leaf's
    logical axes under ``serving_tp_rules`` after the fallback head order
    (along "heads") and the GLU column order (along a 2*d_ff "ff" axis),
    as a tensor of its own on the rank's device; replicated leaves move
    whole."""
    lay = tp_layout(cfg, mesh.model.size)
    rules = serving_tp_rules(mesh.shape, kv_sharded=lay.kv_sharded,
                             ff_sharded=lay.ff_sharded)
    index, size = mesh.model.index, mesh.model.size

    def leaf(t: torch.Tensor, axes) -> torch.Tensor:
        spec = rules.pspec(axes, tuple(t.shape))
        if all(part is None for part in spec):
            return t.to(mesh.device)
        for dim, name in enumerate(axes):
            if name == "heads" and lay.head_order is not None:
                t = _take(t, lay.head_order, dim)
            if (name == "ff" and lay.glu_order is not None
                    and t.shape[dim] == len(lay.glu_order)):
                t = _take(t, lay.glu_order, dim)
        # a copy, never a view: a view would keep the whole leaf alive
        return _local(t, spec, index, size).to(mesh.device).clone()

    def place(tree, axes):
        if isinstance(tree, dict):
            return {k: place(v, axes[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [place(v, a) for v, a in zip(tree, axes, strict=True)]
        return leaf(tree, axes)
    return place


def shard_params(params, cfg: ModelConfig, mesh):
    """The rank's slices of a whole parameter tree (converted weights, a
    checkpoint): what a sharded engine takes."""
    return rank_slicer(cfg, mesh)(params, param_axes(cfg))


def engine_params(model, params, sharding: Optional[ShardingConfig]):
    """The tree an engine at ``sharding`` takes from ``params``: ``params``
    itself where it holds the query heads such an engine serves (the whole
    tree on one device, the rank's slices on a sharded engine), the rank's
    slices cut from it (``shard_params`` on the engine's serving mesh) where
    it is whole and the engine is sharded. Rank slices for an engine of
    another cut raise. A stack without a paged family passes through (a
    sharded engine refuses it)."""
    if model.decode_paged is None:
        return params
    H = model.cfg.num_heads
    sharded = sharding is not None and sharding.num_devices > 1
    want = paged_layout(model.cfg, sharding.model_axis).local_cfg.num_heads if sharded else H
    heads = params["layers"][0]["mixer"]["wq"]["w"].shape[1]
    if heads == want:
        return params
    if heads == H:
        from repro_torch.launch.mesh import make_serving_mesh
        mesh = make_serving_mesh(sharding.data_axis, sharding.model_axis, device=model.device)
        return shard_params(params, model.cfg, mesh)
    raise ValueError(f"the parameters hold {heads} query heads a layer: an engine at "
                     f"model axis {sharding.model_axis if sharded else 1} takes {want} "
                     f"(its rank's slices) or the whole tree's {H}")


def rank_params(model, seed: int = 0, *, mesh, max_seq: int = 0):
    """``model.init(seed)``'s values as the rank's slices, each layer cut as
    soon as it is drawn on the rank's device: the device holds the rank's
    layers, the replicated embedding and head, and at most one whole layer
    on the way."""
    return model.init(seed, max_seq, place=rank_slicer(model.cfg, mesh))


# (logical axis, the leaf's owner) -> pieces side by side on that axis,
# whatever the activation: Mamba's in_proj [x ; z], the mLSTM's up_proj
# [xin ; z], the sLSTM's ffn_up [a ; g] and its wx, gate-major (4, H, dh)
_PIECES = {("ssm_inner", "in_proj"): 2, ("lstm_inner", "up_proj"): 2, ("ff", "ffn_up"): 2,
           ("lstm_inner", "wx"): 4}


def model_order(cfg: ModelConfig, path, axis, width: int, mp: int) -> Optional[np.ndarray]:
    """The order a leaf's ``axis`` (``width`` wide, cut over a model axis of
    ``mp``) takes before the cut, None for a contiguous cut: the
    replicated-KV fallback's head order on "heads"; ``piece_order`` on an
    axis of pieces side by side (a GLU up-projection's "ff": an MLP's
    ``w1``, a MoE's ``shared_w1``, weight or bias; the fused projections of
    ``_PIECES``) where each piece splits over the ranks. Where a piece does
    not split (the sLSTM's ffn_up at 2 x 341 columns on 2 ranks, with
    ffn_down's 341 rows whole) the cut stays contiguous and the model code
    gathers the leaf where it uses it (``models/xlstm.py``)."""
    if axis == "heads":
        return tp_layout(cfg, mp).head_order
    owner = path[-2] if len(path) > 1 else None
    if axis == "ff" and owner in ("w1", "shared_w1"):
        pieces = 2 if is_glu(cfg.activation) else 1
    else:
        pieces = _PIECES.get((axis, owner), 1)
    if pieces > 1 and (width // pieces) % mp == 0:
        return piece_order(width, pieces, mp)
    return None


def rank_block(t: torch.Tensor, dim: int, parts, shape, coords) -> torch.Tensor:
    """The rank's block of ``t`` along ``dim`` cut over the mesh axes
    ``parts``: the block of its row-major index over them (a view)."""
    index, size = 0, 1
    for a in parts:
        index, size = index * shape[a] + coords[a], size * shape[a]
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def train_slicer(cfg: ModelConfig, mesh, rules, device=None):
    """``place(tree, axes)`` for one rank of a training mesh: the rank's
    block of every leaf, cut by ``rules.pspec`` of the leaf's logical axes
    (``mode_rules(mesh.shape, "train", ...)``: "embed" over data, heads,
    KV heads, ff, vocab, experts and the state mixers' inner widths over
    model), as a tensor of its own on the rank's device. Along a dimension
    cut over model the leaf first takes ``model_order``: the
    replicated-KV fallback's head order on "heads", and on an axis of
    pieces side by side (a GLU up-projection, Mamba's ``in_proj``, the
    mLSTM's ``up_proj``, the sLSTM's ``ffn_up`` and ``wx``) the order that
    gives each rank its share of every piece. A dimension cut over several
    axes takes the block of the rank's row-major index over them.
    ``device``: where the slices go (the mesh's device by default)."""
    mp = mesh.shape.get("model", 1)
    device = mesh.device if device is None else device
    coords = mesh.coords()

    def leaf(t: torch.Tensor, axes, path) -> torch.Tensor:
        spec = rules.pspec(axes, tuple(t.shape))
        if all(part is None for part in spec):
            return t.to(device)
        for dim, (name, part) in enumerate(zip(axes, spec)):
            if part is None:
                continue
            parts = (part,) if isinstance(part, str) else tuple(part)
            if "model" in parts and mp > 1:
                order = model_order(cfg, path, name, t.shape[dim], mp)
                if order is not None:
                    t = _take(t, order, dim)
            t = rank_block(t, dim, parts, mesh.shape, coords)
        # a copy, never a view: a view would keep the whole leaf alive
        return t.to(device).clone()

    def place(tree, axes, path=()):
        if isinstance(tree, dict):
            return {k: place(v, axes[k], path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [place(v, a, path + (str(i),))
                    for i, (v, a) in enumerate(zip(tree, axes, strict=True))]
        return leaf(tree, axes, path)
    return place


def train_params(model, seed: int = 0, *, mesh, rules, max_seq: int = 0, device=None):
    """``model.init(seed)``'s values as the rank's training slices
    (``train_slicer``): each layer cut as soon as it is drawn, then the
    embedding, head, norms, encoder and MTP block, so the rank's device
    holds its slices and at most one whole layer or leaf on the way."""
    place = train_slicer(model.cfg, mesh, rules, device)
    params = model.init(seed, max_seq, place=place)
    axes = param_axes(model.cfg)
    return {k: v if k == "layers" else place(v, axes[k]) for k, v in params.items()}


class ShardedPagedRunner(PagedRunner):
    name = "sharded"

    def __init__(self, model, params, engine_cfg, store: PagedModelState, *, mesh=None):
        from repro_torch.launch.mesh import make_serving_mesh, normalize_device

        sh = engine_cfg.sharding or ShardingConfig()
        self.layout = paged_layout(model.cfg, sh.model_axis)
        lay = self.layout
        want_kv = lay.local_cfg.num_kv_heads
        if any(s.shape[0] != want_kv for s in store.stores):
            raise ValueError(f"the page store holds {store.stores[0].shape[0]} KV heads "
                             f"per rank, the model axis gives each rank {want_kv}: "
                             "build it from tp_layout(...).local_cfg")
        if lay.mp > 1:
            heads = {layer["mixer"]["wq"]["w"].shape[1] for layer in params["layers"]}
            if heads != {lay.local_cfg.num_heads}:
                raise ValueError(f"the parameters hold {sorted(heads)} query heads a layer, "
                                 f"a rank serves {lay.local_cfg.num_heads}: pass the rank's "
                                 "slices (rank_params, or shard_params of a whole tree)")
        super().__init__(model, params, engine_cfg, store)
        if mesh is None:
            mesh = make_serving_mesh(sh.data_axis, sh.model_axis, device=model.device)
        if mesh.device != normalize_device(model.device):
            raise ValueError(f"rank {mesh.rank} serves on {mesh.device} but the model "
                             f"lives on {model.device}: build it on the rank's device")
        self.mesh = mesh
        self.mp = lay.mp
        self.kv_sharded, self.ff_sharded = lay.kv_sharded, lay.ff_sharded
        self._lora_cache = None
        if lay.mp > 1:
            # self.model stays the GLOBAL model (the draft comparison, the
            # host-side shapes); the paged calls run the shard-local one
            self.local_model = build_model(lay.local_cfg, device=mesh.device)
            self.tp = mesh.model
        self._build_kernels()

    def _build_kernels(self) -> None:
        """On the card, rank 0 builds the paged path's kernel libraries while
        the other ranks wait, so no two ``nvcc`` race over one library in a
        first serve; every rank then loads the built files."""
        if self.device.type != "cuda":
            return
        if self.mesh.rank == 0:
            from repro_torch.kernels import _build
            from repro_torch.kernels.kv_quant import kv_quant
            from repro_torch.kernels.lora import bgmv
            from repro_torch.kernels.paged_attention import (paged_attention,
                                                            paged_attention_quant)
            _build.build_many([paged_attention.SOURCE, paged_attention_quant.SOURCE,
                               kv_quant.SOURCE, bgmv.SOURCE])
        self.mesh.barrier()

    # ---- LoRA tables -------------------------------------------------
    def _lora_dim(self, site: str, letter: str) -> Optional[int]:
        """The dimension of a (T, Din, r) A or (T, r, Dout) B table that
        shards: B by output column for wq, wk / wv (KV sharded) and w1 (ff
        sharded); A by input row for wo and w2 (ff sharded)."""
        if letter == "b" and (site == "wq" or (site in ("wk", "wv") and self.kv_sharded)
                              or (site == "w1" and self.ff_sharded)):
            return 2
        if letter == "a" and (site == "wo" or (site == "w2" and self.ff_sharded)):
            return 1
        return None

    def _fix_lora(self, layers):
        """This rank's slices of the adapter tables: the fallback's head order
        on wq-B's columns and wo-A's rows, the GLU order on w1-B's columns,
        then the shard of each sharded factor. The store's tables are
        rewritten in place and take a new list identity on every fault-in,
        so the placed copy is cached by that identity."""
        if self._lora_cache is not None and self._lora_cache[0] is layers:
            return self._lora_cache[1]
        lay = self.layout

        def place(site, letter, t):
            if lay.head_order_blocked is not None:
                if site == "wq" and letter == "b":
                    t = _take(t, lay.head_order_blocked, 2)
                if site == "wo" and letter == "a":
                    t = _take(t, lay.head_order_blocked, 1)
            if lay.glu_order is not None and site == "w1" and letter == "b":
                t = _take(t, lay.glu_order, 2)
            dim = self._lora_dim(site, letter)
            if dim is not None:
                n = t.shape[dim] // self.tp.size
                t = t.narrow(dim, self.tp.index * n, n).contiguous()
            return t

        placed = [{site: {letter: place(site, letter, t) for letter, t in ab.items()}
                   for site, ab in layer.items()} for layer in layers]
        self._lora_cache = (layers, placed)
        return placed

    def _lora_arg(self, batch_lora: Optional[dict], pad_rows: int = 0):
        lora = super()._lora_arg(batch_lora, pad_rows)
        if lora is None or self.mp == 1:
            return lora
        return {"ids": lora["ids"], "layers": self._fix_lora(lora["layers"])}


class StepSharding:
    """One rank's plan of a tensor-parallel prefill or decode step
    (``launch/steps.py``) on ``mesh`` under ``rules`` (``mode_rules`` of
    the step's kind, with its overrides): ``tp_layout``'s decisions force
    the rules (``layout.rules``), the rank's parameters are its slices under
    them (``params``, ``shard``: ``train_slicer``, orders included), and
    the model reads ``tp`` (the model group), ``layer_cfg``, ``vocab_tp``
    (the model group where the vocab is cut: the rank's block of the
    logits), ``batch`` (the group the batch rows are cut over, for a MoE's
    global capacity; None where every rank holds every row) and ``ep_data``
    (the data group where the rules put the experts over (data, model)).
    No leaf is cut over data otherwise, so ``gather`` is the identity."""

    def __init__(self, cfg: ModelConfig, mesh, rules: Rules, global_batch: int,
                 max_seq: int = 0):
        from repro_torch.launch.mesh import BATCH_AXES

        self.cfg, self.mesh = cfg, mesh
        mp = mesh.shape.get("model", 1)
        self.tp = mesh.model if mp > 1 else None
        self.layout = tp_layout(cfg, mp)
        self.rules = self.layout.rules(rules)
        self.layer_cfg = self.layout.layer_cfg
        self.axes = param_axes(cfg)

        def specs(shape, axes):
            if isinstance(shape, dict):
                return {k: specs(shape[k], axes[k]) for k in shape}
            if isinstance(shape, list):
                return [specs(a, b) for a, b in zip(shape, axes, strict=True)]
            return self.rules.pspec(axes, shape)
        from repro_torch.models.model import param_shapes
        self.specs = specs(param_shapes(cfg, max_seq), self.axes)
        self.vocab_tp = self.tp if self.specs["embed"][0] == "model" else None
        exp = self.rules.pspec(("experts",), (cfg.num_experts,))[0] if cfg.num_experts \
            else None
        exp = () if exp is None else ((exp,) if isinstance(exp, str) else tuple(exp))
        self.ep_data = mesh.axis("data") if "data" in exp else None
        cut = self.rules.pspec(("batch",), (global_batch,))[0]
        cut = () if cut is None else ((cut,) if isinstance(cut, str) else tuple(cut))
        present = tuple(a for a in BATCH_AXES if mesh.shape.get(a, 1) > 1)
        cut = tuple(a for a in cut if mesh.shape.get(a, 1) > 1)
        if self.ep_data is not None or not cut:
            self.batch = None
        elif set(cut) == set(present):
            self.batch = mesh.batch
        elif len(cut) == 1:
            self.batch = mesh.axis(cut[0])
        else:
            raise NotImplementedError(f"batch rows over {cut}: a group over part of the "
                                      "batch axes")

    def gather(self, tree, specs):
        return tree

    def params(self, model, seed: int = 0, max_seq: int = 0, device=None):
        """``model.init(seed)``'s values as the rank's slices, each layer cut
        as soon as it is drawn (``train_params`` under the step's rules)."""
        return train_params(model, seed, mesh=self.mesh, rules=self.rules, max_seq=max_seq,
                            device=device)

    def shard(self, params, device=None):
        """The rank's slices of a whole tree (converted weights)."""
        return train_slicer(self.cfg, self.mesh, self.rules, device)(params, self.axes)
