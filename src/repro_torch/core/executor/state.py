"""Host-authoritative page stores backing the serving engine.

The port of ``repro.core.executor.state``. ``PagedModelState`` owns one
CPU tensor per (layer, cache leaf) in the leaf's dtype (numpy has no
bfloat16). The leaves come from the model
(``models.model.cache_leaf_shapes``). Page leaves have a shape per token:
an attention layer's ``k`` and ``v`` (KV, D), an MLA layer's latent
``c_kv`` (kv_lora_rank) and roped key ``k_pe`` (qk_rope_head_dim). Every
page store is (heads, NB, P, width) with the block on axis 1: (KV, NB, P,
D), the paged-attention kernel's layout, so a device mirror syncs blocks
with one ``index_copy_`` per leaf and no transpose; an MLA leaf is (1, NB,
P, width).

State leaves (a Mamba, mLSTM or sLSTM layer's fixed-size state per
sequence) live apart from the pages, in ``state_stores``: one
(num_state_slots,) + leaf shape tensor per leaf, in its own dtype (a conv
window in the activation dtype, the recurrences' states in f32), indexed
by the state slot the block manager hands a sequence. ``gather`` /
``scatter`` read and write whole slots and charge their bytes to
``host_copy_bytes`` on both sides, as the reference does;
``state_payload`` / ``restore_state`` move a slot between engines.
``reset_state`` writes a slot's empty history (the model's
``init_state``: zeros, ``m = -1e30`` for the xLSTM stabilizers), which the
engine does whenever it hands a slot out; the reference never does, so a
recycled slot there starts from its previous owner's final state (ROADMAP
C). Page-only bookkeeping (the KIVI layout's eligibility,
``repeat_groups``, bytes per block) sees page leaves only.

``block_payload`` / ``restore_block`` move one block's pages as the store
holds them (the prefix cache's host tier, rank-local); migration moves
the model's global pages, which a store whose KV heads are cut over a
model group assembles with ``gather_payloads`` (one all-gather of every
page of a sequence, packed as bytes per head). ``page_bytes`` counts a
payload as the reference counts it.

The paged path reads pages on the device through block tables and writes
each chunk's own K/V back here (O(tokens), ``write_token_group``), which
keeps this store authoritative for copy-on-write, prefix-cache payloads and
host-tier restores. Engine-side mutations (CoW copies, restores) bump
``version`` and record the block ids in ``dirty_blocks`` so the runner's
device mirror re-syncs just those blocks.

The gathered backend (``GatheredRunner``) reads whole windows instead:
``gather`` copies each row's pages into a dense (B, W) + per-token shape
window per leaf and ``scatter`` writes back only the positions a step
wrote. ``host_copy_bytes`` counts that staging as the reference does (the
window per gather, the written payload per scatter); the paged path keeps
it at 0.

KIVI quantization at rest (``EngineConfig.kv_quant`` with the KIVI axes and
no GEAR residual, on a store of attention K/V only: ``quantized``): each
leaf holds uint8 codes, with f16 scale/zero planes in ``qplanes`` — (KV,
NB, 1, D) for keys (grouped per channel), (KV, NB, P, 1) for values (per
token). A page packs exactly ONCE, when its last slot is written, through
``kernels/kv_quant``'s pack on the engine's device (the CUDA kernel on the
card), from complete group statistics. Until then its tokens live
full-precision in the staging store ``qstage`` and reach attention through
the quantized kernel's fp tail (``PagedRunner.call_pages``) or the gathered
window's overlay (``gather_quantized``). ``block_quantized`` says which side
of that line each block is on. Only fills dirty the device mirror.

Any other ``kv_quant`` (MLA latents, a GEAR ``residual_rank``, non-KIVI
axes) keeps fp stores, serves on the gathered backend only, and takes the
reference's quantize–dequantize round trip in ``scatter``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.kv_quant import QuantConfig, dequantize, quantize
from repro_torch.kernels.kv_quant import quantize_kv_pages
from repro_torch.models.model import DTYPES, cache_leaf_shapes, init_state


def page_tensors(page: list) -> List[torch.Tensor]:
    """The tensors of one ``block_payload``, in its order: each fp page, or
    each KIVI leaf's codes, planes and staging page (not the packed flag)."""
    return [t for entry in page if not isinstance(entry, bool)
            for t in (entry if isinstance(entry, tuple) else (entry,))]


def map_page(page: list, fn) -> list:
    """``page`` (a ``block_payload``) with ``fn`` applied to each of its
    tensors, its structure and packed flag kept."""
    return [entry if isinstance(entry, bool) else
            tuple(fn(t) for t in entry) if isinstance(entry, tuple) else fn(entry)
            for entry in page]


def page_bytes(page: list) -> int:
    """Bytes of one ``block_payload``: what migrating or restoring it moves."""
    return sum(t.numel() * t.element_size() for t in page_tensors(page))


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — the bucketing rule for ragged extend
    batches and marshalled table widths."""
    p = 1
    while p < n:
        p *= 2
    return p


class PagedModelState:
    """Per-layer page stores of the model's cache leaves, host side.
    ``device`` is where page packs run (the engine's device)."""

    def __init__(self, model_cfg, engine_cfg, device):
        self.cfg = engine_cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[model_cfg.dtype]
        NB, P = engine_cfg.num_blocks, engine_cfg.block_size
        self.num_layers = model_cfg.num_layers
        self._leaves: List[Tuple[int, str, int]] = []
        self.shapes: List[tuple] = []  # each page store's per-token shape
        self.stores: List[torch.Tensor] = []
        # state leaves: (layer, name), their slot stores and empty histories
        self.state_leaves: List[Tuple[int, str]] = []
        self.state_stores: List[torch.Tensor] = []
        self._state_init: List[torch.Tensor] = []
        index: Dict[Tuple[int, str], int] = {}
        specs = model_cfg.layer_specs()
        for layer, leaves in enumerate(cache_leaf_shapes(model_cfg)):
            for name, leaf in leaves.items():
                if leaf.state:
                    self.state_leaves.append((layer, name))
                    self.state_stores.append(torch.zeros(
                        (engine_cfg.num_state_slots,) + leaf.shape, dtype=leaf.dtype))
                    self._state_init.append(
                        init_state(model_cfg, specs[layer], 1, "cpu")[name][0])
                    continue
                shape = leaf.shape
                heads, width = shape if len(shape) == 2 else (1,) + shape
                index[layer, name] = len(self.stores)
                self._leaves.append((layer, name, len(self.stores)))
                self.shapes.append(shape)
                self.stores.append(torch.zeros((heads, NB, P, width), dtype=self.dtype))
        # the reference stacks a stage's repeats along a leading axis of one
        # leaf, so its round-trip statistics pool them: the stores of one
        # stage's pattern slot over its repeats, in models/convert.py's order
        self.repeat_groups: List[List[int]] = []
        offset = 0
        for pattern, reps in model_cfg.stages:
            for i in range(len(pattern)):
                for layer, name in [k for k in index if k[0] == offset + i]:
                    self.repeat_groups.append(
                        [index[offset + r * len(pattern) + i, name] for r in range(reps)])
            offset += len(pattern) * reps
        self.host_copy_bytes = 0
        # quantized stores: the pack's round trip — staging pages in their
        # own dtype to the pack's device, codes and f16 planes back
        self.pack_transfer_bytes = 0
        self.version = 0
        self.dirty_blocks: Set[int] = set()
        # KIVI pages: codes replace the fp stores, planes ride in qplanes,
        # fp staging in qstage, all in kernel layout (KV, NB, P, D)
        self.quant: Optional[QuantConfig] = engine_cfg.kv_quant
        self.qaxis: Dict[int, str] = {}
        self.qplanes: Dict[int, Dict[str, torch.Tensor]] = {}
        self.qstage: Dict[int, torch.Tensor] = {}
        self.qdtype: Dict[int, torch.dtype] = {}
        self.quantized = bool(
            self.quant is not None and self.quant.residual_rank == 0
            and self.quant.key_axis == "channel"
            and self.quant.value_axis == "token"
            and self.attn_kv_leaves())
        # block -> "codes+planes are current" (page filled and packed); a
        # False block's live tokens are served from the fp staging store
        self.block_quantized = np.zeros(NB, bool)
        if self.quantized:
            for _, name, idx in self._leaves:
                KV, _, _, D = self.stores[idx].shape
                axis = "channel" if name == "k" else "token"
                pshape = (KV, NB, 1, D) if axis == "channel" else (KV, NB, P, 1)
                self.qaxis[idx] = axis
                self.qdtype[idx] = self.dtype
                self.qstage[idx] = self.stores[idx]
                self.stores[idx] = torch.zeros_like(self.stores[idx], dtype=torch.uint8)
                self.qplanes[idx] = {"scale": torch.zeros(pshape, dtype=torch.float16),
                                     "zero": torch.zeros(pshape, dtype=torch.float16)}

    def _touch(self, blocks) -> None:
        self.version += 1
        self.dirty_blocks.update(int(b) for b in blocks)

    def attn_kv_leaves(self) -> List[Tuple[int, str, int]]:
        """(layer, "k"/"v", leaf index) for every page store — or [] as soon
        as one store is not an attention k/v (MLA latents), as the
        reference's does: the paged path cannot parse such a cache. State
        leaves are not page stores and do not count: a Jamba store's
        attention pages are KIVI-eligible, as in the reference."""
        if any(name not in ("k", "v") for _, name, _ in self._leaves):
            return []
        return list(self._leaves)

    # ------------------------------------------------------------------
    # quantized-page primitives
    # ------------------------------------------------------------------
    def _requant_group(self, items: List[Tuple[int, torch.Tensor, torch.Tensor]]
                       ) -> None:
        """Pack whole pages into the store through ``quantize_kv_pages`` on
        the engine's device. ``items``: (leaf idx, blocks (n,), fp pages
        (KV, n, P, D)). Leaves sharing a grouping axis and page shape
        CONCATENATE into one pack call: on a decode step, one call for every
        layer's K pages and one for every V. The pages go to the device in
        the staging dtype (the pack upcasts them in registers), codes and the
        f16 planes the pack writes come back: the same bytes as packing the
        f32 pages and casting the planes."""
        by_key: Dict[Tuple, List] = {}
        for idx, blocks, pages in items:
            KV, n, P, D = pages.shape
            by_key.setdefault((self.qaxis[idx], P, D), []).append((idx, blocks, pages))
        for (axis, P, D), group in by_key.items():
            # (KV, n, P, D) -> (n, KV, P, D) -> one (P, D) page per (block, head)
            mats = [pages.transpose(0, 1).reshape(-1, P, D) for _, _, pages in group]
            x = torch.cat(mats) if len(mats) > 1 else mats[0]
            codes, scale, zero = (t.cpu() for t in quantize_kv_pages(
                x.to(self.device), bits=self.quant.bits, axis=axis,
                plane_dtype=torch.float16))
            self.pack_transfer_bytes += sum(t.numel() * t.element_size()
                                            for t in (x, codes, scale, zero))
            at = 0
            for idx, blocks, pages in group:
                KV, n = pages.shape[:2]
                sz = KV * n
                self.stores[idx][:, blocks] = codes[at: at + sz].reshape(
                    n, KV, P, D).transpose(0, 1)
                for pname, plane in (("scale", scale), ("zero", zero)):
                    self.qplanes[idx][pname][:, blocks] = plane[at: at + sz].reshape(
                        (n, KV) + plane.shape[1:]).transpose(0, 1)
                at += sz

    def _quant_write_group(self, idxs: List[int], blocks: torch.Tensor,
                           offsets: torch.Tensor,
                           payloads: List[torch.Tensor]) -> None:
        """Place token values (``payloads[j]``: (n, KV, D) for leaf
        ``idxs[j]``) into the fp staging stores, then pack every page whose
        LAST slot was just written. A page packs exactly once, from a
        complete staging page, so how writes are batched cannot change the
        packed bytes. Writes to partially filled pages touch only host
        staging: no pack, no mirror dirtying."""
        for idx, payload in zip(idxs, payloads):
            self.qstage[idx][:, blocks, offsets] = payload.transpose(0, 1).to(
                self.qdtype[idx])
        blk = blocks.numpy()
        # any write re-opens the page; a fill below packs it again
        self.block_quantized[np.unique(blk)] = False
        filled = np.unique(blk[offsets.numpy() == self.cfg.block_size - 1])
        if len(filled):
            fb = torch.from_numpy(filled)
            self._requant_group([(idx, fb, self.qstage[idx][:, fb]) for idx in idxs])
            self.block_quantized[filled] = True
            self._touch(filled)

    # ------------------------------------------------------------------
    # gathered backend: dense cache windows
    # ------------------------------------------------------------------
    def gather_state(self, slots: Optional[np.ndarray]) -> List[Dict[str, torch.Tensor]]:
        """slots: (B,) state slots, or None. Returns, per layer, each state
        leaf's (B,) + leaf shape host copy of those slots (empty dicts for
        page layers, and everywhere without slots), charged to
        ``host_copy_bytes``."""
        out: List[Dict[str, torch.Tensor]] = [{} for _ in range(self.num_layers)]
        if slots is None or not self.state_leaves:
            return out
        idx = torch.from_numpy(np.ascontiguousarray(slots, np.int64))
        for (layer, name), store in zip(self.state_leaves, self.state_stores):
            sl = store[idx]
            self.host_copy_bytes += sl.numel() * sl.element_size()
            out[layer][name] = sl
        return out

    def gather(self, tables: np.ndarray, slots: Optional[np.ndarray] = None
               ) -> List[Dict[str, torch.Tensor]]:
        """tables: (B, nmax) block ids; slots: (B,) state slots (state
        leaves: ``gather_state``). Returns, per layer, each page leaf's host
        window (B, W) + per-token shape with W = min(nmax * P,
        max_model_len): row b's positions in its table's order. Table
        entries past a row's blocks point at block 0 and bring in bytes
        that the model never reads as valid keys. A quantized leaf's window
        is what the quantized kernel serves: ``codes * scale + zero`` (f32,
        then the staging dtype) for a packed block, the fp staging page for
        a block still filling — the reference's host dequantization, and
        the plain version of ``GatheredRunner``'s device-side one
        (``gather_quantized``)."""
        idx = torch.from_numpy(np.ascontiguousarray(tables, np.int64))
        B, nb = idx.shape
        W = min(nb * self.cfg.block_size, self.cfg.max_model_len)
        out = self.gather_state(slots)
        for layer, name, li in self._leaves:
            pages = self.stores[li][:, idx]  # (h, B, nb, P, w)
            if li in self.qplanes:
                planes = self.qplanes[li]
                deq = (pages.float() * planes["scale"][:, idx].float()
                       + planes["zero"][:, idx].float()).to(self.qdtype[li])
                packed = torch.from_numpy(self.block_quantized[tables])
                pages = torch.where(packed[None, :, :, None, None], deq,
                                    self.qstage[li][:, idx])
            P = pages.shape[3]
            win = pages.permute(1, 2, 3, 0, 4).reshape(
                (B, nb * P) + self.shapes[li])[:, :W]
            self.host_copy_bytes += win.numel() * win.element_size()
            out[layer][name] = win
        return out

    def gather_quantized(self, tables: np.ndarray,
                         slots: Optional[np.ndarray] = None) -> dict:
        """The parts of a quantized window that the gathered runner uploads
        and dequantizes on its device (``gathered.dequantize_window``):
        each distinct block of ``tables`` once, with ``inv`` (B, nmax) each
        table entry's index among them, and, per leaf name
        ("k", "v"), every attention layer's ``codes`` (L, KV, n, P, D) and
        f16 ``scale`` / ``zero`` planes of those blocks, plus ``stage`` (L,
        KV, n_open, P, D), the fp staging pages of the blocks still filling,
        at ``open`` (n_open,) among the ids; ``layers`` (L,) the model layer
        of each, and ``state`` the slots' state leaves (``gather_state``).
        ``host_copy_bytes`` is charged the fp window and the slots, as the
        reference's ``gather`` charges them."""
        bs = self.cfg.block_size
        B, nb = tables.shape
        W = min(nb * bs, self.cfg.max_model_len)
        ids, inv = np.unique(tables, return_inverse=True)
        open_at = np.nonzero(~self.block_quantized[ids])[0]
        tid = torch.from_numpy(ids.astype(np.int64))
        oid = torch.from_numpy(ids[open_at].astype(np.int64))
        out = {"inv": torch.from_numpy(inv.reshape(B, nb).astype(np.int64)),
               "open": torch.from_numpy(open_at.astype(np.int64)), "W": W,
               "layers": [layer for layer, n, _ in self._leaves if n == "k"],
               "state": self.gather_state(slots)}
        for name in ("k", "v"):
            leaves = [idx for _, n, idx in self._leaves if n == name]
            parts = {"codes": [self.stores[i] for i in leaves],
                     "scale": [self.qplanes[i]["scale"] for i in leaves],
                     "zero": [self.qplanes[i]["zero"] for i in leaves],
                     "stage": [self.qstage[i] for i in leaves]}
            out[name] = {}
            for part, srcs in parts.items():
                sel = oid if part == "stage" else tid
                buf = torch.empty((len(srcs), srcs[0].shape[0], len(sel))
                                  + srcs[0].shape[2:], dtype=srcs[0].dtype)
                for j, src in enumerate(srcs):
                    torch.index_select(src, 1, sel, out=buf[j])
                out[name][part] = buf
            self.host_copy_bytes += len(leaves) * B * W * int(
                np.prod(self.shapes[leaves[0]])) * self.dtype.itemsize
        return out

    def scatter_state(self, new_cache: List[Dict[str, torch.Tensor]],
                      slots: np.ndarray, lengths: List[int]) -> None:
        """Write each row's new state (``new_cache``'s state leaves, (B,) +
        leaf shape, on any device) into its slot, for the rows that ran
        (``lengths[b] > 0``), charging those bytes to ``host_copy_bytes``:
        one device-side selection and one copy to the host per leaf."""
        rows = [b for b, ln in enumerate(lengths) if ln > 0]
        if not self.state_leaves or not rows:
            return
        sl = torch.from_numpy(np.ascontiguousarray(slots, np.int64)[rows])
        sel = None
        for (layer, name), store in zip(self.state_leaves, self.state_stores):
            leaf = new_cache[layer][name]
            if sel is None:
                sel = torch.tensor(rows, device=leaf.device)
            v = leaf.index_select(0, sel).cpu()
            store[sl] = v.to(store.dtype)
            self.host_copy_bytes += v.numel() * v.element_size()

    def scatter(self, new_cache: List[Dict[str, torch.Tensor]], tables: np.ndarray,
                starts: List[int], lengths: List[int],
                quant: Optional[QuantConfig] = None,
                slots: Optional[np.ndarray] = None) -> None:
        """Write back the positions [starts[b], starts[b] + lengths[b]) of
        every row of ``new_cache`` (per-layer windows, on any device), and
        with ``slots`` every row's new state (``scatter_state``): one
        device-side selection of the page slots across all leaves, one copy
        to the host, then the page writes. Quantized stores write row by row,
        in row order, as the reference does: each row's staging writes,
        then the packs of the pages it filled. fp stores under a ``quant``
        config the page layout cannot hold (MLA latents, a GEAR residual,
        non-KIVI axes) store the reference's quantize–dequantize round trip
        of each row's written values (``_round_trip``). Touched blocks are
        marked dirty."""
        if slots is not None:
            self.scatter_state(new_cache, slots, lengths)
        bs = self.cfg.block_size
        rows = [(b, st, ln) for b, (st, ln) in enumerate(zip(starts, lengths)) if ln > 0]
        if not rows or not self._leaves:
            self.version += 1
            return
        bi = np.concatenate([np.full(ln, b) for b, _, ln in rows])
        pos = np.concatenate([np.arange(st, st + ln) for _, st, ln in rows])
        blk = torch.from_numpy(tables[bi, pos // bs].astype(np.int64))
        off = torch.from_numpy(pos % bs)
        dev = new_cache[self._leaves[0][0]][self._leaves[0][1]].device
        sel = (torch.from_numpy(bi).to(dev), torch.from_numpy(pos).to(dev))
        n = len(pos)
        flat = torch.cat([new_cache[layer][name][sel].reshape(n, -1)
                          for layer, name, _ in self._leaves], dim=1).cpu()
        vals = [v.reshape((n,) + self.shapes[li]) for (_, _, li), v in zip(
            self._leaves, flat.split([int(np.prod(s)) for s in self.shapes], dim=1))]
        for (_, _, li), v in zip(self._leaves, vals):
            self.host_copy_bytes += v.numel() * self.dtype.itemsize
        if self.quantized:
            idxs = [li for _, _, li in self._leaves]
            at = 0
            for _, _, ln in rows:
                part = slice(at, at + ln)
                self._quant_write_group(idxs, blk[part], off[part],
                                        [v[part] for v in vals])
                at += ln
            self.version += 1
            return
        if quant is not None:
            vals = self._round_trip(vals, [ln for _, _, ln in rows], quant)
        for li, v in enumerate(vals):
            store = self.stores[li]
            store[:, blk, off] = v.reshape(n, store.shape[0], -1).transpose(0, 1).to(
                store.dtype)
        self._touch(np.unique(blk.numpy()))

    def _round_trip(self, vals: List[torch.Tensor], lens: List[int],
                    quant: QuantConfig) -> List[torch.Tensor]:
        """The reference's round trip for caches the quantized page layout
        cannot hold (``repro.core.executor.state.scatter``): each row's
        written values, one leaf of a stage's pattern slot with its R
        repeats stacked in front, (R, ln) + per-token shape, are quantized
        at ``quant.bits`` and dequantized back into the store dtype. The
        reference's leaf always has 3 or more dimensions there, so the
        grouping axis is always "channel" — the configured axes and the
        GEAR ``residual_rank`` are not read — and every statistic pools the
        R repeats, the row's ln positions and any heads."""
        out = list(vals)
        for group in self.repeat_groups:
            at = 0
            rows = []
            for ln in lens:
                x = torch.stack([vals[li][at: at + ln] for li in group])
                axis = "channel" if x.dim() >= 3 else "token"
                rows.append(dequantize(*quantize(x, quant.bits, axis)).to(self.dtype))
                at += ln
            y = torch.cat(rows, dim=1)
            for r, li in enumerate(group):
                out[li] = y[r]
        return out

    # ------------------------------------------------------------------
    def write_token_group(self, leaf_idxs: List[int], blocks: torch.Tensor,
                          offsets: torch.Tensor,
                          payloads: List[torch.Tensor]) -> int:
        """Paged-path writeback: token values ``payloads[j]`` (n, KV, D)
        into store ``leaf_idxs[j]`` at (blocks, offsets), both (n,). fp
        stores do NOT dirty the mirror — the device mirror already holds the
        same write (applied in place by the model). Quantized stores write
        fp staging, and only a page fill packs codes and dirties the mirror.
        Returns bytes written."""
        nbytes = 0
        q_idxs: List[int] = []
        q_payloads: List[torch.Tensor] = []
        for idx, payload in zip(leaf_idxs, payloads):
            nbytes += payload.numel() * payload.element_size()
            if idx in self.qplanes:
                q_idxs.append(idx)
                q_payloads.append(payload)
            else:
                self.stores[idx][:, blocks, offsets] = payload.transpose(0, 1)
        if q_idxs:
            self._quant_write_group(q_idxs, blocks, offsets, q_payloads)
        return nbytes

    def copy_block(self, src: int, dst: int) -> None:
        for idx, store in enumerate(self.stores):
            store[:, dst] = store[:, src]
            if idx in self.qplanes:
                for plane in self.qplanes[idx].values():
                    plane[:, dst] = plane[:, src]
                self.qstage[idx][:, dst] = self.qstage[idx][:, src]
        self.block_quantized[dst] = self.block_quantized[src]
        self._touch([dst])

    def block_payload(self, block: int) -> list:
        """One block's pages across layers, this store's KV heads (host-tier
        demotion; migration, gathered where the heads are cut). Quantized
        leaves give (codes, scale, zero) — plus the fp staging page ONLY
        while the block is still filling, so a packed payload stays smaller
        than the fp16 pages it replaces — and the list ends with the
        block's ``block_quantized`` flag."""
        packed = bool(self.block_quantized[block])
        out: list = []
        for idx, store in enumerate(self.stores):
            if idx in self.qplanes:
                entry = (store[:, block].clone(),
                         self.qplanes[idx]["scale"][:, block].clone(),
                         self.qplanes[idx]["zero"][:, block].clone())
                if not packed:
                    entry += (self.qstage[idx][:, block].clone(),)
                out.append(entry)
            else:
                out.append(store[:, block].clone())
        if self.quantized:
            out.append(packed)
        return out

    def gather_payloads(self, payloads: List[list], group, device) -> List[list]:
        """``block_payload``s of this rank's KV heads as the same blocks'
        pages over every KV head of ``group``, the model group the store's
        heads are cut over (contiguously, in rank order): every tensor of
        every payload packed into one byte matrix with a row per head, ONE
        ``all_gather`` of it along the heads on ``device`` (the group's),
        then unpacked. Every rank of the group must call it at once with
        payloads of the same blocks' shapes (SPMD); a failing collective
        raises."""
        tensors = [t for page in payloads for t in page_tensors(page)]
        heads = tensors[0].shape[0]
        flat = torch.cat([t.reshape(heads, -1).view(torch.uint8) for t in tensors], dim=1)
        full = group.all_gather(flat.to(device), dim=0).cpu()
        parts, at = [], 0
        for t in tensors:
            n = t[0].numel() * t.element_size()
            parts.append(full[:, at: at + n].contiguous().view(t.dtype).reshape(
                (full.shape[0],) + tuple(t.shape[1:])))
            at += n
        rest = iter(parts)
        return [map_page(page, lambda _: next(rest)) for page in payloads]

    def restore_block(self, block: int, payload: list) -> int:
        for idx, (store, page) in enumerate(zip(self.stores, payload)):
            if idx in self.qplanes:
                codes, scale, zero = page[:3]
                store[:, block] = codes
                self.qplanes[idx]["scale"][:, block] = scale
                self.qplanes[idx]["zero"][:, block] = zero
                if len(page) > 3:
                    self.qstage[idx][:, block] = page[3]
                else:
                    # a packed payload ships no staging: rebuild it from the
                    # codes, so a block re-opened later serves sane values
                    self.qstage[idx][:, block] = (
                        codes.float() * scale.float() + zero.float()
                    ).to(self.qdtype[idx])
            else:
                store[:, block] = page
        if self.quantized:
            self.block_quantized[block] = payload[-1]
        self._touch([block])
        return page_bytes(payload)

    # ------------------------------------------------------------------
    # state slots
    # ------------------------------------------------------------------
    def reset_state(self, slot: int) -> None:
        """Write the empty history (``init_state``) into every state leaf
        of ``slot``: the engine's step whenever it hands a slot out."""
        for store, init in zip(self.state_stores, self._state_init):
            store[slot] = init

    def state_payload(self, slot: int) -> List[torch.Tensor]:
        """One slot's state leaves, copied (migration)."""
        return [store[slot].clone() for store in self.state_stores]

    def restore_state(self, slot: int, payload: List[torch.Tensor]) -> int:
        """Write a ``state_payload`` into ``slot``; returns its bytes."""
        if len(payload) != len(self.state_stores):
            raise ValueError(f"a state payload of {len(payload)} leaves for a store "
                             f"of {len(self.state_stores)} state leaves")
        nbytes = 0
        for store, leaf in zip(self.state_stores, payload):
            store[slot] = leaf
            nbytes += leaf.numel() * leaf.element_size()
        self.version += 1
        return nbytes

    def state_bytes_per_slot(self) -> int:
        """Bytes of one slot across every state leaf: what a step moves each
        way per row of a state stack."""
        return sum(s[0].numel() * s.element_size() for s in self.state_stores)

    def kv_bytes_per_block(self) -> int:
        """Bytes one block occupies across layers: for quantized stores,
        codes plus scale/zero planes."""
        total = 0
        for idx, s in enumerate(self.stores):
            total += s[:, 0].numel() * s.element_size()
            for p in self.qplanes.get(idx, {}).values():
                total += p[:, 0].numel() * p.element_size()
        return total

    def kv_fp16_bytes_per_block(self) -> int:
        """What the same block would occupy as fp16 pages: the baseline of
        the quantized-capacity claim."""
        return sum(s[:, 0].numel() * 2 for s in self.stores)
