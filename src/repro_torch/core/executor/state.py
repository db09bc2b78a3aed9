"""Host-authoritative page stores backing the serving engine.

The attention-K/V subset of ``repro.core.executor.state``.
``PagedModelState`` owns one CPU tensor per (layer, k/v) in the cache dtype
(numpy has no bfloat16) and in the paged-attention kernel's layout
(KV, NB, P, D), so a device mirror syncs blocks with one ``index_copy_`` per
leaf and no transpose. Shapes come from the model config.

The paged path reads pages on the device through block tables and writes
each chunk's own K/V back here (O(tokens), ``write_token_group``), which
keeps this store authoritative for copy-on-write, prefix-cache payloads and
host-tier restores. Engine-side mutations (CoW copies, restores) bump
``version`` and record the block ids in ``dirty_blocks`` so the runner's
device mirror re-syncs just those blocks.

The gathered backend (``GatheredRunner``) reads whole windows instead:
``gather`` copies each row's pages into a dense (B, W, KV, D) window per
layer and ``scatter`` writes back only the positions a step wrote.
``host_copy_bytes`` counts that staging as the reference does (the window
per gather, the written payload per scatter); the paged path keeps it at
0.

KIVI quantization at rest (``EngineConfig.kv_quant`` with the KIVI axes and
no GEAR residual, ``quantized``): each leaf holds uint8 codes, with f16
scale/zero planes in ``qplanes`` — (KV, NB, 1, D) for keys (grouped per
channel), (KV, NB, P, 1) for values (per token). A page packs exactly ONCE,
when its last slot is written, through ``kernels/kv_quant``'s pack on the
engine's device (the CUDA kernel on the card), from complete group
statistics. Until then its tokens live full-precision in the staging store
``qstage`` and reach attention through the quantized kernel's fp tail
(``PagedRunner.call_pages``). ``block_quantized`` says which side of that
line each block is on. Only fills dirty the device mirror.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.kv_quant import QuantConfig
from repro_torch.kernels.kv_quant import quantize_kv_pages
from repro_torch.models.model import DTYPES


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — the bucketing rule for ragged extend
    batches and marshalled table widths."""
    p = 1
    while p < n:
        p *= 2
    return p


class PagedModelState:
    """Per-layer K/V page stores, host side. ``device`` is where page packs
    run (the engine's device)."""

    def __init__(self, model_cfg, engine_cfg, device):
        self.cfg = engine_cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[model_cfg.dtype]
        shape = (model_cfg.num_kv_heads, engine_cfg.num_blocks,
                 engine_cfg.block_size, model_cfg.head_dim)
        self.num_layers = model_cfg.num_layers
        self._leaves: List[Tuple[int, str, int]] = []
        self.stores: List[torch.Tensor] = []
        for layer in range(model_cfg.num_layers):
            for name in ("k", "v"):
                self._leaves.append((layer, name, len(self.stores)))
                self.stores.append(torch.zeros(shape, dtype=self.dtype))
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
            and self.quant.value_axis == "token")
        # block -> "codes+planes are current" (page filled and packed); a
        # False block's live tokens are served from the fp staging store
        self.block_quantized = np.zeros(engine_cfg.num_blocks, bool)
        if self.quantized:
            for _, name, idx in self._leaves:
                KV, NB, P, D = shape
                axis = "channel" if name == "k" else "token"
                pshape = (KV, NB, 1, D) if axis == "channel" else (KV, NB, P, 1)
                self.qaxis[idx] = axis
                self.qdtype[idx] = self.dtype
                self.qstage[idx] = self.stores[idx]
                self.stores[idx] = torch.zeros(shape, dtype=torch.uint8)
                self.qplanes[idx] = {"scale": torch.zeros(pshape, dtype=torch.float16),
                                     "zero": torch.zeros(pshape, dtype=torch.float16)}

    def _touch(self, blocks) -> None:
        self.version += 1
        self.dirty_blocks.update(int(b) for b in blocks)

    def attn_kv_leaves(self) -> List[Tuple[int, str, int]]:
        """(layer, "k"/"v", leaf index) for every page store."""
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
    def gather(self, tables: np.ndarray) -> List[Dict[str, torch.Tensor]]:
        """tables: (B, nmax) block ids. Returns, per layer, {"k", "v"} host
        windows (B, W, KV, D) with W = min(nmax * P, max_model_len): row b's
        positions in its table's order. Table entries past a row's blocks
        point at block 0 and bring in bytes that the model never reads as
        valid keys."""
        if self.quantized:
            raise NotImplementedError(
                "KIVI-quantized pages on the gathered backend are not ported "
                "yet (ROADMAP queue A.3: KIVI/GEAR stores on the gathered backend)")
        idx = torch.from_numpy(np.ascontiguousarray(tables, np.int64))
        B, nb = idx.shape
        W = min(nb * self.cfg.block_size, self.cfg.max_model_len)
        out: List[Dict[str, torch.Tensor]] = [{} for _ in range(self.num_layers)]
        for layer, name, li in self._leaves:
            pages = self.stores[li][:, idx]  # (KV, B, nb, P, D)
            KV, _, _, P, D = pages.shape
            win = pages.permute(1, 2, 3, 0, 4).reshape(B, nb * P, KV, D)[:, :W]
            self.host_copy_bytes += win.numel() * win.element_size()
            out[layer][name] = win
        return out

    def scatter(self, new_cache: List[Dict[str, torch.Tensor]], tables: np.ndarray,
                starts: List[int], lengths: List[int]) -> None:
        """Write back the positions [starts[b], starts[b] + lengths[b]) of
        every row of ``new_cache`` (per-layer {"k", "v"} (B, W, KV, D)
        windows, on any device): one device-side selection of those slots
        across all layers, one copy to the host, then the page writes.
        Touched blocks are marked dirty."""
        bs = self.cfg.block_size
        rows = [(b, st, ln) for b, (st, ln) in enumerate(zip(starts, lengths)) if ln > 0]
        if not rows:
            self.version += 1
            return
        bi = np.concatenate([np.full(ln, b) for b, _, ln in rows])
        pos = np.concatenate([np.arange(st, st + ln) for _, st, ln in rows])
        blk = torch.from_numpy(tables[bi, pos // bs].astype(np.int64))
        off = torch.from_numpy(pos % bs)
        dev = new_cache[0]["k"].device
        sel = (torch.from_numpy(bi).to(dev), torch.from_numpy(pos).to(dev))
        payload = torch.stack([new_cache[layer][name][sel]
                               for layer, name, _ in self._leaves]).cpu()
        for (_, _, li), vals in zip(self._leaves, payload):
            store = self.stores[li]
            store[:, blk, off] = vals.transpose(0, 1).to(store.dtype)
            self.host_copy_bytes += vals.numel() * store.element_size()
        self._touch(np.unique(blk.numpy()))

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
        """One block's pages across layers (host-tier demotion). Quantized
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

    def restore_block(self, block: int, payload: list) -> int:
        nbytes = 0
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
                nbytes += sum(a.numel() * a.element_size() for a in page)
            else:
                store[:, block] = page
                nbytes += page.numel() * page.element_size()
        if self.quantized:
            self.block_quantized[block] = payload[-1]
        self._touch([block])
        return nbytes

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
