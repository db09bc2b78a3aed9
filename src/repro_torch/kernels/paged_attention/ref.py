"""Plain PyTorch oracles for paged decode attention, fp and KIVI pages.

Twins of ``repro.kernels.paged_attention.ref``: ``paged_attention_ref`` and
``paged_attention_chunked_ref`` over fp pages (beside them
``paged_attention_split_ref``, the split-K partials and merge of the CUDA
kernel), and
``paged_attention_quant_ref`` / ``paged_attention_chunked_quant_ref`` over
uint8 codes with scale/zero planes plus a full-precision tail
(``dequantize_page_leaves``; beside them ``paged_attention_quant_split_ref``,
the split-K partials and merge of the quantized CUDA kernel). All share
the same masking: invalid positions score ``NEG_INF`` and get probability
exactly 0, and the normalizer is clamped at ``1e-30`` so a row with no
valid position returns zeros.

Semantics: one query token per sequence attends over a paged KV cache.
``lengths[b]`` counts valid tokens; page contents beyond it are garbage and
must not influence the output. Pages are gathered by ``block_tables``.
These run wherever their tensors live: the CPU path of the port, and the
yardstick the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(KV, NB, P, D) pages, (B, NP) tables -> (B, KV, NP * P, D)."""
    KV, _, P, D = pages.shape
    B, NP = block_tables.shape
    g = pages[:, block_tables.long()]  # (KV, B, NP, P, D)
    return g.transpose(0, 1).reshape(B, KV, NP * P, D)


def _softmax(s, valid):
    """s: (..., S) f32 scores, valid: bool broadcastable to s -> attention
    probabilities, exactly 0 where invalid. Shared masking of both oracles."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.clamp(l, min=1e-30)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *, scale):
    """q: (B, KV, G, D); k_pages/v_pages: (KV, NB, P, D);
    block_tables: (B, NP) int; lengths: (B,) int -> (B, KV, G, D)."""
    NP, P = block_tables.shape[1], k_pages.shape[2]
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k) * scale
    pos = torch.arange(NP * P, device=q.device)
    valid = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
    p = _softmax(s, valid)
    return torch.einsum("bkgs,bksd->bkgd", p, v).to(q.dtype)


def paged_attention_chunked_ref(q, k_pages, v_pages, block_tables, lengths,
                                *, scale):
    """Direct-masking oracle for chunked extend attention (paged prefill).

    q: (B, C, KV, G, D); query j of sequence b sits at absolute position
    ``lengths[b] + j`` and the chunk's K/V is ALREADY in the pages. Row
    (b, j) sees positions ``pos <= lengths[b] + j``: the page-resident
    prefix plus in-chunk causality, in one mask. Padding rows of ragged
    chunks compute well-defined garbage the caller ignores.
    Returns (B, C, KV, G, D)."""
    C = q.shape[1]
    NP, P = block_tables.shape[1], k_pages.shape[2]
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    s = torch.einsum("bckgd,bksd->bckgs", q.float(), k) * scale
    pos = torch.arange(NP * P, device=q.device)
    qpos = lengths.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    valid = (pos[None, None, :] <= qpos[:, :, None])[:, :, None, None, :]
    p = _softmax(s, valid)
    return torch.einsum("bckgs,bksd->bckgd", p, v).to(q.dtype)



def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                              scale, splits, rows_per_seq=None, key_tile=64):
    """Split-K (flash-decoding) twin of the CUDA kernel's partials and merge,
    the oracle of its algebra. The table's NP * P positions go in tiles of
    ``key_tile``; split s takes tiles [s * per, (s + 1) * per), per =
    ceil(tiles / splits). Each split keeps, per query row, the max ``m`` of
    its visible scores (NEG_INF if it sees none), ``l`` = sum of exp(s - m)
    and ``acc`` = sum of exp(s - m) * v; the merge returns
    sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-30), so a row no
    split sees returns 0. Slots past every row's last position are zeroed,
    as the kernel never loads them.

    Decode (``rows_per_seq`` None): q (B, KV, G, D), row sees positions
    < lengths[b]. Extend: q (B, C, KV, G, D), row (b, c) sees positions
    < lengths[b] + c + 1. Returns q's shape and dtype."""
    decode = rows_per_seq is None
    q5 = q[:, None] if decode else q  # (B, C, KV, G, D)
    C = q5.shape[1]
    NP, P = block_tables.shape[1], k_pages.shape[2]
    S = NP * P
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    pos = torch.arange(S, device=q.device)
    row_len = lengths.long()[:, None] + (0 if decode else torch.arange(
        C, device=q.device)[None, :] + 1)  # (B, C)
    valid = pos[None, None, :] < row_len[:, :, None]  # (B, C, S)
    v = torch.where(valid.any(dim=1)[:, None, :, None], v, torch.zeros_like(v))
    s = torch.einsum("bckgd,bksd->bckgs", q5.float(), k) * scale
    tiles = -(-S // key_tile)
    per = max(1, -(-tiles // splits))
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = i * per * key_tile, min(S, (i + 1) * per * key_tile)
        ok = (valid & (pos >= lo) & (pos < hi))[:, :, None, None, :]
        si = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(si - m), torch.zeros_like(si))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bckgs,bksd->bckgd", p, v))
    m_all = torch.stack(ms)  # (splits, B, C, KV, G, 1)
    w = torch.exp(m_all - m_all.amax(dim=0))
    num = (w * torch.stack(accs)).sum(dim=0)
    den = (w * torch.stack(ls)).sum(dim=0)
    out = (num / torch.clamp(den, min=1e-30)).to(q.dtype)
    return out[:, 0] if decode else out

# ---------------------------------------------------------------------------
# quantized pages (KIVI at rest): uint8 codes + scale/zero planes for packed
# pages, a full-precision tail for everything from ``tail_start`` up
# ---------------------------------------------------------------------------

def dequantize_page_leaves(codes, scale, zero, deq_dtype):
    """uint8 codes (+ broadcastable scale/zero planes) -> values in the
    cache's logical dtype. ``codes * scale + zero`` in f32, then rounded to
    ``deq_dtype``: the kernel must see the same rounded values, or greedy
    parity with a backend that stages windows in the cache dtype breaks."""
    x = codes.float() * scale.float() + zero.float()
    return x.to(deq_dtype)


def _quant_kv(k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail,
              v_tail, block_tables, deq_dtype):
    """Gather the tables' pages, dequantize them and append the tails:
    -> k, v (B, KV, NP * P + T, D) in ``deq_dtype``."""
    KV, _, P, D = k_codes.shape
    B, NP = block_tables.shape
    t = block_tables.long()
    k = dequantize_page_leaves(k_codes[:, t], k_scale[:, t], k_zero[:, t], deq_dtype)
    v = dequantize_page_leaves(v_codes[:, t], v_scale[:, t], v_zero[:, t], deq_dtype)
    k = k.transpose(0, 1).reshape(B, KV, NP * P, D)
    v = v.transpose(0, 1).reshape(B, KV, NP * P, D)
    k = torch.cat([k, k_tail.to(deq_dtype).transpose(1, 2)], dim=2)
    v = torch.cat([v, v_tail.to(deq_dtype).transpose(1, 2)], dim=2)
    return k.float(), v.float()


def _dead_to_zero(v, valid):
    """v (B, KV, S, D) with the positions no query attends (``valid`` (B, S)
    false) set to 0: dead slots may hold anything, and a 0 weight times an
    infinite value would be NaN. The quantized kernel never loads them."""
    return torch.where(valid[:, None, :, None], v, torch.zeros_like(v))


def paged_attention_quant_ref(q, k_codes, k_scale, k_zero, v_codes, v_scale,
                              v_zero, k_tail, v_tail, block_tables, lengths,
                              tail_start, *, scale, deq_dtype=torch.float32,
                              rows_per_seq=1):
    """q: (B, KV, G, D); k_codes/v_codes: (KV, NB, P, D) uint8;
    k_scale/k_zero: (KV, NB, 1, D) — per-channel key groups;
    v_scale/v_zero: (KV, NB, P, 1) — per-token value groups;
    k_tail/v_tail: (B, T, KV, D) full-precision K/V from ``tail_start`` up;
    block_tables: (B, NP) int; lengths: (B,) valid tokens INCLUDING the
    tail tokens this row may attend; tail_start: (B,) tokens resident in the
    quantized pages (tail token i is at position tail_start + i).
    -> (B, KV, G, D). ``rows_per_seq`` > 1 is the extend fold of the CUDA
    kernel's interface: q and lengths have B * rows_per_seq rows, and row r
    takes sequence r // rows_per_seq's tails, table and tail_start."""
    if rows_per_seq > 1:
        k_tail, v_tail, block_tables, tail_start = (
            torch.repeat_interleave(t, rows_per_seq, dim=0)
            for t in (k_tail, v_tail, block_tables, tail_start))
    NP, P, T = block_tables.shape[1], k_codes.shape[2], k_tail.shape[1]
    k, v = _quant_kv(k_codes, k_scale, k_zero, v_codes, v_scale, v_zero,
                     k_tail, v_tail, block_tables, deq_dtype)
    dev = q.device
    ts = tail_start.long()[:, None]
    valid = torch.cat(
        [torch.arange(NP * P, device=dev)[None, :] < ts,  # page slots past the tail are dead
         ts + torch.arange(T, device=dev)[None, :] < lengths.long()[:, None]],
        dim=1)  # (B, NP * P + T)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k) * scale
    p = _softmax(s, valid[:, None, None, :])
    return torch.einsum("bkgs,bksd->bkgd", p, _dead_to_zero(v, valid)).to(q.dtype)


def paged_attention_chunked_quant_ref(q, k_codes, k_scale, k_zero, v_codes,
                                      v_scale, v_zero, k_tail, v_tail,
                                      block_tables, lengths, tail_start, *,
                                      scale, deq_dtype=torch.float32):
    """Chunked-extend oracle over KIVI pages: q (B, C, KV, G, D), query j of
    sequence b at absolute position ``lengths[b] + j``. Page slots serve
    positions ``< tail_start[b]`` (dequantized once per sequence);
    everything from ``tail_start`` up, including the chunk's own K/V at its
    tail slots, comes from the shared fp tail, masked per query row by
    in-chunk causality (``pos <= lengths[b] + j``). -> (B, C, KV, G, D)."""
    C = q.shape[1]
    NP, P, T = block_tables.shape[1], k_codes.shape[2], k_tail.shape[1]
    k, v = _quant_kv(k_codes, k_scale, k_zero, v_codes, v_scale, v_zero,
                     k_tail, v_tail, block_tables, deq_dtype)
    dev = q.device
    ts = tail_start.long()
    qpos = lengths.long()[:, None] + torch.arange(C, device=dev)[None, :]  # (B, C)
    pages_ok = torch.arange(NP * P, device=dev)[None, :] < ts[:, None]  # (B, S)
    pos_tail = ts[:, None] + torch.arange(T, device=dev)[None, :]  # (B, T)
    valid = torch.cat(
        [pages_ok[:, None, :].expand(-1, C, -1),
         pos_tail[:, None, :] <= qpos[:, :, None]], dim=-1)  # (B, C, S + T)
    s = torch.einsum("bckgd,bksd->bckgs", q.float(), k) * scale
    p = _softmax(s, valid[:, :, None, None, :])
    return torch.einsum("bckgs,bksd->bckgd", p,
                        _dead_to_zero(v, valid.any(dim=1))).to(q.dtype)


def paged_attention_quant_split_ref(q, k_codes, k_scale, k_zero, v_codes, v_scale,
                                    v_zero, k_tail, v_tail, block_tables, lengths,
                                    tail_start, *, scale, splits,
                                    deq_dtype=torch.float32, rows_per_seq=1,
                                    page_tile=64, tail_tile=32):
    """Split-K twin of the quantized mma kernel's partials and merge, the
    oracle of its algebra (``paged_attention_split_ref`` over KIVI pages).
    Arguments and result as ``paged_attention_quant_ref``: q (R, KV, G, D)
    with R = B * rows_per_seq, lengths (R,), row r of sequence
    r // rows_per_seq.

    A sequence's positions form one stream of tiles: its valid page slots
    ``[0, tail_start)`` in tiles of ``page_tile``, then its tail slots in
    tiles of ``tail_tile`` (no tile holds both). With ``per`` =
    ceil(most tiles / splits), the most tiles being ceil(NP * P / page_tile)
    + ceil(T / tail_tile) (the host plans from shapes, not lengths), split s
    takes the stream's tiles [s * per, (s + 1) * per). Each split keeps per
    row the max ``m`` of its visible scores (NEG_INF if none), ``l`` and
    ``acc``; the merge is ``paged_attention_split_ref``'s. Positions no row
    of the sequence sees are zeroed in V, as the kernel never loads them."""
    R, KV, G, D = q.shape
    B, NP = block_tables.shape
    C = rows_per_seq
    P, T = k_codes.shape[2], k_tail.shape[1]
    S = NP * P
    k, v = _quant_kv(k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail,
                     v_tail, block_tables, deq_dtype)  # (B, KV, S + T, D)
    dev = q.device
    ts = tail_start.long()
    n_page = ts.clamp(0, S)  # (B,) valid page slots, for every row
    n_tail = (lengths.long().reshape(B, C) - ts[:, None]).clamp(0, T)  # (B, C)
    pos, slot = torch.arange(S, device=dev), torch.arange(T, device=dev)
    valid = torch.cat([(pos[None, :] < n_page[:, None])[:, None, :].expand(B, C, S),
                       slot[None, None, :] < n_tail[:, :, None]], dim=-1)  # (B, C, S + T)
    n_pt = -(-n_page // page_tile)  # (B,) page tiles; tail tiles follow
    tile = torch.cat([(pos // page_tile)[None, :].expand(B, S),
                      n_pt[:, None] + (slot // tail_tile)[None, :]], dim=1)  # (B, S + T)
    per = max(1, -(-(-(-S // page_tile) + -(-T // tail_tile)) // splits))
    split_of = tile // per
    v = _dead_to_zero(v, valid.any(dim=1))
    s = torch.einsum("bckgd,bksd->bckgs", q.reshape(B, C, KV, G, D).float(), k) * scale
    ms, ls, accs = [], [], []
    for i in range(splits):
        ok = (valid & (split_of == i)[:, None, :])[:, :, None, None, :]
        si = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(si - m), torch.zeros_like(si))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bckgs,bksd->bckgd", p, v))
    m_all = torch.stack(ms)  # (splits, B, C, KV, G, 1)
    w = torch.exp(m_all - m_all.amax(dim=0))
    num = (w * torch.stack(accs)).sum(dim=0)
    den = (w * torch.stack(ls)).sum(dim=0)
    return (num / torch.clamp(den, min=1e-30)).to(q.dtype).reshape(R, KV, G, D)
