"""GQA attention: chunked (online-softmax) prefill + KV-cache decode (port of
``repro/models/attention.py``).

Plain tensor code, written as the reference writes it: scores in float32,
probabilities cast to the value dtype before the value product, masked
slots at ``NEG_INF`` so their weights underflow to exact zeros. Attention
is not a TPU kernel in the reference, so it has no hand-written kernel here.
The cache write is in place: one preallocated cache serves a whole
generation, as the reference's donated cache does. The paged primitives
(``paged_decode_attention``, ``paged_verify_attention``,
``paged_cache_write``) read and write a shared page pool through
per-stream block tables (``models/paged.py``).
"""
from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, head_to_kv: tuple) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by the static q-head -> kv-head map."""
    hkv = k.shape[2]
    if head_to_kv == tuple(range(hkv)):
        return k
    group = len(head_to_kv) // hkv
    if head_to_kv == tuple(h // group for h in range(len(head_to_kv))):
        # plain GQA groups: no index tensor, whose host-to-device copy
        # would synchronise the stream on every call
        return torch.repeat_interleave(k, group, dim=2)
    return torch.index_select(k, 2, _kv_index(head_to_kv, k.device))


@functools.lru_cache(maxsize=None)
def _kv_index(head_to_kv: tuple, device: torch.device) -> torch.Tensor:
    """The map as an index tensor on ``device``, made once there: the eager
    step before a decode graph's capture makes it, and the capture, where a
    copy from the host would fail, reads it."""
    return torch.tensor(head_to_kv, dtype=torch.long, device=device)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      head_to_kv: tuple, causal: bool = True, window: int = 0,
                      q_offset: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-efficient attention.

    q: (B, Tq, H, D); k, v: (B, S, Hkv, D). Returns (B, Tq, H, D).
    ``q_offset`` is the absolute position of q[0].
    """
    b, tq, h, d = q.shape
    s = k.shape[1]
    q = q * d ** -0.5
    k = expand_kv(k, head_to_kv)
    v = expand_kv(v, head_to_kv)

    q_chunk = min(q_chunk, tq)
    n_q = -(-tq // q_chunk)
    pad_q = n_q * q_chunk - tq
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))

    outs = []
    for i in range(n_q):  # exact causal kv extent per q chunk
        q_i = q[:, i * q_chunk: (i + 1) * q_chunk]
        q_lo = q_offset + i * q_chunk
        q_hi = q_lo + q_chunk
        kv_hi = min(s, q_hi) if causal else s
        kv_lo = max(0, q_lo - window + 1) if (window and causal) else 0
        kv_lo = (kv_lo // kv_chunk) * kv_chunk
        kv_hi = min(s, -(-kv_hi // kv_chunk) * kv_chunk)
        if kv_hi <= kv_lo:  # fully masked chunk
            outs.append(torch.zeros((b, q_chunk, h, d), dtype=v.dtype, device=v.device))
            continue
        outs.append(_attend_one_q_chunk(
            q_i, k[:, kv_lo:kv_hi], v[:, kv_lo:kv_hi], q_pos0=q_lo, kv_pos0=kv_lo,
            causal=causal, window=window, kv_chunk=kv_chunk))
    return torch.cat(outs, dim=1)[:, :tq]


def _attend_one_q_chunk(q_i, k_i, v_i, *, q_pos0, kv_pos0, causal, window, kv_chunk):
    """Online-softmax loop over kv chunks for one q chunk.

    q_i: (B, Qc, H, D); k_i/v_i: (B, Skv, H, D) — the causal slab, kv expanded.
    """
    b, qc, h, d = q_i.shape
    skv = k_i.shape[1]
    kv_chunk = min(kv_chunk, skv)
    n_kv = -(-skv // kv_chunk)
    pad = n_kv * kv_chunk - skv
    if pad:
        k_i = torch.nn.functional.pad(k_i, (0, 0, 0, 0, 0, pad))
        v_i = torch.nn.functional.pad(v_i, (0, 0, 0, 0, 0, pad))

    dev = q_i.device
    q_pos = q_pos0 + torch.arange(qc, device=dev)
    q32 = q_i.float()
    acc = torch.zeros((b, h, qc, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, qc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
    for blk in range(n_kv):
        k_blk = k_i[:, blk * kv_chunk: (blk + 1) * kv_chunk]
        v_blk = v_i[:, blk * kv_chunk: (blk + 1) * kv_chunk]
        kv_pos = kv_pos0 + blk * kv_chunk + torch.arange(kv_chunk, device=dev)
        # float32 scores, as preferred_element_type=f32 in the reference
        s_blk = torch.einsum("bqhd,bshd->bhqs", q32, k_blk.float())
        mask = torch.ones((qc, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        mask &= kv_pos[None, :] < kv_pos0 + skv  # padded kv tail
        s_blk = torch.where(mask[None, None], s_blk, NEG_INF)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        p = torch.exp(s_blk - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        upd = torch.einsum("bhqs,bshd->bhqd", p.to(v_blk.dtype), v_blk)
        acc = acc * corr[..., None] + upd.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(v_i.dtype)  # (B, Qc, H, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len, *, head_to_kv: tuple, window: int = 0) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, Hkv, D); cache_len: tokens in
    the cache *including* the one just written, a host int or a 0-d device
    tensor. The whole cache is attended under a mask, so no shape depends
    on the length.
    """
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    k_exp = expand_kv(k_cache, head_to_kv)
    v_exp = expand_kv(v_cache, head_to_kv)
    scores = torch.einsum("bqhd,bshd->bhqs", (q * d ** -0.5).float(),
                          k_exp.float())[:, :, 0]                     # (B, H, S)
    slots = torch.arange(s, device=q.device)
    if window:
        t = cache_len - 1 - ((cache_len - 1 - slots) % s)
        valid = (t >= 0) & (t < cache_len) & (t > cache_len - 1 - window)
    else:
        valid = slots < cache_len
    scores = torch.where(valid[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p.to(v_exp.dtype), v_exp)
    return out.reshape(b, 1, h, d)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, cache_len):
    """Write T_new tokens into the cache in place (ring semantics if the
    cache is smaller). k_cache: (B, S, Hkv, D); k_new: (B, T, Hkv, D);
    cache_len: tokens already present, a host int or a 0-d device tensor:
    the slots are computed on the device, so a captured decode step writes
    at whatever length the cache holds when it is replayed. Returns the
    (same) caches."""
    s = k_cache.shape[1]
    t = k_new.shape[1]
    off = 0
    if t >= s:  # only the trailing window survives a big prefill
        k_new, v_new = k_new[:, -s:], v_new[:, -s:]
        off, t = t - s, s
    pos = (cache_len + off + torch.arange(t, device=k_cache.device)) % s
    k_cache.index_copy_(1, pos, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, pos, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def _paged_kv(k_pool: torch.Tensor, v_pool: torch.Tensor, block_table: torch.Tensor,
              head_to_kv: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's pages in position order, expanded to the query heads:
    (B, NB * bs, H, D) each."""
    b, nb = block_table.shape
    bs = k_pool.shape[1]
    pages = block_table.long()
    k = k_pool[pages].reshape(b, nb * bs, *k_pool.shape[2:])
    v = v_pool[pages].reshape(b, nb * bs, *v_pool.shape[2:])
    return expand_kv(k, head_to_kv), expand_kv(v, head_to_kv)


def _attend_prefix(q: torch.Tensor, k32: torch.Tensor, v_exp: torch.Tensor,
                   limit: torch.Tensor) -> torch.Tensor:
    """``decode_attention``'s arithmetic for one query position per stream:
    q (B, 1, H, D) attends the slots ``< limit[b]`` of the gathered keys
    (``k32``, in float32) and values. Slots at or past the limit get
    ``NEG_INF`` before the softmax, so their weights underflow to exact zeros
    and the result does not depend on what they hold. Returns (B, H, D)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bshd->bhqs", (q * d ** -0.5).float(), k32)[:, :, 0]
    valid = torch.arange(k32.shape[1], device=q.device)[None, :] < limit[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p.to(v_exp.dtype), v_exp)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_table: torch.Tensor, lengths: torch.Tensor, *,
                           head_to_kv: tuple) -> torch.Tensor:
    """Single-token attention against a paged KV pool with per-stream lengths.

    q: (B, 1, H, D); k_pool/v_pool: (P, bs, Hkv, D), one layer's page pool;
    block_table: (B, NB) int32 page ids in position order; lengths: (B,)
    int32 tokens per stream *including* the one just written. Token ``t``
    of stream ``b`` lives at ``(block_table[b, t // bs], t % bs)``.

    Slots at or past a stream's length are masked (``_attend_prefix``), so
    the result does not depend on whatever the masked pages hold (idle rows
    point their whole table at the reserved page 0).
    """
    k_exp, v_exp = _paged_kv(k_pool, v_pool, block_table, head_to_kv)
    return _attend_prefix(q, k_exp.float(), v_exp, lengths)[:, None]


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_table: torch.Tensor, lengths: torch.Tensor, *,
                           head_to_kv: tuple) -> torch.Tensor:
    """Multi-position attention against a paged KV pool (speculative verify).

    q: (B, T, H, D), token ``i`` of stream ``b`` sitting at slot
    ``lengths[b] + i`` (already written to the pool); lengths: (B,) tokens
    committed per stream before this dispatch. Query ``i`` attends slots
    ``< lengths[b] + i + 1``: the visibility a chain of T
    ``paged_decode_attention`` calls gives it.

    The pages are gathered once; each position then runs the decode's own
    body (``_attend_prefix``) at the decode's shapes, so position ``i`` is
    bitwise the decode's result at length ``lengths + i + 1`` whatever T is.
    """
    k_exp, v_exp = _paged_kv(k_pool, v_pool, block_table, head_to_kv)
    k32 = k_exp.float()
    return torch.stack([_attend_prefix(q[:, i:i + 1], k32, v_exp, lengths + (i + 1))
                        for i in range(q.shape[1])], dim=1)             # (B, T, H, D)


def paged_cache_write(k_pool: torch.Tensor, v_pool: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, block_table: torch.Tensor,
                      positions: torch.Tensor):
    """Scatter T new tokens per stream into a paged pool, in place.

    k_pool/v_pool: (P, bs, Hkv, D); k_new/v_new: (B, T, Hkv, D);
    block_table: (B, NB) int32; positions: (B, T) absolute token slots.
    Positions past a stream's table extent clamp into its last table
    entry: idle rows keep an all-zero table, so their writes land in the
    reserved garbage page 0 and never touch a live stream's pages.

    Several writes may hit one slot (every idle row writes page 0). The
    last of them in (B, T) order wins, as in the reference's scatter on the
    CPU: each write carries the values of its slot's last writer, so the
    result does not depend on the order a device applies them in. Idle
    rows then read a page whose contents are fixed, and, since an MoE
    layer routes them into the real rows' capacity, the real rows' tokens
    are fixed too. Returns the (same) pools.
    """
    bs = k_pool.shape[1]
    nb = block_table.shape[1]
    positions = positions.long()
    page = torch.clamp(positions // bs, max=nb - 1)                  # (B, T)
    blk = torch.gather(block_table.long(), 1, page).reshape(-1)      # (B*T,)
    off = (positions % bs).reshape(-1)
    src = last_writer(blk * bs + off, k_pool.shape[0] * bs)
    k_pool[blk, off] = k_new.reshape(-1, *k_new.shape[2:])[src].to(k_pool.dtype)
    v_pool[blk, off] = v_new.reshape(-1, *v_new.shape[2:])[src].to(v_pool.dtype)
    return k_pool, v_pool


def last_writer(slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For each write ``i`` to ``slots[i]`` (a flat slot id below
    ``n_slots``), the index of the last write to the same slot. No host
    sync: a max-scatter of the write indices, which is exact in any
    order."""
    order = torch.arange(slots.numel(), device=slots.device)
    last = torch.full((n_slots,), -1, dtype=torch.long, device=slots.device)
    last.scatter_reduce_(0, slots, order, reduce="amax")
    return last[slots]
