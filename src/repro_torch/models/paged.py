"""Paged KV cache: a shared page pool and per-stream block tables (port of
``repro/models/paged.py``, the host-side accounting; pure Python).

The continuous-batching scheduler (``repro_torch.launch.engine``) keeps one
captured decode graph per signature and changes group membership between
chunks: streams are admitted and retired without copying anyone's KV state.

* **Pool**: per layer, ``num_blocks`` pages of ``block_size`` token slots,
  ``{"pk": (L, P, bs, Hkv, D), "pv": ...}`` (``model.init_paged_pool``),
  written in place, so serving memory stays at one pool however many
  requests flow through it.
* **Block table**: per stream, an int32 row of page ids in position order;
  token ``t`` of a stream lives at ``(table[t // bs], t % bs)``. Tables and
  lengths are small host arrays copied into the device buffers a decode
  graph reads before each chunk; regrouping streams is a host-side table
  edit, never a device copy of the pool.
* **Page 0 is reserved** as a garbage page: idle rows of a bucket-padded
  dispatch point their whole table at it, so their writes land harmlessly
  (the last of colliding writes kept, ``attention.paged_cache_write``) and
  a real stream's reads of it are masked by ``lengths``. Real streams never
  hold page 0, which is what makes bucket padding exact.

The device-side read/write primitives are in ``repro_torch.models.attention``
(``paged_decode_attention``, ``paged_cache_write``).
"""
from __future__ import annotations


def pages_for(tokens: int, block_size: int) -> int:
    """Pages needed to hold ``tokens`` slots of one stream."""
    return -(-max(int(tokens), 0) // int(block_size))


def rewind_pages(table_row, allocator, committed_tokens: int, block_size: int) -> int:
    """Roll one stream's table back to ``committed_tokens`` slots.

    Pages covering only slots past the committed length return to the pool
    and their table entries become 0 (later writes then clamp into the
    garbage page, never a stale grant). ``table_row`` is the stream's host
    int32 row, changed in place. Pages holding at least one committed token
    stay. Returns the number of pages freed.
    """
    keep = pages_for(committed_tokens, block_size)
    held = [int(p) for p in table_row if p != 0]
    overshoot = held[keep:]
    if overshoot:
        allocator.release(overshoot)
        table_row[keep:] = 0
    return len(overshoot)


class BlockAllocator:
    """Host-side free list over a pool's page ids (page 0 reserved).

    Allocation is LIFO (recently freed pages are reused first) and
    all-or-nothing: ``alloc`` returns exactly ``n`` pages or raises without
    side effects.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1 (page 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self._free = list(range(1, self.num_blocks))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: requested {n} pages, "
                f"{len(self._free)}/{self.num_blocks - 1} free")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        for p in pages:
            if p == 0:
                raise ValueError("page 0 is the reserved garbage page")
            if p in self._free or not (0 < p < self.num_blocks):
                raise ValueError(f"double free / bad page id {p}")
            self._free.append(p)

    def grow(self, new_num_blocks: int) -> None:
        """Extend the free list after the pool itself grew."""
        if new_num_blocks < self.num_blocks:
            raise ValueError("pool can only grow")
        self._free.extend(range(self.num_blocks, new_num_blocks))
        self.num_blocks = int(new_num_blocks)
