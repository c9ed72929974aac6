"""Paged KV-cache management: fixed-size blocks, per-sequence block tables.

A numpy copy of ``repro/serve/paged.py`` (the port imports nothing of the
JAX package).

The serving engine's cache is a single physical pool per attention layer
(``LM.init_paged_cache``: ``(num_blocks * block_size, KV, hd)`` token
slots) plus ONE shared position ledger ``pos_pool`` (the logical layout is
identical across layers, so it is not replicated per layer).  This module
owns the host-side bookkeeping:

- :class:`BlockAllocator` -- free-list allocation of fixed-size blocks.
  Block 0 is RESERVED as the null block: unallocated block-table entries
  and padded-token writes land there, and its ``pos_pool`` entries keep
  the :data:`~repro_torch.models.attention.EMPTY_POS` sentinel so gathered reads
  from it never attend.
- :class:`BlockTables` -- the (max_slots, blocks_per_seq) int32 table the
  attention reads index through (gathered or streamed block-by-block by
  the fused kernel), with grow / release, **windowed eviction** for
  sliding-window archs (:meth:`BlockTables.evict_window` frees blocks
  whose every position has aged out of the attention window, capping a
  sequence's footprint at ``ceil(window / block_size) + 1`` blocks), and
  a freed-block ``pos_pool`` reset (a recycled block would otherwise leak
  its previous owner's positions into the new owner's mask).

Eviction keeps **absolute column addressing**: freed leading table
columns are zeroed to :data:`NULL_BLOCK` (reads from them are masked --
the null block's ``pos_pool`` entries stay ``EMPTY_POS``), and later
growth appends columns after the evicted prefix.  The per-sequence
context ceiling is unchanged (``max_len`` still caps positions), so
eviction raises pool-level *concurrency* -- more resident sequences per
pool -- not single-sequence length.

Everything here is plain numpy / python -- the model only ever sees the
current table snapshot and the scatter/gather indices derived from it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.models.attention import EMPTY_POS

__all__ = ["BlockAllocator", "BlockTables", "empty_pos_pool", "NULL_BLOCK"]

NULL_BLOCK = 0


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size cache blocks.

    Block 0 is the reserved null block and is never handed out.  ``alloc``
    is all-or-nothing (a partial grant would strand blocks on callers that
    cannot use them); ``free`` returns blocks to the tail of the free list
    (FIFO reuse keeps recycling observable in tests).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the "
                             "reserved null block)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(1, num_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Allocated (non-null) blocks currently owned by sequences."""
        return (self.num_blocks - 1) - len(self._free)

    @property
    def utilization(self) -> float:
        """Fraction of allocatable blocks currently in use."""
        return self.used_blocks / max(1, self.num_blocks - 1)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache entries."""
        return -(-max(0, int(n_tokens)) // self.block_size)

    def occupancy(self) -> dict:
        """Pool occupancy snapshot: the engine publishes it as its
        ``engine_blocks_used`` / ``engine_block_utilization`` gauges each
        tick."""
        return {"num_blocks": self.num_blocks - 1,
                "used_blocks": self.used_blocks,
                "free_blocks": self.free_blocks,
                "utilization": self.utilization}

    def alloc(self, n: int) -> Optional[List[int]]:
        """Grant ``n`` blocks, or None (untouched) if they are not free."""
        if n > len(self._free):
            return None
        grant, self._free = self._free[:n], self._free[n:]
        return grant

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("cannot free the null block")
            if b in self._free or not (0 < b < self.num_blocks):
                raise ValueError(f"double/invalid free of block {b}")
        self._free.extend(blocks)


@dataclasses.dataclass
class BlockTables:
    """Per-slot block tables over a shared :class:`BlockAllocator`.

    ``table[slot]`` lists the pool blocks holding that slot's logical
    cache window in position order; unassigned entries stay
    :data:`NULL_BLOCK`.  ``max_len`` = blocks_per_seq * block_size is the
    engine's per-sequence context ceiling.
    """
    allocator: BlockAllocator
    max_slots: int
    blocks_per_seq: int

    def __post_init__(self):
        self.table = np.full((self.max_slots, self.blocks_per_seq),
                             NULL_BLOCK, np.int32)
        self._owned: List[List[int]] = [[] for _ in range(self.max_slots)]
        # leading table columns freed by windowed eviction, per slot --
        # column addressing stays absolute, so growth resumes after them
        self._evicted: List[int] = [0] * self.max_slots

    @property
    def max_len(self) -> int:
        return self.blocks_per_seq * self.allocator.block_size

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def evicted(self, slot: int) -> int:
        """Leading table columns of ``slot`` freed by windowed eviction."""
        return self._evicted[slot]

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens`` positions.

        Returns False (tables untouched) if the pool cannot supply the
        missing blocks -- the engine then preempts.  Raises if the request
        exceeds the per-sequence ceiling (no allocation could ever help).
        Columns already freed by :meth:`evict_window` count as covered:
        their positions have aged out of the attention window, so no read
        or write will ever touch them again.
        """
        need = self.allocator.blocks_for(n_tokens)
        if need > self.blocks_per_seq:
            raise ValueError(
                f"sequence needs {n_tokens} cache positions "
                f"({need} blocks) > per-sequence ceiling {self.max_len} "
                f"({self.blocks_per_seq} blocks)")
        have = self._evicted[slot] + len(self._owned[slot])
        if need <= have:
            return True
        grant = self.allocator.alloc(need - have)
        if grant is None:
            return False
        self.table[slot, have:need] = grant
        self._owned[slot].extend(grant)
        return True

    def evict_window(self, slot: int, next_pos: int,
                     window: int) -> List[int]:
        """Free ``slot``'s blocks that have aged out of a sliding window.

        ``next_pos`` is the next position the sequence will write (every
        later query sits at ``>= next_pos``); a block column ``c`` covers
        positions ``[c*bs, (c+1)*bs)`` and is dead once its newest
        position is older than the window's reach, i.e. ``(c+1)*bs <=
        next_pos - window + 1``.  The strict per-column bound keeps the
        column holding ``next_pos`` itself alive even at ``window == 1``.

        Freed columns are zeroed to :data:`NULL_BLOCK` in place (absolute
        addressing; see the module docstring) and the blocks are returned
        so the caller can reset their ``pos_pool`` entries before reuse.
        A live sequence evicted at every step holds at most
        ``ceil(window / block_size) + 1`` blocks.
        """
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        bs = self.allocator.block_size
        n_dead = max(0, (int(next_pos) - int(window) + 1) // bs)
        n_dead = min(n_dead, self._evicted[slot] + len(self._owned[slot]))
        k = n_dead - self._evicted[slot]
        if k <= 0:
            return []
        dead, self._owned[slot] = (self._owned[slot][:k],
                                   self._owned[slot][k:])
        self.table[slot, self._evicted[slot]:n_dead] = NULL_BLOCK
        self._evicted[slot] = n_dead
        self.allocator.free(dead)
        return dead

    def release(self, slot: int) -> List[int]:
        """Free all of ``slot``'s blocks; returns them so the engine can
        reset their ``pos_pool`` entries (stale positions in a recycled
        block would attend for its next owner)."""
        blocks = self._owned[slot]
        self._owned[slot] = []
        self._evicted[slot] = 0
        self.table[slot, :] = NULL_BLOCK
        if blocks:
            self.allocator.free(blocks)
        return blocks

    def reset_slots_index(self, blocks: List[int]) -> np.ndarray:
        """Flat pool-slot indices of ``blocks`` (for ``pos_pool`` resets)."""
        bs = self.allocator.block_size
        b = np.asarray(blocks, np.int32)
        return (b[:, None] * bs + np.arange(bs, dtype=np.int32)).reshape(-1)


def empty_pos_pool(num_blocks: int, block_size: int) -> np.ndarray:
    """Fresh position ledger: every physical slot at the EMPTY sentinel."""
    return np.full(num_blocks * block_size, EMPTY_POS, np.int32)
