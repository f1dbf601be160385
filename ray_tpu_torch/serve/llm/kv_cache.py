"""Paged KV cache: a device block pool + per-sequence block tables
(port of ``ray_tpu/serve/llm/kv_cache.py``).

Layout (PagedAttention, Kwon et al. SOSP '23): the pool is ONE tensor on
the engine's device, in float32 as in the reference::

    pool[num_blocks, n_layer, 2, block_size, n_kv, head_dim]

Block-major: block ``i`` is one contiguous range.  The decode step reads
the whole pool through the block table (``ops/paged_attention.py``), and
prefill and decode write their K/V into it on the device.  The block
tables, fills and refcounts stay host-side lists.

The allocator hands out block indices (free list), tracks a block table
and a refcount per sequence, and frees in block grains — preemption
under cache pressure returns exactly the preempted sequence's blocks.
Shared blocks (``fork_seq``) are refcounted: ``free_seq`` returns a block
to the free list only at refcount zero.

The reference's shared-memory segment, its orphan reaping and the
block-transfer helpers wait for the data-plane slice of the port.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Union

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


class NoFreeBlocks(Exception):
    """Allocation failed: the pool is exhausted (caller should preempt)."""


Index = Union[int, Sequence[int], torch.Tensor]


class PagedKVCache:
    """Block pool + tables + refcounts for one engine instance."""

    def __init__(self, num_blocks: int, n_layer: int, block_size: int,
                 n_kv: int, head_dim: int, dtype=torch.float32,
                 device: DeviceLike = None):
        self.num_blocks = num_blocks
        self.block_shape = (n_layer, 2, block_size, n_kv, head_dim)
        self.block_size = block_size
        self.dtype = dtype
        self.device = resolve_device(device)     # None: the card
        self.pool = torch.zeros((num_blocks,) + self.block_shape,
                                dtype=dtype, device=self.device)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))  # guarded by: _lock
        self._tables: Dict[str, List[int]] = {}                      # guarded by: _lock
        self._fill: Dict[str, int] = {}                              # guarded by: _lock
        self._ref: Dict[int, int] = {}                               # guarded by: _lock

    # ------------------------------------------------------------ allocation
    def blocks_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))

    def free_block_count(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc_seq(self, seq_id: str, n_tokens: int) -> List[int]:
        """Allocate blocks for ``n_tokens`` of context; table starts full
        to ``n_tokens`` (prefill scatters into them immediately)."""
        n = self.blocks_needed(n_tokens)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            if len(self._free) < n:
                raise NoFreeBlocks(
                    f"need {n} blocks, {len(self._free)} free")
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._ref[b] = 1
            self._tables[seq_id] = blocks
            self._fill[seq_id] = n_tokens
        return blocks

    def append_slot(self, seq_id: str) -> tuple:
        """Reserve the next token slot for ``seq_id``.

        Returns (block_id, offset_in_block, grew); grows the table by
        one block at a block boundary (``grew`` True).  Raises
        NoFreeBlocks under cache pressure — the scheduler's preemption
        trigger.  A reservation whose decode step then fails must be
        returned with :meth:`rollback_slot` or every later slot is off
        by one."""
        with self._lock:
            fill = self._fill[seq_id]
            table = self._tables[seq_id]
            blk_i, off = divmod(fill, self.block_size)
            grew = False
            if blk_i == len(table):
                if not self._free:
                    raise NoFreeBlocks(f"pool exhausted growing {seq_id!r}")
                b = self._free.pop()
                self._ref[b] = 1
                table.append(b)
                grew = True
            self._fill[seq_id] = fill + 1
            return table[blk_i], off, grew

    def rollback_slot(self, seq_id: str, grew: bool) -> None:
        """Undo one :meth:`append_slot` reservation (failed decode step)."""
        with self._lock:
            if seq_id not in self._fill:
                return                     # freed/preempted meanwhile
            self._fill[seq_id] -= 1
            if grew:
                b = self._tables[seq_id].pop()
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    del self._ref[b]
                    self._free.append(b)

    def free_seq(self, seq_id: str) -> int:
        """Release a sequence's blocks (refcounted); returns #freed."""
        with self._lock:
            blocks = self._tables.pop(seq_id, None)
            self._fill.pop(seq_id, None)
            if not blocks:
                return 0
            freed = 0
            for b in blocks:
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    del self._ref[b]
                    self._free.append(b)
                    freed += 1
            return freed

    def fork_seq(self, seq_id: str, new_seq_id: str) -> None:
        """Share a sequence's blocks with a new id (refcount bump) —
        the prefix-sharing primitive."""
        with self._lock:
            blocks = list(self._tables[seq_id])
            for b in blocks:
                self._ref[b] += 1
            self._tables[new_seq_id] = blocks
            self._fill[new_seq_id] = self._fill[seq_id]

    # ------------------------------------------------------------- accessors
    def table(self, seq_id: str) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    def fill(self, seq_id: str) -> int:
        with self._lock:
            return self._fill[seq_id]

    # ------------------------------------------------------- device writes
    def scatter_prefill(self, seq_id: str, ks: torch.Tensor,
                        vs: torch.Tensor, n_tokens: int) -> None:
        """Write prefill KV (L, T_pad, KV, D) into the seq's blocks (only
        the first ``n_tokens`` positions are real): one indexed write
        each for K and V, on the device."""
        table = self.table(seq_id)
        pos = torch.arange(n_tokens)
        blk = torch.tensor(table, dtype=torch.long)[pos // self.block_size]
        off = pos % self.block_size
        self._write(blk, off, ks[:, :n_tokens], vs[:, :n_tokens])

    def write_token(self, block_id: Index, offset: Index, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Write decoded tokens' K/V into their slots: one token's
        (L, KV, D) at a scalar (block_id, offset), or a batch's
        (L, B, KV, D) at (B,) block ids and offsets."""
        blk = torch.as_tensor(block_id, dtype=torch.long).reshape(-1)
        off = torch.as_tensor(offset, dtype=torch.long).reshape(-1)
        if k.dim() == 3:
            k, v = k[:, None], v[:, None]
        self._write(blk, off, k, v)

    def _write(self, blk: torch.Tensor, off: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
        # pool[:, :, j] is (N, L, bs, KV, D); indexing blocks and offsets
        # (around the layer slice) puts the token axis first: (n, L, KV, D)
        blk = blk.to(self.device)
        off = off.to(self.device)
        self.pool[:, :, 0][blk, :, off] = k.transpose(0, 1).to(self.dtype)
        self.pool[:, :, 1][blk, :, off] = v.transpose(0, 1).to(self.dtype)

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        """Drop the pool (idempotent)."""
        self.pool = None
