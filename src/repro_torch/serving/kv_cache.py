"""BVLSM-style paged KV cache.

The mapping onto the paper:

* page pool (P, page, K, hd) tensors = the **BValue arena** (big values),
* per-sequence page table (int32 page ids) = the **Key-ValueOffset**
  metadata — tiny, hot, and the only thing the scheduler mutates,
* allocator free-list = BValue file/offset reservation.

``kernels.ops.paged_decode`` consumes exactly these structures. The host
page cache and the spill into a key-value store come with the training-state
slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device


class OutOfPages(RuntimeError):
    pass


@dataclass
class SeqInfo:
    seq_id: int
    length: int = 0
    pages: list[int] = field(default_factory=list)


class PagedKVCache:
    def __init__(
        self,
        num_pages: int,
        page_size: int,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        max_pages_per_seq: int,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        dev = resolve_device(device)
        # one arena per layer: (P, page, K, hd)
        shape = (num_pages, page_size, n_kv_heads, head_dim)
        self.pages_k = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n_layers)]
        self.pages_v = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n_layers)]
        self.free: list[int] = list(range(num_pages - 1, -1, -1))
        self.seqs: dict[int, SeqInfo] = {}

    # -- allocator (the ValueOffset reservation) ---------------------------
    def admit(self, seq_id: int, prompt_len: int = 0) -> SeqInfo:
        info = SeqInfo(seq_id)
        self.seqs[seq_id] = info
        if prompt_len:
            self.reserve(seq_id, prompt_len)
        return info

    def reserve(self, seq_id: int, new_tokens: int) -> list[int]:
        info = self.seqs[seq_id]
        need_pages = -(-(info.length + new_tokens) // self.page_size) - len(info.pages)
        newly = []
        for _ in range(need_pages):
            if not self.free:
                raise OutOfPages(f"seq {seq_id}: arena exhausted")
            if len(info.pages) >= self.max_pages_per_seq:
                raise OutOfPages(f"seq {seq_id}: page-table overflow")
            pid = self.free.pop()
            info.pages.append(pid)
            newly.append(pid)
        info.length += new_tokens
        return newly

    def release(self, seq_id: int) -> None:
        info = self.seqs.pop(seq_id)
        self.free.extend(info.pages)

    # -- batch views for the kernels --------------------------------------
    def page_table(self, seq_ids: list[int]) -> np.ndarray:
        table = np.zeros((len(seq_ids), self.max_pages_per_seq), np.int32)
        for row, sid in enumerate(seq_ids):
            pages = self.seqs[sid].pages
            table[row, : len(pages)] = pages
        return table

    def lengths(self, seq_ids: list[int]) -> np.ndarray:
        return np.array([self.seqs[s].length for s in seq_ids], np.int32)

    # -- writes (the BValue put) -------------------------------------------
    def write_token(self, layer: int, seq_ids: list[int], k: torch.Tensor, v: torch.Tensor) -> None:
        """k/v: (B, K, hd) for the token just computed (position = length-1).
        Writes into the arena in place."""
        pk, pv = self.pages_k[layer], self.pages_v[layer]
        for row, sid in enumerate(seq_ids):
            info = self.seqs[sid]
            pos = info.length - 1
            pid = info.pages[pos // self.page_size]
            off = pos % self.page_size
            pk[pid, off] = k[row]
            pv[pid, off] = v[row]

    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.num_pages
