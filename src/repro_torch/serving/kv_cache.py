"""BVLSM-style paged KV cache.

The mapping onto the paper:

* page pool (P, page, K, hd) tensors = the **BValue arena** (big values),
* per-sequence page table (int32 page ids) = the **Key-ValueOffset**
  metadata — tiny, hot, and the only thing the scheduler mutates,
* allocator free-list = BValue file/offset reservation.

``kernels.ops.paged_decode`` consumes exactly these structures.

* ``HostPageCache`` = **BVCache**: a fixed-capacity host tier with MRWF
  admission, LRU eviction and pinning for pages whose write-back is pending,
* ``PageSpillStore`` = the durable tier below it: pages spill into an
  injected ``KVStore`` as big values.
"""
from __future__ import annotations

import io
from collections import OrderedDict
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


class HostPageCache:
    """BVCache for offloaded pages: MRWF admission, LRU eviction, pinning
    for pages whose host write-back hasn't completed."""

    def __init__(self, capacity_pages: int):
        self.capacity = capacity_pages
        self._map: OrderedDict[tuple, tuple[object, bool]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def put(self, key: tuple, page, pinned: bool = False) -> None:
        if key in self._map:
            self._map.pop(key)
        self._map[key] = (page, pinned)
        self._map.move_to_end(key)
        while len(self._map) > self.capacity:
            for k in list(self._map):
                if not self._map[k][1]:
                    self._map.pop(k)
                    break
            else:
                break  # everything pinned

    def unpin(self, key: tuple) -> None:
        if key in self._map:
            page, _ = self._map[key]
            self._map[key] = (page, False)

    def get(self, key: tuple):
        hit = self._map.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._map.move_to_end(key)
        return hit[0]


class PageSpillStore:
    """Durable tier below :class:`HostPageCache`: evicted pages spill into an
    injected ``KVStore`` (a ``DB`` or a ``ShardedDB``; the serving stack
    does not care). A KV page is the paper's big value, so spills ride the
    WAL-time separated value path; ``restore_many`` uses the store's batched
    ``multi_get``.

    Pages are ``.npy`` bytes (``np.save``: dtype and shape, no pickle), as
    the reference writes them. numpy has no bf16, so a bf16 page is written
    as opaque 2-byte ``|V2`` elements holding its bits, the format the
    reference writes for a JAX bf16 array, and every ``|V2`` page is read
    back as bf16. Pages are torch tensors or numpy arrays; restored pages
    are CPU tensors."""

    def __init__(self, store, prefix: bytes = b"kvpage/"):
        self.store = store
        self.prefix = prefix

    def _key(self, key: tuple) -> bytes:
        return self.prefix + "/".join(str(p) for p in key).encode()

    def spill(self, key: tuple, page) -> None:
        if isinstance(page, torch.Tensor):
            page = page.detach().cpu()
            if page.dtype == torch.bfloat16:
                page = page.view(torch.int16).numpy().view("V2")
            else:
                page = page.numpy()
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(page), allow_pickle=False)
        self.store.put(self._key(key), buf.getvalue())

    @staticmethod
    def _decode(raw: bytes) -> torch.Tensor:
        arr = np.load(io.BytesIO(raw), allow_pickle=False)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(arr)

    def restore(self, key: tuple) -> torch.Tensor | None:
        raw = self.store.get(self._key(key))
        return None if raw is None else self._decode(raw)

    def restore_many(self, keys: list[tuple]) -> list[torch.Tensor | None]:
        raws = self.store.multi_get([self._key(k) for k in keys])
        return [None if r is None else self._decode(r) for r in raws]
