"""Continuous-batching serving engine over the paged KV cache.

Requests queue up; each engine step (1) admits pending requests while pages
remain (prefill builds their cache), (2) decodes one token for every active
sequence, (3) retires finished sequences and frees their pages. The
page-table indirection (the paper's Key-ValueOffset) is what makes
admission/eviction O(1) metadata ops rather than cache copies.

As in the reference engine, each active sequence keeps its own contiguous
cache and is decoded with its own ``decode_step`` call at B=1; the
``PagedKVCache`` does the page bookkeeping. On a CUDA device, prefill
attention runs the flash kernel and decode attention the paged-decode
kernel (over an identity-page view of the contiguous cache); an ssm model's
prefill runs the SSD chunk kernels, a hybrid model's the RG-LRU kernel.
The audio model (whisper) is prefilled with no frame embeddings, so it
encodes zero frames, as the reference engine's call does; its cache holds
the decoder's self K/V (``k``/``v``, max_len slots), the cross K/V over the
encoder's output (``ck``/``cv``, enc_len slots: 55 MB a sequence for
whisper-small in bf16) and ``length``, and decode attends over both.
Prefill runs the prompt alone (B = 1, ``pad_to`` pads only the cache), so
in a MoE model no pad token takes an expert's capacity.

Models whose cache is not a per-position K/V cache run unchanged: an
attention-free model (``n_heads == n_kv_heads == 0``, e.g. mamba2) keeps its
recurrent state, and a hybrid model (recurrentgemma) keeps conv tails,
RG-LRU states and ``window``-slot ring K/V buffers. The page arena is still
allocated for every layer, as the reference engine does, with
``n_kv_heads → max(n_kv_heads, 1)`` and ``head_dim → resolved_head_dim``
(``d_model // max(n_heads, 1)`` for mamba2; for recurrentgemma-9b at max
batch 4 and max_len 2112: 272 pages of 64 positions, K and V, 38 layers,
one kv head of 256, bf16, 677 MB by its shapes). For every model, these
and the attention models alike, that arena is bookkeeping only and is
never read.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .kv_cache import OutOfPages, PagedKVCache


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16
    submitted_at: float = field(default_factory=time.monotonic)
    tokens: list[int] = field(default_factory=list)
    first_token_at: float | None = None
    done_at: float | None = None


class ServingEngine:
    def __init__(self, model, max_batch: int = 8, max_len: int = 512, page_size: int = 64):
        cfg = model.cfg
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.kv = PagedKVCache(
            num_pages=max_batch * (max_len // page_size + 1) * 2,
            page_size=page_size,
            n_layers=cfg.n_layers,
            n_kv_heads=max(cfg.n_kv_heads, 1),
            head_dim=cfg.resolved_head_dim,
            max_pages_per_seq=max_len // page_size + 1,
            device=model.device,
        )
        self.pending: list[Request] = []
        self.active: dict[int, Request] = {}
        self.caches: dict[int, dict] = {}  # per-seq model cache (contiguous path)
        self.finished: list[Request] = []
        self.prefill_calls = 0
        self.decode_calls = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _tensor(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64), device=self.model.device)

    @torch.no_grad()
    def _admit(self) -> None:
        while self.pending and len(self.active) < self.max_batch:
            req = self.pending[0]
            try:
                self.kv.admit(req.req_id, len(req.prompt))
            except OutOfPages:
                break
            self.pending.pop(0)
            logits, cache = self.model.prefill(self._tensor(req.prompt)[None], pad_to=self.max_len)
            self.prefill_calls += 1
            req.tokens.append(int(torch.argmax(logits[0])))
            req.first_token_at = time.monotonic()
            self.kv.reserve(req.req_id, 1)
            self.active[req.req_id] = req
            self.caches[req.req_id] = cache

    def _retire(self, req: Request) -> None:
        req.done_at = time.monotonic()
        self.kv.release(req.req_id)
        self.caches.pop(req.req_id)
        self.active.pop(req.req_id)
        self.finished.append(req)

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration; returns number of tokens produced."""
        self._admit()
        if not self.active:
            return 0
        produced = 0
        for sid in list(self.active):
            req = self.active[sid]
            last = self._tensor([[req.tokens[-1]]])
            logits, cache = self.model.decode_step(self.caches[sid], last)
            self.decode_calls += 1
            self.caches[sid] = cache
            req.tokens.append(int(torch.argmax(logits[0])))
            produced += 1
            try:
                self.kv.reserve(sid, 1)
            except OutOfPages:
                self._retire(req)
                continue
            if len(req.tokens) >= req.max_new_tokens or int(cache["length"]) >= self.max_len - 1:
                self._retire(req)
        return produced

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.pending and not self.active:
                break
            self.step()
        return self.finished

    def metrics(self) -> dict:
        lat = [r.done_at - r.submitted_at for r in self.finished if r.done_at]
        ttft = [r.first_token_at - r.submitted_at for r in self.finished if r.first_token_at]
        toks = sum(len(r.tokens) for r in self.finished)
        return {
            "requests": len(self.finished),
            "tokens": toks,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "kv_utilization": self.kv.utilization(),
        }
