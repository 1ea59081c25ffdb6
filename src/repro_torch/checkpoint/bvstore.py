"""BVLSM-backed checkpoint store: the paper's WAL-time separation applied to
training state, as the reference's ``checkpoint/bvstore.py``.

* **big values** = tensor chunks (4 MiB) under ``ckpt/<step>/t<path>/c<i>``,
  which a BVLSM engine routes to its BValue queues;
* **lightweight metadata** = the META record under ``meta/<step>`` (the
  manifest of paths, shapes, dtypes, chunk counts and content hashes, the
  step, and ``extra`` such as the data-pipeline cursor), WAL-committed.

Commit protocol: chunks → value barrier → META → flush. A checkpoint exists
iff its META record is durable, so a crash mid-save leaves only unreferenced
chunks. Incremental saves point a tensor whose hash matches the previous
save at the step that wrote its chunks (``reuse_step``).

The port has no storage engine of its own: the store is injected, any
object with the ``KVStore`` surface it uses (``put``/``get``/``range``/
``delete``/``delete_range``/``flush``/``close``), such as the reference's
``repro.core.DB`` or ``ShardedDB``. Keys, chunking, leaf paths
(``jax.tree_util.keystr``) and META (MessagePack, written by
:mod:`._msgpack`) are the reference's, so either package restores the
other's checkpoints. Leaves are torch tensors or numpy arrays; bf16 crosses
as its uint16 bits under the dtype name ``bfloat16``. Not ported:
``backup`` and ``load_distributed``.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, tree_map_with_path
from . import _msgpack

CHUNK = 4 << 20  # 4 MiB value chunks

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
                 "int8": torch.int8, "int16": torch.int16, "bool": torch.bool}


def _host_bytes(leaf) -> tuple[np.ndarray, str]:
    """(a C-contiguous uint8 view of the leaf's bytes on the host, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    else:
        arr = np.ascontiguousarray(leaf)
        name = str(arr.dtype)
    return arr.reshape(-1).view(np.uint8), name


class BVCheckpointStore:
    def __init__(self, db):
        """``db``: the injected ``KVStore``. The store takes ownership:
        :meth:`close` closes it."""
        self.db = db

    def _value_barrier(self) -> None:
        """Every chunk durable before a META record commits: per-queue BValue
        flushes on a BVLSM engine (``DB``, or each shard of a ``ShardedDB``),
        a full flush on any other store."""
        engines = getattr(self.db, "shards", None)
        if engines is None:
            engines = [self.db]
        if all(hasattr(e, "bvalue") for e in engines):
            for e in engines:
                e.bvalue.flush()
        else:
            self.db.flush()

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, step: int, state, extra_meta: dict | None = None, prev_hashes: dict | None = None) -> dict:
        """Returns ``{path: (content_hash, src_step)}`` for the next
        incremental save; ``src_step`` is where the chunks physically live."""
        manifest = []
        hashes: dict[str, tuple] = {}
        reused = 0
        for path, leaf in leaves_with_paths(state):
            buf, dtype = _host_bytes(leaf)
            h = hashlib.blake2b(buf, digest_size=16).hexdigest()
            entry = {"path": path, "shape": list(leaf.shape), "dtype": dtype,
                     "chunks": max(1, -(-buf.size // CHUNK)), "hash": h}
            prev = prev_hashes.get(path) if prev_hashes else None
            if prev is not None and prev[0] == h:
                entry["reuse_step"] = prev[1]  # the original writer's step
                hashes[path] = (h, prev[1])
                reused += 1
            else:
                for ci in range(entry["chunks"]):
                    self.db.put(self._chunk_key(step, path, ci), buf[ci * CHUNK:(ci + 1) * CHUNK].tobytes())
                hashes[path] = (h, step)
            manifest.append(entry)
        self._value_barrier()
        meta = {"step": step, "time": time.time(), "manifest": manifest, "extra": extra_meta or {},
                "reused_tensors": reused}
        self.db.put(self._meta_key(step), _msgpack.packb(meta))
        self.db.flush()
        return hashes

    def _chunk_key(self, step: int, path: str, ci: int) -> bytes:
        return f"ckpt/{step:012d}/t{path}/c{ci:05d}".encode()

    def _meta_key(self, step: int) -> bytes:
        return f"meta/{step:012d}".encode()

    # ------------------------------------------------------------------
    # load
    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(k[5:]) for k, _ in self.db.range(b"meta/", end=b"meta0"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def load_meta(self, step: int) -> dict:
        raw = self.db.get(self._meta_key(step))
        if raw is None:
            raise KeyError(f"no checkpoint at step {step}")
        return _msgpack.unpackb(raw)

    def load(self, step: int | None = None, template=None):
        """Returns (state, meta): with ``template`` (a tree of tensors, on any
        device, meta included) the state is a tree of CPU tensors of the
        same structure; otherwise a ``{path: tensor}`` dict."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise KeyError("no checkpoints")
        meta = self.load_meta(step)
        tensors: dict[str, torch.Tensor] = {}
        for ent in meta["manifest"]:
            src_step = ent.get("reuse_step", step)
            parts = []
            for ci in range(ent["chunks"]):
                buf = self.db.get(self._chunk_key(src_step, ent["path"], ci))
                if buf is None:
                    raise IOError(f"missing chunk {ent['path']}#{ci} @ step {src_step}")
                parts.append(buf)
            raw = bytearray().join(parts)
            dtype = _TORCH_DTYPES[ent["dtype"]]
            bits = torch.int16 if dtype == torch.bfloat16 else dtype
            t = torch.frombuffer(raw, dtype=bits) if raw else torch.empty(0, dtype=bits)
            tensors[ent["path"]] = t.view(dtype).reshape(ent["shape"])
        if template is None:
            return tensors, meta
        return tree_map_with_path(lambda path, _: tensors[path], template), meta

    # ------------------------------------------------------------------
    # retention
    # ------------------------------------------------------------------
    def delete_step(self, step: int) -> None:
        self.load_meta(step)  # raises KeyError if the step does not exist
        # one range tombstone covers every chunk the step physically owns
        # (reused chunks live under their writer's prefix, outside the range)
        prefix = f"ckpt/{step:012d}/".encode()
        self.db.delete_range(prefix, prefix + b"\xff")
        self.db.delete(self._meta_key(step))

    def close(self) -> None:
        self.db.close()

