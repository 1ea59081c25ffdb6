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

By default the store opens the port's engine (:class:`repro_torch.core.DB`)
at ``path`` with the reference's settings; ``db=`` injects any object with
the ``KVStore`` surface it uses (``put``/``get``/``range``/``delete``/
``delete_range``/``flush``/``close``), such as the port's
``ShardedDB`` or a replicated ``DB``, or the reference's ``repro.core.DB``
in tests. Keys, chunking, leaf paths
(``jax.tree_util.keystr``), META (MessagePack, written by
:mod:`repro_torch._msgpack`) and the engine's files are the reference's, so
either package restores the other's checkpoints. Leaves are torch tensors
or numpy arrays; bf16 crosses as its uint16 bits under the dtype name
``bfloat16``. :meth:`load_distributed` re-shards a loaded state onto a
``DeviceMesh``; :meth:`backup` asks the store's engine for an online image
of itself (``checkpoint``).
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from repro_torch import _msgpack
from repro_torch.core import DB, DBConfig
from repro_torch.tree import leaves_with_paths, tree_map, tree_map_with_path

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


def store_config(num_queues: int = 4, sync_values: bool = False, env=None) -> DBConfig:
    """The engine config the store opens at a path, as the reference's: a
    synchronous WAL for META, values of 4 KiB and more to ``num_queues``
    BValue queues, ``sync_values`` as ``DBConfig.sync_flush_io``, and ``env``
    the filesystem (fault-injection tests). An engine made for injection
    (a ``ShardedDB``, a replicated pair) takes the same config from here."""
    cfg = DBConfig.bvlsm(wal_mode="sync", value_threshold=4096, num_bvalue_queues=num_queues,
                         memtable_size=4 << 20, bvcache_bytes=16 << 20)
    cfg.sync_flush_io = sync_values
    cfg.env = env
    return cfg


class BVCheckpointStore:
    def __init__(self, path: str | None = None, num_queues: int = 4, sync_values: bool = False, env=None,
                 db=None):
        """``db`` injects any ``KVStore`` (a ``DB`` or a ``ShardedDB``): the
        store takes ownership (:meth:`close` closes it), and ``path``,
        ``num_queues``, ``sync_values`` and ``env`` are ignored. Default: a
        single engine at ``path`` with :func:`store_config`'s config."""
        if db is not None:
            self.db = db
            return
        if path is None:
            raise ValueError("BVCheckpointStore needs a path or an injected db")
        self.db = DB.open(path, store_config(num_queues, sync_values, env))

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

    def load_distributed(self, mesh, template, axes_tree, step: int | None = None):
        """Elastic restore: load the state and place it on ``mesh`` (a
        ``DeviceMesh``, which may differ from the one the checkpoint was
        written on) by the logical axes of the parallel ``axes_tree``: every
        rank reads the whole leaf and keeps its shard
        (:func:`repro_torch.dist.distribute_tree`), on the mesh's device
        type. Returns (state of DTensors, meta)."""
        from repro_torch.dist import distribute_tree

        state, meta = self.load(step, template=template)
        state = tree_map(lambda t: t.to(mesh.device_type), state)
        return distribute_tree(state, mesh, axes_tree), meta

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

    # ------------------------------------------------------------------
    # online backup
    # ------------------------------------------------------------------
    def backup(self, directory: str, base: str | None = None) -> str:
        """An online, crash-consistent image of the whole store in
        ``directory`` (the store's ``checkpoint``, e.g. ``DB.checkpoint``,
        which hard-links its files): every committed training checkpoint,
        openable as a store of its own, without pausing in-flight saves.
        ``base`` (a previous backup directory) makes the image incremental,
        where the store supports it (a single ``DB``). Returns
        ``directory``."""
        if base is None:
            self.db.checkpoint(directory)
        else:
            self.db.checkpoint(directory, base=base)
        return directory

    def stats(self) -> dict:
        return self.db.stats()

    def close(self) -> None:
        self.db.close()

