"""The port's BVLSM checkpoint store, manager and MessagePack codec over the
reference's storage engine (``repro.core.DB`` and a 3-shard ``ShardedDB``,
injected) and over its own (``BVCheckpointStore(path)``), checkpoints
restored across the two packages, on disk too, online backups, and
the elastic restore onto a 4-rank gloo mesh against the reference's on 4 host
devices."""
import dataclasses
import textwrap
import threading

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.bvstore import BVCheckpointStore as RefStore
from repro.configs import get_config as ref_get_config
from repro.core import DB, DBConfig, ShardedDB
from repro.training.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.training.train_step import TrainConfig as RefTrainConfig
from repro.training.trainer import Trainer as RefTrainer
from repro.training.trainer import TrainerConfig as RefTrainerConfig
from repro_torch import _msgpack
from repro_torch import core as port_core
from repro_torch.checkpoint.bvstore import BVCheckpointStore
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import state_to_jax, tensor_to_numpy
from repro_torch.models import build_model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, init_state
from repro_torch.training.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves_with_paths, tree_map

torch.set_num_threads(1)

TOL = 2e-5  # fp32, tests/test_kernels.py::_tol
CFG = dict(d_model=64, n_layers=2, vocab=512, vocab_pad_multiple=64, dtype="float32")  # tests/test_trainer.py's, fp32


def _cfg() -> DBConfig:  # tests/test_api.py's
    return DBConfig.bvlsm(value_threshold=256, memtable_size=256 << 10, num_bvalue_queues=2,
                          block_cache_bytes=1 << 20, bvcache_bytes=1 << 20)


def _open(kind, path):
    return DB.open(path, _cfg()) if kind == "db" else ShardedDB.open(path, shards=3, config=_cfg())


@pytest.fixture(params=["db", "sharded"])
def kv(request, tmp_path):
    path = str(tmp_path / "store")
    s = _open(request.param, path)
    yield s
    s.close()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w1": torch.randn(64, 128, generator=g), "emb": torch.randn(1000, 32, generator=g),
                   "half": torch.randn(3, 40, generator=g).bfloat16()},
        "opt": {"m": torch.zeros(64, 128), "count": torch.tensor(3, dtype=torch.int32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _equal(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

CODEC_CASES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, 1.5, -0.0, 1e300,
    "", "a" * 31, "é" * 40, "x" * 300, "y" * 70000, b"", b"\x00" * 300, b"z" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)), {}, {str(i): i for i in range(16)},
    {"step": 12, "time": 1.7e9, "manifest": [{"path": "['params']['w']", "shape": [64, 128], "dtype": "float32",
                                              "chunks": 1, "hash": "ab" * 16, "reuse_step": 3}],
     "extra": {"pipeline": {"seed": 0, "step": 12, "host": 0, "num_hosts": 1}}, "reused_tensors": 1},
]


@pytest.mark.parametrize("obj", CODEC_CASES, ids=lambda o: type(o).__name__ + str(len(str(o))))
def test_msgpack_codec_matches_msgpack_both_ways(obj):
    ours = _msgpack.packb(obj)
    theirs = msgpack.packb(obj, use_bin_type=True)
    assert ours == theirs
    assert msgpack.unpackb(ours, raw=False) == obj or obj != obj
    assert _msgpack.unpackb(theirs) == msgpack.unpackb(theirs, raw=False)


def test_msgpack_codec_reads_float32():
    raw = msgpack.packb(np.float32(1.25).item(), use_single_float=True)
    assert raw[0] == 0xCA and _msgpack.unpackb(raw) == 1.25


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_save_load_roundtrip_with_bf16(kv):
    store = BVCheckpointStore(db=kv)
    st = _state()
    store.save(10, st, {"pipeline": {"step": 10, "seed": 0}})
    out, meta = store.load(template=st)
    assert meta["step"] == 10 and meta["extra"]["pipeline"] == {"step": 10, "seed": 0}
    _equal(st, out)
    flat, _ = store.load(10)
    assert set(flat) == {p for p, _ in leaves_with_paths(st)} and flat["['params']['half']"].dtype == torch.bfloat16
    # the reference reads the port's checkpoint, bf16 included
    ref, ref_meta = RefStore("unused", db=kv).load(10)
    assert ref_meta["manifest"] == meta["manifest"]
    for path, t in leaves_with_paths(st):
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(ref[path].view(np.int16) if t.dtype == torch.bfloat16 else ref[path],
                                      bits.numpy())


def test_latest_and_multiple_steps(kv):
    store = BVCheckpointStore(db=kv)
    for s in (5, 10, 15):
        store.save(s, _state(s))
    assert store.steps() == [5, 10, 15] and store.latest_step() == 15
    out, meta = store.load(10, template=_state())
    assert meta["step"] == 10
    _equal(_state(10), out)


def test_incremental_reuse_and_retention(kv):
    store = BVCheckpointStore(db=kv)
    mgr = CheckpointManager(store, interval_steps=1, keep_last=2, async_save=False)
    st = _state()
    for s in range(1, 6):
        st["step"] = torch.tensor(s, dtype=torch.int32)
        mgr.save_now(s, st)
    meta = store.load_meta(5)
    reused = {e["path"]: e["reuse_step"] for e in meta["manifest"] if "reuse_step" in e}
    assert reused and set(reused.values()) == {1}  # unchanged tensors point at their writer
    assert "['step']" not in reused
    assert store.steps() == [1, 4, 5]  # step 1 kept: steps 4 and 5 reuse its chunks
    out, _ = store.load(5, template=st)
    _equal(st, out)


def test_delete_step_uses_range_tombstone(kv):
    store = BVCheckpointStore(db=kv)
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    for step in (1, 2, 3):
        store.save(step, state)
    store.delete_step(1)
    assert store.steps() == [2, 3] and kv.get(store._chunk_key(1, "['w']", 0)) is None
    with pytest.raises(KeyError):
        store.delete_step(99)


@pytest.mark.parametrize("kind", ["db", "sharded"])
def test_crash_before_meta_leaves_no_checkpoint(tmp_path, kind):
    path = str(tmp_path / "ck")
    store = BVCheckpointStore(db=_open(kind, path))
    st = _state()
    store.save(1, st)
    # a crash mid-save of step 2: chunks written, no META
    store.db.put(store._chunk_key(2, "['params']['w1']", 0), (st["params"]["w1"] + 1).numpy().tobytes())
    store.db.close(crash=True)
    store2 = BVCheckpointStore(db=_open(kind, path))
    try:
        assert store2.latest_step() == 1
        out, _ = store2.load(template=st)
        _equal(st, out)
    finally:
        store2.close()


class _HeldStore:
    """A KVStore whose chunk writes wait until ``release`` is set: the save
    thread cannot read the state before the test has updated it."""

    def __init__(self, db):
        self.db, self.release = db, threading.Event()

    def put(self, key, value):
        self.release.wait(30)
        self.db.put(key, value)

    def __getattr__(self, name):
        return getattr(self.db, name)


def test_async_snapshot_isolated_from_in_place_update(kv):
    held = _HeldStore(kv)
    mgr = CheckpointManager(BVCheckpointStore(db=held), interval_steps=1, async_save=True)
    st = _state()
    before = {p: t.clone() for p, t in leaves_with_paths(st)}
    mgr.save_now(1, st)
    for t in (st["params"]["w1"], st["params"]["half"], st["opt"]["m"]):
        t.add_(1)  # the optimizer's next in-place update
    held.release.set()
    mgr.wait()
    out, _ = BVCheckpointStore(db=kv).load(1)
    for path, t in before.items():
        assert torch.equal(out[path], t), path


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _ref_tcfg(path, steps):
    return RefTrainerConfig(steps=steps, global_batch=2, seq_len=32, ckpt_dir=path, ckpt_interval=100,
                            ckpt_async=False, log_every=10_000,
                            train=RefTrainConfig(opt=RefOptimizerConfig(warmup_steps=2, total_steps=100)))


def _tcfg(steps):
    return TrainerConfig(steps=steps, global_batch=2, seq_len=32, ckpt_interval=100, ckpt_async=False,
                         log_every=10_000, train=TrainConfig(opt=OptimizerConfig(warmup_steps=2, total_steps=100)))


def _ref_run(path, steps):
    tr = RefTrainer(ref_get_config("llama3-8b").reduced(**CFG), _ref_tcfg(path, steps))
    res = tr.run()
    state = jax.device_get(tr.state)
    tr.close()
    return res, state


def _port_run(kv, steps):
    tr = Trainer(get_config("llama3-8b").reduced(**CFG), _tcfg(steps), kv, device="cpu")
    res = tr.run()
    state = state_to_jax(tr.state)
    tr.close()
    return res, state


def _close_states(ref_state, port_state):
    got = dict(leaves_with_paths(port_state))
    flat = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    assert {jax.tree_util.keystr(p) for p, _ in flat} == set(got)
    for path, r in flat:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)], r, atol=TOL, rtol=0)


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """The JAX trainer writes steps 1–3; the port resumes from its store and
    takes step 4, which matches the JAX trainer's own step 4."""
    _ref_run(str(tmp_path / "a"), 3)
    ref4, ref_state = _ref_run(str(tmp_path / "b"), 4)
    db = RefStore(str(tmp_path / "a")).db  # the reference's engine settings
    res, state = _port_run(db, 4)
    assert res["step"] == 4 and [m["step"] for m in res["metrics"]] == [4]
    np.testing.assert_allclose(res["metrics"][0]["loss"], ref4["metrics"][3]["loss"], atol=TOL, rtol=0)
    _close_states(ref_state, state)


def test_port_checkpoint_resumes_in_reference(tmp_path):
    """The port writes steps 1–3; the JAX trainer resumes from the store and
    takes step 4, which matches the port's own step 4."""
    _port_run(RefStore(str(tmp_path / "a")).db, 3)
    port4, port_state = _port_run(RefStore(str(tmp_path / "b")).db, 4)
    res, ref_state = _ref_run(str(tmp_path / "a"), 4)
    assert res["step"] == 4 and [m["step"] for m in res["metrics"]] == [4]
    np.testing.assert_allclose(res["metrics"][0]["loss"], port4["metrics"][3]["loss"], atol=TOL, rtol=0)
    _close_states(ref_state, port_state)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_on_disk_restores_bit_equal_across_packages(tmp_path, writer):
    """``BVCheckpointStore(path)`` of either package opens its own engine at
    ``path``, the port's with every field of the reference's config; a
    reduced qwen3-4b train state (fp32 parameters, AdamW moments, the int32
    step) and a bf16 leaf, saved by one package, load bit-equal in the
    other."""
    import ml_dtypes

    model = build_model(get_config("qwen3-4b").reduced(dtype="float32"), "cpu")
    state = init_state(model, torch.Generator().manual_seed(0), OptimizerConfig())
    state = {**state, "bf16": torch.randn(3, 40, generator=torch.Generator().manual_seed(1)).bfloat16()}
    path = str(tmp_path / "ck")
    extra = {"pipeline": {"seed": 0, "step": 3, "host": 0, "num_hosts": 1}}
    if writer == "port":
        store = BVCheckpointStore(path)
        assert isinstance(store.db, port_core.DB)
        port_cfg = _fields(store.db.cfg)
        store.save(3, state, extra)
        store.close()
        ref = RefStore(path)
        try:
            assert _fields(ref.db.cfg) == port_cfg
            got, meta = ref.load(3)
        finally:
            ref.close()
        assert meta["extra"] == extra
        for p, t in leaves_with_paths(state):
            want = tensor_to_numpy(t)
            assert got[p].dtype.itemsize == want.dtype.itemsize and got[p].shape == want.shape, p
            np.testing.assert_array_equal(got[p].view(want.dtype), want, err_msg=p)
    else:
        tree = tree_map(tensor_to_numpy, state)
        tree["bf16"] = tree["bf16"].view(ml_dtypes.bfloat16)
        ref = RefStore(path)
        ref.save(3, tree, extra)
        ref_cfg = _fields(ref.db.cfg)
        ref.close()
        store = BVCheckpointStore(path)
        try:
            assert isinstance(store.db, port_core.DB) and _fields(store.db.cfg) == ref_cfg
            out, meta = store.load(3, template=state)
        finally:
            store.close()
        assert meta["extra"] == extra
        _equal(state, out)


# ---------------------------------------------------------------------------
# online backup, and the elastic restore onto a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["db", "sharded"])
def test_backup_image_opens_as_a_store(tmp_path, kind):
    """``backup`` through the injected engine's ``checkpoint``: a store opened
    on the image reads back every checkpoint committed before it, bit for
    bit, and none written or deleted on the source after it."""
    store = BVCheckpointStore(db=_open(kind, str(tmp_path / "store")))
    for s in (10, 20):
        store.save(s, _state(s))
    assert store.backup(str(tmp_path / "bak")) == str(tmp_path / "bak")
    store.save(30, _state(30))
    store.delete_step(10)
    assert store.steps() == [20, 30]
    store.close()
    bak = BVCheckpointStore(db=_open(kind, str(tmp_path / "bak")))
    try:
        assert bak.steps() == [10, 20]
        for s in (10, 20):
            out, meta = bak.load(s, template=_state())
            assert meta["step"] == s
            _equal(_state(s), out)
    finally:
        bak.close()


def test_incremental_backup_links_from_its_base(tmp_path):
    """``base``: the second image is taken against the first (a single
    ``DB``'s incremental checkpoint) and holds both steps."""
    store = BVCheckpointStore(db=_open("db", str(tmp_path / "store")))
    store.save(1, _state(1))
    store.backup(str(tmp_path / "b1"))
    store.save(2, _state(2))
    store.backup(str(tmp_path / "b2"), base=str(tmp_path / "b1"))
    store.close()
    for image, steps in (("b1", [1]), ("b2", [1, 2])):
        bak = BVCheckpointStore(db=_open("db", str(tmp_path / image)))
        try:
            assert bak.steps() == steps
            for s in steps:
                _equal(_state(s), bak.load(s, template=_state())[0])
        finally:
            bak.close()


LOAD_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from repro.checkpoint.bvstore import BVCheckpointStore
    from repro.configs import get_config
    from repro.core import DB, DBConfig
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model

    d = sys.argv[1]
    cfg = DBConfig.bvlsm(value_threshold=256, memtable_size=256 << 10, num_bvalue_queues=2,
                         block_cache_bytes=1 << 20, bvcache_bytes=1 << 20)
    store = BVCheckpointStore("unused", db=DB.open(os.path.join(d, "ref_image"), cfg))
    model = build_model(get_config("qwen3-4b").reduced(dtype="float32"))
    template = jax.eval_shape(model.init, jax.random.key(0))
    mesh = make_host_mesh((2, 2))
    state, meta = store.load_distributed(mesh, template, model.param_axes())
    out = {}
    for path, arr in jax.tree_util.tree_flatten_with_path(state)[0]:
        for s in arr.addressable_shards:  # mesh position (i, j) is torch rank 2 i + j
            (i, j), = np.argwhere(mesh.devices == s.device)
            out[f"{jax.tree_util.keystr(path)}@{2 * i + j}"] = np.asarray(s.data)
    np.savez(os.path.join(d, "ref_shards.npz"), **out)
    store.close()
""")

LOAD_PORT = textwrap.dedent("""
    import os, sys
    import numpy as np, torch, torch.distributed as dist
    rank, d = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "rendezvous"), rank=rank, world_size=4)
    from repro.core import DB, DBConfig
    from repro_torch import dist as rdist
    from repro_torch.checkpoint.bvstore import BVCheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.convert import param_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import leaves_with_paths

    cfg = DBConfig.bvlsm(value_threshold=256, memtable_size=256 << 10, num_bvalue_queues=2,
                         block_cache_bytes=1 << 20, bvcache_bytes=1 << 20)
    store = BVCheckpointStore(db=DB.open(os.path.join(d, f"image{rank}"), cfg))
    model = build_model(get_config("qwen3-4b").reduced(dtype="float32"), "meta")
    mesh = make_host_mesh((2, 2), ("data", "model"), "cpu")
    state, meta = store.load_distributed(mesh, param_tree(model), model.param_axes())
    assert all(rdist.is_dtensor(t) for _, t in leaves_with_paths(state)) and meta["step"] == 7
    np.savez(os.path.join(d, f"port_shards{rank}.npz"),
             **{path: t.to_local().numpy() for path, t in leaves_with_paths(state)})
    store.close()
    dist.destroy_process_group()
""")


def test_load_distributed_matches_reference_on_4_ranks(tmp_path):
    """A reduced qwen3-4b parameter tree saved by the port, restored onto a
    (2, 2) mesh: by the reference's ``load_distributed`` on 4 host devices
    (one subprocess), and by the port's on 4 gloo ranks (a backup image of
    the store each): every rank's local shard of every leaf equals the
    reference's shard on the device at the same mesh position."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.convert import param_tree
    from repro_torch.models import build_model

    model = build_model(get_config("qwen3-4b").reduced(dtype="float32"), "cpu").init(torch.Generator().manual_seed(0))
    store = BVCheckpointStore(db=_open("db", str(tmp_path / "store")))
    store.save(7, param_tree(model))
    for image in ["ref_image"] + [f"image{r}" for r in range(4)]:
        store.backup(str(tmp_path / image))
    store.close()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", LOAD_REF, str(tmp_path)], capture_output=True, text=True, env=env,
                         cwd=str(root), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    procs = [subprocess.Popen([sys.executable, "-c", LOAD_PORT, str(r), str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=str(root)) for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    ref = dict(np.load(tmp_path / "ref_shards.npz"))
    paths = {p for p, _ in leaves_with_paths(param_tree(model))}
    assert {k.split("@")[0] for k in ref} == paths
    for r in range(4):
        port = dict(np.load(tmp_path / f"port_shards{r}.npz"))
        assert set(port) == paths
        for path in paths:
            np.testing.assert_array_equal(port[path], ref[f"{path}@{r}"], err_msg=f"rank {r} {path}")
    sharded = [p for p in paths if ref[f"{p}@0"].shape != tuple(dict(leaves_with_paths(param_tree(model)))[p].shape)]
    assert len(sharded) >= 5  # the rules split most leaves over data or model
