"""The port's trainer under a mesh against the reference's ``Trainer(mesh=…)``.

One subprocess runs the reference's trainer on a (2, 2) ``make_host_mesh``
of 4 forced host devices (``XLA_FLAGS``); four more run the port's as 4 gloo
ranks on (2, 2), (4, 1) and (1, 4) ``DeviceMesh``es (rendezvous through a
file); then the reference once more, resuming from what the port wrote.
Every family, ``.reduced()``, fp32, a global batch of 4 × 32, AdamW (one
dense case with Adafactor at widths where its factored moments are sharded,
one with 2 microbatches, qwen2-moe also under §Perf V2). Each case:

(a) every state leaf is placed by the reference's ``tree_shardings`` spec,
    each rank's local shape its shard's;
(b) from the store the reference wrote at step 3, the port's step 4 on each
    mesh shape equals the reference's uninterrupted step 4 (loss, grad
    norm, the gathered state);
(c) the port's run under the mesh from its own seed equals its run without
    one, step by step;
(d) the checkpoint the port writes under the mesh at step 3 resumes in the
    reference's trainer, whose step 4 equals the port's own (the families);
(g) only global rank 0 opens a store directory.

And a SIGTERM to one rank stops all four at the same step, whose committed
checkpoint resumes to the uninterrupted run's state. In this process: a
mesh without a process group, a device that is not the mesh's, and a train
step whose parameters are not placed on the active mesh all raise.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.bvstore import BVCheckpointStore
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig, init_state, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5  # tests/test_kernels.py::_tol, fp32
RUN_TIMEOUT_S = 600
FAMILIES = ("llama3-8b", "qwen2-moe-a2.7b", "granite-moe-1b-a400m", "mamba2-1.3b", "recurrentgemma-9b",
            "whisper-small")
# case: (arch, overrides of ``reduced``, optimizer, microbatches, §Perf V2)
CASES = {**{arch: (arch, {}, "adamw", 1, False) for arch in FAMILIES},
         "llama3-8b adafactor": ("llama3-8b", {"d_model": 128, "n_heads": 8, "head_dim": 16}, "adafactor", 1, False),
         "llama3-8b accum 2": ("llama3-8b", {}, "adamw", 2, False),
         "qwen2-moe-a2.7b V2": ("qwen2-moe-a2.7b", {}, "adamw", 1, True)}
MESHES = ((2, 2), (4, 1), (1, 4))
# (b) on every mesh shape for the families, on (2, 2) for the variants
RESUMES = [(c, m) for c in CASES for m in (MESHES if c in FAMILIES else MESHES[:1])]
PREEMPT = "llama3-8b"  # the case whose run is preempted
REF_PROCS = 3

REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from repro.configs import get_config
    from repro.dist import tree_shardings
    from repro.dist.perf import PerfConfig, perf_context
    from repro.launch.mesh import make_host_mesh
    from repro.training.optimizer import OptimizerConfig
    from repro.training.train_step import TrainConfig, state_axes
    from repro.training.trainer import Trainer, TrainerConfig

    phase, d, cases, part = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]
    mesh = make_host_mesh((2, 2))
    out, meta = {}, {}
    spec = lambda s: [list(e) if isinstance(e, tuple) else e for e in s.spec]
    for name, (arch, over, opt, accum, v2) in cases.items():
        cfg = get_config(arch).reduced(dtype="float32", **over)
        tcfg = TrainerConfig(steps=4, global_batch=4, seq_len=32, ckpt_dir=os.path.join(d, phase, name),
                             ckpt_interval=3, keep_last=3, ckpt_async=False, seed=0, log_every=1000,
                             train=TrainConfig(opt=OptimizerConfig(name=opt, warmup_steps=2, total_steps=10),
                                               accum_steps=accum))
        with perf_context(PerfConfig(moe_local_dispatch=v2)):
            tr = Trainer(cfg, tcfg, mesh=mesh)
            res = tr.run()
        tr.close()
        sds = jax.eval_shape(lambda: tr.state)
        specs = tree_shardings(mesh, sds, state_axes(tr.model, tcfg.train.opt, sds))
        meta[name] = {"metrics": [{k: m[k] for k in ("step", "loss", "grad_norm")} for m in res["metrics"]],
                      "specs": {jax.tree_util.keystr(p): spec(s) for p, s in
                                jax.tree_util.tree_flatten_with_path(specs)[0]}}
        for p, x in jax.tree_util.tree_flatten_with_path(jax.device_get(tr.state))[0]:
            out[name + "|" + jax.tree_util.keystr(p)] = np.asarray(x)
    np.savez(os.path.join(d, phase + part + ".npz"), **out)
    with open(os.path.join(d, phase + part + ".json"), "w") as f:
        json.dump(meta, f)
""")

PORT = textwrap.dedent("""
    import json, os, signal, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, d, cases, resumes, preempt = (int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3]),
                                        json.loads(sys.argv[4]), sys.argv[5])
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "rendezvous"), rank=rank, world_size=4)
    import repro_torch.checkpoint.bvstore as bvstore
    from repro_torch import dist as rdist
    from repro_torch.configs import get_config
    from repro_torch.dist.perf import PerfConfig, perf_context
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_step import TrainConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves_with_paths

    DB = bvstore.DB

    class LoggedDB:  # (g): which ranks open a store directory
        @staticmethod
        def open(path, *args, **kwargs):
            with open(os.path.join(d, f"opens{rank}.txt"), "a") as f:
                f.write(path + "\\n")
            return DB.open(path, *args, **kwargs)

    bvstore.DB = LoggedDB
    meshes = {s: make_host_mesh(s, ("data", "model"), "cpu") for s in ((2, 2), (4, 1), (1, 4))}
    out, meta = {}, {}

    def tcfg(ckpt, opt, accum):
        return TrainerConfig(steps=4, global_batch=4, seq_len=32, ckpt_dir=ckpt, ckpt_interval=3, keep_last=3,
                             ckpt_async=False, seed=0, log_every=1000,
                             train=TrainConfig(opt=OptimizerConfig(name=opt, warmup_steps=2, total_steps=10),
                                               accum_steps=accum))

    def run(tag, cfg, tc, flags, mesh, hook=None):
        with perf_context(flags):
            tr = Trainer(cfg, tc, device="cpu", mesh=mesh)
            if hook is not None:
                hook(tr)
            res = tr.run()
        tr.close()
        meta[tag] = {"status": res["status"], "step": res["step"],
                     "metrics": [{k: m[k] for k in ("step", "loss", "grad_norm")} for m in res["metrics"]]}
        for p, x in leaves_with_paths(tr.state):
            out[tag + "|" + p] = (x.full_tensor() if rdist.is_dtensor(x) else x).detach().numpy()
        return tr

    def spec(x):
        return [None if not e else e[0] if len(e) == 1 else list(e) for e in rdist.placement_spec(x)] \\
            if rdist.is_dtensor(x) else [None] * x.ndim

    def sigterm_at_second_batch(tr):  # one rank is asked to stop while step 2 runs
        if rank == 1:
            nb, calls = tr.pipeline.next_batch, []

            def next_batch():
                calls.append(1)
                if len(calls) == 2:
                    signal.raise_signal(signal.SIGTERM)
                return nb()

            tr.pipeline.next_batch = next_batch

    for name, (arch, over, opt, accum, v2) in cases.items():
        cfg, flags = get_config(arch).reduced(dtype="float32", **over), PerfConfig(moe_local_dispatch=v2)
        tr = run(name + "|mesh", cfg, tcfg(os.path.join(d, "port", name), opt, accum), flags, meshes[(2, 2)])
        meta[name + "|placement"] = {p: {"spec": spec(x), "local": list(rdist.local(x).shape)}
                                     for p, x in leaves_with_paths(tr.state)}
        if rank == 0:
            run(name + "|plain", cfg, tcfg(None, opt, accum), flags, None)
        dist.barrier()
        for case, shape in resumes:
            if case == name:
                run(f"{name}|from_ref|{shape}", cfg, tcfg(os.path.join(d, "from_ref", f"{name}@{shape}"), opt, accum),
                    flags, meshes[tuple(shape)])
        if name == preempt:
            q = os.path.join(d, "preempt")
            run("preempt|first", cfg, tcfg(q, opt, accum), flags, meshes[(2, 2)], sigterm_at_second_batch)
            run("preempt|resumed", cfg, tcfg(q, opt, accum), flags, meshes[(2, 2)])
    np.savez(os.path.join(d, f"port{rank}.npz"), **out)
    with open(os.path.join(d, f"port{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _ref(phase, d, cases):
    """The reference's runs of ``cases``, in REF_PROCS subprocesses side by
    side (each case's jit compile takes seconds): (leaves, meta)."""
    parts = [{c: CASES[c] for c in list(cases)[i::REF_PROCS]} for i in range(REF_PROCS)]
    procs = [subprocess.Popen([sys.executable, "-c", REF, phase, str(d), json.dumps(part), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=str(ROOT))
             for i, part in enumerate(parts)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    leaves, meta = {}, {}
    for i in range(REF_PROCS):
        leaves.update(np.load(d / f"{phase}{i}.npz"))
        meta.update(json.loads((d / f"{phase}{i}.json").read_text()))
    return leaves, meta


def _copy_at_step_3(src, dst):
    """A copy of a store that both trainers wrote steps 3 and 4 into, with
    step 4 deleted: a resume starts at step 3."""
    shutil.copytree(src, dst)
    store = BVCheckpointStore(str(dst))
    store.delete_step(4)
    assert store.latest_step() == 3
    store.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, its resume of the port's step 3, [port rank 0..3], rank
    directories opened): each a (leaves, meta) pair."""
    d = tmp_path_factory.mktemp("trainer_mesh")
    ref = _ref("ref", d, CASES)
    for case, shape in RESUMES:
        _copy_at_step_3(d / "ref" / case, d / "from_ref" / f"{case}@{list(shape)}")
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(r), str(d), json.dumps(CASES),
                               json.dumps([[c, list(m)] for c, m in RESUMES]), PREEMPT],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=str(ROOT))
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    for case in FAMILIES:
        _copy_at_step_3(d / "port" / case, d / "resume_ref" / case)
    resumed = _ref("resume_ref", d, FAMILIES)
    ports = [(dict(np.load(d / f"port{r}.npz")), json.loads((d / f"port{r}.json").read_text())) for r in range(4)]
    opens = {r: (d / f"opens{r}.txt").read_text().split() if (d / f"opens{r}.txt").exists() else []
             for r in range(4)}
    return ref, resumed, ports, opens


def _state(leaves: dict, tag: str) -> dict:
    return {k[len(tag) + 1:]: v for k, v in leaves.items() if k.startswith(tag + "|")}


def _same_on_every_rank(ports, tag):
    """The gathered state and the metrics of ``tag``, which every rank must hold alike."""
    state = _state(ports[0][0], tag)
    for leaves, meta in ports[1:]:
        other = _state(leaves, tag)
        assert other.keys() == state.keys()
        assert all(np.array_equal(other[k], state[k]) for k in state)
        assert meta[tag] == ports[0][1][tag]
    return state, ports[0][1][tag]


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)


def _close_metrics(got: list, want: list):
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=0, err_msg=f"step {a['step']} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_state_is_placed_by_the_reference_s_shardings(runs, case):
    """(a) Every leaf's placement on the (2, 2) mesh is the reference's
    ``tree_shardings`` spec (the counters plain and replicated, as the
    reference's ``P()``), and each rank holds its shard's local shape."""
    (_, ref_meta), _, ports, _ = runs
    want = ref_meta[case]["specs"]
    sizes = {"data": 2, "model": 2}
    for _, meta in ports:
        got = meta[case + "|placement"]
        assert {p: v["spec"] for p, v in got.items()} == want
        full = _state(ports[0][0], case + "|mesh")
        for p, v in got.items():
            shape = list(full[p].shape)
            for dim, e in enumerate(v["spec"]):
                for a in ([] if e is None else [e] if isinstance(e, str) else e):
                    shape[dim] //= sizes[a]
            assert v["local"] == shape, p


@pytest.mark.parametrize("case,shape", RESUMES)
def test_resume_of_the_reference_s_checkpoint_matches_its_step_4(runs, case, shape):
    """(b) The reference's trainer wrote steps 1–3 under its (2, 2) mesh; the
    port, on this mesh shape, restores step 3 (rank 0 reads, every rank
    places) and takes step 4: loss, grad norm and every leaf of the state
    as the reference's own step 4."""
    (ref, ref_meta), _, ports, _ = runs
    state, meta = _same_on_every_rank(ports, f"{case}|from_ref|{list(shape)}")
    _close_metrics(meta["metrics"], ref_meta[case]["metrics"][3:])
    _close(state, _state(ref, case))


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][4]])
def test_mesh_run_matches_the_run_without_a_mesh(runs, case):
    """(c) From the port's own seed, 4 steps on the (2, 2) mesh and 4
    without one: the same losses and grad norms, the same state (up to
    summation order). Not under V2, which routes each data shard with its
    own capacity and aux loss, as the reference's does: (b) and (d) hold it
    to the reference's V2."""
    _, _, ports, _ = runs
    state, meta = _same_on_every_rank(ports, case + "|mesh")
    plain = ports[0][1][case + "|plain"]
    _close_metrics(meta["metrics"], plain["metrics"])
    _close(state, _state(ports[0][0], case + "|plain"))


@pytest.mark.parametrize("case", FAMILIES)
def test_port_mesh_checkpoint_resumes_in_reference(runs, case):
    """(d) The checkpoint the port wrote at step 3 under the mesh resumes in
    the reference's trainer on its (2, 2) mesh: its step 4 equals the port's
    own step 4."""
    _, (resumed, resumed_meta), ports, _ = runs
    state, meta = _same_on_every_rank(ports, case + "|mesh")
    _close_metrics(resumed_meta[case]["metrics"], meta["metrics"][3:])
    _close(_state(resumed, case), state)


def test_only_rank_0_opens_the_store(runs):
    """(g) Every store directory of the port's runs was opened by global rank
    0 and by no other rank."""
    *_, opens = runs
    assert opens[0] and not opens[1] and not opens[2] and not opens[3]


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_step(runs):
    """Rank 1 alone receives SIGTERM during step 2: all four ranks return
    ``preempted`` at step 2, with its checkpoint committed; a fresh trainer
    resumes from it to step 4 and ends where the uninterrupted run ended."""
    _, _, ports, _ = runs
    for _, meta in ports:
        assert (meta["preempt|first"]["status"], meta["preempt|first"]["step"]) == ("preempted", 2)
        assert [m["step"] for m in meta["preempt|resumed"]["metrics"]] == [3, 4]
    state, meta = _same_on_every_rank(ports, "preempt|resumed")
    want, want_meta = _same_on_every_rank(ports, PREEMPT + "|mesh")
    _close_metrics(meta["metrics"], want_meta["metrics"][2:])
    _close(state, want)


# ---------------------------------------------------------------------------
# in this process: what raises
# ---------------------------------------------------------------------------

class FakeMesh:
    device_type = "cpu"
    mesh_dim_names = ("data", "model")
    shape = (1, 1)


def _tcfg():
    return TrainerConfig(steps=1, global_batch=2, seq_len=16, log_every=1000)


def test_mesh_without_a_process_group_raises():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(get_config("llama3-8b").reduced(dtype="float32"), _tcfg(), device="cpu", mesh=FakeMesh())


@pytest.fixture
def one_rank(tmp_path):
    """A 1-rank gloo group (file rendezvous) and its (1, 1) mesh, destroyed after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        yield make_host_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_device_that_is_not_the_mesh_s_raises(one_rank):
    with pytest.raises(ValueError, match="device type"):
        Trainer(get_config("llama3-8b").reduced(dtype="float32"), _tcfg(), device="meta", mesh=one_rank)


def test_train_step_with_parameters_not_placed_raises(one_rank):
    """Under a mesh the train step takes a placed state; plain parameters
    raise instead of being trained without the mesh."""
    from repro_torch import dist as rdist

    model = build_model(get_config("llama3-8b").reduced(dtype="float32"), "cpu")
    state = init_state(model, torch.Generator().manual_seed(0), OptimizerConfig())
    tokens = torch.zeros(2, 16, dtype=torch.long)
    with rdist.mesh_context(one_rank), pytest.raises(ValueError, match="not placed"):
        make_train_step(model, TrainConfig())(state, {"tokens": tokens, "labels": tokens})


def test_async_save_under_the_mesh_writes_the_step_it_was_given(one_rank, tmp_path):
    """On a (1, 1) mesh a gathered leaf is a view of the rank's own shard, so
    an async save must still copy it. The writer of step 1 is held until step
    2 has updated the state in place; the checkpoint of step 1 then equals
    the state after step 1 of a run that saves nothing."""
    import threading

    from repro_torch import dist as rdist
    from repro_torch.tree import leaves_with_paths

    cfg = get_config("llama3-8b").reduced(dtype="float32")

    def tcfg(ckpt, steps):
        return TrainerConfig(steps=steps, global_batch=2, seq_len=16, ckpt_dir=ckpt, ckpt_interval=1,
                             ckpt_async=True, log_every=1000)

    plain = Trainer(cfg, tcfg(None, 1), device="cpu", mesh=one_rank)
    plain.run()
    want = {p: (x.full_tensor() if rdist.is_dtensor(x) else x).detach().clone()
            for p, x in leaves_with_paths(plain.state)}
    plain.close()

    trainer = Trainer(cfg, tcfg(str(tmp_path / "ckpt"), 2), device="cpu", mesh=one_rank)
    stepped, waits = threading.Event(), []
    save, wait = trainer.store.save, trainer.ckpt.wait

    def held_save(step, *args, **kwargs):
        if step == 1:
            assert stepped.wait(60)
        return save(step, *args, **kwargs)

    def wait_then_release():  # its second call opens step 2's save, after step 2's update
        waits.append(1)
        if len(waits) == 2:
            stepped.set()
        wait()

    trainer.store.save, trainer.ckpt.wait = held_save, wait_then_release
    assert trainer.run()["step"] == 2 and stepped.is_set()
    trainer.close()
    store = BVCheckpointStore(str(tmp_path / "ckpt"))
    got = store.load(1)[0]
    store.close()
    assert got.keys() == want.keys()
    assert [p for p in want if not torch.equal(got[p], want[p])] == []
