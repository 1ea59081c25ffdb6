"""The port's trainer, as tests/test_trainer.py holds the reference's: exact
resume (params, optimizer state, step and data cursor, bit for bit),
preemption checkpointing, straggler detection. Checkpoints go to the
reference's storage engine, injected."""
import time

import torch

from repro.core import DB, DBConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as train_launch
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig
from repro_torch.training.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

CFG = get_config("llama3-8b").reduced(d_model=64, n_layers=2, vocab=512, vocab_pad_multiple=64)


def _db(path):
    return DB.open(str(path), DBConfig.bvlsm(wal_mode="sync", value_threshold=4096, num_bvalue_queues=4,
                                               memtable_size=4 << 20, bvcache_bytes=16 << 20))


def _tcfg(steps, interval=5, async_=True):
    return TrainerConfig(steps=steps, global_batch=2, seq_len=32, ckpt_interval=interval, ckpt_async=async_,
                         log_every=10_000, train=TrainConfig(opt=OptimizerConfig(warmup_steps=2, total_steps=100)))


def _trainer(path, tcfg, **kw):
    return Trainer(CFG, tcfg, _db(path), device="cpu", **kw)


def _snapshot(state):
    return {p: t.detach().clone() for p, t in leaves_with_paths(state)}


def test_pipeline_deterministic_resume():
    p1 = TokenPipeline(512, 4, 16, seed=3)
    batches = [p1.next_batch() for _ in range(5)]
    p2 = TokenPipeline(512, 4, 16, seed=3)
    p2.load_state_dict({"seed": 3, "step": 3, "host": 0, "num_hosts": 1})
    assert (p2.next_batch()["tokens"] == batches[3]["tokens"]).all()


def test_exact_resume_matches_uninterrupted(tmp_path):
    """train 10 straight == train 5, 'crash', resume to 10: bit for bit, every
    leaf of the state (bf16 compute, as the reference's test)."""
    t_full = _trainer(tmp_path / "a", _tcfg(10, interval=100))
    t_full.run()
    full = _snapshot(t_full.state)
    t_full.close()

    t_half = _trainer(tmp_path / "b", _tcfg(5, interval=5, async_=False))
    t_half.run()
    t_half.close()  # the process "dies" here
    t_resume = _trainer(tmp_path / "b", _tcfg(10, interval=100))
    res = t_resume.run()
    assert res["step"] == 10 and [m["step"] for m in res["metrics"]] == list(range(6, 11))
    resumed = _snapshot(t_resume.state)
    t_resume.close()
    assert full.keys() == resumed.keys()
    for path in full:
        assert torch.equal(full[path], resumed[path]), path


def test_preemption_checkpoints_and_resumes(tmp_path):
    tr = _trainer(tmp_path / "p", _tcfg(20, interval=100))
    orig = tr.pipeline.next_batch
    n = {"v": 0}

    def wrapped():
        n["v"] += 1
        if n["v"] == 7:
            tr._preempted = True  # SIGTERM equivalent
        return orig()

    tr.pipeline.next_batch = wrapped
    res = tr.run()
    tr.close()
    assert res["status"] == "preempted" and res["step"] == 7

    tr2 = _trainer(tmp_path / "p", _tcfg(20, interval=100))
    assert tr2.store.latest_step() == 7
    res2 = tr2.run()
    tr2.close()
    assert res2["status"] == "done" and res2["step"] == 20


def test_sigterm_sets_the_preemption_flag(tmp_path):
    import os
    import signal

    tr = _trainer(tmp_path / "s", _tcfg(20, interval=100))
    orig = tr.pipeline.next_batch
    n = {"v": 0}

    def wrapped():
        n["v"] += 1
        if n["v"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig()

    tr.pipeline.next_batch = wrapped
    res = tr.run()
    tr.close()
    assert res["status"] == "preempted" and res["step"] == 3


def test_straggler_detection(tmp_path):
    events = []
    tr = _trainer(tmp_path / "s", _tcfg(15, interval=100), straggler_cb=lambda *a: events.append(a))
    orig = tr.pipeline.next_batch
    n = {"v": 0}

    def slow():
        n["v"] += 1
        if n["v"] == 12:
            time.sleep(1.0)  # a straggler step
        return orig()

    tr.pipeline.next_batch = slow
    tr.run()
    tr.close()
    assert tr.straggler_events >= 1
    assert events


def test_launcher_run_takes_a_store_and_main_trains_without_one(tmp_path, capsys):
    tcfg = train_launch.build(steps=3, batch=2, seq=16)
    trainer, res = train_launch.run(CFG, tcfg, _db(tmp_path / "l"), device="cpu")
    assert res["status"] == "done" and trainer.store.latest_step() == 3
    trainer.close()
    res = train_launch.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                             "--seq", "16", "--ckpt-dir", str(tmp_path / "m")])
    assert res["status"] == "done" and len(res["metrics"]) == 2
    assert "checkpoint engine stats:" in capsys.readouterr().out


def _main(ckpt_dir, steps):
    return train_launch.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--steps", str(steps),
                              "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt_dir), "--ckpt-interval", "1"])


def test_launcher_main_checkpoints_into_ckpt_dir_and_resumes(tmp_path, capsys):
    """``main`` opens the port's engine at ``--ckpt-dir``, saves every
    ``--ckpt-interval`` steps and prints the engine's stats; a second run
    with more steps resumes after the last saved step, and the reference's
    store reads what it saved."""
    from repro.checkpoint.bvstore import BVCheckpointStore as RefStore

    assert _main(tmp_path / "ck", 2)["step"] == 2
    out = capsys.readouterr().out
    assert "checkpoints: 3 saved" in out and "steps kept [1, 2]" in out and "'write_amp': 1.0" in out
    res = _main(tmp_path / "ck", 4)
    assert [m["step"] for m in res["metrics"]] == [3, 4]
    out = capsys.readouterr().out
    assert "steps kept [3, 4]" in out and "resumed: read from" in out
    ref = RefStore(str(tmp_path / "ck"))
    try:
        assert ref.steps() == [3, 4] and ref.load_meta(4)["extra"]["pipeline"]["step"] == 4
    finally:
        ref.close()


def test_whisper_trains_a_step_with_frames_from_the_pipeline():
    """The reduced whisper through the trainer on the CPU, checkpoints off:
    the pipeline adds ``enc_embeds`` (B, enc_len, d_model) to each batch, as
    the reference trainer's, the model's loss receives them, the loss is
    finite and every parameter moves."""
    cfg = get_config("whisper-small").reduced(dtype="float32")
    tr = Trainer(cfg, _tcfg(2), None, device="cpu")
    seen, loss = [], tr.model.loss

    def spy(batch, **kw):
        seen.append({k: tuple(v.shape) for k, v in batch.items()})
        return loss(batch, **kw)

    tr.model.loss = spy
    tr._init_or_restore()
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}  # run() draws the same
    res = tr.run()
    assert res["status"] == "done" and all(torch.isfinite(torch.tensor(m["loss"])) for m in res["metrics"])
    assert seen[0] == {"tokens": (2, 32), "labels": (2, 32), "enc_embeds": (2, cfg.enc_len, cfg.d_model)}
    for n, p in tr.model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n
