"""The benchmark's files: each found by its name, unknown names refused, and
``BENCHMARK.json`` within the contract's limits."""
from __future__ import annotations

import json
import re

import pytest

from portbench import check, families, harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
ALL_CONFIGS = sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))  # a file no cell uses yet too


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_load_by_name(workload):
    spec = harness.cell_spec(BENCH, workload)
    assert spec["config"]["name"] == spec["entry"]["config"]
    limits = spec["cell"]["limits"]
    assert set(limits) <= set(check.NUMBERS) and len(limits) >= 2
    assert all(0 < v < 1 for v in limits.values())
    assert harness.mode(spec["traffic"]["mode"]).run


@pytest.mark.parametrize("name", METRICS)
def test_metric_readers_load_by_name(name):
    read = harness.reader(name)
    assert read(object()) is None  # a reader that finds nothing to read returns nothing


@pytest.mark.parametrize("kind, name", [("workloads", "no-such-cell"), ("configs", "no-such-config"),
                                        ("traffic", "no-such-mix"), ("workloads", "../BENCHMARK"),
                                        ("configs", "a/b")])
def test_unknown_names_are_refused(kind, name):
    with pytest.raises(harness.UnknownName):
        harness.load(kind, name)


@pytest.mark.parametrize("call", ["mode", "reader", "cell"])
def test_unknown_mode_metric_and_cell_are_refused(call):
    with pytest.raises(harness.UnknownName):
        {"mode": lambda: harness.mode("no_such_mode"), "reader": lambda: harness.reader("no_such.metric"),
         "cell": lambda: harness.cell_spec(BENCH, "no-such-cell")}[call]()


def test_runner_refuses_an_unknown_workload(capsys):
    from portbench import run

    assert run.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = CELLS + CONFIGS + METRICS + [m["name"] for m in BENCH["end_to_end"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json" and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in CONFIGS and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] == "train_tokens_per_s" and m["source"] in ("device_trace", "program_span",
                                                                      "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", CONFIGS)
def test_reduced_keys_are_the_keys_changed_from_the_source(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = harness.load("configs", config)
    assert entry["reduced"] == data["reduced"] and entry["source"] == data["source"]
    for key in entry["reduced"]:
        assert data[key] != data["published"][key]
    assert set(data["published"]) == set(entry["reduced"])


WIDTH = ("_dim", "_rank", "_size", "_per_tok")  # endings of a width's key (and of experts per token)


@pytest.mark.parametrize("config", ALL_CONFIGS)
def test_reduced_cuts_scale_only(config):
    """``reduced`` names the keys cut from the source, each with its
    published value under ``published``, and never a width."""
    data = harness.load("configs", config)
    assert set(data["published"]) == set(data["reduced"])
    for key in data["reduced"]:
        assert data[key] != data["published"][key]
        assert not key.endswith(WIDTH) and "expan" not in key, key


def test_every_workload_file_is_a_cell():
    assert sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json")) == sorted(CELLS)


HF = {  # the published keys that carry each model-block size, by model_type
    "granitemoe": {"d_model": "hidden_size", "d_ff": "intermediate_size", "n_experts": "num_local_experts"},
    "qwen2_moe": {"d_model": "hidden_size", "d_ff": "moe_intermediate_size", "n_experts": "num_experts"},
    # mamba_ssm's config.json, and the Mamba-2 block's defaults (the file's "block")
    "mamba2": {"d_model": "d_model", "n_layers": "n_layer", "vocab": "vocab_size", "tie_embeddings": "tie_embeddings",
               "ssm_state": "block.d_state", "conv_kernel": "block.d_conv", "ssm_expand": "block.expand",
               "ssm_head_dim": "block.headdim", "ssm_groups": "block.ngroups", "ssm_chunk": "block.chunk_size"},
}


def published(data: dict, key: str):
    for part in key.split("."):
        data = data[part]
    return data


@pytest.mark.parametrize("config", ALL_CONFIGS)
def test_model_block_is_the_published_config(config):
    data = harness.load("configs", config)
    m, keys = data["model"], HF[data["model_type"]]
    if m["family"] == "ssm":
        # each size is the published one but the vocabulary: the port's 50280
        # is the published 50277 padded to a multiple of 8 (a declared departure)
        for field, key in keys.items():
            want = published(data, key)
            if field == "vocab":
                want = -(-want // 8) * 8
                assert any(d.startswith("vocab:") for d in data["departures"])
            assert m[field] == want, field
        assert (data["ssm_cfg"]["layer"], data["d_intermediate"], data["attn_layer_idx"]) == ("Mamba2", 0, [])
        return
    assert m["d_model"] == data[keys["d_model"]] and m["d_ff"] == data[keys["d_ff"]]
    assert m["n_experts"] == data[keys["n_experts"]] and m["top_k"] == data["num_experts_per_tok"]
    assert (m["n_layers"], m["n_heads"], m["n_kv_heads"], m["vocab"]) == (
        data["num_hidden_layers"], data["num_attention_heads"], data["num_key_value_heads"], data["vocab_size"])
    assert m["head_dim"] * m["n_heads"] == data["hidden_size"]
    assert (m["rope_theta"], m["rms_eps"], m["tie_embeddings"]) == (
        data["rope_theta"], data["rms_norm_eps"], data["tie_word_embeddings"])
    if data["model_type"] == "qwen2_moe":
        assert m["n_shared_experts"] * m["d_ff"] == data["shared_expert_intermediate_size"]


@pytest.mark.parametrize("config", ALL_CONFIGS)
def test_program_config_is_the_configuration(config):
    from portbench.modes import train

    m = harness.load("configs", config)["model"]
    cfg = train.program_config(m)
    train.verify(cfg, m)
    for field in families.of(m).FIELDS:  # each field its family checks, one at a time
        changed = not m[field] if isinstance(m[field], bool) else (
            m[field] + 1 if isinstance(m[field], (int, float)) else m[field] + "x")
        with pytest.raises(ValueError, match=field):
            train.verify(cfg, {**m, field: changed})


@pytest.mark.parametrize("family", ["no_such_family", "../moe", "moe.x", ""])
def test_unknown_family_is_refused(family):
    with pytest.raises(ValueError):
        families.of({"family": family})
