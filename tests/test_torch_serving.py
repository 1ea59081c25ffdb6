"""The port's paged KV allocator (invariants under hypothesis) and serving
engine, end to end and token for token against the reference engine."""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import flatten, params_from_jax
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import OutOfPages, PagedKVCache

torch.set_num_threads(1)


def _kv(num_pages=16, page=8, maxp=4):
    return PagedKVCache(num_pages, page, n_layers=2, n_kv_heads=2, head_dim=8,
                        max_pages_per_seq=maxp, device="cpu")


def test_alloc_free_roundtrip():
    kv = _kv()
    kv.admit(1, prompt_len=20)  # 3 pages at page=8
    assert len(kv.seqs[1].pages) == 3
    assert kv.utilization() == 3 / 16
    kv.release(1)
    assert kv.utilization() == 0.0


def test_out_of_pages():
    kv = _kv(num_pages=4, maxp=8)
    kv.admit(1, prompt_len=30)  # needs 4 pages
    kv.admit(2)
    with pytest.raises(OutOfPages):
        kv.reserve(2, 10)


def test_page_table_overflow():
    kv = _kv(num_pages=16, maxp=2)
    kv.admit(1, prompt_len=16)
    with pytest.raises(OutOfPages, match="page-table"):
        kv.reserve(1, 1)


def test_page_table_and_lengths():
    kv = _kv()
    kv.admit(7, prompt_len=10)
    kv.admit(9, prompt_len=3)
    pt = kv.page_table([7, 9])
    assert pt.shape == (2, 4) and pt.dtype == np.int32
    assert (kv.lengths([7, 9]) == np.array([10, 3])).all()
    assert set(kv.seqs[7].pages).isdisjoint(kv.seqs[9].pages)
    assert list(pt[0, :2]) == kv.seqs[7].pages and list(pt[1, :1]) == kv.seqs[9].pages


def test_write_token_lands_in_its_page():
    kv = _kv()
    kv.admit(3, prompt_len=9)  # position 8 = page 1, offset 0
    k = torch.arange(16, dtype=torch.float32).view(1, 2, 8)
    kv.write_token(1, [3], k, -k)
    pid = kv.seqs[3].pages[1]
    assert kv.pages_k[1].dtype == torch.bfloat16
    assert torch.equal(kv.pages_k[1][pid, 0], k[0].bfloat16())
    assert torch.equal(kv.pages_v[1][pid, 0], -k[0].bfloat16())
    assert kv.pages_k[0].abs().sum() == 0  # other layers untouched


@settings(max_examples=30, deadline=None)
@given(
    ops=st.lists(
        st.tuples(st.sampled_from(["admit", "reserve", "release"]), st.integers(0, 5), st.integers(1, 12)),
        max_size=60,
    )
)
def test_allocator_invariants(ops):
    """No page is ever owned by two sequences; free+owned == total."""
    kv = _kv(num_pages=12, page=4, maxp=6)
    for op, sid, n in ops:
        try:
            if op == "admit" and sid not in kv.seqs:
                kv.admit(sid)
            elif op == "reserve" and sid in kv.seqs:
                kv.reserve(sid, n)
            elif op == "release" and sid in kv.seqs:
                kv.release(sid)
        except OutOfPages:
            pass
        owned = [p for s in kv.seqs.values() for p in s.pages]
        assert len(owned) == len(set(owned))
        assert sorted(owned + kv.free) == list(range(12))


def _cfg(dtype="bfloat16"):
    kw = dict(d_model=64, n_layers=2, vocab=256, vocab_pad_multiple=64, dtype=dtype)
    return ref_get_config("llama3-8b").reduced(**kw), get_config("llama3-8b").reduced(**kw)


def test_engine_end_to_end():
    _, cfg = _cfg()
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    engine = ServingEngine(model, max_batch=2, max_len=64, page_size=16)
    rng = np.random.default_rng(0)
    for rid in range(5):
        engine.submit(Request(rid, rng.integers(1, cfg.vocab, 8).astype(np.int32), max_new_tokens=6))
    done = engine.run_until_drained()
    assert len(done) == 5
    assert all(len(r.tokens) == 6 for r in done)
    m = engine.metrics()
    assert m["tokens"] == 30
    assert (engine.prefill_calls, engine.decode_calls) == (5, 25)
    assert engine.kv.utilization() == 0.0


def test_engine_greedy_matches_manual_decode():
    _, cfg = _cfg()
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    prompt = np.arange(1, 9, dtype=np.int32)
    engine = ServingEngine(model, max_batch=1, max_len=64, page_size=16)
    engine.submit(Request(0, prompt, max_new_tokens=5))
    (req,) = engine.run_until_drained()
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(prompt).long()[None], pad_to=64)
        toks = [int(torch.argmax(logits[0]))]
        for _ in range(4):
            logits, cache = model.decode_step(cache, torch.tensor([[toks[-1]]]))
            toks.append(int(torch.argmax(logits[0])))
    assert req.tokens == toks


def test_engine_tokens_equal_reference_engine():
    """Same weights, same prompts, fp32: the greedy tokens are identical."""
    rcfg, cfg = _cfg("float32")
    ref_model = ref_build_model(rcfg)
    params = ref_model.init(jax.random.key(1))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (8, 5, 12)]
    ref_engine = RefServingEngine(rcfg, params, max_batch=2, max_len=64, page_size=16)
    engine = ServingEngine(model, max_batch=2, max_len=64, page_size=16)
    for rid, p in enumerate(prompts):
        ref_engine.submit(RefRequest(rid, p, max_new_tokens=6))
        engine.submit(Request(rid, p, max_new_tokens=6))
    ref_done = {r.req_id: r.tokens for r in ref_engine.run_until_drained()}
    done = {r.req_id: r.tokens for r in engine.run_until_drained()}
    assert done == ref_done


def test_engine_tokens_equal_reference_engine_mamba2():
    """The attention-free model through the unchanged engine: same weights,
    same prompts (40, 53 and 66 tokens: one, two and three chunks of 32 with
    a ragged tail), fp32: the greedy tokens are identical."""
    kw = dict(dtype="float32")
    rcfg, cfg = ref_get_config("mamba2-1.3b").reduced(**kw), get_config("mamba2-1.3b").reduced(**kw)
    ref_model = ref_build_model(rcfg)
    params = ref_model.init(jax.random.key(2))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (40, 53, 66)]
    ref_engine = RefServingEngine(rcfg, params, max_batch=2, max_len=128, page_size=16)
    engine = ServingEngine(model, max_batch=2, max_len=128, page_size=16)
    # the unused arena, sized as the reference's: n_kv_heads → 1, head_dim → d_model // max(n_heads, 1)
    assert engine.kv.pages_k[0].shape == (2 * (128 // 16 + 1) * 2, 16, 1, cfg.resolved_head_dim)
    for rid, p in enumerate(prompts):
        ref_engine.submit(RefRequest(rid, p, max_new_tokens=6))
        engine.submit(Request(rid, p, max_new_tokens=6))
    ref_done = {r.req_id: r.tokens for r in ref_engine.run_until_drained()}
    done = {r.req_id: r.tokens for r in engine.run_until_drained()}
    assert done == ref_done and all(len(t) == 6 for t in done.values())
    assert (engine.prefill_calls, engine.decode_calls) == (3, 15)


def test_engine_tokens_equal_reference_engine_recurrentgemma():
    """The hybrid model through the unchanged engine: the reduced
    recurrentgemma-9b with its RR remainder (5 layers), prompts of 40 and 50
    tokens (beyond the window of 32, so prefill keeps the last 32 positions
    in the ring and decode overwrites its slots), fp32: the greedy tokens are
    identical."""
    kw = dict(dtype="float32", n_layers=5)
    rcfg, cfg = ref_get_config("recurrentgemma-9b").reduced(**kw), get_config("recurrentgemma-9b").reduced(**kw)
    ref_model = ref_build_model(rcfg)
    params = ref_model.init(jax.random.key(3))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (40, 50)]
    ref_engine = RefServingEngine(rcfg, params, max_batch=2, max_len=64, page_size=16)
    engine = ServingEngine(model, max_batch=2, max_len=64, page_size=16)
    # the unused arena, sized as the reference's: 1 kv head of head_dim 16
    assert engine.kv.pages_k[0].shape == (2 * (64 // 16 + 1) * 2, 16, 1, cfg.resolved_head_dim)
    for rid, p in enumerate(prompts):
        ref_engine.submit(RefRequest(rid, p, max_new_tokens=6))
        engine.submit(Request(rid, p, max_new_tokens=6))
    ref_done = {r.req_id: r.tokens for r in ref_engine.run_until_drained()}
    done = {r.req_id: r.tokens for r in engine.run_until_drained()}
    assert done == ref_done and all(len(t) == 6 for t in done.values())
    assert (engine.prefill_calls, engine.decode_calls) == (2, 10)


def test_engine_tokens_equal_reference_engine_whisper():
    """The audio family through the unchanged engine: prefill with no frame
    embeddings (zero frames, as the reference engine serves), the cross K/V
    over the 16 reduced encoder positions cached beside the self K/V; same
    weights, same prompts, fp32: the greedy tokens are identical."""
    kw = dict(dtype="float32")
    rcfg, cfg = ref_get_config("whisper-small").reduced(**kw), get_config("whisper-small").reduced(**kw)
    params = ref_build_model(rcfg).init(jax.random.key(9))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (8, 5, 12)]
    ref_engine = RefServingEngine(rcfg, params, max_batch=2, max_len=64, page_size=16)
    engine = ServingEngine(model, max_batch=2, max_len=64, page_size=16)
    for rid, p in enumerate(prompts):
        ref_engine.submit(RefRequest(rid, p, max_new_tokens=6))
        engine.submit(Request(rid, p, max_new_tokens=6))
    ref_done = {r.req_id: r.tokens for r in ref_engine.run_until_drained()}
    done = {r.req_id: r.tokens for r in engine.run_until_drained()}
    assert done == ref_done and all(len(t) == 6 for t in done.values())
    assert (engine.prefill_calls, engine.decode_calls) == (3, 15)


# (arch, config overrides, prompt lengths, max_len): both MoE configs
# reduced, then granite-moe at capacity_factor 0.3 with prompts of 200 and 150
# tokens (C = 64 slots per expert against ~100 and ~75 routed): prefill
# overflows, and the dropped slots take slot 0's token with them
# (tests/test_torch_moe.py)
MOE_ENGINE_CASES = {"granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, (8, 5, 12), 64),
                    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}, (8, 5, 12), 64),
                    "granite-moe-overflow": ("granite-moe-1b-a400m", {"capacity_factor": 0.3}, (200, 150), 256)}


@pytest.mark.parametrize("case", list(MOE_ENGINE_CASES))
def test_engine_tokens_equal_reference_engine_moe(case, monkeypatch):
    """The MoE family through the unchanged engine (prefill at B = 1, the
    cache padded to max_len, so no pad token takes an expert's slot): same
    weights, same prompts, fp32: the greedy tokens are identical."""
    from repro_torch.models import moe

    arch, over, lens, max_len = MOE_ENGINE_CASES[case]
    kw = dict(over, dtype="float32")
    rcfg, cfg = ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    params = ref_build_model(rcfg).init(jax.random.key(7))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    overflowed, dispatch = [], moe.dispatch

    def counting(top_i, top_p, E, C):
        overflowed.append(bool((torch.bincount(top_i.flatten(), minlength=E) > C).any()))
        return dispatch(top_i, top_p, E, C)

    monkeypatch.setattr(moe, "dispatch", counting)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]
    ref_engine = RefServingEngine(rcfg, params, max_batch=2, max_len=max_len, page_size=16)
    engine = ServingEngine(model, max_batch=2, max_len=max_len, page_size=16)
    for rid, p in enumerate(prompts):
        ref_engine.submit(RefRequest(rid, p, max_new_tokens=6))
        engine.submit(Request(rid, p, max_new_tokens=6))
    ref_done = {r.req_id: r.tokens for r in ref_engine.run_until_drained()}
    done = {r.req_id: r.tokens for r in engine.run_until_drained()}
    assert done == ref_done and all(len(t) == 6 for t in done.values())
    assert any(overflowed) == (case == "granite-moe-overflow")


# The bf16 path that serves against the reference's (ROADMAP Queue C 11):
# the port's engine and the JAX engine on the reduced configs in bf16
# compute, same fp32 weights, same prompts, 16 greedy tokens each. Measured:
# one request of each family diverges, at token 7 (dense), 12 (mamba2) and
# 13 (recurrentgemma) of 16 (0 is the prefill's), the others never. Asserted
# is only that every request's first 4 tokens agree, with room below the
# first divergence measured, as ties may flip with the thread count or build.
BF16_CASES = {"llama3-8b": (dict(d_model=64, n_layers=2, vocab=256, vocab_pad_multiple=64), (8, 5, 12), 64, 1),
              "mamba2-1.3b": ({}, (40, 53, 66), 128, 2),
              "recurrentgemma-9b": (dict(n_layers=5), (40, 50), 80, 3),
              "granite-moe-1b-a400m": ({}, (8, 5, 12), 64, 4),
              "qwen2-moe-a2.7b": ({}, (8, 5, 12), 64, 4),
              "whisper-small": ({}, (8, 5, 12), 64, 5)}
BF16_AGREE = 4
# qwen2-moe (reduced): request 0 differs at token 1 (request 1 at 9), where
# the JAX engine's two best logits are equal (2.828125 each, so its argmax
# takes the lower id) and the port's differ by one bf16 ulp (2.84375 against
# 2.828125; the logits' max|Δ| 0.026, within the bf16 tolerance): a tie, so
# only the prefill's token is asserted for it. granite-moe never differs.
# whisper-small (reduced): request 1 differs at token 2, where the JAX
# engine's two best logits are equal (2.25 each, ids 59 and 241) and the
# port's differ by one bf16 ulp (2.265625 for 241; the logits' max|Δ|
# 0.018): a tie, so tokens 0 and 1 are asserted. The others never differ.
BF16_AGREE_BY_ARCH = {"qwen2-moe-a2.7b": 1, "whisper-small": 2}


@pytest.mark.parametrize("arch", list(BF16_CASES))
def test_bf16_engine_tokens_against_reference_engine(arch, capsys):
    over, lens, max_len, key = BF16_CASES[arch]
    kw = dict(over, dtype="bfloat16")
    rcfg, cfg = ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    params = ref_build_model(rcfg).init(jax.random.key(key))
    model = build_model(cfg, "cpu")
    model.load_state_dict(flatten(params_from_jax(jax.tree.map(np.asarray, params))))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]
    ref_engine = RefServingEngine(rcfg, params, max_batch=2, max_len=max_len, page_size=16)
    engine = ServingEngine(model, max_batch=2, max_len=max_len, page_size=16)
    for rid, p in enumerate(prompts):
        ref_engine.submit(RefRequest(rid, p, max_new_tokens=16))
        engine.submit(Request(rid, p, max_new_tokens=16))
    ref_done = {r.req_id: r.tokens for r in ref_engine.run_until_drained()}
    done = {r.req_id: r.tokens for r in engine.run_until_drained()}
    first = {rid: next((k for k, (a, b) in enumerate(zip(done[rid], ref_done[rid])) if a != b), None)
             for rid in sorted(done)}
    with capsys.disabled():
        print(f"\n{arch} bf16: first differing token per request (None: never) {first}")
    assert all(len(done[rid]) == len(ref_done[rid]) == 16 for rid in done)
    agree = BF16_AGREE_BY_ARCH.get(arch, BF16_AGREE)
    assert all(done[rid][:agree] == ref_done[rid][:agree] for rid in done)
