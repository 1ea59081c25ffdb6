"""The port's shared model components against repro.models.common on CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import common

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6), "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _both(shape, dtype, scale=1.0):
    jd, td, _ = DTYPES[dtype]
    a = jnp.asarray(RNG.normal(size=shape) * scale, jd)
    return a, tensor_from_numpy(np.asarray(a)).to(td)


def _close(a, b, atol):
    assert b.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[a.dtype.type]
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["rmsnorm", "layernorm"])
def test_norms(name, dtype):
    x, tx = _both((2, 5, 32), dtype, 3.0)
    s, ts = _both((32,), "float32", 0.1)
    _close(getattr(ref, name)(x, s, 1e-6), getattr(common, name)(tx, ts, 1e-6), DTYPES[dtype][2])
    kind = "rmsnorm" if name == "rmsnorm" else "layernorm"
    _close(ref.norm(x, s, 1e-5, kind), common.norm(tx, ts, 1e-5, kind), DTYPES[dtype][2])


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 1000000.0)])
def test_rope(head_dim, theta):
    pos = np.array([0, 1, 7, 63, 255], np.int32)
    rs, rc = ref.rope_tables(jnp.asarray(pos), head_dim, theta)
    ts, tc = common.rope_tables(torch.from_numpy(pos), head_dim, theta)
    _close(rs, ts, 2e-6)
    _close(rc, tc, 2e-6)
    # angles reach 255 rad, where the two libraries' sin/cos differ in the
    # last ulp; times |x| ~ 3 that is a few 1e-6 in fp32
    for dtype, atol in [("float32", 1e-5), ("bfloat16", 1e-2)]:
        x, tx = _both((2, 5, 3, head_dim), dtype)
        _close(ref.apply_rope(x, rs, rc), common.apply_rope(tx, ts, tc), atol)


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_glu_activation(kind):
    g, tg = _both((3, 40), "float32", 2.0)
    u, tu = _both((3, 40), "float32")
    _close(ref.glu_activation(g, u, kind), common.glu_activation(tg, tu, kind), 1e-6)
    with pytest.raises(ValueError):
        common.glu_activation(tg, tu, "relu")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_tokens(dtype):
    emb, temb = _both((50, 16), "float32")
    tokens = RNG.integers(0, 50, size=(2, 7)).astype(np.int32)
    _close(ref.embed_tokens(emb, jnp.asarray(tokens), DTYPES[dtype][0]),
           common.embed_tokens(temb, torch.from_numpy(tokens).long(), DTYPES[dtype][1]), 0)


@pytest.mark.parametrize("vocab", [64, 60])
def test_logits_from_hidden(vocab):
    x, tx = _both((2, 3, 16), "float32")
    emb, temb = _both((64, 16), "float32")
    r = ref.logits_from_hidden(x, emb, vocab)
    t = common.logits_from_hidden(tx, temb, vocab)
    _close(r, t, 1e-5)
    assert (t[..., vocab:] == -1e30).all()


def test_truncated_normal_init():
    t = torch.empty(4, 64, 64)
    common.init_truncated_normal_(t, 0.5, torch.Generator().manual_seed(0))
    assert t.abs().max() <= 1.0 and abs(t.std().item() - 0.88 * 0.5) < 0.02
    b = torch.empty(4, 64, 64, dtype=torch.bfloat16)
    common.init_truncated_normal_(b, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(b, t.to(torch.bfloat16))  # drawn in fp32, slice by slice
