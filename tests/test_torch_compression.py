"""The port's int8 gradient compression against the reference's, bit for bit.

The reference is held as it runs, compiled (``jax.jit``; ``compressed_psum``
only runs inside a ``shard_map``): XLA's CPU compiler multiplies by the
float32 1/127 where the source divides by 127, and rounds the error
feedback's multiply-subtract once, so its eager ops give other bits in
about a third of the error state (and in a block's scale now and then).

In this process: ``quantize_int8``, ``dequantize_int8`` and
``ef_compress_leaf`` on ragged sizes (not a multiple of the 256-element
block) and with all-zero blocks. Across ranks: ``compressed_psum`` over 4
gloo ranks (rendezvous through a file) against the reference's inside a
``shard_map`` over a 4-device ``pod`` mesh (one subprocess, forced host
devices), from the same numpy inputs in an ``.npz``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as ref_compression
from repro_torch.training import compression

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 600
SHAPES = [(1,), (255,), (256,), (257,), (3, 300), (2, 128, 5), (4, 512)]


def _grad(shape, seed, zero_block=True):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=shape) * rng.choice([1e-4, 1.0, 30.0], size=shape)).astype(np.float32)
    if zero_block and g.size > 256:
        g.reshape(-1)[:256] = 0.0  # an all-zero block: scale 1, q 0
    return g


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_and_error_feedback_bit_equal_reference(shape):
    g, e = _grad(shape, 0), _grad(shape, 1, zero_block=False) * 1e-3
    q, scale = compression.quantize_int8(torch.from_numpy(g))
    rq, rscale = jax.jit(ref_compression.quantize_int8)(jnp.asarray(g))
    assert q.dtype == torch.int8 and q.shape == (-(-g.size // 256), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    deq = compression.dequantize_int8(q, scale, shape)
    rdeq = jax.jit(ref_compression.dequantize_int8, static_argnums=2)(rq, rscale, shape)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(rdeq))
    q, scale, err = compression.ef_compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    rq, rscale, rerr = jax.jit(ref_compression.ef_compress_leaf)(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    np.testing.assert_array_equal(err.numpy(), np.asarray(rerr))
    assert err.abs().max() <= scale.max() / 2  # what rounding to the nearest step leaves


def test_init_error_state_is_zeros_of_each_leaf():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(5)]}
    err = compression.init_error_state(params)
    assert err["a"].dtype == torch.float32 and err["a"].shape == (3, 4) and not err["a"].any()
    assert err["b"][0].shape == (5,)


# leaf -> per-rank shape (the reference's shard_map hands each device a (1, ...) slice)
PSUM_LEAVES = {"a": (1, 300), "b": (1, 7, 256), "c": (1, 3)}

REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.dist import shard_map
    from repro.launch.mesh import make_host_mesh
    from repro.training.compression import compressed_psum

    d = sys.argv[1]
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    names = sorted(k[2:] for k in inp if k.startswith("g_"))
    mesh = make_host_mesh((4,), ("pod",))
    grads = {n: jnp.asarray(inp["g_" + n]) for n in names}
    err = {n: jnp.asarray(inp["e_" + n]) for n in names}
    spec = {n: P("pod") for n in names}
    f = shard_map(lambda g, e: compressed_psum(g, e, "pod"), mesh=mesh, in_specs=(spec, spec),
                  out_specs=(spec, spec), check_vma=False)
    total, new_err = jax.jit(f)(grads, err)
    np.savez(os.path.join(d, "ref.npz"), **{"t_" + n: np.asarray(total[n]) for n in names},
             **{"e_" + n: np.asarray(new_err[n]) for n in names})
""")

PORT = textwrap.dedent("""
    import os, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, d = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "rendezvous"), rank=rank, world_size=4)
    from repro_torch.training.compression import compressed_psum

    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    names = sorted(k[2:] for k in inp if k.startswith("g_"))
    grads = {n: torch.from_numpy(inp["g_" + n][rank:rank + 1]) for n in names}
    err = {n: torch.from_numpy(inp["e_" + n][rank:rank + 1]) for n in names}
    total, new_err = compressed_psum(grads, err, dist.group.WORLD)
    np.savez(os.path.join(d, f"port{rank}.npz"), **{"t_" + n: total[n].numpy() for n in names},
             **{"e_" + n: new_err[n].numpy() for n in names})
    dist.destroy_process_group()
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    inputs = {}
    for i, (n, shape) in enumerate(PSUM_LEAVES.items()):
        inputs["g_" + n] = np.stack([_grad(shape, 10 * i + r, zero_block=r == 0) for r in range(4)])
        inputs["e_" + n] = np.stack([_grad(shape, 100 + 10 * i + r, zero_block=False) * 1e-3 for r in range(4)])
    np.savez(d / "inputs.npz", **inputs)
    res = subprocess.run([sys.executable, "-c", REF, str(d)], capture_output=True, text=True, env=_env(),
                         cwd=str(ROOT), timeout=RUN_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(r), str(d)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_env(), cwd=str(ROOT)) for r in range(4)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return dict(np.load(d / "ref.npz")), [dict(np.load(d / f"port{r}.npz")) for r in range(4)], inputs


@pytest.mark.parametrize("leaf", list(PSUM_LEAVES))
def test_compressed_psum_bit_equal_reference(psum_runs, leaf):
    """Every rank's dequantized sum and its new error state, bit for bit;
    the sum is every rank's, and within a shared step of each block of the
    uncompressed sum of the corrected gradients."""
    ref, ports, inputs = psum_runs
    for r, port in enumerate(ports):
        np.testing.assert_array_equal(port["t_" + leaf], ref["t_" + leaf][r:r + 1])
        np.testing.assert_array_equal(port["e_" + leaf], ref["e_" + leaf][r:r + 1])
        np.testing.assert_array_equal(port["t_" + leaf], ports[0]["t_" + leaf])
    exact = (inputs["g_" + leaf] + inputs["e_" + leaf]).sum(axis=0)
    carried = sum(port["e_" + leaf] for port in ports)[0]
    np.testing.assert_allclose(ports[0]["t_" + leaf][0] + carried, exact, rtol=0, atol=1e-4 * np.abs(exact).max())
