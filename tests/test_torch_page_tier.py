"""The KV-page host tier of the port's serving cache: the host page cache
(tests/test_serving.py's test) and the spill into an injected store
(``repro.core.DB`` and ``ShardedDB``), with bf16 pages and pages the
reference wrote."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DB, DBConfig, ShardedDB
from repro.serving.kv_cache import PageSpillStore as RefPageSpillStore
from repro_torch.serving.kv_cache import HostPageCache, PageSpillStore

torch.set_num_threads(1)


@pytest.fixture(params=["db", "sharded"])
def kv(request, tmp_path):
    cfg = DBConfig.bvlsm(value_threshold=256, memtable_size=256 << 10, num_bvalue_queues=2,
                         block_cache_bytes=1 << 20, bvcache_bytes=1 << 20)  # tests/test_api.py's
    path = str(tmp_path / "store")
    s = DB.open(path, cfg) if request.param == "db" else ShardedDB.open(path, shards=3, config=cfg)
    yield s
    s.close()


def test_host_page_cache_mrwf_pin():
    c = HostPageCache(capacity_pages=2)
    c.put(("s1", 0), np.zeros(4), pinned=True)
    c.put(("s1", 1), np.ones(4))
    c.put(("s1", 2), np.ones(4) * 2)  # evicts (s1,1): (s1,0) is pinned
    assert ("s1", 0) in c._map
    assert ("s1", 1) not in c._map
    c.unpin(("s1", 0))
    c.put(("s1", 3), np.ones(4) * 3)
    assert ("s1", 0) not in c._map  # LRU and unpinned: evicted
    assert c.get(("s1", 1)) is None and c.get(("s1", 3))[0] == 3
    assert (c.hits, c.misses) == (1, 1)


def test_page_spill_roundtrip_fp32_and_bf16(kv):
    spill = PageSpillStore(kv)
    g = torch.Generator().manual_seed(0)
    pages = {(layer, 7, p): torch.randn(8, 2, 16, generator=g).to(dtype)
             for layer, dtype in ((0, torch.float32), (1, torch.bfloat16)) for p in range(3)}
    for key, page in pages.items():
        spill.spill(key, page)
    got = spill.restore_many(list(pages) + [(9, 9, 9)])
    for (key, page), r in zip(pages.items(), got):
        assert r.dtype == page.dtype and torch.equal(r, page), key
    assert got[-1] is None
    assert torch.equal(spill.restore((1, 7, 2)), pages[(1, 7, 2)])
    assert spill.restore((5, 5, 5)) is None


def test_pages_cross_packages(kv):
    """The reference's spill writes np.save bytes: an fp32 page reads back as
    itself, a JAX bf16 page (opaque ``|V2`` elements) as bf16 bits; the
    reference reads the port's fp32 and bf16 pages."""
    ref = RefPageSpillStore(kv)
    port = PageSpillStore(kv)
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((8, 16)).astype(np.float32)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((8, 16)), jnp.bfloat16))
    ref.spill((0, 1, 0), f32)
    ref.spill((0, 1, 1), bf16)
    a, b = port.restore_many([(0, 1, 0), (0, 1, 1)])
    assert a.dtype == torch.float32 and np.array_equal(a.numpy(), f32)
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.view(torch.int16).numpy().view(np.uint16), bf16.view(np.uint16))
    port.spill((0, 2, 0), torch.from_numpy(f32))
    np.testing.assert_array_equal(ref.restore((0, 2, 0)), f32)
    port.spill((0, 2, 1), b)
    back = ref.restore((0, 2, 1))
    assert back.dtype.itemsize == 2
    np.testing.assert_array_equal(back.view(np.uint16), bf16.view(np.uint16))
