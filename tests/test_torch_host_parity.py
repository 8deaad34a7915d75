"""The port's own host control plane against the JAX package's.

vecgo_tpu_torch carries its own copy of the host modules (metadata filters,
the section container, manifests, the PK index, tombstones, the block
caches and caching store, the metrics observers, the native ingest
kernels of utils/hostops). Each test feeds
the same seeded inputs to both packages and requires the same results or
the same bytes, so a database written by either package stays readable by
the other. The static test checks that no port file and no line of
chip_smoke.py imports the JAX package.
"""

import ast
import os

import numpy as np
import pytest

from vecgo_tpu import metadata as jmd
from vecgo_tpu.blobstore import MemoryStore as JaxMemoryStore
from vecgo_tpu.engine import manifest as jman
from vecgo_tpu.engine import metrics as jmetrics
from vecgo_tpu.engine import pk as jpk
from vecgo_tpu.engine import tombstone as jtomb
from vecgo_tpu.metadata.columnar import ColumnarMeta as JaxColumnarMeta
from vecgo_tpu.storage import cache as jcache
from vecgo_tpu.storage import container as jcon
from vecgo_tpu_torch import metadata as pmd
from vecgo_tpu_torch.blobstore import MemoryStore
from vecgo_tpu_torch.engine import manifest as pman
from vecgo_tpu_torch.engine import metrics as pmetrics
from vecgo_tpu_torch.engine import pk as ppk
from vecgo_tpu_torch.engine import tombstone as ptomb
from vecgo_tpu_torch.metadata.columnar import ColumnarMeta
from vecgo_tpu_torch.storage import cache as pcache
from vecgo_tpu_torch.storage import container as pcon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vecgo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imported_modules(f)
           if m == "vecgo_tpu" or m.startswith("vecgo_tpu.") or m == "jax" or m.startswith("jax.")]
    assert len(files) > 30 and not bad, bad
    rel = {os.path.relpath(f, os.path.join(REPO, "vecgo_tpu_torch")) for f in files}
    for new in ("ops/hamming.py", "quantization/scalar.py", "quantization/pq.py",
                "quantization/binary.py", "quantization/kmeans.py", "utils/tensors.py",
                "ops/ivf_cache.py", "storage/cache.py", "engine/metrics.py", "index/fresh.py",
                "tools/compact.py", "utils/hostops.py", "entry.py", "lexical/__init__.py",
                "lexical/bm25.py", "lexical/device_bm25.py", "parallel/mesh.py",
                "parallel/engine_shard.py", "examples/basic.py", "examples/time_travel.py"):
        assert new in rel, new  # the quantizers, their ops, lexical, parallel and examples


def _docs(n=500, seed=3):
    r = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        if r.random() < 0.1:
            docs.append(None)
            continue
        d = {"u": int(r.integers(0, 100)), "tag": f"t{int(r.integers(0, 5))}",
             "w": float(r.standard_normal()), "flag": bool(r.random() < 0.5),
             "arr": [f"a{j}" for j in r.choice(6, int(r.integers(0, 3)), replace=False)]}
        if r.random() < 0.2:
            del d["w"]
        docs.append(d)
    return docs


FILTERS = [
    lambda m: m.eq("tag", "t1"),
    lambda m: m.neq("tag", "t1"),
    lambda m: m.gt("u", 40),
    lambda m: m.gte("w", 0.0),
    lambda m: m.lt("u", 7),
    lambda m: m.lte("w", -0.5),
    lambda m: m.isin("u", [1, 2, 3, 50]),
    lambda m: m.contains("arr", "a2"),
    lambda m: m.eq("flag", True),
    lambda m: m.gt("u", 10) & m.isin("tag", ["t0", "t3"]) & m.eq("flag", False),
]


@pytest.mark.parametrize("make", FILTERS, ids=range(len(FILTERS)))
def test_filter_masks_match_jax(make):
    docs = _docs()
    want = JaxColumnarMeta.from_docs(docs).filter_mask(jmd.as_filterset(make(jmd)))
    got = ColumnarMeta.from_docs(docs).filter_mask(pmd.as_filterset(make(pmd)))
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(docs)


@pytest.mark.parametrize("compress", [None, "deflate", "lz4", "zstd"])
def test_container_bytes_match_and_cross_open(compress):
    r = np.random.default_rng(5)
    sections = {"vectors": r.standard_normal((300, 24)).astype(np.float32),
                "ids": np.arange(300, dtype=np.uint64),
                "graph": r.integers(-1, 300, (300, 8)).astype(np.int32),
                "payload.data": r.integers(0, 256, 999).astype(np.uint8)}
    meta = {"kind": "flat", "dim": 24, "nested": {"a": [1, 2]}}
    jb = jcon.pack_container(meta, sections, compress=compress)
    pb = pcon.pack_container(meta, sections, compress=compress)
    assert jb == pb
    for unpack, data in ((pcon.unpack_container, jb), (jcon.unpack_container, pb)):
        m, secs = unpack(data, True)
        assert m["nested"] == {"a": [1, 2]}
        for name, arr in sections.items():
            np.testing.assert_array_equal(secs[name], arr)


def _manifest(mod, version):
    info = mod.SegmentInfo(name="segment_000003.vgt", seg_id=3, kind="flat", level=1,
                           row_count=1234, stats={"row_count": 1234, "radius": 2.5},
                           tombstone_blob="segment_000003.v2.tomb")
    return mod.Manifest(version=version, lsn=77, next_id=1300, next_seg_id=4,
                        segments=[info], config={"dim": 24, "metric": "l2"},
                        created_at=1.5 + version)


def test_manifests_match_and_load_across_packages():
    js, ps = JaxMemoryStore(), MemoryStore()
    jms, pms = jman.ManifestStore(js), pman.ManifestStore(ps)
    for v in (1, 2):
        jms.save(_manifest(jman, v))
        pms.save(_manifest(pman, v))
    assert sorted(js.list("")) == sorted(ps.list(""))
    for name in js.list(""):
        assert js.get(name) == ps.get(name)
    # Each package's store loads the other's manifests.
    for src, dst in ((js, ps), (ps, js)):
        for name in src.list(""):
            dst.put(name, src.get(name))
    for ms in (pman.ManifestStore(ps), jman.ManifestStore(js)):
        m = ms.load()
        assert (m.version, m.lsn, m.next_id, m.segments[0].tombstone_blob) == (
            2, 77, 1300, "segment_000003.v2.tomb")
        assert ms.load(version=1).created_at == 2.5


def _pk_ops(mod):
    pk = mod.PKIndex()
    pk.upsert_block(np.arange(1, 201, dtype=np.int64), mod.MEMTABLE_SEG,
                    np.arange(200, dtype=np.int64), 1)
    for i, id_ in enumerate((5, 17, 150)):
        pk.upsert(id_, mod.MEMTABLE_SEG, 200 + i, 300 + i)
    pk.delete(42, 310)
    pk.delete(17, 311)
    pk.remap_bulk(mod.MEMTABLE_SEG, 7, np.arange(203, dtype=np.int64)[::-1].copy())
    pk.upsert(900, 7, 3, 320)
    pk.compact_chains(305)
    return pk


def test_pk_index_matches_jax():
    jp, pp = _pk_ops(jpk), _pk_ops(ppk)
    assert jp.checkpoint_bytes() == pp.checkpoint_bytes()
    assert jp.checkpoint_bytes(max_lsn=305) == pp.checkpoint_bytes(max_lsn=305)
    np.testing.assert_array_equal(jp.dirty_sorted(), pp.dirty_sorted())
    cross = ppk.PKIndex.from_checkpoint(jp.checkpoint_bytes())
    for id_ in list(range(0, 205)) + [900, 901]:
        for lsn in (None, 1, 302, 310, 320):
            want = jp.get_entry(id_, lsn)
            assert pp.get_entry(id_, lsn) == want
            assert cross.get_entry(id_, lsn) == want
    assert sorted(pp.scan(315)) == sorted(jp.scan(315)) and len(pp) == len(jp)


def test_tombstones_match_jax():
    rows, lsns = [3, 99, 12, 40], [10, 11, 12, 20]
    jt = jtomb.SegmentTombstones(128, rows, lsns).add(77, 25)
    pt = ptomb.SegmentTombstones(128, rows, lsns).add(77, 25)
    assert jt.to_bytes() == pt.to_bytes()
    for snap in (None, 11, 20, 30):
        np.testing.assert_array_equal(pt.deleted_mask(snap), jt.deleted_mask(snap))
        assert pt.count(snap) == jt.count(snap)
    back = ptomb.SegmentTombstones.from_bytes(jt.to_bytes())
    np.testing.assert_array_equal(back.deleted_mask(), jt.deleted_mask())
    js = jtomb.TombstoneSet().with_delete(4, 9, 30, 64).with_delete(5, 1, 31, 8)
    ps = ptomb.TombstoneSet().with_delete(4, 9, 30, 64).with_delete(5, 1, 31, 8)
    for seg, n in ((4, 64), (5, 8), (6, 10)):
        a, b = ps.deleted_mask(seg, n, 30), js.deleted_mask(seg, n, 30)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        assert ps.count(seg) == js.count(seg)


def _cache_trace(mod, store_mod, root):
    """One sequence of block-cache and caching-store operations; returns
    everything each step gave back (bytes, hits, stats)."""
    out = []
    for cache in (mod.LRUCache(64), mod.ShardedLRUCache(4096, shards=4)):
        for i in range(12):
            cache.put(("f", i), bytes([i]) * 9)
        out.append([cache.get(("f", i)) for i in range(12)])
        out.append((cache.stats() if hasattr(cache, "stats") else None))
    disk = mod.DiskCache(root, 1 << 20)
    disk.put(("f", 3), b"xyz")
    out.append((disk.get(("f", 3)), mod.DiskCache(root, 1 << 20).get(("f", 3))))
    tier = mod.TieredCache(mod.LRUCache(32), mod.DiskCache(root + "-t", 1 << 20))
    inner = store_mod.MemoryStore()
    cs = mod.CachingStore(inner, cache=tier, block_size=8)
    cs.put("blob", b"0123456789abcdef" * 3)
    out.append(cs.get("blob"))
    out.append([cs.get_range("blob", off, n) for off, n in ((0, 5), (7, 10), (40, 20))])
    cs.put("CURRENT", b"1")
    inner.put("CURRENT", b"2")
    out.append(cs.get("CURRENT"))
    cs.put("blob", b"bb")
    out.append((cs.get("blob"), cs.cache_stats()))
    return out


def test_block_caches_and_caching_store_match_jax(tmp_path):
    from vecgo_tpu import blobstore as jstore
    from vecgo_tpu_torch import blobstore as pstore

    want = _cache_trace(jcache, jstore, str(tmp_path / "jax"))
    got = _cache_trace(pcache, pstore, str(tmp_path / "port"))
    assert got == want


def test_observers_match_jax_and_the_port_engine_calls_them():
    """The observer classes are the JAX module's; the port's engine calls
    the same hooks as the JAX engine on the same writes and reads."""
    assert [n for n in dir(pmetrics.MetricsObserver) if n.startswith("on_")] == [
        n for n in dir(jmetrics.MetricsObserver) if n.startswith("on_")]
    from vecgo_tpu.blobstore import MemoryStore as JaxStore
    from vecgo_tpu.engine import Engine as JaxEngine
    from vecgo_tpu.engine import EngineOptions as JaxOptions
    from vecgo_tpu_torch.engine import Engine, EngineOptions

    x = np.random.default_rng(5).standard_normal((20, 8)).astype(np.float32)
    counts = []
    for mod, eng in ((jmetrics, lambda o: JaxEngine.open(JaxStore(), JaxOptions(
                         dim=8, flush_threshold=10**9, observer=o), create=True)),
                     (pmetrics, lambda o: Engine.open(MemoryStore(), EngineOptions(
                         dim=8, flush_threshold=10**9, observer=o, device="cpu"),
                         create=True))):
        obs = mod.CountingObserver()
        e = eng(obs)
        ids = e.insert_batch(x)
        e.delete(ids[0])
        e.search(x[1], k=2)
        e.get(ids[2])
        e.commit()
        e.get(ids[3])
        counts.append(dict(obs.counters))
        noop = mod.NoopObserver()
        noop.on_insert(1)
    assert counts[0] == counts[1]
    assert counts[1]["inserts"] == 20 and counts[1]["gets"] == 2


def test_hostops_copies_and_validates_as_numpy_and_the_jax_module():
    """utils/hostops (the JAX package's hostops.cpp, the same code, built
    with the host compiler): byte-equal copies, the same finiteness answers as numpy and
    as the JAX module, and the memtable's ingest copy the same with the
    native path and without it."""
    import contextlib

    from vecgo_tpu.utils import hostops as jhostops
    from vecgo_tpu_torch.engine import memtable
    from vecgo_tpu_torch.errors import ErrInvalidVector
    from vecgo_tpu_torch.utils import hostmem, hostops

    def code(*parts):  # the source without its comments
        with open(os.path.join(REPO, *parts, "utils", "hostops.cpp")) as f:
            return [ln.split("//")[0].rstrip() for ln in f if ln.split("//")[0].strip()]

    assert code("vecgo_tpu_torch") == code("vecgo_tpu")
    r = np.random.default_rng(5)
    x = r.standard_normal((3000, 24)).astype(np.float32)
    bad = x.copy()
    bad[1234, 5] = np.nan
    inf = x.copy()
    inf[2999, 23] = -np.inf
    if not hostops.available():
        pytest.skip("no host compiler: the numpy path is the only one")
    for arr in (x, bad, inf):
        out = np.empty_like(arr)
        ok = hostops.copy_validate_range(arr, out, 0, len(arr))
        assert out.tobytes() == arr.tobytes()
        assert ok == bool(np.isfinite(arr).all()) == hostmem.all_finite(arr)
        assert hostops.validate_range(arr, 100, 2000) == bool(np.isfinite(arr[100:2000]).all())
        if jhostops.available():
            assert jhostops.validate_range(arr, 0, len(arr)) == ok
        with hostops.disabled():
            assert hostmem.all_finite(arr) == ok
    big = r.standard_normal((70000, 16)).astype(np.float32)
    native = memtable.copy_validate(big)
    with hostops.disabled():
        plain = memtable.copy_validate(big)
    assert native.tobytes() == plain.tobytes() == big.tobytes()
    big[69999, 0] = np.inf
    for ctx in (hostops.disabled(), contextlib.nullcontext()):
        with ctx, pytest.raises(ErrInvalidVector):
            memtable.copy_validate(big)
