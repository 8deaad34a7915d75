"""The port never imports jax, nor any module of the JAX package.

Runs in a subprocess, because this test process has jax loaded already
(tests/conftest.py imports it). The child imports every module of
vecgo_tpu_torch, drives a small slice of the flat path and of the graph path
(compaction into a Vamana segment, filtered and unfiltered search), a
quantized and partitioned flat segment with probing, a streamed search
under a device budget over both transports, the cluster cache
(graph_cached) over persisted PQ codes reopened from the store, with a
caching store and a counting observer, a beam-mode compaction served from a
compact table, FreshVamana, the compaction tool, entry(), the native
ingest path (utils/hostops), hybrid search (the BM25 index and
hybrid_search_batch through a device BM25 snapshot), the device grid
(`entry.dryrun_multichip(8, device="cpu")`, parallel/*) and every example
(examples/*), on the CPU, and checks sys.modules for jax and for
vecgo_tpu / vecgo_tpu.*; without a CUDA device it also checks that the
default device ("cuda") is refused by Create, VamanaWriter,
build_graph_clustered and make_mesh.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent(
    """
    import importlib
    import pkgutil
    import sys
    import numpy as np
    import torch
    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.metadata import eq

    for mod in pkgutil.walk_packages(vg.__path__, "vecgo_tpu_torch."):
        importlib.import_module(mod.name)

    torch.set_num_threads(1)
    x = np.random.default_rng(0).standard_normal((600, 8)).astype(np.float32)
    db = vg.Open(vg.Memory(), vg.Create(dim=8, device="cpu"))
    ids = db.insert_batch(x, [{"c": i % 3} for i in range(600)])
    db.commit()
    db.insert_batch(x[:50] + 1.0)
    db.delete(ids[0])
    got, _ = db.search_arrays(x[:4], k=3, filter=eq("c", 1))
    assert got.shape == (4, 3) and ids[0] not in got
    assert db.search(x[1], k=1)[0].id == ids[1]
    db.close()

    # The graph path: compaction into a Vamana segment and its serving.
    import vecgo_tpu_torch.index.build_fast  # noqa: F401
    import vecgo_tpu_torch.ops.coded_group_scan  # noqa: F401
    import vecgo_tpu_torch.quantization.kmeans  # noqa: F401
    from vecgo_tpu_torch.index.vamana import VamanaSegment

    y = np.random.default_rng(1).standard_normal((4500, 8)).astype(np.float32)
    db = vg.Open(vg.Memory(), vg.Create(dim=8, device="cpu", graph_threshold=4096))
    ids = db.insert_batch(y, [{"c": i % 3} for i in range(len(y))])
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    assert type(db.engine._segments[0].segment) is VamanaSegment
    db.delete(ids[1])
    got, _ = db.search_arrays(y[:4], k=3, ef=48, nprobes=4)
    assert got.shape == (4, 3) and ids[1] not in got and got[0, 0] == ids[0]
    got, _ = db.search_arrays(y[:4], k=3, filter=eq("c", 1))
    assert got.shape == (4, 3) and ids[1] not in got
    db.close()

    # Quantized + partitioned flat segments, probing, and the streamed tier.
    import vecgo_tpu_torch.ops.hamming  # noqa: F401
    import vecgo_tpu_torch.quantization.binary  # noqa: F401
    import vecgo_tpu_torch.quantization.pq  # noqa: F401
    import vecgo_tpu_torch.quantization.scalar  # noqa: F401
    from vecgo_tpu_torch import quantization as Q

    z = y[:3000]
    for kind in ("sq8", "int4", "pq", "opq", "bq", "rabitq"):
        qz = Q.create(kind, device="cpu", dim=8, **({"m": 2} if kind in ("pq", "opq") else {}))
        qz.train(z)
        assert len(qz.encode(z[:10])["codes"]) == 10
    db = vg.Open(vg.Memory(), vg.Create(dim=8, device="cpu", quantizer="sq8",
                                        flush_ivf_partitions=True, ivf_rows_per_partition=500))
    ids = db.insert_batch(z, [{"c": i % 3} for i in range(len(z))])
    db.commit()
    seg = db.engine._segments[0].segment
    assert seg.quant.kind == "sq8" and seg.meta["ivf"]["partitions"] == 6
    for kw in ({}, {"nprobes": 2}, {"filter": eq("c", 1)}):
        got, _ = db.search_arrays(z[:4], k=3, refine_factor=4, **kw)
        assert got.shape == (4, 3) and (kw.get("filter") is not None or got[0, 0] == ids[0])
    db.close()
    for transport in ("sq8", "pq"):
        db = vg.Open(vg.Memory(), vg.Create(dim=8, device="cpu", hbm_budget_bytes=64,
                                            stream_transport=transport))
        ids = db.insert_batch(z)
        db.commit()
        got, _ = db.search_arrays(z[:4], k=3)
        assert got[:, 0].tolist() == ids[:4] and db.stats()["hbm"]["resident"] == 0
        db.close()
    # The cluster cache over persisted codes, through a caching store, with
    # a counting observer.
    import vecgo_tpu_torch.ops.ivf_cache  # noqa: F401
    from vecgo_tpu_torch.engine.metrics import CountingObserver
    from vecgo_tpu_torch.storage.cache import CachingStore, LRUCache

    backend = vg.Memory()
    db = vg.Open(backend, vg.Create(dim=8, device="cpu", graph_threshold=4096,
                                    store_codes="pq"))
    ids = db.insert_batch(y)
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    seg = db.engine._segments[0].segment
    assert seg.meta["ivf"]["codes_stored"] == "pq"
    budget = (seg.cache_bytes() + seg.device_bytes()) // 2
    db.close()
    obs = CountingObserver()
    store = CachingStore(backend.store, cache=LRUCache(1 << 24), block_size=1 << 16)
    db = vg.Open(vg.Remote(store, read_only=True),
                 vg.Create(dim=0, device="cpu", hbm_budget_bytes=budget, observer=obs))
    got, _ = db.search_arrays(y[:4], k=3)
    seg = db.engine._segments[0].segment
    assert got[0, 0] == ids[0] and seg._ccache.stats["batches"] == 1
    assert seg._vectors_arr is None and obs.counters["searches"] == 4
    assert db.engine.cache_stats()
    db.close()

    # The beam build served from the one-slot-per-row table, FreshVamana,
    # the compaction tool, entry() and the native ingest path.
    import tempfile
    from vecgo_tpu_torch.entry import entry
    from vecgo_tpu_torch.index.fresh import FreshVamana
    from vecgo_tpu_torch.tools import compact as compact_tool
    from vecgo_tpu_torch.utils import hostmem, hostops

    db = vg.Open(vg.Memory(), vg.Create(dim=8, device="cpu", graph_threshold=4096,
                                        graph_build_mode="beam", serve_compact=True))
    ids = db.insert_batch(y)
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    seg = db.engine._segments[0].segment
    assert type(seg) is VamanaSegment and seg.serve_compact and seg.meta["alpha"] == 1.2
    got, _ = db.search_arrays(y[:4], k=3)
    assert got[:, 0].tolist() == ids[:4]
    assert (seg.device_state("cpu")["ivfq"].rows >= 0).sum() == len(y)
    db.close()
    fv = FreshVamana(8, r=8, l_build=16, device="cpu")
    fv.insert_batch(z[:500])
    fv.insert_batch(z[500:1000])
    fv.delete(3)
    assert fv.search(z[:2], 1)[1][0, 0] == 0 and 3 not in fv.search(z[3:4], 5)[1]
    fv.consolidate()
    assert fv.n == 999
    with tempfile.TemporaryDirectory() as d:
        db = vg.Open(vg.Local(d), vg.Create(dim=8, device="cpu", graph_threshold=500,
                                            flush_threshold=10**9))
        db.insert_batch(z[:400])
        db.commit()
        db.insert_batch(z[400:700])
        db.commit()
        db.close()
        assert compact_tool.main([d, "--all", "--graph-threshold", "500", "--device", "cpu"]) == 0
        db = vg.Open(vg.Local(d), device="cpu")
        assert type(db.engine._segments[0].segment) is VamanaSegment
        db.close()
    fn, args = entry(device="cpu")
    assert fn(*args)[1].shape == (64, 10)
    ok = hostops.available()
    with hostops.disabled():
        assert not hostops.available() and hostmem.all_finite(z)
    assert hostops.available() == ok and hostmem.all_finite(z)

    # BM25 and hybrid search through a device snapshot.
    from vecgo_tpu_torch.lexical.bm25 import BM25Index
    from vecgo_tpu_torch.lexical.device_bm25 import DeviceBM25

    words = [f"w{i}" for i in range(40)]
    texts = [" ".join(words[(i * j) % 40] for j in range(1, 6)) for i in range(600)]
    texts[9] = "needle " + texts[9]
    db = vg.Open(vg.Memory(), vg.Create(dim=8, device="cpu", lexical=True))
    ids = db.insert_batch(x, texts=texts)
    db.commit()
    snap = db.engine.enable_device_lexical(max_hot_terms=32, min_df=2)
    assert isinstance(snap, DeviceBM25) and isinstance(db.engine._lexical, BM25Index)
    got, _ = db.hybrid_search_batch(x[:4], ["needle w1", "w3", "w5 w7", "needle"], k=3)
    assert got.shape == (4, 3) and got[0, 0] == ids[0] and ids[9] in got[3]
    assert [c.id for c in db.hybrid_search(x[9], "needle", k=1)] == [ids[9]]
    db.close()

    # The device grid (parallel/*) and every example (examples/*).
    import contextlib
    import io
    from vecgo_tpu_torch import examples
    from vecgo_tpu_torch.entry import dryrun_multichip

    with contextlib.redirect_stdout(io.StringIO()):
        dryrun_multichip(8, device="cpu")
        for mod in pkgutil.iter_modules(examples.__path__):
            importlib.import_module(f"vecgo_tpu_torch.examples.{mod.name}").main(device="cpu")
    assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
    jax_pkg = sorted(m for m in sys.modules if m == "vecgo_tpu" or m.startswith("vecgo_tpu."))
    assert not jax_pkg, jax_pkg
    if not torch.cuda.is_available():
        try:
            vg.Create(dim=8)
        except RuntimeError:
            pass
        else:
            raise AssertionError("Create() with the default device must need CUDA")
        from vecgo_tpu_torch.index.build_fast import build_graph_clustered
        from vecgo_tpu_torch.index.vamana import VamanaWriter
        from vecgo_tpu_torch.parallel.mesh import make_mesh

        for build in (lambda: VamanaWriter(8), lambda: build_graph_clustered(z[:40]),
                      lambda: make_mesh(shard=4)):
            try:
                build()
            except RuntimeError as e:
                assert "needs a CUDA device" in str(e), e
            else:
                raise AssertionError("the default device must need CUDA")
    print("NOJAX-OK")
    """
)


def test_port_runs_without_importing_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    assert "NOJAX-OK" in out.stdout
