"""The port's memtable search against the JAX package's `MemTable.search`.

Same inserts into both; frozen 8192-row chunks plus the tail, with and
without a mask, over a visible prefix. JAX scans these chunks with exact
`lax.top_k` (rows below 16,384), so ids must match and distances agree
within atol 1e-4 (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.engine.memtable import CHUNK
from vecgo_tpu.engine.memtable import MemTable as JaxMemTable
from vecgo_tpu.model import Metric
from vecgo_tpu_torch.engine.memtable import MemTable
from vecgo_tpu_torch.model import Metric as PMetric

torch.set_num_threads(1)

D = 16


def _filled(cls, metric, x):
    mt = cls(D, metric if cls is JaxMemTable else PMetric(metric.value))
    mt.insert_block(x[:CHUNK + 100], id0=1, lsn0=1)
    for i in range(CHUNK + 100, len(x)):  # per-row inserts land in the tail
        mt.insert(x[i], id=i + 1, lsn=i + 1)
    return mt


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE, Metric.DOT])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("n_visible", [CHUNK + 150, CHUNK - 7], ids=["chunk+tail", "prefix"])
def test_memtable_search_matches_jax(metric, masked, n_visible):
    r = np.random.default_rng(21)
    x = r.standard_normal((CHUNK + 150, D)).astype(np.float32)
    q = r.standard_normal((6, D)).astype(np.float32)
    if metric == Metric.COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = r.random(n_visible) < 0.2 if masked else None
    jm, tm = _filled(JaxMemTable, metric, x), _filled(MemTable, metric, x)
    d_j, r_j = jm.search(jnp.asarray(q), 12, n_visible, mask)
    d_t, r_t = tm.search(torch.from_numpy(q), 12, n_visible, mask)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    assert len(tm._chunks) == 1  # CHUNK + 150 rows freeze one device chunk
    tm.release_device()
    assert tm._chunks == [] and tm._frozen_rows == 0


def test_memtable_fewer_rows_than_k():
    x = np.random.default_rng(22).standard_normal((5, D)).astype(np.float32)
    tm = MemTable(D, PMetric.L2)
    tm.insert_block(x, id0=1, lsn0=1)
    d, rows = tm.search(torch.from_numpy(x[:2]), 8, 5, np.array([1, 0, 1, 1, 0], bool))
    assert sorted(rows[0, :3].tolist()) == [0, 2, 3]
    assert (rows[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()


def test_tail_upload_follows_new_rows():
    """The tail's device copy is reused while rows stay the same and is
    replaced when rows arrive or a chunk freezes."""
    r = np.random.default_rng(23)
    x = r.standard_normal((CHUNK + 40, D)).astype(np.float32)
    q = torch.from_numpy(x[-3:] + 0.001)
    tm = MemTable(D, PMetric.L2)
    tm.insert_block(x[: CHUNK - 10], id0=1, lsn0=1)
    assert tm.search(q, 1, len(tm))[1][0, 0] != CHUNK + 37
    for i in range(CHUNK - 10, CHUNK + 40):
        tm.insert(x[i], id=i + 1, lsn=i + 1)
        if i % 16 == 0:
            tm.search(q, 1, len(tm))
    _, rows = tm.search(q, 1, len(tm))
    assert rows[:, 0].tolist() == [CHUNK + 37, CHUNK + 38, CHUNK + 39]
    assert len(tm._chunks) == 1 and tm._tail_dev[0] == (CHUNK, CHUNK + 40)
