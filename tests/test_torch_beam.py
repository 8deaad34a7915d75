"""The port's lockstep beam search and RobustPrune against the JAX package on
the same graph, entries and candidates.

Both packages sort the same lists with the same keys and stability, and
score with exact bf16 products summed in f32 in another order, so results
agree up to near-ties: at least 0.99 of the ids overlap. `_dedup_topk` is
exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.ops import beam as jbeam
from vecgo_tpu.ops import ivf as jivf
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch.index.build_fast import build_graph_clustered
from vecgo_tpu_torch.ops import beam as tbeam
from vecgo_tpu_torch.ops import ivf as tivf

torch.set_num_threads(1)

N, D, R = 3000, 16, 16


def overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    hits = sum(len(set(x[x >= 0]) & set(y[y >= 0])) for x, y in zip(a, b))
    return hits / max(1, sum(len(set(y[y >= 0])) for y in b))


@pytest.fixture(scope="module")
def graph():
    x, _ = tu.clustered_vectors(N, D, n_clusters=20, seed=21)
    g, medoid, ecent, enodes, members = build_graph_clustered(
        x, r=R, cluster_size=256, seed=3, return_membership=True, device="cpu")
    rng = np.random.default_rng(22)
    q = (x[rng.choice(N, 48, replace=False)]
         + 0.02 * rng.standard_normal((48, D))).astype(np.float32)
    # Per-query entries: the entry nodes of the 3 nearest entry centroids + medoid.
    near = np.argsort(((q[:, None] - ecent[None]) ** 2).sum(-1), 1)[:, :3]
    entries = np.concatenate([enodes[near], np.full((len(q), 1), medoid)], 1).astype(np.int32)
    mask = rng.random(N) < 0.5
    return x, g, members, q, entries, mask


def test_dedup_topk_equals_jax():
    r = np.random.default_rng(1)
    d = np.round(r.random((20, 40)), 1).astype(np.float32)  # ties everywhere
    d[r.random(d.shape) < 0.1] = np.inf
    i = r.integers(-1, 15, (20, 40)).astype(np.int32)
    want = jbeam._dedup_topk(jnp.asarray(d), jnp.asarray(i), 12)
    got = tbeam._dedup_topk(torch.from_numpy(d), torch.from_numpy(i).long(), 12)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("masked", [False, True])
def test_beam_search_matches_jax(graph, masked):
    x, g, _, q, entries, mask = graph
    x16 = x.astype(np.float32)
    rn = np.einsum("nd,nd->n", x, x).astype(np.float32)
    kw = dict(ef=32, k=10, beam_width=4, with_visited=True)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = jbeam.beam_search(jnp.asarray(q), jnp.asarray(x16, jnp.bfloat16), jnp.asarray(rn),
                             jnp.asarray(g), jnp.asarray(entries), mask=jm, **kw)
    got = tbeam.beam_search(torch.from_numpy(q), torch.from_numpy(x16).to(torch.bfloat16),
                            torch.from_numpy(rn), torch.from_numpy(g).long(),
                            torch.from_numpy(entries), mask=tm, **kw)
    assert overlap(got[1].numpy(), want[1]) >= 0.99
    assert overlap(got[3].numpy(), want[3]) >= 0.99
    if masked:
        ids = got[1].numpy()
        assert mask[ids[ids >= 0]].all()


@pytest.mark.parametrize("masked,steps", [(False, 1), (True, 1), (False, 0)])
def test_beam_search_coded_matches_jax(graph, masked, steps):
    """One refine round (steps=1) as the serving path runs it, and the full
    auto step count (steps=0) on the SQ8-coded scorer."""
    x, g, members, q, entries, mask = graph
    jt = jivf.device_table_coded(members, jnp.asarray(x))
    tt = tivf.IVFCodedTable(*[torch.from_numpy(np.array(a)) for a in jt[:8]])
    qc = q @ np.asarray(jt.centroids).T
    kw = dict(ef=32, k=32, beam_width=4, max_steps=steps)
    want = jbeam.beam_search_coded(jnp.asarray(q), jt, jnp.asarray(g), jnp.asarray(entries),
                                   jnp.asarray(qc), mask=jnp.asarray(mask) if masked else None,
                                   **kw)
    got = tbeam.beam_search_coded(torch.from_numpy(q), tt, torch.from_numpy(g).long(),
                                  torch.from_numpy(entries), torch.from_numpy(qc),
                                  mask=torch.from_numpy(mask) if masked else None, **kw)
    assert overlap(got[1].numpy(), want[1]) >= 0.99
    fin = np.isfinite(np.asarray(want[0]))
    np.testing.assert_allclose(got[0].numpy()[fin], np.asarray(want[0])[fin], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("occ", [False, True])
def test_robust_prune_matches_jax(graph, occ):
    x, g, _, _, _, _ = graph
    r = np.random.default_rng(9)
    rows = np.arange(0, N, 7, dtype=np.int32)
    # Candidates: the graph's own edges, random ids, repeats and self-loops.
    cand = np.concatenate([g[rows], r.integers(0, N, (len(rows), 20)), g[rows][:, :4],
                           rows[:, None]], 1).astype(np.int32)
    x16 = jnp.asarray(x, jnp.bfloat16)
    rn = np.einsum("nd,nd->n", x, x).astype(np.float32)
    kw = dict(r_out=R, alpha=1.2)
    jocc, tocc = {}, {}
    if occ:
        p = r.standard_normal((D, 8)).astype(np.float32) / np.sqrt(8)
        xo = (x @ p).astype(np.float32)
        ro = (xo * xo).sum(1)
        jocc = dict(vectors_occ=jnp.asarray(xo), rnorm2_occ=jnp.asarray(ro))
        tocc = dict(vectors_occ=torch.from_numpy(xo), rnorm2_occ=torch.from_numpy(ro))
    want = jbeam.robust_prune(jnp.asarray(rows), x16[rows], jnp.asarray(cand), x16,
                              jnp.asarray(rn), **kw, **jocc)
    t16 = torch.from_numpy(x).to(torch.bfloat16)
    got = tbeam.robust_prune(torch.from_numpy(rows), t16[torch.from_numpy(rows).long()],
                             torch.from_numpy(cand), t16, torch.from_numpy(rn), **kw, **tocc)
    assert overlap(got.numpy(), want) >= 0.99
    assert not (got.numpy() == rows[:, None]).any()
