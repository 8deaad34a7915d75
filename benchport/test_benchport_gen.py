"""The generator: the same seed gives the same inputs; sizes never depend on
the seed (CPU)."""

import numpy as np
import torch

from benchport import gen

CFG = {"rows": 2000, "dim": 16, "memtable_rows": 300, "deletes": 50, "metadata": {"u": 100},
       "generator": {"centres": 32, "sigma": 0.35}}
TRAFFIC = {"batch": 64, "pool_batches": 3}
BIG = 2**33 + 12345  # seeds past 32 bits


def _same(a: gen.Inputs, b: gen.Inputs) -> bool:
    return (torch.equal(a.base, b.base) and torch.equal(a.tail, b.tail)
            and np.array_equal(a.deleted, b.deleted)
            and all(np.array_equal(a.meta[f], b.meta[f]) for f in a.meta)
            and all(torch.equal(x, y) for x, y in zip(a.queries, b.queries)))


def test_same_seed_same_inputs():
    assert _same(gen.make(CFG, TRAFFIC, BIG, "cpu"), gen.make(CFG, TRAFFIC, BIG, "cpu"))


def test_other_seed_other_values_same_sizes():
    a, b = gen.make(CFG, TRAFFIC, BIG, "cpu"), gen.make(CFG, TRAFFIC, BIG + 1, "cpu")
    assert not torch.equal(a.base, b.base)
    assert not np.array_equal(a.deleted, b.deleted)
    assert a.base.shape == b.base.shape == (2000, 16)
    assert a.tail.shape == (300, 16) and len(a.queries) == 3
    assert a.queries[0].shape == (64, 16) and a.meta["u"].shape == (2300,)


def test_parts_are_independent_streams():
    """A part's values do not move when another part's size changes."""
    a = gen.make(CFG, TRAFFIC, 7, "cpu")
    b = gen.make(dict(CFG, memtable_rows=900, deletes=80), dict(TRAFFIC, pool_batches=5), 7, "cpu")
    assert torch.equal(a.base, b.base)
    assert torch.equal(a.queries[0], b.queries[0])


def test_deletes_are_distinct_committed_ids_and_metadata_in_range():
    inp = gen.make(CFG, TRAFFIC, 3, "cpu")
    assert len(np.unique(inp.deleted)) == 50
    assert inp.deleted.min() >= 0 and inp.deleted.max() < 2000
    assert inp.meta["u"].min() >= 0 and inp.meta["u"].max() < 100


def test_rows_sit_around_their_centres():
    g = gen.generator(5, "x", "cpu")
    centres = torch.randn(4, 8, generator=g) * 10
    x = gen.clustered(g, centres, 4000, 0.35)
    nearest = torch.cdist(x, centres).min(1).values
    assert float(nearest.mean()) < 0.35 * 8 ** 0.5 * 1.2


def test_docs_one_dict_a_row():
    meta = {"u": np.array([4, 5, 6]), "v": np.array([1, 2, 3])}
    assert gen.docs(meta, 1, 3) == [{"u": 5, "v": 2}, {"u": 6, "v": 3}]
    assert gen.docs({}, 0, 3) is None
