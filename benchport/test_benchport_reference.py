"""The plain reference and the judge against a NumPy brute force (CPU)."""

import numpy as np
import torch

from benchport import judge
from benchport import reference as R


def _brute(q, x, visible, k, metric):
    if metric == "cosine":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        d = 1.0 - qn @ xn.T
    elif metric == "l2":
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(2)
    else:
        d = -(q @ x.T)
    d = np.where(visible[None, :], d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), order


def _case(seed=0, n=3000, m=400, d=24, b=64):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    tail = rng.standard_normal((m, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    deleted = np.sort(rng.choice(n, 150, replace=False))
    u = rng.integers(0, 10, n + m)
    return base, tail, q, deleted, u


def test_exact_topk_matches_brute_force_with_deletes_memtable_and_filter():
    base, tail, q, deleted, u = _case()
    x = np.concatenate([base, tail]).astype(np.float64)
    for metric in ("cosine", "l2", "dot"):
        for flt in (None, {"field": "u", "op": "lt", "value": 3}):
            vis = R.visible_mask(len(x), torch.from_numpy(deleted), {"u": u}, flt, "cpu")
            blocks = [(0, torch.from_numpy(base)), (len(base), torch.from_numpy(tail))]
            d, ids = R.exact_topk(torch.from_numpy(q), blocks, vis, 10, metric)
            want_d, want_i = _brute(q.astype(np.float64), x, vis.numpy(), 10, metric)
            assert not np.isin(ids.numpy(), deleted).any()
            assert (ids.numpy() >= len(base)).any(), "memtable rows are searched"
            if flt:
                assert (u[ids.numpy()] < 3).all()
            np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-5, atol=1e-5)
            same = (ids.numpy() == want_i).mean()
            assert same > 0.99, (metric, flt, same)


def test_exact_topk_row_blocks_do_not_change_the_answer(monkeypatch):
    base, tail, q, deleted, u = _case(seed=1)
    blocks = [(0, torch.from_numpy(base)), (len(base), torch.from_numpy(tail))]
    vis = R.visible_mask(len(base) + len(tail), torch.from_numpy(deleted), {}, None, "cpu")
    whole = R.exact_topk(torch.from_numpy(q), blocks, vis, 7, "cosine")
    monkeypatch.setattr(R, "_SCORE_ELEMS", 64 * 97)  # 97-row blocks
    split = R.exact_topk(torch.from_numpy(q), blocks, vis, 7, "cosine")
    assert torch.equal(whole[1], split[1])
    assert torch.allclose(whole[0], split[0])


def test_pads_when_fewer_rows_are_visible_than_k():
    base = torch.randn(5, 8)
    vis = torch.tensor([True, False, True, False, False])
    d, ids = R.exact_topk(torch.randn(3, 8), [(0, base)], vis, 4, "l2")
    assert (ids[:, 2:] == -1).all() and torch.isinf(d[:, 2:]).all()
    assert set(ids[:, :2].flatten().tolist()) <= {0, 2}


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, -3.0 - 2.0 ** -10 - 2.0 ** -12])
    y = R.round_tf32(x)
    assert y[0] == 1.0 + 2.0 ** -10
    assert y[1] == 1.0
    assert y[2] == -3.0 - 2.0 ** -9  # [2, 4): a step of 2^-9


def _judged(ids, dists, q, blocks, vis, deleted, k):
    t = judge.truth(q, blocks, vis, k, "cosine")
    return judge.judge_batch(q, ids, dists, t, blocks, vis, deleted, "cosine")


def test_judge_reads_zero_for_the_exact_answer_and_counts_each_fault():
    base, tail, q, deleted, u = _case(seed=2)
    blocks = [(0, torch.from_numpy(base)), (len(base), torch.from_numpy(tail))]
    dels = torch.from_numpy(deleted)
    vis = R.visible_mask(len(base) + len(tail), dels, {}, None, "cpu")
    qt = torch.from_numpy(q)
    t = judge.truth(qt, blocks, vis, 10, "cosine")
    ids = t.ids.numpy().copy()
    dists = t.d64.float().numpy().copy()
    nums = _judged(ids, dists, qt, blocks, vis, dels, 10)
    assert nums["deleted_returned"] == 0 and nums["missing_answers"] == 0
    assert nums["dist_err"] < 1e-6 and nums["rank_gap"] == 0.0
    assert abs(nums["recall_sum"] - len(q)) < 1e-9

    bad = ids.copy()
    bad[0, 3] = deleted[0]
    assert _judged(bad, dists, qt, blocks, vis, dels, 10)["deleted_returned"] == 1

    bad = ids.copy()
    bad[1, 9] = -1
    bad[2, 4] = bad[2, 5]
    assert _judged(bad, dists, qt, blocks, vis, dels, 10)["missing_answers"] == 2

    bad = ids.copy()
    bad[3, 0] = (ids[3, 0] + 1) % len(base)  # another row, its distance kept
    assert _judged(bad, dists, qt, blocks, vis, dels, 10)["dist_err"] > 1e-3


def test_distinct_groups_identical_answers_by_pool_batch():
    a = np.arange(6).reshape(2, 3)
    d = np.zeros((2, 3), np.float32)
    done = [(0.0, a, d), (0.1, a + 1, d), (0.2, a.copy(), d), (0.3, a + 2, d)]
    pulls = [(0.0, 0), (0.0, 1), (0.0, 0), (0.0, 0)]
    groups = judge.distinct(done, pulls)
    counts = sorted((p, g[2]) for (p, _), g in groups.items())
    assert counts == [(0, 1), (0, 2), (1, 1)]
