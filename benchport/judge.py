"""Decides `correct`: every answer the window completed, against the plain
reference (`reference.py`).

The numbers compared (each against its cell's limit, `limits/<cell>.json`):

- `deleted_returned`: answers that are a deleted id (the snapshot's MVCC
  visibility). Exact: limit 0.
- `missing_answers`: answer slots that are empty (-1), out of range, a
  repeat of another answer to the same query, or a row the filter excludes,
  while more visible rows exist. Exact: limit 0.
- `dist_err`: the largest gap between a distance the program returned and
  the float64 distance of the id it returned it for.
- `rank_gap`: the largest amount by which the program's r-th best answer
  (by float64 distance) lies beyond the reference's r-th best, over every
  query and rank: 0 where the program found the exact top-k, rounding where
  it swapped near-ties.

`recall_at_k` (an end-to-end metric, not compared) is the mean share of the
reference's top-k that each answer holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from benchport import reference as R

NUMBERS = ("deleted_returned", "missing_answers", "dist_err", "rank_gap")
_QUERY_CHUNK = 256  # queries whose candidate rows are gathered at once


@dataclass
class Truth:
    """The reference's answer to one pool batch."""

    ids: torch.Tensor  # [B, k] int64, sorted by the reference's distance
    d64: torch.Tensor  # [B, k] float64 distances of those ids, sorted


def truth(q: torch.Tensor, blocks, visible: torch.Tensor, k: int, metric: str,
          precision: str = "f32") -> Truth:
    _, ids = R.exact_topk(q, blocks, visible, k, metric, precision)
    d64 = torch.cat([R.distances_of(q[s : s + _QUERY_CHUNK], blocks, ids[s : s + _QUERY_CHUNK],
                                    metric) for s in range(0, q.shape[0], _QUERY_CHUNK)])
    d64, pos = torch.sort(d64, dim=1)
    return Truth(torch.gather(ids, 1, pos), d64)


def distinct(done: List[tuple], pulls: List[tuple]) -> Dict[tuple, list]:
    """Completed answers grouped by pool batch and content: (pool index,
    first position) -> [ids, dists, count]. A batch answered identically
    each time it came round is judged once, with its count."""
    groups: Dict[tuple, list] = {}
    firsts: Dict[int, List[tuple]] = {}
    for pos, ((_, ids, dists), (_, p)) in enumerate(zip(done, pulls)):
        for key in firsts.get(p, []):
            g = groups[key]
            if np.array_equal(g[0], ids) and np.array_equal(g[1], dists):
                g[2] += 1
                break
        else:
            groups[(p, pos)] = [ids, dists, 1]
            firsts.setdefault(p, []).append((p, pos))
    return groups


def judge_batch(q: torch.Tensor, ids_np: np.ndarray, dists_np: np.ndarray, t: Truth, blocks,
                visible: torch.Tensor, deleted: torch.Tensor, metric: str) -> dict:
    """The compared numbers and the summed recall of one answered batch."""
    dev = q.device
    ids = torch.as_tensor(ids_np, device=dev).long()
    dists = torch.as_tensor(dists_np, device=dev).double()
    b, k = ids.shape
    total = visible.shape[0]
    in_range = (ids >= 0) & (ids < total)
    safe = torch.where(in_range, ids, 0)
    is_deleted = in_range & torch.isin(safe, deleted)
    srt, _ = torch.sort(torch.where(in_range, ids, -1 - torch.arange(k, device=dev)), dim=1)
    repeat = torch.zeros_like(in_range)
    repeat[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    expected = (t.ids >= 0).sum(1, keepdim=True)  # answers the visible rows allow
    bad = (~in_range | (~visible[safe] & ~is_deleted)) & (torch.arange(k, device=dev) < expected)
    missing = int(bad.sum()) + int(repeat.sum())

    valid = in_range & ~is_deleted & visible[safe]
    d64 = torch.cat([R.distances_of(q[s : s + _QUERY_CHUNK], blocks,
                                    torch.where(valid, ids, -1)[s : s + _QUERY_CHUNK], metric)
                     for s in range(0, b, _QUERY_CHUNK)])
    err = torch.where(valid, (dists - d64).abs(), torch.zeros_like(d64))
    got, _ = torch.sort(d64, dim=1)
    full = torch.isfinite(t.d64)
    gap = torch.where(full & torch.isfinite(got), got - t.d64, torch.zeros_like(got))
    hit = (ids[:, :, None] == t.ids[:, None, :]) & (t.ids[:, None, :] >= 0)
    recall = (hit.any(2).sum(1) / expected.squeeze(1).clamp_min(1)).sum()
    return {"deleted_returned": int(is_deleted.sum()), "missing_answers": missing,
            "dist_err": float(err.max()), "rank_gap": float(gap.max().clamp_min(0.0)),
            "recall_sum": float(recall), "queries": b}


def combine(parts: List[tuple]) -> dict:
    """Numbers over every judged batch: (numbers of a batch, its count)."""
    out = {"deleted_returned": 0, "missing_answers": 0, "dist_err": 0.0, "rank_gap": 0.0}
    recall, queries = 0.0, 0
    for nums, count in parts:
        out["deleted_returned"] += nums["deleted_returned"] * count
        out["missing_answers"] += nums["missing_answers"] * count
        out["dist_err"] = max(out["dist_err"], nums["dist_err"])
        out["rank_gap"] = max(out["rank_gap"], nums["rank_gap"])
        recall += nums["recall_sum"] * count
        queries += nums["queries"] * count
    out["recall_at_k"] = recall / max(queries, 1)
    return out


def checks(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit."""
    return {name: {"value": numbers[name], "limit": limits[name]} for name in NUMBERS}


def passed(chk: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in chk.values())
