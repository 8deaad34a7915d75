"""Batched lockstep graph search + vectorized RobustPrune (port of
vecgo_tpu/ops/beam.py).

B queries walk the graph in lockstep. Each keeps a sorted list of `ef`
(id, dist, expanded) entries; a step expands the `beam_width` nearest
unexpanded entries, gathers their neighbour rows, scores them (a bf16 row
scorer or the SQ8-coded scorer), and merges by two sorts: an (id, dist)
sort that makes duplicate ids adjacent, then a dist sort. A filtered search
keeps a separate masked result list.

`lax.sort` takes several keys; `torch.sort` takes one. A lexicographic
(id, dist) order is two stable sorts, the secondary key first, which also
keeps `lax.sort`'s stability, so equal entries keep their order and the
lists match the JAX package's entry for entry.

The JAX search runs a `lax.while_loop` until no query has an unexpanded
entry. Here the loop runs its fixed `max_steps`: a step over a fully
expanded list selects nothing and leaves every list as it was, so the lists
are the same, and no step waits for the host to test the stop condition.
"""

from __future__ import annotations

import math

import torch

_BIG = 3.0e38


def _lex_order(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Row-wise permutation sorting by (primary, secondary), stable."""
    o1 = torch.sort(secondary, dim=1, stable=True).indices
    o2 = torch.sort(primary.gather(1, o1), dim=1, stable=True).indices
    return o1.gather(1, o2)


def _adjacent_dups(si: torch.Tensor) -> torch.Tensor:
    """True where an id equals its left neighbour (ids >= 0 only)."""
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)
    return dup


def _dedup_topk(d: torch.Tensor, i: torch.Tensor, k: int):
    """Unique-by-id top-k: an (id, dist) sort makes duplicate ids adjacent
    with the best copy first; the rest are killed, then a dist sort."""
    order = _lex_order(i, d)
    si, sd = i.gather(1, order), d.gather(1, order)
    dup = _adjacent_dups(si)
    sd = torch.where(dup, _BIG, sd)
    si = torch.where(dup, -1, si)
    o = torch.sort(sd, dim=1, stable=True).indices
    return sd.gather(1, o)[:, :k], si.gather(1, o)[:, :k]


def _score_rows(q16, qn, vectors, rnorm2, ids):
    """Distances from q [B, d] (bf16 values, f32 type) to vectors[ids]
    [B, M]: bf16 x bf16 products are exact, sums in f32."""
    safe = ids.clamp_min(0)
    v = vectors[safe].float()  # [B, M, d]
    prod = torch.bmm(v, q16[:, :, None])[:, :, 0]
    return qn + rnorm2[safe] - 2.0 * prod


def _auto_steps(ef: int, beam_width: int, n: int) -> int:
    return ef // max(beam_width, 1) + 8 + int(math.ceil(math.log2(max(n, 2))))


def beam_search(q, vectors, rnorm2, graph, entry_ids, *, ef: int, k: int,
                beam_width: int = 8, max_steps: int = 0, mask=None,
                with_visited: bool = False, score_fn=None):
    """Batched beam search (the port of `beam_search` and its body
    `beam_search_traced`). q [B, d]; vectors [N, d] (bf16 traversal copy)
    and rnorm2 [N], or score_fn(ids [B, M]) -> dists [B, M]; graph [N, R]
    (-1 padded); entry_ids [E] shared or [B, E] per query; mask [N] bool:
    result filter (traversal unrestricted). Returns (res_d [B, k], res_i
    [B, k]) plus, with with_visited, the final list (cand_d, cand_ids)."""
    b = q.shape[0]
    dev = q.device
    r = graph.shape[1]
    if max_steps == 0:
        max_steps = _auto_steps(ef, beam_width, graph.shape[0])
    qf = q.float()
    q16 = q.to(torch.bfloat16).float()
    qn = (qf * qf).sum(-1, keepdim=True)
    if score_fn is None:
        def score_fn(ids):
            return _score_rows(q16, qn, vectors, rnorm2, ids)

    init_ids = entry_ids.long()
    if init_ids.dim() == 1:
        init_ids = init_ids[None, :].expand(b, -1)
    e = init_ids.shape[1]
    init_d = torch.where(init_ids >= 0, score_fn(init_ids), _BIG)
    pad = max(ef - e, 0)
    cand_ids = torch.cat([init_ids, torch.full((b, pad), -1, dtype=torch.int64, device=dev)], 1)
    cand_d = torch.cat([init_d, torch.full((b, pad), _BIG, device=dev)], 1)
    cand_d, cand_ids = _dedup_topk(cand_d, cand_ids, ef)
    expanded = cand_ids < 0  # sentinels count as expanded

    track_res = mask is not None
    if track_res:
        allowed0 = mask[init_ids.clamp_min(0)] & (init_ids >= 0)
        kpad = max(k - e, 0)
        res_d = torch.cat([torch.where(allowed0, init_d, _BIG),
                           torch.full((b, kpad), _BIG, device=dev)], 1)
        res_i = torch.cat([init_ids, torch.full((b, kpad), -1, dtype=torch.int64, device=dev)], 1)
        res_d, res_i = _dedup_topk(res_d, res_i, k)

    w = min(beam_width, cand_ids.shape[1])
    for _ in range(max_steps):
        # ---- the w nearest unexpanded entries (the list is sorted) ----
        unexp = ~expanded & (cand_d < _BIG)
        rank = torch.cumsum(unexp.int(), 1)
        selm = unexp & (rank <= beam_width)
        pick = torch.sort(torch.where(selm, rank, beam_width + 1), dim=1,
                          stable=True).indices[:, :w]
        sel_ok = selm.gather(1, pick)
        sel_ids = torch.where(sel_ok, cand_ids.gather(1, pick), -1)
        expanded = expanded | selm

        # ---- expand and score ----
        nbrs = graph[sel_ids.clamp_min(0)].long()  # [B, w, R]
        nbrs = torch.where(sel_ok[:, :, None], nbrs, -1).reshape(b, w * r)
        fresh = nbrs >= 0
        d_new = torch.where(fresh, score_fn(nbrs), _BIG)

        # ---- merge into the sorted ef-list, one copy per id ----
        all_d = torch.cat([cand_d, d_new], 1)
        all_i = torch.cat([cand_ids, nbrs], 1)
        all_e = torch.cat([expanded, torch.zeros_like(fresh)], 1)
        order = _lex_order(all_i, all_d)
        si, sd, se = all_i.gather(1, order), all_d.gather(1, order), all_e.gather(1, order)
        # The kept (first) copy inherits "expanded" from any later copy: a
        # segmented suffix-OR over id groups in doubling strides.
        width = si.shape[1]
        stride = 1
        while stride < width:
            later = torch.zeros_like(se)
            same = si[:, : width - stride] == si[:, stride:]
            later[:, : width - stride] = se[:, stride:] & same
            se = se | later
            stride *= 2
        dup = _adjacent_dups(si)
        sd = torch.where(dup, _BIG, sd)
        si = torch.where(dup, -1, si)
        se = se | dup
        o = torch.sort(sd, dim=1, stable=True).indices[:, :ef]
        cand_d, cand_ids, expanded = sd.gather(1, o), si.gather(1, o), se.gather(1, o)

        if track_res:
            allowed = mask[nbrs.clamp_min(0)] & fresh
            res_d, res_i = _dedup_topk(torch.cat([res_d, torch.where(allowed, d_new, _BIG)], 1),
                                       torch.cat([res_i, nbrs], 1), k)

    if not track_res:
        res_d, res_i = cand_d[:, :k], cand_ids[:, :k]
    res_d = torch.where(res_d >= _BIG, math.inf, res_d)
    res_i = torch.where(torch.isfinite(res_d), res_i, -1)
    if with_visited:
        return res_d, res_i, torch.where(cand_d >= _BIG, math.inf, cand_d), cand_ids
    return res_d, res_i


def coded_score_closure(q, qc, table):
    """Scorer over an IVFCodedTable: candidate rows -> distances to the
    decoded vectors x^ = c + s * code,
    d(q, x^) = |q|^2 + |x^|^2 - 2 (q.c + s (bf16(q) . code)), with q.c from
    the precomputed [B, K] centroid products `qc`."""
    k_pad, s, d = table.codes.shape
    codes_flat = table.codes.reshape(k_pad * s, d)
    xn_flat = table.xnorm2.reshape(-1)
    qf = q.float()
    q16 = q.to(torch.bfloat16).float()
    qn = (qf * qf).sum(-1, keepdim=True)

    def score(ids):
        b, m = ids.shape
        slot = table.slot_of_row[ids.clamp_min(0)].long()  # [B, M]
        cl = slot // s
        cv = codes_flat[slot].float()  # [B, M, d]
        prod = torch.bmm(cv, q16[:, :, None])[:, :, 0]
        return qn + xn_flat[slot] - 2.0 * (qc.gather(1, cl) + table.scale[cl] * prod)

    return score


def beam_search_coded(q, table, graph, entry_ids, qc, *, ef: int, k: int,
                      beam_width: int = 4, max_steps: int = 0, mask=None):
    """Beam search scoring SQ8 residual codes (the codes table is the only
    vector data on the device)."""
    if max_steps == 0:
        max_steps = _auto_steps(ef, beam_width, graph.shape[0])
    return beam_search(q, None, None, graph, entry_ids, ef=ef, k=k, beam_width=beam_width,
                       max_steps=max_steps, mask=mask,
                       score_fn=coded_score_closure(q, qc, table))


def robust_prune(p_ids, p_vecs, cand_ids, vectors, rnorm2, *, r_out: int, alpha: float,
                 vectors_occ=None, rnorm2_occ=None, pick_batch: int = 8):
    """Vectorized RobustPrune, the batched form of `robust_prune_traced`
    (reference: diskann/writer.go:
    571-625). Candidates are taken in ascending d(p, .) order in contiguous
    batches of `pick_batch`; a candidate is kept unless an already kept
    neighbour c occludes it (alpha * d(c, x) <= d(p, x)), up to r_out kept.
    The occlusion distances may come from a low-dimensional projection
    (vectors_occ, rnorm2_occ). Returns [C, r_out] int64 ids, -1 padded."""
    c, l = cand_ids.shape
    dev = cand_ids.device
    m = min(pick_batch, l)
    pf = p_vecs.float()
    p16 = p_vecs.to(torch.bfloat16).float()
    pn = (pf * pf).sum(-1, keepdim=True)

    # Dedup candidates by id before any gathers.
    si = torch.sort(cand_ids.long(), dim=1).values
    cand_ids = torch.where(_adjacent_dups(si), -1, si)
    safe = cand_ids.clamp_min(0)
    cv16 = vectors[safe].to(torch.bfloat16).float()  # [C, L, d]
    d_p = pn + rnorm2[safe] - 2.0 * torch.bmm(cv16, p16[:, :, None])[:, :, 0]
    valid = (cand_ids >= 0) & (cand_ids != p_ids.long()[:, None])
    d_p = torch.where(valid, d_p.clamp_min(0.0), _BIG)

    o = torch.sort(d_p, dim=1, stable=True).indices
    d_s, ids_s = d_p.gather(1, o), cand_ids.gather(1, o)
    safe_s = ids_s.clamp_min(0)
    occ, occ_n = (vectors_occ, rnorm2_occ) if vectors_occ is not None else (vectors, rnorm2)
    ov16 = occ[safe_s].to(torch.bfloat16).float()
    on = occ_n[safe_s]
    valid_s = d_s < _BIG

    l_pad = -(-l // m) * m
    if l_pad > l:
        padw = l_pad - l
        ov16 = torch.cat([ov16, ov16.new_zeros((c, padw, ov16.shape[2]))], 1)
        on = torch.cat([on, on.new_full((c, padw), _BIG)], 1)
        d_s = torch.cat([d_s, d_s.new_full((c, padw), _BIG)], 1)
        ids_s = torch.cat([ids_s, ids_s.new_full((c, padw), -1)], 1)
        valid_s = torch.cat([valid_s, valid_s.new_zeros((c, padw))], 1)

    occ_d = ov16.shape[-1]
    r_iota = torch.arange(r_out, device=dev)
    # Empty keeper slots carry _BIG norms: their occlusion distances are
    # astronomically large, so they never kill.
    k_occ = torch.zeros((c, r_out, occ_d), dtype=torch.float32, device=dev)
    k_on = torch.full((c, r_out), _BIG, dtype=torch.float32, device=dev)
    out_ids = torch.full((c, r_out), -1, dtype=torch.int64, device=dev)
    count = torch.zeros(c, dtype=torch.int64, device=dev)
    for s0 in range(0, l_pad, m):
        cb16 = ov16[:, s0 : s0 + m]
        on_b, dpb = on[:, s0 : s0 + m], d_s[:, s0 : s0 + m]
        idsb, vb = ids_s[:, s0 : s0 + m], valid_s[:, s0 : s0 + m]
        # Kills from the kept set: alpha * d(keeper, x) <= d_p(x).
        d_k = on_b[:, :, None] + k_on[:, None, :] - 2.0 * torch.bmm(cb16, k_occ.transpose(1, 2))
        killed = (alpha * d_k.clamp_min(0.0) <= dpb[:, :, None]).any(2)
        alive_b = vb & ~killed
        # Within the batch, earlier survivors kill later members, in order.
        gram = torch.bmm(cb16, cb16.transpose(1, 2))
        d_bb = (on_b[:, :, None] + on_b[:, None, :] - 2.0 * gram).clamp_min(0.0)
        for j in range(1, m):
            kill_j = (alive_b[:, :j] & (alpha * d_bb[:, :j, j] <= dpb[:, j : j + 1])).any(1)
            alive_b[:, j] &= ~kill_j
        # Append the survivors to the kept set (one-hot column writes).
        col = count[:, None] + torch.cumsum(alive_b.long(), 1) - 1
        ok_w = alive_b & (col < r_out)
        wm = ok_w[:, :, None] & (col[:, :, None] == r_iota)  # [C, m, r_out]
        hit = wm.any(1)
        out_ids = torch.where(hit, torch.where(wm, idsb[:, :, None], 0).sum(1), out_ids)
        k_on = torch.where(hit, torch.where(wm, on_b[:, :, None], 0.0).sum(1), k_on)
        k_occ = k_occ + torch.bmm(wm.float().transpose(1, 2), cb16)
        count = count + ok_w.sum(1)
    return out_ids
