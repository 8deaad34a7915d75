"""What the port does not cover yet, by its item in ROADMAP.md's port queue."""

QUEUE = {
    3: ("the rest of graph segments: the beam build mode, serve_compact, stored "
        "codes and the cluster cache (with the planner's preference for graph_cached over "
        "graph_stream), FreshVamana, tools/compact, the uncoded IVF table"),
    4: "device BM25 hybrid search",
    5: "the multi-device plane",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to vecgo_tpu_torch yet "
        f"(ROADMAP.md, port queue item {item}: {QUEUE[item]})"
    )
