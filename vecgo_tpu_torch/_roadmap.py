"""What the port does not cover yet, by its item in ROADMAP.md's port queue."""

QUEUE = {
    3: ("the rest of graph segments: serve_compact (3c), the beam build mode with the "
        "uncoded IVF table (3d), FreshVamana (3e), tools/compact (3f)"),
    4: "device BM25 hybrid search",
    5: "the multi-device plane",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to vecgo_tpu_torch yet "
        f"(ROADMAP.md, port queue item {item}: {QUEUE[item]})"
    )
