"""What the port does not cover yet, by its item in ROADMAP.md's port queue."""

QUEUE = {
    5: "the multi-device plane",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to vecgo_tpu_torch yet "
        f"(ROADMAP.md, port queue item {item}: {QUEUE[item]})"
    )
