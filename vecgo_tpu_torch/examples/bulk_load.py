"""Bulk loading a large corpus (reference: examples/bulk_load — the deferred
insert path; bulk appends are the only insert path and run at millions of
rows/s host-side)."""

import time

import numpy as np

import vecgo_tpu_torch as vecgo
from vecgo_tpu_torch.engine import EngineOptions


def main(device="cuda"):
    n, d = 200_000, 64
    db = vecgo.Open(
        vecgo.Memory(),
        EngineOptions(dim=d, flush_threshold=250_000, graph_threshold=1 << 40, device=device),
    )
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, d)).astype(np.float32)

    t0 = time.perf_counter()
    db.insert_batch(x)
    dt = time.perf_counter() - t0
    print(f"ingested {n} rows in {dt:.2f}s -> {n / dt:,.0f} rows/s")

    t0 = time.perf_counter()
    db.commit()
    print(f"commit (flush to immutable segment): {time.perf_counter() - t0:.2f}s")

    q = x[123]
    hit = db.search(q, k=1)[0]
    print("self-search:", hit.id, f"{hit.distance:.2e}")


if __name__ == "__main__":
    main()
