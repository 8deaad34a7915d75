"""Versioned time travel + vacuum (reference: examples/time_travel)."""

import numpy as np

import vecgo_tpu_torch as vecgo
from vecgo_tpu_torch.blobstore import MemoryStore


def main(device="cuda"):
    shared = MemoryStore()
    db = vecgo.Open(vecgo.Remote(shared), vecgo.Create(dim=16, device=device))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((100, 16)).astype(np.float32)

    ids = db.insert_batch(x[:50])
    v1 = db.commit()
    db.delete(ids[0])
    db.insert_batch(x[50:])
    v2 = db.commit()
    print(f"versions on disk: {db.versions()}")

    # Open the database as of version v1: the delete and second batch are
    # not visible there.
    old = vecgo.Open(vecgo.Remote(shared), version=v1, device=device)
    print("v1 live rows:", old.stats()["live_rows"])  # 50
    print("v1 still finds the deleted id:", old.search(x[0], k=1)[0].id == ids[0])

    now = vecgo.Open(vecgo.Remote(shared), device=device)
    print("current live rows:", now.stats()["live_rows"])  # 99

    # Reclaim history beyond the retention policy.
    db.engine.options.retention_versions = 1
    print("vacuum:", db.vacuum())
    print("versions after vacuum:", db.versions())


if __name__ == "__main__":
    main()
