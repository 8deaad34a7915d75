"""Writer/reader separation over a shared store with block caches
(reference: examples/cloud_tiered — S3 + RAM/NVMe cache tiers)."""

import tempfile

import numpy as np

import vecgo_tpu_torch as vecgo
from vecgo_tpu_torch.blobstore import MemoryStore
from vecgo_tpu_torch.storage.cache import CachingStore, DiskCache, LRUCache, TieredCache


def main(device="cuda"):
    # MemoryStore stands in for S3; swap in blobstore.s3.S3Store(client, bucket)
    # in production. The cache tiers are identical either way.
    cloud = MemoryStore()

    with tempfile.TemporaryDirectory() as nvme:
        tier = TieredCache(
            ram=LRUCache(64 * 1024 * 1024),
            disk=DiskCache(nvme, 1024 * 1024 * 1024),
        )
        cached = CachingStore(cloud, cache=tier, block_size=4 * 1024 * 1024)

        # One writer...
        writer = vecgo.Open(vecgo.Remote(cached), vecgo.Create(dim=32, device=device))
        rng = np.random.default_rng(3)
        x = rng.standard_normal((5000, 32)).astype(np.float32)
        ids = writer.insert_batch(x)
        writer.commit()

        # ...many stateless readers over the same store.
        reader = vecgo.Open(vecgo.Remote(cached, read_only=True), device=device)
        hit = reader.search(x[7], k=1)[0]
        print(f"reader found id={hit.id} (want {ids[7]})")
        print("cache stats:", cached.cache_stats())


if __name__ == "__main__":
    main()
