"""A cell's inputs, made from `--seed` on the device.

The corpus generator is the one `chip_smoke.py` (and the JAX package's
`bench.py`) uses: rows drawn around `centres` N(0, 1) cluster centres with
N(0, sigma^2) noise. Every part of a cell (centres, committed rows, memtable
rows, deleted ids, metadata, the query pool) has its own random stream,
derived from the seed and the part's name, so the same seed gives the same
inputs and one part's size never shifts another's values. Sizes never depend
on the seed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

_ROW_CHUNK = 1 << 20  # rows a centre gather adds at once (bounds its temporary)


def stream_seed(seed: int, part: str) -> int:
    """A 63-bit seed for one part of the inputs (any whole `seed`)."""
    digest = hashlib.blake2b(f"{int(seed)}:{part}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed: int, part: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, part))
    return g


def clustered(g: torch.Generator, centres: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """n rows [n, d] f32 on centres' device: a centre drawn uniformly for each
    row plus sigma times standard normal noise."""
    n_c, d = centres.shape
    x = torch.randn((n, d), generator=g, device=centres.device, dtype=torch.float32)
    x.mul_(sigma)
    idx = torch.randint(0, n_c, (n,), generator=g, device=centres.device)
    for s in range(0, n, _ROW_CHUNK):
        x[s : s + _ROW_CHUNK] += centres[idx[s : s + _ROW_CHUNK]]
    return x


@dataclass
class Inputs:
    """One run's inputs. Row i of `base` has id i; row j of `tail` has id
    rows + j. `deleted` holds sorted ids of committed rows. `meta` maps a
    metadata field to its value for every id. Tensors live where they were
    made (the device, or the host after `to_host`)."""

    base: torch.Tensor  # [rows, d] f32, committed
    tail: torch.Tensor  # [memtable_rows, d] f32, left in the memtable
    deleted: np.ndarray  # int64 ids
    meta: Dict[str, np.ndarray]  # field -> int64 [rows + memtable_rows]
    queries: List[torch.Tensor]  # pool of [batch, d] f32

    def to_host(self) -> "Inputs":
        return Inputs(self.base.cpu().numpy(), self.tail.cpu().numpy(), self.deleted,
                      self.meta, [q.cpu().numpy() for q in self.queries])


def corpus(cfg: dict, seed: int, device) -> tuple:
    """(base, tail, centres): the configuration's rows and their cluster
    centres, on `device`."""
    gen = cfg["generator"]
    d = int(cfg["dim"])
    centres = torch.randn((int(gen["centres"]), d), generator=generator(seed, "centres", device),
                          device=device, dtype=torch.float32)
    base = clustered(generator(seed, "base", device), centres, int(cfg["rows"]), gen["sigma"])
    tail = clustered(generator(seed, "tail", device), centres, int(cfg["memtable_rows"]),
                     gen["sigma"])
    return base, tail, centres


def query_pool(cfg: dict, traffic: dict, seed: int, centres: torch.Tensor) -> List[torch.Tensor]:
    """The traffic's pool of distinct query batches, from the corpus's mixture."""
    g = generator(seed, "queries", centres.device)
    return [clustered(g, centres, int(traffic["batch"]), cfg["generator"]["sigma"])
            for _ in range(int(traffic["pool_batches"]))]


def deleted_ids(cfg: dict, seed: int) -> np.ndarray:
    """`deletes` distinct ids of committed rows, sorted."""
    rng = np.random.default_rng(stream_seed(seed, "deletes"))
    ids = rng.choice(int(cfg["rows"]), int(cfg["deletes"]), replace=False)
    return np.sort(ids).astype(np.int64)


def metadata(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """Each metadata field's values for every id: uniform integers in
    [0, cardinality)."""
    total = int(cfg["rows"]) + int(cfg["memtable_rows"])
    out = {}
    for field, card in sorted(cfg.get("metadata", {}).items()):
        rng = np.random.default_rng(stream_seed(seed, f"meta:{field}"))
        out[field] = rng.integers(0, int(card), total, dtype=np.int64)
    return out


def make(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    """Every input of one run, on `device`."""
    base, tail, centres = corpus(cfg, seed, device)
    return Inputs(base, tail, deleted_ids(cfg, seed), metadata(cfg, seed),
                  query_pool(cfg, traffic, seed, centres))


def docs(meta: Dict[str, np.ndarray], lo: int, hi: int) -> Optional[list]:
    """The metadata of ids [lo, hi) as the program takes it: one dict a row."""
    if not meta:
        return None
    fields = list(meta)
    cols = [meta[f][lo:hi].tolist() for f in fields]
    return [dict(zip(fields, vals)) for vals in zip(*cols)]
