"""Hybrid vector + BM25 search with RRF fusion — the RAG building block
(reference: examples/rag + HybridSearch engine.go:1538)."""

import numpy as np

import vecgo_tpu_torch as vecgo
from vecgo_tpu_torch.engine import EngineOptions

DOCS = [
    "jax compiles numerical programs for tpus",
    "the quick brown fox jumps over the lazy dog",
    "vector databases answer nearest neighbor queries",
    "bm25 ranks documents by term frequency statistics",
    "tpus multiply matrices with a systolic array",
    "hybrid search fuses lexical and semantic signals",
]


def fake_embed(texts, dim=48):
    """Stand-in for a real embedding model (hash-based, deterministic)."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        for tok in t.split():
            rng = np.random.default_rng(abs(hash(tok)) % (2**32))
            out[i] += rng.standard_normal(dim).astype(np.float32)
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


def main(device="cuda"):
    db = vecgo.Open(
        vecgo.Memory(), EngineOptions(dim=48, lexical=True, device=device)
    )
    embs = fake_embed(DOCS)
    db.insert_batch(embs, texts=DOCS, payloads=[d.encode() for d in DOCS])
    db.commit()

    query = "how do tpus do matrix multiplication"
    qv = fake_embed([query])[0]
    hits = db.hybrid_search(qv, query, k=3)
    for h in hits:
        print(f"rrf={-h.distance:.4f}  {h.payload.decode()}")


if __name__ == "__main__":
    main()
