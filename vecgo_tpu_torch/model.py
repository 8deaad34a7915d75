"""Core model types (reference: model/types.go, distance/distance.go).

Host-side types are plain Python/numpy; nothing here imports jax. Device code
works in dense row space [0, N) per segment; the host maps rows <-> user IDs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class Metric(enum.Enum):
    """Distance metric (reference: distance/distance.go:66-73).

    All internal scores use the *smaller-is-better* convention:
      L2      -> squared euclidean distance
      COSINE  -> cosine distance = 1 - cos(q, x)   (vectors L2-normalized)
      DOT     -> negative inner product
      HAMMING -> bit hamming distance (packed binary vectors)
    """

    L2 = "l2"
    COSINE = "cosine"
    DOT = "dot"
    HAMMING = "hamming"

    def compute(self) -> "Metric":
        """The scoring-space metric. HAMMING vectors are 0/1-encoded floats,
        for which hamming(u, v) == ||u - v||^2 EXACTLY — so the whole L2
        compute path (matmul scoring, graphs, IVF, rerank) serves hamming
        unchanged and distances come back as exact bit counts. (The
        reference's dedicated XOR+popcount kernels, simd Hamming, exist to
        make CPU scans fast; on the MXU the matmul identity is the fast path.)
        """
        return Metric.L2 if self is Metric.HAMMING else self


@dataclass(frozen=True)
class Location:
    """Physical row address: (segment id, row within segment).

    Reference: model.Location (model/types.go).
    """

    segment_id: int
    row: int


@dataclass
class Candidate:
    """A search hit (reference: model.Candidate)."""

    id: int
    distance: float
    metadata: Optional[dict] = None
    payload: Optional[bytes] = None
    vector: Any = None  # np.ndarray when materialized with data


@dataclass
class Record:
    """An insertable record (reference: model.Record + builder, vecgo.go:196)."""

    vector: Any  # array-like float32 [d]
    metadata: Optional[dict] = None
    payload: Optional[bytes] = None
    id: Optional[int] = None  # assigned by engine if None


@dataclass
class SearchOptions:
    """Per-query options (reference: model.SearchOptions, vecgo.go:236-333)."""

    k: int = 10
    filter: Any = None  # metadata.Filter / FilterSet
    prefilter: Optional[bool] = None  # force pre-filter strategy; None = adaptive
    refine_factor: int = 2  # rerank pool = refine_factor * k (candidates)
    nprobes: int = 0  # IVF probes (0 = auto)
    beam_width: int = 0  # graph beam width override (0 = index default)
    ef: int = 0  # graph search list size override (0 = index default)
    # Graph serving profile (two-stage segments). Defaults (-1/None) keep the
    # index's exact-leaning behavior: f32 ef-pool rescore + 1 refine round.
    # The measured fast profile (graph_refine=0, graph_rescore=False) serves
    # 163k QPS @ recall 0.9575 at 1M vs ~20k exact (docs/PERF.md) — the
    # reference's RefineFactor/NProbes-style quality/throughput dial.
    graph_refine: int = -1  # expansion rounds after the IVF shortlist
    graph_rescore: Optional[bool] = None  # decoded-f32 pool rescore pre-cut
    graph_qcap_factor: float = 0.0  # scan query-capacity multiple (0 = auto 3x)
    selectivity_cutoff: float = 0.30  # brute-force-with-mask below this selectivity
    with_stats: bool = False
    without_data: bool = False  # skip metadata/payload materialization
    with_vectors: bool = False  # materialize vectors into candidates
    batch: bool = False  # internal: part of a batched query


@dataclass
class QueryStats:
    """Query explainability (reference: model.QueryStats, model/types.go:137-249)."""

    total_time_s: float = 0.0
    planning_time_s: float = 0.0
    scoring_time_s: float = 0.0
    rerank_time_s: float = 0.0
    materialize_time_s: float = 0.0
    distance_computations: int = 0
    rows_considered: int = 0
    rows_filtered_out: int = 0
    segments_total: int = 0
    segments_pruned: int = 0
    segments_brute_force: int = 0
    segments_graph: int = 0
    selectivity: float = 1.0
    strategy: str = ""
    nodes_visited: int = 0

    def explain(self) -> str:
        """Human-readable query plan summary (reference: QueryStats.Explain)."""
        lines = [
            f"strategy={self.strategy} selectivity={self.selectivity:.4f}",
            (
                f"segments: total={self.segments_total} pruned={self.segments_pruned} "
                f"brute={self.segments_brute_force} graph={self.segments_graph}"
            ),
            (
                f"rows considered={self.rows_considered} filtered_out={self.rows_filtered_out} "
                f"distances={self.distance_computations} nodes_visited={self.nodes_visited}"
            ),
            (
                f"time: total={self.total_time_s * 1e6:.0f}us plan={self.planning_time_s * 1e6:.0f}us "
                f"score={self.scoring_time_s * 1e6:.0f}us rerank={self.rerank_time_s * 1e6:.0f}us "
                f"materialize={self.materialize_time_s * 1e6:.0f}us"
            ),
        ]
        return "\n".join(lines)

    def estimated_cost(self) -> float:
        """Abstract cost units ~ distance computations (reference: EstimatedCost)."""
        return float(self.distance_computations) + 10.0 * self.segments_total


@dataclass
class SearchResult:
    """Result of a search: candidates plus optional stats."""

    candidates: list = field(default_factory=list)
    stats: Optional[QueryStats] = None

    def __iter__(self):
        return iter(self.candidates)

    def __len__(self):
        return len(self.candidates)

    def __getitem__(self, i):
        return self.candidates[i]
