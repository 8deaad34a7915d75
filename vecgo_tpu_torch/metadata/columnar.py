"""Columnar metadata store + filter-to-mask compilation.

Reference: internal/metadata (UnifiedIndex: interned inverted index + sorted
numeric index, unified.go:121-257; FilterResult/FilterCursor) and
internal/bitmap (QueryBitmap word ops).

TPU-first collapse (SURVEY.md §7.1): instead of roaring bitmaps + cursor
machinery, each segment keeps typed columns in numpy; a FilterSet compiles to a
dense boolean mask [N] with vectorized compares. The mask ships to the device
for masked scoring; its popcount gives *exact* selectivity (the reference has
to estimate selectivity, unified.go; dense numpy makes exact counting cheap).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from vecgo_tpu_torch.metadata import Filter, FilterSet, Op, as_filterset

_NUMERIC = "num"
_STRING = "str"
_BOOL = "bool"
_ARRAY = "arr"


class ColumnarMeta:
    """Typed columns for one segment's metadata documents."""

    def __init__(self, n: int):
        self.n = n
        # field -> (kind, payload...)
        self.numeric: Dict[str, np.ndarray] = {}  # f64, NaN = absent
        self.bools: Dict[str, np.ndarray] = {}  # int8: -1 absent / 0 / 1
        self.str_codes: Dict[str, np.ndarray] = {}  # int32, -1 = absent
        self.str_values: Dict[str, List[str]] = {}  # code -> value (interning)
        # array fields: CSR of interned codes
        self.arr_indptr: Dict[str, np.ndarray] = {}  # int64 [n+1]
        self.arr_codes: Dict[str, np.ndarray] = {}  # int32 [nnz]
        self.arr_values: Dict[str, List[Any]] = {}
        self.docs: List[Optional[dict]] = []  # source docs (materialization)

    # ---------------- build ----------------

    @staticmethod
    def from_docs(docs: List[Optional[dict]]) -> "ColumnarMeta":
        n = len(docs)
        cm = ColumnarMeta(n)
        cm.docs = list(docs)
        fields: Dict[str, str] = {}
        for doc in docs:
            if not doc:
                continue
            for k, v in doc.items():
                kind = _classify(v)
                if kind is None:
                    continue
                prev = fields.get(k)
                if prev is None:
                    fields[k] = kind
                elif prev != kind:
                    # Mixed-type field: degrade numerics+bools to string repr.
                    fields[k] = _STRING
        for fname, kind in fields.items():
            cm._build_column(fname, kind, docs)
        return cm

    def _build_column(self, fname: str, kind: str, docs):
        n = self.n
        if kind == _NUMERIC:
            col = np.full(n, np.nan, np.float64)
            for i, doc in enumerate(docs):
                v = doc.get(fname) if doc else None
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    col[i] = float(v)
            self.numeric[fname] = col
        elif kind == _BOOL:
            col = np.full(n, -1, np.int8)
            for i, doc in enumerate(docs):
                v = doc.get(fname) if doc else None
                if isinstance(v, bool):
                    col[i] = int(v)
            self.bools[fname] = col
        elif kind == _STRING:
            codes = np.full(n, -1, np.int32)
            interned: Dict[str, int] = {}
            values: List[str] = []
            for i, doc in enumerate(docs):
                v = doc.get(fname) if doc else None
                if v is None:
                    continue
                s = v if isinstance(v, str) else json.dumps(v)
                c = interned.get(s)
                if c is None:
                    c = len(values)
                    interned[s] = c
                    values.append(s)
                codes[i] = c
            self.str_codes[fname] = codes
            self.str_values[fname] = values
        elif kind == _ARRAY:
            indptr = np.zeros(n + 1, np.int64)
            flat: List[int] = []
            interned: Dict[Any, int] = {}
            values: List[Any] = []
            for i, doc in enumerate(docs):
                v = doc.get(fname) if doc else None
                if isinstance(v, (list, tuple)):
                    for item in v:
                        key = item if isinstance(item, (str, int)) else json.dumps(item)
                        c = interned.get(key)
                        if c is None:
                            c = len(values)
                            interned[key] = c
                            values.append(key)
                        flat.append(c)
                indptr[i + 1] = len(flat)
            self.arr_indptr[fname] = indptr
            self.arr_codes[fname] = np.asarray(flat, np.int32)
            self.arr_values[fname] = values

    # ---------------- slab ops (compaction fast path) ----------------

    def field_kinds(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for f in self.numeric:
            out[f] = _NUMERIC
        for f in self.bools:
            out[f] = _BOOL
        for f in self.str_codes:
            out[f] = _STRING
        for f in self.arr_indptr:
            out[f] = _ARRAY
        return out

    def select(self, rows: np.ndarray) -> "ColumnarMeta":
        """Vectorized row selection (compaction: live-row mask applied as a
        gather, no per-row doc materialization)."""
        rows = np.asarray(rows, np.int64)
        cm = ColumnarMeta(len(rows))
        for f, col in self.numeric.items():
            cm.numeric[f] = col[rows]
        for f, col in self.bools.items():
            cm.bools[f] = col[rows]
        for f, codes in self.str_codes.items():
            cm.str_codes[f] = codes[rows]
            cm.str_values[f] = list(self.str_values[f])
        for f, indptr in self.arr_indptr.items():
            data, new_indptr = _csr_take(self.arr_codes[f], indptr, rows)
            cm.arr_indptr[f] = new_indptr
            cm.arr_codes[f] = data
            cm.arr_values[f] = list(self.arr_values[f])
        if self.docs:
            cm.docs = [self.docs[int(r)] for r in rows]
        return cm

    @staticmethod
    def concat(parts: List["ColumnarMeta"]) -> "ColumnarMeta":
        """Vectorized multi-segment concat with re-interning. Raises
        ValueError on a cross-part column kind conflict (rare; callers fall
        back to the per-row doc path)."""
        n = sum(p.n for p in parts)
        out = ColumnarMeta(n)
        kinds: Dict[str, str] = {}
        for p in parts:
            for f, kd in p.field_kinds().items():
                if kinds.setdefault(f, kd) != kd:
                    raise ValueError(
                        f"column kind conflict on field {f!r}: "
                        f"{kinds[f]} vs {kd}"
                    )
        for f, kind in kinds.items():
            if kind == _NUMERIC:
                out.numeric[f] = np.concatenate([
                    p.numeric.get(f, np.full(p.n, np.nan, np.float64))
                    for p in parts
                ])
            elif kind == _BOOL:
                out.bools[f] = np.concatenate([
                    p.bools.get(f, np.full(p.n, -1, np.int8)) for p in parts
                ])
            elif kind == _STRING:
                interned: Dict[str, int] = {}
                values: List[str] = []
                cols = []
                for p in parts:
                    codes = p.str_codes.get(f)
                    if codes is None:
                        cols.append(np.full(p.n, -1, np.int32))
                        continue
                    trans = np.asarray(
                        [_intern(v, interned, values) for v in p.str_values[f]],
                        np.int32,
                    )
                    cols.append(
                        np.where(codes >= 0, trans[np.maximum(codes, 0)], -1)
                        .astype(np.int32)
                    )
                out.str_codes[f] = np.concatenate(cols)
                out.str_values[f] = values
            else:  # _ARRAY
                interned = {}
                values = []
                datas, lens = [], []
                for p in parts:
                    indptr = p.arr_indptr.get(f)
                    if indptr is None:
                        lens.append(np.zeros(p.n, np.int64))
                        continue
                    trans = np.asarray(
                        [_intern(v, interned, values) for v in p.arr_values[f]],
                        np.int32,
                    )
                    codes = p.arr_codes[f]
                    datas.append(
                        trans[codes] if len(codes) else codes.astype(np.int32)
                    )
                    lens.append(np.diff(indptr).astype(np.int64))
                new_indptr = np.zeros(n + 1, np.int64)
                np.cumsum(np.concatenate(lens), out=new_indptr[1:])
                out.arr_indptr[f] = new_indptr
                out.arr_codes[f] = (
                    np.concatenate(datas) if datas else np.zeros(0, np.int32)
                )
                out.arr_values[f] = values
        return out

    # ---------------- filtering ----------------

    def filter_mask(self, f) -> np.ndarray:
        """Compile a Filter/FilterSet to a dense bool mask [n] (AND semantics)."""
        fs = as_filterset(f)
        mask = np.ones(self.n, bool)
        if fs is None:
            return mask
        for flt in fs:
            mask &= self._one_mask(flt)
            if not mask.any():
                break
        return mask

    def selectivity(self, f) -> float:
        m = self.filter_mask(f)
        return float(m.mean()) if self.n else 0.0

    def _one_mask(self, flt: Filter) -> np.ndarray:
        fname, op, val = flt.field, flt.op, flt.value
        if fname in self.numeric:
            return _numeric_mask(self.numeric[fname], op, val)
        if fname in self.bools:
            return _bool_mask(self.bools[fname], op, val)
        if fname in self.str_codes:
            return _string_mask(self.str_codes[fname], self.str_values[fname], op, val)
        if fname in self.arr_indptr:
            return _array_mask(
                self.arr_indptr[fname], self.arr_codes[fname], self.arr_values[fname],
                op, val, self.n,
            )
        # Unknown field: EQ/IN/GT/... match nothing; NEQ matches everything
        # (consistent with "missing != value").
        if op == Op.NEQ:
            return np.ones(self.n, bool)
        return np.zeros(self.n, bool)

    # ---------------- materialization ----------------

    def doc(self, row: int) -> Optional[dict]:
        if self.docs:
            return self.docs[row]
        return self._doc_from_columns(row)

    def _doc_from_columns(self, row: int) -> Optional[dict]:
        out = {}
        for f, col in self.numeric.items():
            if not np.isnan(col[row]):
                v = col[row]
                out[f] = int(v) if float(v).is_integer() else float(v)
        for f, col in self.bools.items():
            if col[row] >= 0:
                out[f] = bool(col[row])
        for f, codes in self.str_codes.items():
            if codes[row] >= 0:
                out[f] = self.str_values[f][codes[row]]
        for f, indptr in self.arr_indptr.items():
            s, e = indptr[row], indptr[row + 1]
            if e > s:
                vals = self.arr_values[f]
                out[f] = [vals[c] for c in self.arr_codes[f][s:e]]
        return out or None

    # ---------------- persistence ----------------

    def to_sections(self):
        """Returns (meta_dict, {section_name: ndarray})."""
        sections = {}
        meta = {"n": self.n, "fields": {}}
        for f, col in self.numeric.items():
            meta["fields"][f] = {"kind": _NUMERIC}
            sections[f"md.num.{f}"] = col
        for f, col in self.bools.items():
            meta["fields"][f] = {"kind": _BOOL}
            sections[f"md.bool.{f}"] = col
        for f, codes in self.str_codes.items():
            meta["fields"][f] = {"kind": _STRING, "values": self.str_values[f]}
            sections[f"md.str.{f}"] = codes
        for f, indptr in self.arr_indptr.items():
            meta["fields"][f] = {"kind": _ARRAY, "values": self.arr_values[f]}
            sections[f"md.arrp.{f}"] = indptr
            sections[f"md.arrc.{f}"] = self.arr_codes[f]
        return meta, sections

    @staticmethod
    def from_sections(meta, sections) -> "ColumnarMeta":
        cm = ColumnarMeta(meta["n"])
        for f, spec in meta.get("fields", {}).items():
            kind = spec["kind"]
            if kind == _NUMERIC:
                cm.numeric[f] = np.asarray(sections[f"md.num.{f}"])
            elif kind == _BOOL:
                cm.bools[f] = np.asarray(sections[f"md.bool.{f}"])
            elif kind == _STRING:
                cm.str_codes[f] = np.asarray(sections[f"md.str.{f}"])
                cm.str_values[f] = list(spec["values"])
            elif kind == _ARRAY:
                cm.arr_indptr[f] = np.asarray(sections[f"md.arrp.{f}"])
                cm.arr_codes[f] = np.asarray(sections[f"md.arrc.{f}"])
                cm.arr_values[f] = list(spec["values"])
        return cm


def _intern(v, interned: dict, values: list) -> int:
    c = interned.get(v)
    if c is None:
        c = len(values)
        interned[v] = c
        values.append(v)
    return c


def _csr_take(data: np.ndarray, indptr: np.ndarray, rows: np.ndarray):
    """Gather CSR rows: returns (data', indptr') for the selected rows."""
    starts = indptr[rows]
    counts = (indptr[rows + 1] - starts).astype(np.int64)
    new_indptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(counts, out=new_indptr[1:])
    total = int(new_indptr[-1])
    if total == 0:
        return data[:0], new_indptr
    idx = (
        np.arange(total, dtype=np.int64)
        - np.repeat(new_indptr[:-1], counts)
        + np.repeat(starts.astype(np.int64), counts)
    )
    return data[idx], new_indptr


def _classify(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, bool):
        return _BOOL
    if isinstance(v, (int, float)):
        return _NUMERIC
    if isinstance(v, str):
        return _STRING
    if isinstance(v, (list, tuple)):
        return _ARRAY
    return _STRING  # fallback: JSON repr


def _numeric_mask(col: np.ndarray, op: Op, val) -> np.ndarray:
    present = ~np.isnan(col)
    if op == Op.EQ:
        return present & (col == float(val))
    if op == Op.NEQ:
        return ~(present & (col == float(val)))
    if op == Op.GT:
        return present & (col > float(val))
    if op == Op.GTE:
        return present & (col >= float(val))
    if op == Op.LT:
        return present & (col < float(val))
    if op == Op.LTE:
        return present & (col <= float(val))
    if op == Op.IN:
        return present & np.isin(col, np.asarray([float(v) for v in val]))
    raise ValueError(f"op {op} unsupported on numeric field")


def _bool_mask(col: np.ndarray, op: Op, val) -> np.ndarray:
    if op == Op.EQ:
        return col == int(bool(val))
    if op == Op.NEQ:
        return col != int(bool(val))
    raise ValueError(f"op {op} unsupported on bool field")


def _string_mask(codes: np.ndarray, values: List[str], op: Op, val) -> np.ndarray:
    lut = {v: i for i, v in enumerate(values)}
    if op == Op.EQ:
        c = lut.get(val, -2)
        return codes == c
    if op == Op.NEQ:
        c = lut.get(val, -2)
        return codes != c
    if op == Op.IN:
        cs = np.asarray([lut.get(v, -2) for v in val], np.int32)
        return np.isin(codes, cs)
    if op in (Op.GT, Op.GTE, Op.LT, Op.LTE):
        # Lexicographic compare: map codes -> sorted rank.
        order = np.argsort(np.asarray(values, object))
        rank_of_code = np.empty(len(values), np.int64)
        rank_of_code[order] = np.arange(len(values))
        svals = [values[i] for i in order]
        import bisect

        present = codes >= 0
        ranks = np.where(present, rank_of_code[np.maximum(codes, 0)], -1)
        if op == Op.GT:
            pivot = bisect.bisect_right(svals, val)
            return present & (ranks >= pivot)
        if op == Op.GTE:
            pivot = bisect.bisect_left(svals, val)
            return present & (ranks >= pivot)
        if op == Op.LT:
            pivot = bisect.bisect_left(svals, val)
            return present & (ranks < pivot)
        pivot = bisect.bisect_right(svals, val)
        return present & (ranks < pivot)
    raise ValueError(f"op {op} unsupported on string field")


def _array_mask(indptr, codes, values, op: Op, val, n: int) -> np.ndarray:
    lut = {v: i for i, v in enumerate(values)}
    if op == Op.CONTAINS:
        targets = np.asarray([lut.get(val, -2)], np.int32)
    elif op == Op.IN:  # any-of
        targets = np.asarray([lut.get(v, -2) for v in val], np.int32)
    else:
        raise ValueError(f"op {op} unsupported on array field")
    hit = np.isin(codes, targets)
    # Reduce per-row over CSR: count of hits in [indptr[i], indptr[i+1]) > 0.
    cum = np.concatenate([[0], np.cumsum(hit)])
    return (cum[indptr[1:]] - cum[indptr[:-1]]) > 0
