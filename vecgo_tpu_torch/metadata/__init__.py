"""Public metadata types: values, filters, schema.

Reference: metadata/types.go (typed Value with interned strings, Document,
Filter/FilterSet with 8 operators at types.go:409-447), metadata/schema.go.

TPU-first collapse: filters do not drive cursor/bitmap machinery; they compile
to dense boolean masks [N] per segment (metadata/columnar.py) which ship to the
device for masked scoring (SURVEY.md §7.1).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence

from vecgo_tpu_torch.errors import ErrSchemaViolation

Document = Dict[str, Any]  # values: None | bool | int | float | str | list


class Op(enum.Enum):
    """Filter operators (reference: metadata/types.go:409-447)."""

    EQ = "eq"
    NEQ = "neq"
    GT = "gt"
    GTE = "gte"
    LT = "lt"
    LTE = "lte"
    IN = "in"
    CONTAINS = "contains"  # membership in an array-valued field


@dataclass(frozen=True)
class Filter:
    """A single predicate on one metadata field."""

    field: str
    op: Op
    value: Any

    def __and__(self, other):
        return FilterSet([self]) & other


@dataclass
class FilterSet:
    """Conjunction (AND) of filters (reference: metadata.FilterSet)."""

    filters: List[Filter] = dc_field(default_factory=list)

    def __and__(self, other):
        if isinstance(other, Filter):
            return FilterSet(self.filters + [other])
        if isinstance(other, FilterSet):
            return FilterSet(self.filters + other.filters)
        return NotImplemented

    def __iter__(self):
        return iter(self.filters)

    def __len__(self):
        return len(self.filters)


def eq(field: str, value) -> Filter:
    return Filter(field, Op.EQ, value)


def neq(field: str, value) -> Filter:
    return Filter(field, Op.NEQ, value)


def gt(field: str, value) -> Filter:
    return Filter(field, Op.GT, value)


def gte(field: str, value) -> Filter:
    return Filter(field, Op.GTE, value)


def lt(field: str, value) -> Filter:
    return Filter(field, Op.LT, value)


def lte(field: str, value) -> Filter:
    return Filter(field, Op.LTE, value)


def isin(field: str, values: Sequence) -> Filter:
    return Filter(field, Op.IN, list(values))


def contains(field: str, value) -> Filter:
    return Filter(field, Op.CONTAINS, value)


def as_filterset(f) -> Optional[FilterSet]:
    if f is None:
        return None
    if isinstance(f, Filter):
        return FilterSet([f])
    if isinstance(f, FilterSet):
        return f
    raise TypeError(f"not a filter: {f!r}")


class FieldType(enum.Enum):
    INT = "int"
    FLOAT = "float"
    STRING = "string"
    BOOL = "bool"
    ARRAY = "array"  # list of strings/ints


_PY_TYPES = {
    FieldType.INT: (int,),
    FieldType.FLOAT: (int, float),
    FieldType.STRING: (str,),
    FieldType.BOOL: (bool,),
    FieldType.ARRAY: (list, tuple),
}


@dataclass
class FieldSpec:
    type: FieldType
    required: bool = False


@dataclass
class Schema:
    """Optional metadata schema validation (reference: metadata/schema.go:40-120)."""

    fields: Dict[str, FieldSpec] = dc_field(default_factory=dict)
    strict: bool = False  # reject unknown fields

    def validate(self, doc: Optional[Document]) -> None:
        doc = doc or {}
        for name, spec in self.fields.items():
            v = doc.get(name)
            if v is None:
                if spec.required:
                    raise ErrSchemaViolation(f"missing required field {name!r}")
                continue
            # bool is a subclass of int; disambiguate.
            if spec.type in (FieldType.INT, FieldType.FLOAT) and isinstance(v, bool):
                raise ErrSchemaViolation(f"field {name!r}: bool given, want {spec.type.value}")
            if not isinstance(v, _PY_TYPES[spec.type]):
                raise ErrSchemaViolation(
                    f"field {name!r}: {type(v).__name__} given, want {spec.type.value}"
                )
        if self.strict:
            unknown = set(doc) - set(self.fields)
            if unknown:
                raise ErrSchemaViolation(f"unknown fields {sorted(unknown)}")

    def to_dict(self):
        return {
            "strict": self.strict,
            "fields": {
                k: {"type": s.type.value, "required": s.required}
                for k, s in self.fields.items()
            },
        }

    @staticmethod
    def from_dict(d):
        return Schema(
            fields={
                k: FieldSpec(FieldType(v["type"]), v["required"])
                for k, v in d.get("fields", {}).items()
            },
            strict=d.get("strict", False),
        )
