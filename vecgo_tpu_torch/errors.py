"""Error taxonomy (reference: vecgo.go error re-exports, internal/engine errors)."""


class VecgoError(Exception):
    """Base class for all vecgo_tpu_torch errors."""


class ErrNotFound(VecgoError, KeyError):
    """ID not found (reference: model.ErrNotFound)."""


class ErrDimensionMismatch(VecgoError, ValueError):
    """Vector dimension does not match the index dimension."""


class ErrInvalidVector(VecgoError, ValueError):
    """Vector contains NaN/Inf or is otherwise invalid (engine.go:781 validateVector)."""


class ErrReadOnly(VecgoError):
    """Write attempted on a read-only (reader-mode / time-travel) database."""


class ErrClosed(VecgoError):
    """Operation on a closed database."""


class ErrBackpressure(VecgoError):
    """Resource controller rejected the operation (resource/controller.go)."""


class ErrCorrupt(VecgoError):
    """Segment or manifest failed integrity checks (magic/version/CRC)."""


class ErrConflict(VecgoError):
    """Optimistic concurrency (CAS) conflict on commit (multi-writer)."""


class ErrSchemaViolation(VecgoError, ValueError):
    """Metadata document violates the configured schema."""
