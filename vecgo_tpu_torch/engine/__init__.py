"""The port's engine: device memtable, planner dispatch and the Engine."""

from vecgo_tpu_torch.engine.engine import Engine, EngineOptions

__all__ = ["Engine", "EngineOptions"]
