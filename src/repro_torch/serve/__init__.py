from repro_torch.serve.api import Engine, EngineConfig
from repro_torch.serve.continuous import ContinuousConfig, ContinuousServingEngine

__all__ = ["Engine", "EngineConfig", "ContinuousConfig", "ContinuousServingEngine"]
