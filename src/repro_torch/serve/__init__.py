from repro_torch.serve.api import Engine, EngineConfig
from repro_torch.serve.continuous import ContinuousConfig, ContinuousServingEngine
from repro_torch.serve.engine import ServeConfig, ServingEngine

__all__ = ["Engine", "EngineConfig", "ContinuousConfig", "ContinuousServingEngine",
           "ServeConfig", "ServingEngine"]
