from .engine import GenerationResult, ServeEngine, SteadyTiming
from .specdecode import speculative_generate

__all__ = ["GenerationResult", "ServeEngine", "SteadyTiming",
           "speculative_generate"]
