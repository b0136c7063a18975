from .engine import GenerationResult, ServeEngine, SteadyTiming

__all__ = ["GenerationResult", "ServeEngine", "SteadyTiming"]
