from .engine import AdmissionController, Engine, GenerationConfig

__all__ = ["AdmissionController", "Engine", "GenerationConfig"]
