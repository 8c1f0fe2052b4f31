from .lm import LM, build_model

__all__ = ["LM", "build_model"]
