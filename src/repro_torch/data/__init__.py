from .pipeline import DataConfig, PrefetchPipeline, synth_batch

__all__ = ["DataConfig", "PrefetchPipeline", "synth_batch"]
