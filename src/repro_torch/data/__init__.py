from .pipeline import DataConfig, SyntheticLM, make_batches

__all__ = ["DataConfig", "SyntheticLM", "make_batches"]
