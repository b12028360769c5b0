from .synthetic import DataPipeline, SyntheticLM

__all__ = ["DataPipeline", "SyntheticLM"]
