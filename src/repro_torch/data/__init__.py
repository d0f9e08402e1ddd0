"""The deterministic token pipeline (own copy of ``repro.data``)."""
from .pipeline import DataCfg, TokenPipeline

__all__ = ["DataCfg", "TokenPipeline"]
