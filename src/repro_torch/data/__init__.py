"""Synthetic LM data, ported from ``repro.data``."""

from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM, make_batch_arrays

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "make_batch_arrays"]
