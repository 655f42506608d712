"""Optimizer: AdamW, LR schedules and int8 gradient compression, ported
from ``repro.optim``."""

from repro_torch.optim import adamw, compress, schedule

__all__ = ["adamw", "compress", "schedule"]
