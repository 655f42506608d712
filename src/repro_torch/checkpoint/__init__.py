"""repro_torch.checkpoint -- atomic, async, keep-N checkpoints of
nested dicts / lists / tuples of tensors, in the reference's on-disk
layout (``repro.checkpoint``), so either package restores the other's."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
