"""Training steps, ported from ``repro.train`` (one rank, and the
compressed data-parallel step; ``state_shardings`` / ``jit_train_step``
come with training over a model axis, ROADMAP A15.3b)."""

from repro_torch.train.step import (
    DDPState,
    TrainState,
    ddp_state_from_numpy,
    init_ddp_state,
    init_train_state,
    make_ddp_compressed_step,
    make_loss_fn,
    make_train_step,
    train_state_from_numpy,
)

__all__ = [
    "DDPState", "TrainState", "ddp_state_from_numpy", "init_ddp_state", "init_train_state",
    "make_ddp_compressed_step", "make_loss_fn", "make_train_step", "train_state_from_numpy",
]
