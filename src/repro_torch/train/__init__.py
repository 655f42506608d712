"""Training steps, ported from ``repro.train``: one rank or
tensor-parallel over a ``model`` axis, and the compressed data-parallel
step; ``state_shardings`` / ``jit_train_step`` come with FSDP and the
placed training state, ROADMAP A15.3c."""

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
