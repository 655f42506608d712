"""Training steps, ported from ``repro.train``: the step over one rank or
any mesh -- FSDP x TP over a ``ProcessGroupMesh``, the counterpart of
``jit_train_step`` -- with its placed state (``state_placement``,
``place_train_state``: ``state_shardings`` and the jit's
``in_shardings``), and the compressed data-parallel step."""

from repro_torch.train.step import (
    DDPState,
    TrainState,
    ddp_state_from_numpy,
    init_ddp_state,
    init_train_state,
    make_ddp_compressed_step,
    make_loss_fn,
    make_train_step,
    place_train_state,
    state_placement,
    train_state_from_numpy,
)

__all__ = [
    "DDPState", "TrainState", "ddp_state_from_numpy", "init_ddp_state", "init_train_state",
    "make_ddp_compressed_step", "make_loss_fn", "make_train_step", "place_train_state",
    "state_placement", "train_state_from_numpy",
]
