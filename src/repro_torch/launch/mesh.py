"""Mesh builders for the launchers, ported from ``repro.launch.mesh``
(functions, never module-level constants: importing this module touches
no device). ``make_production_mesh`` comes with FSDP and the placed
training state over processes (ROADMAP A15.3c)."""

from __future__ import annotations

from repro_torch.core.mesh import SimMesh


def make_local_mesh(model_parallel: int = 1, device=None) -> SimMesh:
    """A ``(data, model)`` mesh of ``(1, model_parallel)`` ranks, all in
    this process on ``device`` (default ``cuda``): a ``SimMesh``, whose
    ranks share the one device and run in lock step. The reference's
    ``(n // mp, mp)`` with ``mp = min(model_parallel, n)`` over this
    process's ``n`` devices would give ``(1, 1)`` on the one device a
    process of the port drives; the port keeps the asked ``model`` axis
    instead (ROADMAP queue C), so ``--model-parallel`` trains
    tensor-parallel on one card."""
    return SimMesh((1, model_parallel), axis_names=("data", "model"), device=device)
