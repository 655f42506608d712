"""Mesh builders for the launchers, ported from ``repro.launch.mesh``
(functions, never module-level constants: importing this module touches
no device). ``make_production_mesh`` comes with training over a model
axis (ROADMAP A15.3b)."""

from __future__ import annotations

from repro_torch.core.mesh import SimMesh


def make_local_mesh(model_parallel: int = 1, device=None) -> SimMesh:
    """Whatever this process has, as a ``(data, model)`` mesh: the
    reference's ``(n // mp, mp)`` with ``mp = min(model_parallel, n)``
    over this process's ``n`` devices. A process of the port drives one
    device, so that is one rank, ``(1, 1)``, on ``device`` (default
    ``cuda``), whatever ``model_parallel`` asks."""
    return SimMesh((1, 1), axis_names=("data", "model"), device=device)
