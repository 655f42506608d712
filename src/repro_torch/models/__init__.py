"""The LM stack's dense decoder models, ported from ``repro.models``
(the serving path, ROADMAP A15.1)."""

from repro_torch.models.model import Model, build_groups, params_from_numpy

__all__ = ["Model", "build_groups", "params_from_numpy"]
