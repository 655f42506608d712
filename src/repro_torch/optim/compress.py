"""Gradient compression for the data-parallel all-reduce, ported from
``repro.optim.compress``: int8 quantization with error feedback.

    q = round(g / scale) in int8, scale = max|g| / 127 (per tensor)
    residual e <- g - q * scale carried to the next step (error feedback,
    keeps SGD convergence despite biased rounding)

:func:`compressed_psum` is the reference's all-gather form: every rank
of the axis gathers the others' int8 payloads and float32 scales
(``mesh.all_gather``: rank order on a ``SimMesh``, one
``all_gather_into_tensor`` of the int8 payload and one of the scales on a
``ProcessGroupMesh``), then dequantizes and sums locally in rank order --
the same bits on every rank. The payload on the wire stays int8: a
quarter of a float32 all-reduce's bytes.

The collectives take the mesh's per-rank lists: one gradient (and one
residual) per ``mesh.local_ranks()`` entry, as the rest of the port's
per-rank code.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.optim.adamw import leaves, tree_map, unflatten


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = gf.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: Sequence[torch.Tensor], mesh, axis_name: str,
                    err: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback int8 all-reduce (mean) over ``axis_name``: each
    local rank's gradient and residual in, each rank's (float32 mean
    gradient, new residual) out."""
    gf = [gi.float() + ei for gi, ei in zip(g, err)]
    qs = [quantize_int8(x) for x in gf]
    new_err = [x - dequantize_int8(q, s) for x, (q, s) in zip(gf, qs)]
    n = mesh.axis_size(axis_name)
    q_all = mesh.all_gather([q for q, _ in qs], axis_name)  # (P, ...) int8 on the wire
    s_all = mesh.all_gather([s for _, s in qs], axis_name)  # (P,) float32
    done = {}  # a SimMesh hands each rank of a ring the same gathered tensor
    out = []
    for qa, sa in zip(q_all, s_all):
        if id(qa) not in done:
            total = torch.tensordot(sa, qa.float().reshape(n, -1), dims=1).reshape(g[0].shape)
            done[id(qa)] = (qa, total / n)
        out.append(done[id(qa)][1])
    return out, new_err


def compressed_psum_tree(grads: Sequence, mesh, axis_name: str, errs: Sequence):
    """Tree version: ``grads`` and ``errs`` hold one tree per local rank
    (``errs`` float32 residuals); returns (one reduced tree per local
    rank, each in its leaves' dtypes; one new residual tree per local
    rank)."""
    flat_g = [leaves(t) for t in grads]
    flat_e = [leaves(t) for t in errs]
    outs = [[] for _ in grads]
    new_e = [[] for _ in grads]
    for i in range(len(flat_g[0])):
        r, e2 = compressed_psum([f[i] for f in flat_g], mesh, axis_name, [f[i] for f in flat_e])
        for k in range(len(grads)):
            outs[k].append(r[k].to(flat_g[k][i].dtype))
            new_e[k].append(e2[k])
    return [unflatten(t, o) for t, o in zip(grads, outs)], [unflatten(t, e) for t, e in zip(grads, new_e)]


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
