"""AdamW with dtype-configurable state, ported from ``repro.optim.adamw``.

The reference's order of operations, leaf by leaf: float32 moments from
the float32 gradient, bias correction from a float32 ``count``, ``eps``
1e-8 outside the square root, decoupled weight decay on the float32
parameter, one cast back to each leaf's dtype. With
``opt_state_dtype='bfloat16'`` the moments are stored in bfloat16.

Trees are nested dicts of tensors (the model's parameter trees); their
leaves are walked in sorted-key order, as ``jax.tree.leaves`` walks a
dict. :func:`update` returns new tensors, or with ``inplace=True``
writes the new parameters and moments into the given ones leaf by leaf
(the counterpart of the reference's donated buffers: the train steps
hold one copy of the state, not two).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: Any
    nu: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of a tree of dicts (and the matching leaves of
    ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree) -> List[torch.Tensor]:
    """A tree's leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def unflatten(like, flat: List[torch.Tensor]):
    """``flat`` (in :func:`leaves` order) in the shape of the tree ``like``."""
    return _build(like, iter(flat))


def _build(node, it):
    # a module-level recursion: a closure calling itself would make a reference cycle that keeps
    # ``flat``'s tensors alive until the cycle collector runs
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def init(params, dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, dtype)
    first = leaves(params)[0]
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
    )


def state_specs(param_specs) -> AdamWState:
    """Optimizer-state sharding mirrors the params."""
    return AdamWState(count=((),), mu=param_specs, nu=param_specs)


def _squares(xs) -> torch.Tensor:
    total = None
    for x in xs:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return total


def global_norm(tree, mesh=None, placed: Optional[Sequence[Sequence[str]]] = None) -> torch.Tensor:
    """The 2-norm of every leaf of ``tree`` together. Over a
    ``ProcessGroupMesh`` whose ranks hold blocks of some leaves
    (``placed``: the mesh axes each leaf in :func:`leaves` order is cut
    over, () for a leaf held whole -- ``Model.sharded_leaves``), the
    whole model's norm: each leaf's squares summed over the axes it is
    placed on (one all-reduce a set of axes) and counted once over the
    axes it is replicated on -- the same value on every rank."""
    flat = leaves(tree)
    if mesh is None or placed is None or not any(placed):
        return torch.sqrt(_squares(flat))
    if len(placed) != len(flat):
        raise ValueError(f"{len(placed)} placements for a tree of {len(flat)} leaves")
    total = None
    for axes in dict.fromkeys(tuple(a) for a in placed):
        sq = _squares([x for x, a in zip(flat, placed) if tuple(a) == axes])
        if axes:
            sq = mesh.psum([sq], axes)[0]
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, mesh=None, placed: Optional[Sequence[Sequence[str]]] = None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and that
    norm (:func:`global_norm`, over ``mesh`` where ``placed`` says)."""
    norm = global_norm(grads, mesh, placed)
    scale = torch.clamp(norm.new_tensor(max_norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _leaf(g, m, v, p, lr, bc1, bc2, cfg: TrainConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's (new param, m, v) in float32, the reference's ``upd``."""
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float()
    m2 = b1 * m.float() + (1 - b1) * gf
    v2 = b2 * v.float() + (1 - b2) * gf * gf
    mhat = m2 / bc1
    vhat = v2 / bc2
    step = mhat / (torch.sqrt(vhat) + 1e-8) + cfg.weight_decay * p.float()
    return p.float() - lr * step, m2, v2


def update(grads, state: AdamWState, params, *, lr: torch.Tensor, cfg: TrainConfig,
           inplace: bool = False) -> Tuple[Any, AdamWState]:
    c = state.count + 1
    bc1 = 1 - cfg.b1 ** c.float()
    bc2 = 1 - cfg.b2 ** c.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=c.device)
    flat = zip(leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params))
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in flat:
        p2, m2, v2 = _leaf(g, m, v, p, lr, bc1, bc2, cfg)
        if inplace:
            p.copy_(p2)
            m.copy_(m2)
            v.copy_(v2)
            p2, m2, v2 = p, m, v
        new_p.append(p2.to(p.dtype))
        new_m.append(m2.to(m.dtype))
        new_v.append(v2.to(v.dtype))
    return unflatten(params, new_p), AdamWState(count=c, mu=unflatten(params, new_m), nu=unflatten(params, new_v))
