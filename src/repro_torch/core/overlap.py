"""Decomposed collectives with interleaved compute -- the paper's technique
as a reusable layer. PyTorch port of ``repro.core.overlap``.

The paper's contribution generalizes past FFT: *replace one synchronized
collective with a sequence of smaller direct sends so per-chunk compute
can hide behind the remaining communication*. This module provides that
pattern for the collective shapes the rest of the framework needs:

- ``ring_scatter_reduce``  : all-to-all whose received chunks are folded
  into an accumulator (the shape of the fused scatter-FFT and of an MoE
  combine).
- ``ring_all_gather``      : all-gather decomposed into P-1 neighbour hops
  with an optional per-chunk consumer (ring attention / collective
  matmul).
- ``collective_matmul_ag`` : y = all_gather(x) @ w without materializing
  the gather -- each arriving x-chunk is multiplied into the accumulator
  (the LM-side analogue of the paper's scatter-FFT).
- ``ring_reduce_scatter``  : reduce-scatter decomposed into a ring with
  the running partial folded at each hop.

The reference runs each function inside ``shard_map``; here each takes
the blocks this process runs, one per ``mesh.local_ranks()`` (every
rank's on a ``SimMesh``, the rank's own on a ``ProcessGroupMesh``), and
returns one result per block. On a grid mesh the functions run over
every ring of ``axis_name`` (``mesh.rings``). Hop order, the chunk each
rank seeds, and the ``src`` handed to ``chunk_fn`` are the reference's.
Each hop is ``ppermute_start(...).wait()`` inside one
:class:`torch.autograd.Function` whose backward sends the gradient along
the reverse permutation -- the transpose of ``lax.ppermute`` -- so
gradients flow through the ring on both meshes (NCCL's point-to-point
calls have no autograd of their own). On a ``ProcessGroupMesh`` a
backward through a ring is collective, as the forward is.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import schedule
from repro_torch.core.mesh import Blocks, Mesh, Pending

#: ``chunk_fn(chunk, src)``: the partial a rank accumulates for the chunk
#: that source rank ``src`` contributed.
ChunkFn = Callable[[torch.Tensor, int], torch.Tensor]


class _Hop(torch.autograd.Function):
    """One ppermute of the ring's blocks, differentiable: the gradient of
    ``out[dst] = pieces[src]`` is ``grad_pieces[src] = grad_out[dst]``."""

    @staticmethod
    def forward(ctx, ring, perm, *pieces):
        ctx.ring, ctx.perm = ring, perm
        return tuple(ring.ppermute_start(pieces, perm).wait())

    @staticmethod
    def backward(ctx, *grads):
        back = [(dst, src) for src, dst in ctx.perm]
        return (None, None, *ctx.ring.ppermute_start(grads, back).wait())


def _hop(ring, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Blocks:
    return list(_Hop.apply(ring, tuple(perm), *pieces))


def ppermute_start(ring, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Pending:
    """``ring.ppermute_start(pieces, perm)`` where autograd records
    nothing (the message travels until it is waited on); where it
    records, the differentiable hop (:class:`_Hop`), waited on at once:
    a ``ProcessGroupMesh``'s posted message carries no gradient."""
    if not (torch.is_grad_enabled() and any(p.requires_grad for p in pieces)):
        return ring.ppermute_start(pieces, perm)
    out = _hop(ring, pieces, perm)
    return Pending(ring, lambda: out)


def _call(ring, me: int, fn: ChunkFn, chunk: torch.Tensor, src: int) -> torch.Tensor:
    with ring.running(me):  # a chunk_fn may ask ring.axis_index
        return fn(chunk, src)


def _on_rings(xs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str, fn) -> Blocks:
    """``fn(blocks, ring, p)`` on each ring of ``axis_name``, its results
    put back in the blocks' order."""
    return schedule._on_rings(list(xs), mesh, axis_name,
                              lambda blocks, ring: fn(blocks, ring, ring.axis_size(axis_name)))


def _ring_perm(p: int) -> List[Tuple[int, int]]:
    return [(i, (i + 1) % p) for i in range(p)]  # pass left-to-right


def ring_scatter_reduce(
    xs: Sequence[torch.Tensor],
    mesh: Mesh,
    axis_name: str,
    chunk_fn: ChunkFn,
    *,
    split_axis: int = -1,
) -> Blocks:
    """All-to-all + reduce: chunk j of every rank's block is sent to rank
    j, and each rank folds the arriving chunks with
    ``sum(chunk_fn(chunk, src))``.

    Each block has P*c entries along ``split_axis``; chunk_fn receives a
    (..., c) chunk and its source rank and returns the partial to
    accumulate. The own chunk's partial comes first, then hop s brings
    the chunk of rank me - s."""

    def run(blocks, ring, p):
        axis = split_axis % blocks[0].ndim
        if blocks[0].shape[axis] % p:
            raise ValueError(f"axis {axis} ({blocks[0].shape[axis]}) not divisible by {p}")
        c = blocks[0].shape[axis] // p
        ranks = ring.local_ranks()
        accs = [_call(ring, me, chunk_fn, x.narrow(axis, me * c, c), me) for x, me in zip(blocks, ranks)]
        for s in range(1, p):
            perm = [(i, (i + s) % p) for i in range(p)]
            recv = _hop(ring, [x.narrow(axis, (me + s) % p * c, c) for x, me in zip(blocks, ranks)], perm)
            accs = [acc + _call(ring, me, chunk_fn, r, (me - s) % p) for acc, r, me in zip(accs, recv, ranks)]
        return accs

    return _on_rings(xs, mesh, axis_name, run)


def ring_all_gather(
    xs: Sequence[torch.Tensor],
    mesh: Mesh,
    axis_name: str,
    chunk_fn: Optional[ChunkFn] = None,
    *,
    axis: int = 0,
) -> Blocks:
    """All-gather decomposed into P-1 neighbour hops.

    Without ``chunk_fn`` each rank gets the gathered array (the blocks
    concatenated in rank order along ``axis``). With ``chunk_fn(chunk,
    src)`` it gets the *sum* of the per-chunk results instead, and the
    gather is never materialized."""

    def run(blocks, ring, p):
        if p == 1:
            return [_call(ring, 0, chunk_fn, x, 0) for x in blocks] if chunk_fn is not None else list(blocks)
        ranks, perm = ring.local_ranks(), _ring_perm(p)
        bufs, srcs = list(blocks), list(ranks)
        if chunk_fn is None:
            got = [{me: x} for x, me in zip(blocks, ranks)]
            for _ in range(p - 1):
                bufs = _hop(ring, bufs, perm)
                srcs = [(s - 1) % p for s in srcs]
                for g, b, s in zip(got, bufs, srcs):
                    g[s] = b
            dim = axis % blocks[0].ndim
            return [torch.cat([g[s] for s in range(p)], dim=dim) for g in got]
        accs = [_call(ring, me, chunk_fn, x, me) for x, me in zip(blocks, ranks)]
        for _ in range(p - 1):
            bufs = _hop(ring, bufs, perm)
            srcs = [(s - 1) % p for s in srcs]
            accs = [acc + _call(ring, me, chunk_fn, b, s) for acc, b, s, me in zip(accs, bufs, srcs, ranks)]
        return accs

    return _on_rings(xs, mesh, axis_name, run)


def collective_matmul_ag(
    xs: Sequence[torch.Tensor],
    w: torch.Tensor,
    mesh: Mesh,
    axis_name: str,
    *,
    contract_chunks_of: str = "w",
) -> Blocks:
    """y = all_gather(x, axis=-1) @ w without the materialized gather.

    Each block is (..., k/P); every rank holds the full (k, n) ``w`` and
    multiplies each arriving chunk from ``src`` by its row block
    ``w[src*k/P:(src+1)*k/P]``, so y = sum_src x_src @ w_src. The
    per-chunk product is one ``torch.matmul`` (the reference's
    ``jnp.einsum``)."""
    del contract_chunks_of
    kc = xs[0].shape[-1]

    def chunk_fn(chunk: torch.Tensor, src: int) -> torch.Tensor:
        return torch.matmul(chunk, w.narrow(0, src * kc, kc))

    return ring_all_gather(xs, mesh, axis_name, chunk_fn, axis=-1)


def ring_reduce_scatter(xs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str, *, axis: int = -1) -> Blocks:
    """Reduce-scatter decomposed into a P-1 hop ring with the running
    partial added at each hop: rank s ends with the sum over ranks of
    their chunk s along ``axis``."""

    def run(blocks, ring, p):
        dim = axis % blocks[0].ndim
        if blocks[0].shape[dim] % p:
            raise ValueError(f"axis {dim} ({blocks[0].shape[dim]}) not divisible by {p}")
        if p == 1:
            return list(blocks)
        c = blocks[0].shape[dim] // p
        ranks, perm = ring.local_ranks(), _ring_perm(p)
        # The partial destined to rank c starts at rank c+1 and travels P-1
        # forward hops, absorbing each visited rank's chunk c; so rank ``me``
        # seeds chunk (me-1), and after hop t holds the partial for chunk
        # (me-1-t), finishing with its own fully-reduced chunk ``me``.
        accs = [x.narrow(dim, (me - 1) % p * c, c) for x, me in zip(blocks, ranks)]
        for t in range(1, p):
            accs = _hop(ring, accs, perm)
            accs = [acc + x.narrow(dim, (me - 1 - t) % p * c, c) for acc, x, me in zip(accs, blocks, ranks)]
        return accs

    return _on_rings(xs, mesh, axis_name, run)
