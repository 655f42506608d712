"""The port's meshes: the per-rank collectives the exchanges run on.

The reference runs its per-rank exchange code inside ``shard_map`` over
a jax ``Mesh`` (``repro.core.compat``), with ``lax.axis_index`` giving
the rank and ``lax.ppermute`` / ``lax.all_to_all`` moving the blocks.
The port runs the same per-rank code over a Python list of local
blocks, one per rank this process runs, and ``me`` a plain ``int``.
Two meshes supply the collectives, with the same methods:

:class:`SimMesh`
    All ranks' blocks on one device, run in lock step; the collectives
    are copies between list entries. This is how P > 1 schedules run on
    one card (NCCL will not place two ranks of one communicator on the
    same GPU) and in fast CPU tests. A posted message is copied when it
    is waited on, so sends and chunk callbacks run in program order on
    one stream: nothing overlaps.
:class:`ProcessGroupMesh`
    One rank per process over ``torch.distributed`` (NCCL for blocks on
    the card, gloo for blocks on the CPU); the list holds the one local
    block. :meth:`ProcessGroupMesh.ppermute_start` posts a message's
    send and receive at once (one ``batch_isend_irecv``) and returns;
    the exchange posts every ring step up front and runs each chunk
    callback as its receive completes, so the sends travel while the
    callbacks compute. On the card NCCL moves the bytes on its own
    stream and ``wait()`` only orders the compute stream after them.

Both take one named axis (``SimMesh(4)``, the slab layout) or a grid of
them (``SimMesh((2, 4), axis_names=("rows", "cols"))``, the pencil
layout; the counterpart of a jax ``Mesh`` with those axes). Ranks are
numbered row-major over the axes, the first axis varying slowest, as
``repro.core.grid.make_grid`` orders devices. An exchange runs over one
axis: :meth:`rings` hands out one 1-D view per ring of that axis (the
ranks that differ only in its coordinate), each offering the 1-D
collectives in ring-local rank numbers. On a ``SimMesh`` that is every
ring, run one after another; on a ``ProcessGroupMesh`` it is the rank's
own ring, over that ring's ``torch.distributed`` subgroup.

The exchange code loops over :meth:`local_ranks` of a 1-D view
(``range(p)`` on the simulated mesh, ``[rank]`` here) and never asks
which mesh it has.

Gradients: on a ``SimMesh`` every rank's blocks lie in one autograd
graph and the collectives are tensor ops on them, differentiated as any
other. On a ``ProcessGroupMesh`` each rank's graph holds only its own
part. The model keeps its activations the same on every rank after each
collective, and every rank computes the same loss, so ``psum``,
``gather``, ``all_gather`` and ``all_to_all`` carry Megatron's backward
passes (the identity, the rank's own block, the inverse all-to-all), and
``pvary`` (Megatron's "f") marks where a replicated tensor enters
rank-specific compute, summing the ranks' gradients. ``pmax`` and a
posted ``ppermute_start`` have no gradient and raise under autograd;
the rings' hops carry their own (``core.overlap._Hop``,
``core.overlap.ppermute_start``).
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.comm_model import COLLECTIVE_KINDS

Blocks = List[torch.Tensor]
#: one mesh axis, or a tuple of them that together place one dim
Axes = Union[str, Sequence[str]]

#: Seconds a ``torch.distributed`` group waits on a message or collective
#: before it fails (a peer that never posts its half raises instead of
#: hanging the job).
DEFAULT_TIMEOUT_S = 120.0

#: The bytes the state's collectives -- FSDP's (``gather_many`` /
#: ``all_gather_fsdp`` and their reduce-scatters, ``psum_scatter``) and the
#: all-reduces over a batch axis (``psum`` over ``"pod"`` or ``"data"``:
#: the gradients of leaves replicated there, the step's scalars) --
#: assemble on this rank, by kind: ``"all_gather"`` the gathered tensors
#: (the ring's P blocks each), ``"reduce_scatter"`` the whole gradients
#: handed in (P blocks each), ``"all_reduce"`` the reduced block.
#: ``FSDP_CALLS`` counts the collectives of each kind. Clear both before a
#: run to read that run's (``launch.dryrun`` predicts them).
FSDP_BYTES: "collections.Counter[str]" = collections.Counter()
FSDP_CALLS: "collections.Counter[str]" = collections.Counter()
#: the axes whose all-reduces ``FSDP_BYTES`` counts: the batch's
STATE_AXES = ("pod", "data")


def _count(kind: str, t: torch.Tensor) -> None:
    FSDP_BYTES[kind] += t.numel() * t.element_size()
    FSDP_CALLS[kind] += 1


#: Every collective this process issues on a rank's behalf, keyed
#: ``(scope, kind, axes)``: ``scope`` "state" for what ``FSDP_BYTES``
#: counts (FSDP's gathers and reduce-scatters, the all-reduces over a
#: batch axis), "activation" for the rest (the model's collectives over
#: ``model``, the MoE ring's hops and gathers, the clip's norm over
#: ``model``); ``kind`` one of ``COLLECTIVE_KINDS`` (the reference's
#: HLO names, ``core.comm_model``); ``axes`` the mesh axes of more than one rank the
#: collective runs over. The bytes are what the collective assembles on
#: the rank (as ``FSDP_BYTES``): an all-reduce's block, an all-gather's
#: gathered tensor, a reduce-scatter's whole operand, an all-to-all's
#: received block, a permute's received piece. Backward passes count
#: when they run. On a ``SimMesh`` each call counts one rank's share --
#: what one process-group rank would issue for it -- and the backward
#: collectives a process-group rank's autograd would issue (Megatron's
#: "f" all-reduce, the inverse all-to-all) are counted when their forward
#: runs outside a backward pass (not again in remat's recompute). Clear
#: with :func:`reset_collectives`; :func:`collectives` reads them.
COLLECTIVE_BYTES: "collections.Counter[Tuple[str, str, Tuple[str, ...]]]" = collections.Counter()
COLLECTIVE_CALLS: "collections.Counter[Tuple[str, str, Tuple[str, ...]]]" = collections.Counter()


def reset_collectives() -> None:
    """Zero :data:`COLLECTIVE_BYTES` / :data:`COLLECTIVE_CALLS` (and the
    ``FSDP_*`` view)."""
    for c in (COLLECTIVE_BYTES, COLLECTIVE_CALLS, FSDP_BYTES, FSDP_CALLS):
        c.clear()


def collectives(scope: Optional[str] = None, axes: Optional[Tuple[str, ...]] = None) -> Dict[str, Dict[str, int]]:
    """``{"counts": {kind: n}, "bytes": {kind: bytes}}`` of what was
    counted since the last reset, every kind of :data:`COLLECTIVE_KINDS`
    present (0 where none ran): of one ``scope`` ("state" or
    "activation") or both, over one tuple of ``axes`` or any."""
    out = {"counts": dict.fromkeys(COLLECTIVE_KINDS, 0), "bytes": dict.fromkeys(COLLECTIVE_KINDS, 0)}
    for (sc, kind, ax), n in COLLECTIVE_CALLS.items():
        if (scope is None or sc == scope) and (axes is None or ax == axes):
            out["counts"][kind] += n
            out["bytes"][kind] += COLLECTIVE_BYTES[(sc, kind, ax)]
    return out


def _record(mesh, kind: str, nbytes: int, scope: str = "activation",
            axes: Optional[Tuple[str, ...]] = None) -> None:
    """Count one ``kind`` collective over ``axes`` (default ``mesh``'s
    ``count_axes``) assembling ``nbytes`` on the rank; nothing on a group
    of one rank."""
    axes = mesh.count_axes if axes is None else axes
    if not axes:
        return
    COLLECTIVE_BYTES[(scope, kind, axes)] += int(nbytes)
    COLLECTIVE_CALLS[(scope, kind, axes)] += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _first_pass(t: torch.Tensor) -> bool:
    """Whether autograd records ``t`` and this is no backward pass (remat's
    recompute runs inside one): where a ``SimMesh`` counts, at its
    forward, a backward collective a process-group rank would issue."""
    return _records(t) and torch._C._current_graph_task_id() == -1


def note_backward(mesh, kind: str, t: torch.Tensor, scope: str = "activation",
                  axes: Optional[Tuple[str, ...]] = None, nbytes: Optional[int] = None) -> None:
    """On a ``SimMesh``, count the ``kind`` collective of ``t``'s gradient
    (assembling ``nbytes``, default ``t``'s) that a process-group rank's
    backward issues (:func:`_first_pass`)."""
    if _first_pass(t):
        _record(mesh, kind, _nbytes(t) if nbytes is None else nbytes, scope, axes)


#: Axis names of a grid mesh when the caller gives none, in (row, col)
#: order -- ``repro.core.grid.GRID_AXES``.
GRID_AXES: Tuple[str, str] = ("rows", "cols")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``: the port's entry points run on the card
    unless the caller asks for the CPU. Raises when no GPU is present
    and the caller did not pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (the tests do)"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # what a tensor's .device reports
    return dev


class Pending:
    """A posted ppermute. :meth:`wait` returns the received blocks (one
    per local rank), once; until then the mesh counts it in
    ``in_flight``."""

    def __init__(self, mesh, complete: Callable[[], Blocks]):
        self._mesh = mesh
        self._complete: Optional[Callable[[], Blocks]] = complete
        mesh.in_flight += 1

    def wait(self) -> Blocks:
        if self._complete is None:
            raise RuntimeError("this message was already waited on")
        complete, self._complete = self._complete, None
        try:
            return complete()
        finally:
            self._mesh.in_flight -= 1


def _grid_axes(dims, axis_name: str, axis_names) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(sizes, names) of a mesh given as ``p`` (one axis named
    ``axis_name``) or as a tuple of sizes (named ``axis_names``,
    :data:`GRID_AXES` for two)."""
    if isinstance(dims, int):
        if axis_names is not None:
            raise ValueError("axis_names names the axes of a grid; a 1-D mesh takes axis_name")
        dims, names = (dims,), (axis_name,)
    else:
        dims = tuple(int(d) for d in dims)
        names = tuple(axis_names) if axis_names is not None else (GRID_AXES if len(dims) == 2 else None)
        if names is None or len(names) != len(dims):
            raise ValueError(f"a grid of shape {dims} needs one axis name per dim, got {axis_names!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axis names must be distinct, got {names}")
    if any(d < 1 for d in dims):
        raise ValueError(f"a mesh needs at least one rank per axis, got {dims}")
    return dims, names


class _AxisMesh:
    """What both meshes share: named axes of ``p`` ranks in all, whose
    blocks lie on ``device``, numbered row-major over the axes."""

    p: int
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    shape: Dict[str, int]
    in_flight: int

    def _set_axes(self, dims: Tuple[int, ...], names: Tuple[str, ...]) -> None:
        self.dims, self.axis_names = dims, names
        self.shape = dict(zip(names, dims))
        self.p = math.prod(dims)
        self.in_flight = 0
        #: the axes of more than one rank a collective over the whole mesh
        #: runs over (a ring view's: its parent's axes, :func:`_ring_view`)
        self.count_axes = tuple(a for a, d in zip(names, dims) if d > 1)

    @property
    def axis_name(self) -> str:
        """The one axis of a 1-D mesh."""
        if len(self.axis_names) != 1:
            raise ValueError(f"a grid mesh has axes {self.axis_names}, not one axis_name")
        return self.axis_names[0]

    def axes_of(self, axis_name: Axes) -> Tuple[str, ...]:
        """The mesh axes ``axis_name`` names -- one axis, or a tuple of them
        (``("pod", "data")``, one dim placed over both) -- in the mesh's
        order."""
        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh has axes {tuple(self.shape)}, not {a!r}")
        if not names or len(set(names)) != len(names):
            raise ValueError(f"an axis group names each mesh axis once, got {axis_name!r}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axis_name: Axes) -> int:
        """The ranks along one axis, or the product over a tuple of axes."""
        return math.prod(self.shape[a] for a in self.axes_of(axis_name))

    def _counted_axes(self, axis_name: Optional[Axes]) -> Tuple[str, ...]:
        """The axes of more than one rank of ``axis_name`` (a 1-D mesh's own
        by default): what a collective over them is counted under."""
        return tuple(a for a in self.axes_of(axis_name or self.axis_name) if self.shape[a] > 1)

    def _ring_view(self, view: "_AxisMesh", axes: Tuple[str, ...]) -> "_AxisMesh":
        """``view``, a 1-D mesh over the ring of ``axes``, counting its
        collectives under those axes of this mesh."""
        view.count_axes = tuple(a for a in axes if self.shape[a] > 1)
        return view

    def coords(self, rank: int) -> Dict[str, int]:
        """Axis name -> coordinate of ``rank`` (row-major, the first axis
        varying slowest)."""
        out = {}
        for name, d in zip(reversed(self.axis_names), reversed(self.dims)):
            rank, out[name] = divmod(rank, d)
        return out

    def _rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name, d in zip(self.axis_names, self.dims):
            rank = rank * d + coords.get(name, 0)
        return rank

    def _count_reduce(self, axis_name: Optional[Axes], block: torch.Tensor) -> bool:
        """Count a psum of ``block`` over a batch axis of more than one rank
        in ``FSDP_BYTES["all_reduce"]``; whether it did (a state
        collective)."""
        axes = self.axes_of(axis_name or self.axis_name)
        if self.axis_size(axes) > 1 and any(a in STATE_AXES for a in axes):
            _count("all_reduce", block)
            return True
        return False

    def ring_ranks(self, axis_name: Axes) -> List[List[int]]:
        """The rings of ``axis_name`` (an axis, or a tuple of axes): each
        the ranks that differ only in those coordinates, in their row-major
        order (the first axis slowest: ``("pod", "data")`` runs pod-major,
        as a jax ``NamedSharding`` lays a dim over both); the rings in the
        order of their first rank."""
        axes = self.axes_of(axis_name)
        others = [n for n in self.axis_names if n not in axes]
        rings = []
        for fixed in itertools.product(*(range(self.shape[n]) for n in others)):
            base = dict(zip(others, fixed))
            rings.append([self._rank_of({**base, **dict(zip(axes, pos))})
                          for pos in itertools.product(*(range(self.shape[a]) for a in axes))])
        return rings

    def ring_index(self, rank: int, axis_name: Axes) -> int:
        """``rank``'s position on its ring of ``axis_name`` (row-major over
        a tuple of axes): the block of a dim placed over those axes that
        the rank keeps."""
        coords, i = self.coords(rank), 0
        for a in self.axes_of(axis_name):
            i = i * self.shape[a] + coords[a]
        return i

    def place(self, x) -> torch.Tensor:
        """``x`` (a tensor or array-like) on the mesh's device, moved
        there if it lies elsewhere: a transform runs where the mesh's
        ranks are, never where the caller's tensor happened to be made."""
        return torch.as_tensor(x, device=self.device)

    def ppermute(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Blocks:
        """``out[dst] = pieces[src]`` for each ``(src, dst)`` pair, into a
        fresh receive tensor (an aliasing reassignment would move no
        bytes). Ranks that receive nothing get zeros, as in
        ``lax.ppermute``."""
        return self.ppermute_start(pieces, perm).wait()

    def _check(self, blocks: Sequence[torch.Tensor]) -> None:
        if len(blocks) != len(self.local_ranks()):
            raise ValueError(
                f"expected one block per local rank ({len(self.local_ranks())}), got {len(blocks)}"
            )
        for b in blocks:
            if b.device != self.device:
                raise ValueError(f"a block lies on {b.device}, but the mesh's ranks are on {self.device}")

    def _check_1d(self, blocks: Sequence[torch.Tensor]) -> None:
        """The collectives run over one axis: on a grid, over a ring view."""
        if len(self.dims) != 1:
            raise ValueError(f"a collective over the grid {self.shape} needs one axis: run it on mesh.rings(axis)")
        self._check(blocks)

    # -- partition specs --------------------------------------------------------
    def _shard_dims(self, ndim: int, tail: Sequence[Optional[str]]) -> List[Tuple[int, str]]:
        """(dim, axis) for each dim the trailing partition spec ``tail``
        shards, in dim order; each axis may shard one dim."""
        dims = [(ndim - len(tail) + i, a) for i, a in enumerate(tail) if a is not None]
        names = [n for _, a in dims for n in ((a,) if isinstance(a, str) else a)]
        for a in names:
            if a not in self.shape:
                raise ValueError(f"tail spec {tuple(tail)} names axis {a!r}; mesh axes are {self.axis_names}")
        if len(set(names)) != len(names):
            raise ValueError(f"tail spec {tuple(tail)} names a mesh axis twice")
        return dims

    def _coords_at(self, axis: Axes, i: int) -> Dict[str, int]:
        """The coordinates of position ``i`` along ``axis`` (row-major over
        a tuple of axes)."""
        out = {}
        for a in reversed(self.axes_of(axis)):
            i, out[a] = divmod(i, self.shape[a])
        return out

    def _block(self, x: torch.Tensor, rank: int, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """Rank ``rank``'s block of the global ``x`` under ``tail`` (a view)."""
        index = [slice(None)] * x.ndim
        for dim, axis in self._shard_dims(x.ndim, tail):
            k = self.axis_size(axis)
            if x.shape[dim] % k:
                raise ValueError(
                    f"dim {dim} of size {x.shape[dim]} is not divisible by the {k} "
                    f"ranks of mesh axis {axis!r}"
                )
            n, at = x.shape[dim] // k, self.ring_index(rank, axis)
            index[dim] = slice(at * n, (at + 1) * n)
        return x[tuple(index)]

    def _assemble(self, block_of: Callable[[int], torch.Tensor], ndim: int,
                  tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The global array from the blocks ``block_of(rank)`` under
        ``tail``: each block copied to its place along the sharded dims,
        taking coordinate 0 on every axis the spec leaves replicated."""
        dims = self._shard_dims(ndim, tail)
        first = block_of(self._rank_of({}))
        if not dims:
            return first
        shape = list(first.shape)
        for dim, axis in dims:
            shape[dim] *= self.axis_size(axis)
        out = torch.empty(shape, dtype=first.dtype, device=first.device)
        for coords in itertools.product(*(range(self.axis_size(axis)) for _, axis in dims)):
            index = [slice(None)] * ndim
            at: Dict[str, int] = {}
            for (dim, axis), i in zip(dims, coords):
                index[dim] = slice(i * first.shape[dim], (i + 1) * first.shape[dim])
                at.update(self._coords_at(axis, i))
            out[tuple(index)] = block_of(self._rank_of(at))
        return out

    def global_shape(self, shape: Sequence[int], tail: Sequence[Optional[str]]) -> Tuple[int, ...]:
        """Global shape of a caller's array under the trailing spec
        ``tail``: the array itself where the caller holds the global
        array (:class:`SimMesh`), its block's dims times their axis
        sizes where it holds its own block."""
        shape = list(shape)
        if self.caller_holds_block:
            for dim, axis in self._shard_dims(len(shape), tail):
                shape[dim] *= self.axis_size(axis)
        return tuple(shape)

    def caller_shape(self, global_shape: Sequence[int], tail: Sequence[Optional[str]]) -> Tuple[int, ...]:
        """The inverse of :meth:`global_shape`: the shape of the array a
        caller passes for a global array of ``global_shape`` under
        ``tail`` (the global shape itself, or the rank's block's)."""
        shape = list(global_shape)
        if self.caller_holds_block:
            for dim, axis in self._shard_dims(len(shape), tail):
                shape[dim] //= self.axis_size(axis)
        return tuple(shape)


class SimMesh(_AxisMesh):
    """``p`` ranks over one named axis, or a grid of them, all on
    ``device``: ``SimMesh(4)``, ``SimMesh((2, 4), axis_names=("rows",
    "cols"))``.

    ``shape`` maps each axis name to its size, like a jax ``Mesh``, so
    plan code reads ring sizes the same way in both packages."""

    caller_holds_block = False

    def __init__(self, p: Union[int, Sequence[int]], axis_name: str = "model", device=None, *,
                 axis_names: Optional[Sequence[str]] = None):
        self._set_axes(*_grid_axes(p, axis_name, axis_names))
        self.device = resolve_device(device)
        self._rank: Optional[int] = None
        self._ring_views: Dict[str, "SimMesh"] = {}

    def local_ranks(self) -> List[int]:
        """The ranks whose blocks this process holds: all of them."""
        return list(range(self.p))

    def rings(self, axis_name: str) -> List[Tuple["SimMesh", List[int]]]:
        """One ``(1-D view, ranks)`` per ring of ``axis_name``: the view is
        a ``SimMesh`` over that axis alone, ``ranks`` the blocks (in
        ring order) it runs. A 1-D mesh is its own one ring."""
        if len(self.dims) == 1:
            self.axis_size(axis_name)
            return [(self, self.local_ranks())]
        key = _axis_key(self.axes_of(axis_name))
        view = self._ring_views.get(key)
        if view is None:
            view = self._ring_views[key] = self._ring_view(SimMesh(self.axis_size(axis_name), key, self.device),
                                                           self.axes_of(axis_name))
        return [(view, ring) for ring in self.ring_ranks(axis_name)]

    # -- the rank whose per-rank code is running -------------------------------
    @contextlib.contextmanager
    def running(self, me: int):
        """Mark rank ``me`` as the one whose per-rank code runs inside the
        block (the lock-step exchanges wrap each per-rank callback)."""
        prev, self._rank = self._rank, int(me)
        try:
            yield
        finally:
            self._rank = prev

    def axis_index(self, axis_name: str) -> int:
        """Coordinate along ``axis_name`` of the per-rank code running
        now -- the lock-step counterpart of ``lax.axis_index`` for
        callbacks that depend on their own rank (the six-step twiddle)."""
        self.axis_size(axis_name)
        if self._rank is None:
            raise RuntimeError("axis_index is only defined inside per-rank code (SimMesh.running)")
        return self.ring_index(self._rank, axis_name)

    # -- collectives over per-rank lists (1-D) ------------------------------------
    def ppermute_start(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Pending:
        """Post a :meth:`ppermute`. The copies run when the message is
        waited on: one stream, program order, no overlap."""
        self._check_1d(pieces)
        pieces, perm = list(pieces), list(perm)
        if any(src != dst for src, dst in perm):  # one rank's share: its piece
            _record(self, "collective-permute", _nbytes(pieces[0]))

        def complete() -> Blocks:
            out: List[Optional[torch.Tensor]] = [None] * self.p
            for src, dst in perm:
                out[dst] = pieces[src].clone(memory_format=torch.contiguous_format)
            return [torch.zeros_like(pieces[i]) if o is None else o for i, o in enumerate(out)]

        return Pending(self, complete)

    def all_to_all(self, blocks: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> Blocks:
        """Tiled all-to-all: rank ``i`` splits its block into ``p`` pieces
        along ``split_axis`` and sends piece ``j`` to rank ``j``, which
        concatenates what it receives along ``concat_axis`` in source
        order (``lax.all_to_all(..., tiled=True)``)."""
        self._check_1d(blocks)
        p = self.p
        size = blocks[0].shape[split_axis]
        if size % p:
            raise ValueError(f"all_to_all: axis of size {size} does not split into {p} pieces")
        pieces = [torch.chunk(b, p, dim=split_axis) for b in blocks]
        _record(self, "all-to-all", _nbytes(blocks[0]))
        note_backward(self, "all-to-all", blocks[0])  # the inverse all-to-all of a process-group rank
        return [torch.cat([pieces[src][dst] for src in range(p)], dim=concat_axis) for dst in range(p)]

    def all_max(self, values: Sequence[float]) -> List[float]:
        """The largest of each value over the ranks that call it: every
        rank of this process runs the same code, so its own values."""
        return [float(v) for v in values]

    host_max = all_max  # host values (ProcessGroupMesh.host_max): the same here

    def psum(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None, *,
             activation: bool = False) -> Blocks:
        """``lax.psum`` over ``axis_name`` (a 1-D mesh's own axis by
        default): every rank of a ring gets the sum of the ring's blocks,
        added in rank order -- one tensor, the same object for each.
        ``activation``: a model's activations summed over a batch axis
        (the sequence-sharded cache's combine), counted with the
        activations' collectives, not the state's."""
        state = not activation and self._count_reduce(axis_name, blocks[0])
        _record(self, "all-reduce", _nbytes(blocks[0]), "state" if state else "activation",
                self._counted_axes(axis_name))
        return self._reduce(blocks, axis_name, torch.add)

    def pmax(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None) -> Blocks:
        """``lax.pmax`` over ``axis_name``, as :meth:`psum`."""
        _record(self, "all-reduce", _nbytes(blocks[0]), axes=self._counted_axes(axis_name))
        return self._reduce(blocks, axis_name, torch.maximum)

    def pvary(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None) -> Blocks:
        """A replicated tensor entering each rank's own compute
        (:meth:`ProcessGroupMesh.pvary`): the blocks as they are. Every
        rank's use lies in one autograd graph here, which sums their
        gradients itself."""
        self._check(blocks)
        return list(blocks)

    def all_gather(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None) -> Blocks:
        """``lax.all_gather`` over ``axis_name`` (a 1-D mesh's own axis by
        default): every rank of a ring gets the (P, ...) stack of the
        ring's blocks in ring order -- one tensor, the same object for
        each."""
        self._check(blocks)
        out = list(blocks)
        axes = self._counted_axes(axis_name)
        _record(self, "all-gather", _nbytes(blocks[0]) * self.axis_size(axis_name or self.axis_name), axes=axes)
        for ring in self.ring_ranks(axis_name or self.axis_name):
            stacked = torch.stack([blocks[r] for r in ring])
            for r in ring:
                out[r] = stacked
        return out

    def all_gather_fsdp(self, blocks: Sequence[torch.Tensor], axis_name: Optional[Axes] = None,
                        dim: int = 0) -> Blocks:
        """FSDP's gather: every rank of a ring gets the ring's blocks
        concatenated along ``dim`` in ring order (``lax.all_gather(...,
        axis=dim, tiled=True)``) -- one tensor, the same object for each.
        Its gradient is autograd's: the uses' gradients summed, each
        rank's slice to its block (:meth:`ProcessGroupMesh.all_gather_fsdp`'s
        reduce-scatter)."""
        self._check(blocks)
        out = list(blocks)
        axes, k = self._counted_axes(axis_name), self.axis_size(axis_name or self.axis_name)
        _record(self, "all-gather", _nbytes(blocks[0]) * k, "state", axes)
        note_backward(self, "reduce-scatter", blocks[0], "state", axes, _nbytes(blocks[0]) * k)
        for ring in self.ring_ranks(axis_name or self.axis_name):
            whole = torch.cat([blocks[r] for r in ring], dim)
            for r in ring:
                out[r] = whole
        return out

    def psum_scatter(self, blocks: Sequence[torch.Tensor], axis_name: Optional[Axes] = None,
                     dim: int = 0) -> Blocks:
        """``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``:
        the ring's blocks summed in ring order, and each rank's slice of
        the sum along ``dim`` (its position on the ring's)."""
        self._check(blocks)
        out = list(blocks)
        axes = self._counted_axes(axis_name)
        _record(self, "reduce-scatter", _nbytes(blocks[0]), "state", axes)
        note_backward(self, "all-gather", blocks[0], "state", axes)
        for ring in self.ring_ranks(axis_name or self.axis_name):
            acc = blocks[ring[0]]
            for r in ring[1:]:
                acc = acc + blocks[r]
            if acc.shape[dim] % len(ring):
                raise ValueError(f"psum_scatter: dim {dim} of size {acc.shape[dim]} does not split over "
                                 f"{len(ring)} ranks")
            for i, piece in enumerate(torch.chunk(acc, len(ring), dim)):
                out[ring[i]] = piece
        return out

    def _reduce(self, blocks, axis_name, op) -> Blocks:
        self._check(blocks)
        out = list(blocks)
        for ring in self.ring_ranks(axis_name or self.axis_name):
            acc = blocks[ring[0]]
            for r in ring[1:]:
                acc = op(acc, blocks[r])
            for r in ring:
                out[r] = acc
        return out

    # -- global <-> per-rank ----------------------------------------------------
    def split(self, x: torch.Tensor, tail: Sequence[Optional[str]]) -> Blocks:
        """Global array -> per-rank blocks, sharding the dims the trailing
        partition spec ``tail`` names (a schedule's ``in_tail``; each
        entry an axis name or None) and replicating over the axes it
        does not name. The blocks are views of ``x``."""
        return [self._block(x, rank, tail) for rank in range(self.p)]

    def gather(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """Per-rank blocks -> global array (a schedule's ``out_tail``),
        counted as :meth:`ProcessGroupMesh.gather`'s all-gather."""
        self._check(blocks)
        out = self._assemble(lambda rank: blocks[rank], blocks[0].ndim, tail)
        if self._shard_dims(blocks[0].ndim, tail):
            _record(self, "all-gather", self.p * _nbytes(blocks[0]))
        return out

    # -- what a transform takes from and gives back to its caller ---------------
    def local_blocks(self, x, tail: Sequence[Optional[str]]) -> Blocks:
        """The caller's array -> the blocks this process runs: here the
        caller holds the global array."""
        return self.split(self.place(x), tail)

    def caller_array(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The blocks a transform produced -> what its caller gets: the
        global array."""
        return self.gather(blocks, tail)

    def global_input(self, x, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The caller's array -> the global array (for a whole-transform
        library call): the caller's array itself here."""
        return self.place(x)

    def global_output(self, y: torch.Tensor, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """A whole-transform result -> what its caller gets: all of it."""
        return y

    def __repr__(self) -> str:
        if len(self.dims) == 1:
            return f"SimMesh(p={self.p}, axis_name={self.axis_name!r}, device={str(self.device)!r})"
        return f"SimMesh({self.dims}, axis_names={self.axis_names}, device={str(self.device)!r})"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """What a ``torch.distributed`` call moves for ``t``: complex tensors
    as their real (..., 2) view (NCCL has no complex type)."""
    return torch.view_as_real(t) if t.is_complex() else t


class ProcessGroupMesh(_AxisMesh):
    """One rank per process over a ``torch.distributed`` group (the
    default one unless ``group`` is given): the counterpart of
    ``repro.core.compat.make_mesh_1d`` + ``shard_map``, or with
    ``grid=(p_rows, p_cols)`` of a 2-D jax ``Mesh`` named
    ``axis_names`` (default ``("rows", "cols")``). Blocks lie on
    ``device`` (``None``: this process's card), which must match the
    group's backend -- NCCL for the card, gloo for the CPU.

    A grid makes one subgroup per ring of each axis (every rank creates
    every ring's group, in the same order), each failing after
    ``timeout_s`` seconds; a ring of one rank needs no group and moves
    nothing. Join the default group with :func:`init_process_mesh`. A
    transform run on this mesh takes and returns the rank's own block,
    the counterpart of a sharded ``jax.Array``'s addressable shard;
    :meth:`split` and :meth:`gather` convert a global array."""

    caller_holds_block = True

    def __init__(self, axis_name: str = "model", device=None, group=None, *,
                 grid: Optional[Sequence[int]] = None, axis_names: Optional[Sequence[str]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: join a group with init_process_mesh first")
        self.group = group
        world = dist.get_world_size(group)
        self._set_axes(*_grid_axes(world if grid is None else grid, axis_name, axis_names))
        if self.p != world:
            raise ValueError(f"grid {tuple(grid)} has {self.p} ranks, but the group has {world}")
        self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        self._backend = str(dist.get_backend(group))
        #: device type -> backend of the group ("cpu:gloo,cuda:nccl" names both)
        self._backends = (dict(part.split(":") for part in self._backend.split(","))
                          if ":" in self._backend else {"cuda" if self._backend == "nccl" else "cpu": self._backend})
        if self.device.type not in self._backends:
            raise ValueError(f"a {self._backend} group moves no blocks on {self.device}")
        #: group rank -> global rank (what point-to-point calls address)
        self._global = dist.get_process_group_ranks(group or dist.group.WORLD)
        self._rings: Dict[str, _AxisMesh] = {}
        if len(self.dims) > 1:
            timeout = datetime.timedelta(seconds=timeout_s)
            for axes in ring_axes(self.axis_names):
                key = _axis_key(axes)
                for ring in self.ring_ranks(axes):
                    if len(ring) == 1:  # no message moves on a ring of one
                        if ring == [self.rank]:
                            self._rings[key] = self._ring_view(SimMesh(1, key, self.device), axes)
                        continue
                    sub = dist.new_group([self._global[r] for r in ring], timeout=timeout)
                    if self.rank in ring:
                        self._rings[key] = self._ring_view(ProcessGroupMesh(key, self.device, sub), axes)

    def local_ranks(self) -> List[int]:
        """The ranks whose blocks this process holds: its own."""
        return [self.rank]

    def rings(self, axis_name: str) -> List[Tuple[_AxisMesh, List[int]]]:
        """The rank's own ring of ``axis_name`` as ``[(1-D view, [0])]``:
        the view is a mesh over that ring's subgroup (a one-rank
        ``SimMesh`` where the ring has one rank), ``[0]`` the index of
        the one local block. A 1-D mesh is its own ring."""
        axes = self.axes_of(axis_name)
        if len(self.dims) == 1 or axes == self.axis_names:  # every axis: the whole group
            return [(self, [0])]
        return [(self._rings[_axis_key(axes)], [0])]

    @contextlib.contextmanager
    def running(self, me: int):
        """Per-rank code of rank ``me`` -- always this process's rank."""
        if me != self.rank:
            raise ValueError(f"process of rank {self.rank} cannot run rank {me}'s code")
        yield

    def axis_index(self, axis_name: Axes) -> int:
        """The rank's coordinate along ``axis_name`` (row-major over a
        tuple of axes: :meth:`ring_index`)."""
        return self.ring_index(self.rank, axis_name)

    # -- collectives (1-D) ----------------------------------------------------------
    def ppermute_start(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Pending:
        """Post this rank's send and receive of a ppermute as one
        ``batch_isend_irecv`` (grouped, so a ring of NCCL sends cannot
        deadlock) and return at once. The send buffer and the receive
        buffer are held until :meth:`Pending.wait`, so the caching
        allocator cannot hand them out while the transport still uses
        them; on the card ``wait`` orders the current stream after the
        transfer and does not block the host."""
        self._check_1d(pieces)
        piece, me = pieces[0], self.rank
        if _records(piece):
            raise NotImplementedError("a posted ppermute over a process group carries no gradient: under autograd "
                                      "hop through core.overlap (ppermute_start, the rings)")
        dsts = [d for s, d in perm if s == me]
        srcs = [s for s, d in perm if d == me]
        if len(dsts) > 1 or len(srcs) > 1:
            raise ValueError(f"perm {list(perm)} sends or receives twice at rank {me}")
        send = piece.resolve_conj().contiguous()
        if srcs == [me]:  # a rank's message to itself moves no bytes
            return Pending(self, lambda: [send.clone()])
        recv = torch.empty(piece.shape, dtype=piece.dtype, device=self.device)
        if srcs:
            _record(self, "collective-permute", _nbytes(recv))
        ops, works = self._post([(send, d) for d in dsts], [(recv, s) for s in srcs])

        def complete() -> Blocks:
            for w in works:
                w.wait()
            del ops[:]  # the send buffer lives until here
            return [recv if srcs else torch.zeros_like(piece)]

        return Pending(self, complete)

    def all_to_all(self, blocks: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> Blocks:
        """Tiled all-to-all (see :meth:`SimMesh.all_to_all`) as one
        ``all_to_all_single`` over the pieces stacked source-major.
        Differentiable: the backward is the inverse all-to-all."""
        self._check_1d(blocks)
        b, p = blocks[0], self.p
        if b.shape[split_axis] % p:
            raise ValueError(f"all_to_all: axis of size {b.shape[split_axis]} does not split into {p} pieces")
        if _records(b):
            return [_AllToAll.apply(self, split_axis, concat_axis, b)]
        return [self._all_to_all(b, split_axis, concat_axis)]

    def _all_to_all(self, b: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        inp = torch.stack(torch.chunk(b.resolve_conj(), self.p, dim=split_axis))
        out = torch.empty_like(inp)
        self._wire_all_to_all(out, inp)
        _record(self, "all-to-all", _nbytes(out))
        return torch.cat(list(out.unbind(0)), dim=concat_axis)

    def all_max(self, values: Sequence[float]) -> List[float]:
        """The largest of each value over the group's ranks (one
        ``all_reduce``; every rank must call it with as many values): how
        ranks agree on a decision that leads into collectives, so none
        of them takes a branch the others do not."""
        import torch.distributed as dist

        t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t.tolist()

    def host_max(self, values: Sequence[float]) -> List[float]:
        """:meth:`all_max` over the group's CPU backend (gloo): the
        control plane of decisions taken on the host (the serving
        engine's admission, breaker and retry clocks). On the card
        :meth:`all_max` all-reduces a device tensor, so the host waits
        until the stream reaches it; this never touches the stream, so
        batches already queued keep running while the ranks agree. A
        group joined with :func:`init_process_mesh` has a CPU backend on
        the card too (``cpu:gloo,cuda:nccl``)."""
        import torch.distributed as dist

        if "cpu" not in self._backends:
            raise ValueError(
                f"the group's backend {self._backend!r} has no CPU half for host agreements: "
                "join with init_process_mesh (cpu:gloo,cuda:nccl on the card)"
            )
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t.tolist()

    def psum(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None, *,
             activation: bool = False) -> Blocks:
        """``lax.psum`` over ``axis_name`` (a 1-D mesh's own axis by
        default): one ``all_reduce`` (SUM) of a copy of the rank's block on
        the axis's ring group (a grid's rings have theirs, made with the
        mesh). The collective hands every rank of the ring the same bits.
        ``activation``: as :meth:`SimMesh.psum`'s.

        Differentiable for the model's layout, where the sum is used the
        same on every rank (every rank computes the same loss from it):
        the backward is the identity, Megatron's "g" -- each rank's
        partial sum takes the whole sum's gradient. A replicated tensor
        that enters each rank's own compute goes through :meth:`pvary`,
        whose backward sums the ranks' gradients."""
        self._check(blocks)
        ring, _ = self.rings(axis_name or self.axis_name)[0]
        if ring.p == 1:  # a ring of one: nothing to reduce
            return [blocks[0]]
        scope = "state" if not activation and self._count_reduce(axis_name, blocks[0]) else "activation"
        if _records(blocks[0]):
            return [_Psum.apply(ring, blocks[0], scope)]
        return [_all_reduce(ring, blocks[0], "SUM", scope)]

    def pmax(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None) -> Blocks:
        """``lax.pmax`` over ``axis_name``, as :meth:`psum` (MAX). It has
        no gradient, and raises where autograd would record it: its one
        caller, ``models.attention.flash_decode_combine``, lies on no
        training path (no path calls it)."""
        self._check(blocks)
        ring, _ = self.rings(axis_name or self.axis_name)[0]
        if ring.p == 1:
            return [blocks[0]]
        if _records(blocks[0]):
            raise NotImplementedError("pmax over a process group has no gradient: run it outside autograd")
        return [_all_reduce(ring, blocks[0], "MAX")]

    def pvary(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None) -> Blocks:
        """A tensor that is the same on every rank of ``axis_name``'s ring
        entering rank-specific compute (a product with the rank's block of
        a weight, the rank's slice of it, or a weight kept whole that
        meets the rank's own activations): Megatron's "f", the transpose
        of ``lax.pvary``. The forward is the identity; the backward sums
        the ranks' gradients with one all-reduce over the ring, since each
        rank's graph holds only its own use of the tensor."""
        self._check(blocks)
        ring, _ = self.rings(axis_name or self.axis_name)[0]
        if ring.p == 1 or not _records(blocks[0]):
            return [blocks[0]]
        return [_Vary.apply(ring, blocks[0])]

    def all_gather(self, blocks: Sequence[torch.Tensor], axis_name: Optional[str] = None) -> Blocks:
        """``lax.all_gather`` over ``axis_name``: the (P, ...) stack of the
        ring's blocks in ring order, by one ``all_gather_into_tensor`` of
        the rank's block (in its own dtype: int8 moves as int8) on the
        axis's ring group. Differentiable: the backward keeps the rank's
        own entry of the stack's gradient (the stack is used the same on
        every rank)."""
        self._check(blocks)
        ring, _ = self.rings(axis_name or self.axis_name)[0]
        b = blocks[0].resolve_conj().contiguous()
        if ring.p == 1:
            return [b[None]]
        if _records(b):
            return [_AllGather.apply(ring, b)]
        return [_stack_gather(ring, b)]

    def all_gather_fsdp(self, blocks: Sequence[torch.Tensor], axis_name: Optional[Axes] = None,
                        dim: int = 0) -> Blocks:
        """FSDP's gather: the ring's blocks concatenated along ``dim`` in
        ring order (``lax.all_gather(..., axis=dim, tiled=True)``), one
        ``all_gather_into_tensor`` on the ring's group. Differentiable:
        unlike :meth:`all_gather`, whose stack every rank uses the same,
        each rank uses the gathered weight on its own rows of the batch,
        so the backward reduce-scatters -- the ring's gradients summed,
        each rank its block (:meth:`psum_scatter`)."""
        self._check(blocks)
        return [self.gather_many([blocks[0]], [dim], axis_name)[0]]

    def gather_many(self, tensors: Sequence[torch.Tensor], dims: Sequence[int],
                    axis_name: Optional[Axes] = None) -> List[torch.Tensor]:
        """:meth:`all_gather_fsdp` of several of the rank's tensors at once,
        each along its own dim: one ``all_gather_into_tensor`` for all of
        them (per dtype), and in the backward one reduce-scatter -- a
        layer's weights move in one collective, not one a leaf."""
        ring, _ = self.rings(axis_name or self.axis_name)[0]
        if ring.p == 1 or not tensors:
            return list(tensors)
        if any(_records(t) for t in tensors):
            return list(_GatherMany.apply(ring, tuple(dims), *tensors))
        return _gather_many(ring, list(tensors), list(dims))

    def psum_scatter(self, blocks: Sequence[torch.Tensor], axis_name: Optional[Axes] = None,
                     dim: int = 0) -> Blocks:
        """``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``: one
        ``reduce_scatter_tensor`` (SUM) on the ring's group; the rank gets
        its slice of the ring's sum along ``dim``. Differentiable: the
        backward all-gathers the slices' gradients (each rank's slice is
        its own; the sum's gradient is every slice's)."""
        self._check(blocks)
        ring, _ = self.rings(axis_name or self.axis_name)[0]
        b = blocks[0]
        if b.shape[dim] % ring.p:
            raise ValueError(f"psum_scatter: dim {dim} of size {b.shape[dim]} does not split over {ring.p} ranks")
        if ring.p == 1:
            return [b]
        if _records(b):
            return [_PsumScatter.apply(ring, dim, b)]
        return [_psum_scatter(ring, b, dim)]

    # -- global <-> per-rank ----------------------------------------------------
    def split(self, x, tail: Sequence[Optional[str]]) -> Blocks:
        """Global array -> this rank's block (a view of ``x`` on the
        mesh's device)."""
        return [self._block(self.place(x), self.rank, tail)]

    def gather(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """This rank's block -> the global array, on every rank: one
        ``all_gather_into_tensor`` over the mesh's group where ``tail``
        shards one dim of a 1-D mesh (the MoE dispatches' gathers), else
        one list ``all_gather`` and a copy of each block into place.
        Differentiable: the backward keeps the rank's own block of the
        global array's gradient (the array is used the same on every
        rank)."""
        self._check(blocks)
        b = blocks[0]
        if not self._shard_dims(b.ndim, tail):
            return b.resolve_conj().contiguous()
        if _records(b):
            return _Gather.apply(self, tuple(tail), b)
        return self._gather(b, tail)

    def _gather(self, b: torch.Tensor, tail: Sequence[Optional[str]]) -> torch.Tensor:
        b = b.resolve_conj().contiguous()
        dims = self._shard_dims(b.ndim, tail)
        if len(self.dims) == 1:
            dim = dims[0][0]
            front = b.movedim(dim, 0).contiguous()
            out = torch.empty((self.p * front.shape[0],) + tuple(front.shape[1:]), dtype=b.dtype, device=b.device)
            self._wire_gather_into(out, front)
            _record(self, "all-gather", _nbytes(out))
            return out.movedim(0, dim).contiguous()
        outs = [torch.empty_like(b) for _ in range(self.p)]
        self._wire_gather_list(outs, b)
        _record(self, "all-gather", self.p * _nbytes(b))
        return self._assemble(lambda rank: outs[rank], b.ndim, tail)

    # -- what a transform takes from and gives back to its caller ---------------
    def local_blocks(self, x, tail: Sequence[Optional[str]]) -> Blocks:
        """The caller's array -> the blocks this process runs: the
        caller holds its own block."""
        return [self.place(x)]

    def caller_array(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The blocks a transform produced -> the rank's own block."""
        self._check(blocks)
        return blocks[0]

    def global_input(self, x, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The caller's block -> the global array (for a whole-transform
        library call; every rank gathers it)."""
        return self.gather([self.place(x)], tail)

    def global_output(self, y: torch.Tensor, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """A whole-transform result -> the rank's own block of it."""
        return self.split(y, tail)[0]

    # -- the wire: every ``torch.distributed`` call of the transports ----------------
    def _post(self, sends: List[Tuple[torch.Tensor, int]], recvs: List[Tuple[torch.Tensor, int]]):
        """(the ops, their works) of one ``batch_isend_irecv`` of ``sends``
        / ``recvs`` ((tensor, group rank) pairs)."""
        import torch.distributed as dist

        ops = [dist.P2POp(dist.isend, _wire(t), self._global[d], self.group) for t, d in sends]
        ops += [dist.P2POp(dist.irecv, _wire(t), self._global[s], self.group) for t, s in recvs]
        return ops, (dist.batch_isend_irecv(ops) if ops else [])

    def _wire_all_reduce(self, t: torch.Tensor, op: str) -> None:
        import torch.distributed as dist

        dist.all_reduce(_wire(t), op=getattr(dist.ReduceOp, op), group=self.group)

    def _wire_gather_into(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        import torch.distributed as dist

        dist.all_gather_into_tensor(_wire(out), _wire(inp), group=self.group)

    def _wire_gather_list(self, outs: List[torch.Tensor], inp: torch.Tensor) -> None:
        import torch.distributed as dist

        dist.all_gather([_wire(o) for o in outs], _wire(inp), group=self.group)

    def _wire_all_to_all(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        import torch.distributed as dist

        dist.all_to_all_single(_wire(out), _wire(inp), group=self.group)

    def _wire_reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        import torch.distributed as dist

        dist.reduce_scatter_tensor(_wire(out), _wire(inp), group=self.group)

    def __repr__(self) -> str:
        axes = (f"axis_name={self.axis_name!r}" if len(self.dims) == 1
                else f"grid={self.dims}, axis_names={self.axis_names}")
        return f"{type(self).__name__}(p={self.p}, rank={self.rank}, {axes}, device={str(self.device)!r})"


class MetaRankMesh(ProcessGroupMesh):
    """One rank of a grid of ``dims`` ranks named ``axis_names`` (or
    ``p`` ranks on ``axis_name``), holding its own blocks on the ``meta``
    device: shapes and dtypes, no memory. It joins no process group and
    reads no environment. Every transport is :class:`ProcessGroupMesh`'s
    -- the same buffers made, the same shapes returned, the same counts
    recorded in :data:`COLLECTIVE_BYTES` / :data:`FSDP_BYTES` -- but the
    wire calls move nothing, so one process runs one rank's step as a
    trace (``launch.dryrun.executed``). :meth:`all_max` and
    :meth:`host_max` return the rank's own values (a stand-in: every rank
    is taken to agree). ``rank`` picks the rank's coordinates (row-major).
    ``device`` other than ``meta`` runs a rank's step on real tensors, where
    a grid of one rank (nothing moves) is the meaningful one."""

    def __init__(self, dims: Union[int, Sequence[int]], axis_names: Optional[Sequence[str]] = None, *,
                 rank: int = 0, axis_name: str = "model", device="meta"):
        self.group = None
        self._set_axes(*_grid_axes(dims, axis_name, axis_names))
        if not 0 <= rank < self.p:
            raise ValueError(f"rank {rank} is not one of the grid's {self.p}")
        self.rank = rank
        self.device = torch.device(device)
        self._backend, self._backends = "meta", {"meta": "meta", "cpu": "meta"}
        self._global = list(range(self.p))
        self._rings: Dict[str, _AxisMesh] = {}
        if len(self.dims) > 1:
            for axes in ring_axes(self.axis_names):
                key = _axis_key(axes)
                ring = next(r for r in self.ring_ranks(axes) if self.rank in r)
                view = (SimMesh(1, key, self.device) if len(ring) == 1
                        else MetaRankMesh(len(ring), axis_name=key, rank=ring.index(self.rank), device=self.device))
                self._rings[key] = self._ring_view(view, axes)

    def all_max(self, values: Sequence[float]) -> List[float]:
        return [float(v) for v in values]

    def host_max(self, values: Sequence[float]) -> List[float]:
        return [float(v) for v in values]

    def _post(self, sends, recvs):
        return [], []

    def _wire_all_reduce(self, t, op) -> None:
        pass

    def _wire_gather_into(self, out, inp) -> None:
        pass

    def _wire_gather_list(self, outs, inp) -> None:
        pass

    def _wire_all_to_all(self, out, inp) -> None:
        pass

    def _wire_reduce_scatter(self, out, inp) -> None:
        pass


def _records(t: torch.Tensor) -> bool:
    """Whether autograd records an op on ``t`` (the collectives take their
    differentiable form only then: serving and the FFT paths run the plain
    calls, untouched)."""
    return torch.is_grad_enabled() and t.requires_grad


def _all_reduce(ring: ProcessGroupMesh, b: torch.Tensor, op: str, scope: str = "activation") -> torch.Tensor:
    """One ``all_reduce`` of a copy of ``b`` over ``ring``'s group."""
    t = b.resolve_conj().clone(memory_format=torch.contiguous_format)
    ring._wire_all_reduce(t, op)
    _record(ring, "all-reduce", _nbytes(t), scope)
    return t


def _stack_gather(ring: ProcessGroupMesh, b: torch.Tensor) -> torch.Tensor:
    """The (P, ...) stack of the ring's blocks, one ``all_gather_into_tensor``."""
    b = b.resolve_conj().contiguous()
    out = torch.empty((ring.p * b.numel(),), dtype=b.dtype, device=b.device)
    ring._wire_gather_into(out, b.reshape(-1))
    _record(ring, "all-gather", _nbytes(out))
    return out.view((ring.p,) + tuple(b.shape))


def ring_axes(names: Sequence[str]) -> List[Tuple[str, ...]]:
    """The axis groups a grid of axes ``names`` makes rings for, in the
    order every rank creates their groups: each axis alone, then each
    proper subset of two or more axes (a dim placed over ``("pod",
    "data")``, the norm of leaves placed on two axes)."""
    names = tuple(names)
    return [axes for k in range(1, len(names)) for axes in itertools.combinations(names, k)]


def _axis_key(axes: Sequence[str]) -> str:
    """The name of a ring over ``axes``: the axis itself, or the axes
    joined by ``+``."""
    return "+".join(axes)


def _flat_cat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors]) if len(tensors) > 1 else tensors[0].reshape(-1)


def _gather_many(ring: ProcessGroupMesh, tensors: List[torch.Tensor], dims: List[int]) -> List[torch.Tensor]:
    """Each tensor's ring blocks concatenated along its dim, by one
    ``all_gather_into_tensor`` of the rank's blocks side by side (one per
    dtype): the output holds the ranks' buffers one after another, so a
    tensor's blocks are one column of the (P, n) view, laid along its
    dim by a ``movedim``."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        send = _flat_cat([tensors[i].detach().resolve_conj().contiguous() for i in idx])
        recv = torch.empty((ring.p, send.numel()), dtype=dtype, device=send.device)
        ring._wire_gather_into(recv.view(-1), send)
        _count("all_gather", recv)
        _record(ring, "all-gather", _nbytes(recv), "state")
        at = 0
        for i in idx:
            t, d = tensors[i], dims[i] % max(tensors[i].ndim, 1)
            n = t.numel()
            piece = recv[:, at:at + n].reshape((ring.p,) + tuple(t.shape))
            shape = list(t.shape)
            shape[d] *= ring.p
            out[i] = piece.movedim(0, d).reshape(shape)
            at += n
    return out  # type: ignore[return-value]


def _reduce_scatter_many(ring: ProcessGroupMesh, grads: List[torch.Tensor], dims: List[int]) -> List[torch.Tensor]:
    """The inverse layout of :func:`_gather_many`: each whole gradient
    cut along its dim into the ring's blocks, the blocks laid rank-major
    in one buffer a dtype, and one reduce-scatter (SUM) hands the rank the
    sum of its blocks."""
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        cols = []
        for i in idx:
            g, d = grads[i], dims[i]
            shape = list(g.shape)
            shape[d:d + 1] = [ring.p, shape[d] // ring.p]
            cols.append(g.reshape(shape).movedim(d, 0).reshape(ring.p, -1))
        send = torch.cat(cols, 1).contiguous() if len(cols) > 1 else cols[0].contiguous()
        recv = torch.empty(send.shape[1], dtype=dtype, device=send.device)
        ring._wire_reduce_scatter(recv, send.view(-1))
        _count("reduce_scatter", send)
        _record(ring, "reduce-scatter", _nbytes(send), "state")
        at = 0
        for i in idx:
            shape = list(grads[i].shape)
            shape[dims[i]] //= ring.p
            n = math.prod(shape)
            out[i] = recv[at:at + n].view(shape)
            at += n
    return out  # type: ignore[return-value]


def _psum_scatter(ring: ProcessGroupMesh, b: torch.Tensor, dim: int) -> torch.Tensor:
    return _reduce_scatter_many(ring, [b], [dim % b.ndim])[0]


class _GatherMany(torch.autograd.Function):
    """FSDP's gather of several tensors (:func:`_gather_many`); the
    backward reduce-scatters their gradients in one collective."""

    @staticmethod
    def forward(ctx, ring, dims, *tensors):
        ctx.ring, ctx.dims = ring, [d % max(t.ndim, 1) for d, t in zip(dims, tensors)]
        return tuple(_gather_many(ring, list(tensors), ctx.dims))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        return (None, None) + tuple(_reduce_scatter_many(ctx.ring, grads, ctx.dims))


class _PsumScatter(torch.autograd.Function):
    """The reduce-scatter; the backward all-gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, ring, dim, b):
        ctx.ring, ctx.dim = ring, dim % b.ndim
        return _psum_scatter(ring, b, ctx.dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, _gather_many(ctx.ring, [grad.contiguous()], [ctx.dim])[0]


class _Psum(torch.autograd.Function):
    """Megatron's "g": a psum of partial sums whose result every rank uses
    the same way. Forward all-reduce, backward identity."""

    @staticmethod
    def forward(ctx, ring, b, scope):
        return _all_reduce(ring, b, "SUM", scope)

    @staticmethod
    def backward(ctx, grad):
        return None, grad, None


class _Vary(torch.autograd.Function):
    """Megatron's "f": a replicated tensor entering rank-specific compute.
    Forward identity, backward all-reduce (SUM)."""

    @staticmethod
    def forward(ctx, ring, b):
        ctx.ring = ring
        return b.view_as(b)

    @staticmethod
    def backward(ctx, grad):
        return None, _all_reduce(ctx.ring, grad, "SUM")


class _AllGather(torch.autograd.Function):
    """The (P, ...) stack of the ring's blocks; the backward keeps the
    rank's own entry of the stack's gradient."""

    @staticmethod
    def forward(ctx, ring, b):
        ctx.me = ring.rank
        return _stack_gather(ring, b)

    @staticmethod
    def backward(ctx, grad):
        return None, grad[ctx.me]


class _Gather(torch.autograd.Function):
    """The global array from each rank's block under ``tail``; the backward
    keeps the rank's own block of the gradient."""

    @staticmethod
    def forward(ctx, mesh, tail, b):
        ctx.mesh, ctx.tail = mesh, tail
        return mesh._gather(b, tail)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return None, None, mesh._block(grad, mesh.rank, ctx.tail)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; the backward is the inverse all-to-all (split
    along the forward's ``concat_axis``, concatenate along its
    ``split_axis``)."""

    @staticmethod
    def forward(ctx, mesh, split_axis, concat_axis, b):
        ctx.mesh, ctx.axes = mesh, (split_axis, concat_axis)
        return mesh._all_to_all(b, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return None, None, None, ctx.mesh._all_to_all(grad.contiguous(), concat_axis, split_axis)


Mesh = Union[SimMesh, ProcessGroupMesh]


def init_process_mesh(rank: int, world_size: int, init_method: str, *, axis_name: str = "model",
                      device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                      grid: Optional[Sequence[int]] = None,
                      axis_names: Optional[Sequence[str]] = None) -> ProcessGroupMesh:
    """Join the default ``torch.distributed`` group as ``rank`` of
    ``world_size`` and return its mesh: one axis named ``axis_name``, or
    with ``grid=(p_rows, p_cols)`` a grid named ``axis_names`` (default
    ``("rows", "cols")``) with one subgroup per ring of each axis.
    ``device=None`` is this rank's card (``cuda:rank % device_count``,
    made current) over NCCL; ``device="cpu"`` runs gloo.
    On the card the group runs NCCL for device tensors and gloo for
    host ones (``cpu:gloo,cuda:nccl``; :meth:`ProcessGroupMesh.host_max`).
    ``init_method`` is the rendezvous address, e.g.
    ``tcp://localhost:29500``: nothing here discovers a cluster. Every
    message and collective of the group and its subgroups fails after
    ``timeout_s`` seconds instead of hanging. Leave the group with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist

    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(device_id=dev) if dev.type == "cuda" else {}  # NCCL: one communicator, made now
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo", init_method=init_method, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    return ProcessGroupMesh(axis_name, device=dev, grid=grid, axis_names=axis_names, timeout_s=timeout_s)


def fft_axis(mesh: Mesh) -> str:
    """Mesh axis the FFT decomposition shards over (``model`` when the
    mesh has it, else its last axis -- ``repro.core.sharding.fft_axis``)."""
    if "model" in mesh.shape:
        return "model"
    return list(mesh.shape)[-1]
