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
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

Blocks = List[torch.Tensor]

#: Seconds a ``torch.distributed`` group waits on a message or collective
#: before it fails (a peer that never posts its half raises instead of
#: hanging the job).
DEFAULT_TIMEOUT_S = 120.0

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

    @property
    def axis_name(self) -> str:
        """The one axis of a 1-D mesh."""
        if len(self.axis_names) != 1:
            raise ValueError(f"a grid mesh has axes {self.axis_names}, not one axis_name")
        return self.axis_names[0]

    def axis_size(self, axis_name: str) -> int:
        if axis_name not in self.shape:
            raise ValueError(f"mesh has axes {tuple(self.shape)}, not {axis_name!r}")
        return self.shape[axis_name]

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

    def ring_ranks(self, axis_name: str) -> List[List[int]]:
        """The rings of ``axis_name``: each the ranks that differ only in
        that axis's coordinate, in coordinate order; the rings in the
        order of their first rank."""
        self.axis_size(axis_name)
        others = [n for n in self.axis_names if n != axis_name]
        rings = []
        for fixed in itertools.product(*(range(self.shape[n]) for n in others)):
            base = dict(zip(others, fixed))
            rings.append([self._rank_of({**base, axis_name: i}) for i in range(self.shape[axis_name])])
        return rings

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
        names = [a for _, a in dims]
        for a in names:
            if a not in self.shape:
                raise ValueError(f"tail spec {tuple(tail)} names axis {a!r}; mesh axes are {self.axis_names}")
        if len(set(names)) != len(names):
            raise ValueError(f"tail spec {tuple(tail)} names a mesh axis twice")
        return dims

    def _block(self, x: torch.Tensor, rank: int, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """Rank ``rank``'s block of the global ``x`` under ``tail`` (a view)."""
        coords = self.coords(rank)
        index = [slice(None)] * x.ndim
        for dim, axis in self._shard_dims(x.ndim, tail):
            k = self.shape[axis]
            if x.shape[dim] % k:
                raise ValueError(
                    f"dim {dim} of size {x.shape[dim]} is not divisible by the {k} "
                    f"ranks of mesh axis {axis!r}"
                )
            n = x.shape[dim] // k
            index[dim] = slice(coords[axis] * n, (coords[axis] + 1) * n)
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
            shape[dim] *= self.shape[axis]
        out = torch.empty(shape, dtype=first.dtype, device=first.device)
        for coords in itertools.product(*(range(self.shape[axis]) for _, axis in dims)):
            index = [slice(None)] * ndim
            for (dim, _), i in zip(dims, coords):
                index[dim] = slice(i * first.shape[dim], (i + 1) * first.shape[dim])
            out[tuple(index)] = block_of(self._rank_of({axis: i for (_, axis), i in zip(dims, coords)}))
        return out

    def global_shape(self, shape: Sequence[int], tail: Sequence[Optional[str]]) -> Tuple[int, ...]:
        """Global shape of a caller's array under the trailing spec
        ``tail``: the array itself where the caller holds the global
        array (:class:`SimMesh`), its block's dims times their axis
        sizes where it holds its own block."""
        shape = list(shape)
        if self.caller_holds_block:
            for dim, axis in self._shard_dims(len(shape), tail):
                shape[dim] *= self.shape[axis]
        return tuple(shape)

    def caller_shape(self, global_shape: Sequence[int], tail: Sequence[Optional[str]]) -> Tuple[int, ...]:
        """The inverse of :meth:`global_shape`: the shape of the array a
        caller passes for a global array of ``global_shape`` under
        ``tail`` (the global shape itself, or the rank's block's)."""
        shape = list(global_shape)
        if self.caller_holds_block:
            for dim, axis in self._shard_dims(len(shape), tail):
                shape[dim] //= self.shape[axis]
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
        view = self._ring_views.get(axis_name)
        if view is None:
            view = self._ring_views[axis_name] = SimMesh(self.axis_size(axis_name), axis_name, self.device)
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
        return self.coords(self._rank)[axis_name]

    # -- collectives over per-rank lists (1-D) ------------------------------------
    def ppermute_start(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Pending:
        """Post a :meth:`ppermute`. The copies run when the message is
        waited on: one stream, program order, no overlap."""
        self._check_1d(pieces)
        pieces, perm = list(pieces), list(perm)

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
        return [torch.cat([pieces[src][dst] for src in range(p)], dim=concat_axis) for dst in range(p)]

    def all_max(self, values: Sequence[float]) -> List[float]:
        """The largest of each value over the ranks that call it: every
        rank of this process runs the same code, so its own values."""
        return [float(v) for v in values]

    # -- global <-> per-rank ----------------------------------------------------
    def split(self, x: torch.Tensor, tail: Sequence[Optional[str]]) -> Blocks:
        """Global array -> per-rank blocks, sharding the dims the trailing
        partition spec ``tail`` names (a schedule's ``in_tail``; each
        entry an axis name or None) and replicating over the axes it
        does not name. The blocks are views of ``x``."""
        return [self._block(x, rank, tail) for rank in range(self.p)]

    def gather(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """Per-rank blocks -> global array (a schedule's ``out_tail``)."""
        self._check(blocks)
        return self._assemble(lambda rank: blocks[rank], blocks[0].ndim, tail)

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
        backend = str(dist.get_backend(group))
        if (backend == "nccl") != (self.device.type == "cuda"):
            raise ValueError(f"a {backend} group moves blocks on the "
                             f"{'card' if backend == 'nccl' else 'CPU'}, not on {self.device}")
        #: group rank -> global rank (what point-to-point calls address)
        self._global = dist.get_process_group_ranks(group or dist.group.WORLD)
        self._rings: Dict[str, _AxisMesh] = {}
        if len(self.dims) > 1:
            timeout = datetime.timedelta(seconds=timeout_s)
            for axis in self.axis_names:
                for ring in self.ring_ranks(axis):
                    if len(ring) == 1:  # no message moves on a ring of one
                        if ring == [self.rank]:
                            self._rings[axis] = SimMesh(1, axis, self.device)
                        continue
                    sub = dist.new_group([self._global[r] for r in ring], timeout=timeout)
                    if self.rank in ring:
                        self._rings[axis] = ProcessGroupMesh(axis, self.device, sub)

    def local_ranks(self) -> List[int]:
        """The ranks whose blocks this process holds: its own."""
        return [self.rank]

    def rings(self, axis_name: str) -> List[Tuple[_AxisMesh, List[int]]]:
        """The rank's own ring of ``axis_name`` as ``[(1-D view, [0])]``:
        the view is a mesh over that ring's subgroup (a one-rank
        ``SimMesh`` where the ring has one rank), ``[0]`` the index of
        the one local block. A 1-D mesh is its own ring."""
        self.axis_size(axis_name)
        if len(self.dims) == 1:
            return [(self, [0])]
        return [(self._rings[axis_name], [0])]

    @contextlib.contextmanager
    def running(self, me: int):
        """Per-rank code of rank ``me`` -- always this process's rank."""
        if me != self.rank:
            raise ValueError(f"process of rank {self.rank} cannot run rank {me}'s code")
        yield

    def axis_index(self, axis_name: str) -> int:
        self.axis_size(axis_name)
        return self.coords(self.rank)[axis_name]

    # -- collectives (1-D) ----------------------------------------------------------
    def ppermute_start(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Pending:
        """Post this rank's send and receive of a ppermute as one
        ``batch_isend_irecv`` (grouped, so a ring of NCCL sends cannot
        deadlock) and return at once. The send buffer and the receive
        buffer are held until :meth:`Pending.wait`, so the caching
        allocator cannot hand them out while the transport still uses
        them; on the card ``wait`` orders the current stream after the
        transfer and does not block the host."""
        import torch.distributed as dist

        self._check_1d(pieces)
        piece, me = pieces[0], self.rank
        dsts = [d for s, d in perm if s == me]
        srcs = [s for s, d in perm if d == me]
        if len(dsts) > 1 or len(srcs) > 1:
            raise ValueError(f"perm {list(perm)} sends or receives twice at rank {me}")
        send = piece.resolve_conj().contiguous()
        if srcs == [me]:  # a rank's message to itself moves no bytes
            return Pending(self, lambda: [send.clone()])
        recv = torch.empty(piece.shape, dtype=piece.dtype, device=self.device)
        ops = [dist.P2POp(dist.isend, _wire(send), self._global[d], self.group) for d in dsts]
        ops += [dist.P2POp(dist.irecv, _wire(recv), self._global[s], self.group) for s in srcs]
        works = dist.batch_isend_irecv(ops) if ops else []

        def complete() -> Blocks:
            for w in works:
                w.wait()
            del ops[:]  # the send buffer lives until here
            return [recv if srcs else torch.zeros_like(piece)]

        return Pending(self, complete)

    def all_to_all(self, blocks: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> Blocks:
        """Tiled all-to-all (see :meth:`SimMesh.all_to_all`) as one
        ``all_to_all_single`` over the pieces stacked source-major."""
        import torch.distributed as dist

        self._check_1d(blocks)
        b, p = blocks[0], self.p
        if b.shape[split_axis] % p:
            raise ValueError(f"all_to_all: axis of size {b.shape[split_axis]} does not split into {p} pieces")
        inp = torch.stack(torch.chunk(b.resolve_conj(), p, dim=split_axis))
        out = torch.empty_like(inp)
        dist.all_to_all_single(_wire(out), _wire(inp), group=self.group)
        return [torch.cat(list(out.unbind(0)), dim=concat_axis)]

    def all_max(self, values: Sequence[float]) -> List[float]:
        """The largest of each value over the group's ranks (one
        ``all_reduce``; every rank must call it with as many values): how
        ranks agree on a decision that leads into collectives, so none
        of them takes a branch the others do not."""
        import torch.distributed as dist

        t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t.tolist()

    # -- global <-> per-rank ----------------------------------------------------
    def split(self, x, tail: Sequence[Optional[str]]) -> Blocks:
        """Global array -> this rank's block (a view of ``x`` on the
        mesh's device)."""
        return [self._block(self.place(x), self.rank, tail)]

    def gather(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """This rank's block -> the global array, on every rank (one
        ``all_gather`` over the mesh's group; for tests and checks,
        never on the hot path)."""
        import torch.distributed as dist

        self._check(blocks)
        b = blocks[0].resolve_conj().contiguous()
        if not self._shard_dims(b.ndim, tail):
            return b
        outs = [torch.empty_like(b) for _ in range(self.p)]
        dist.all_gather([_wire(o) for o in outs], _wire(b), group=self.group)
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

    def __repr__(self) -> str:
        axes = (f"axis_name={self.axis_name!r}" if len(self.dims) == 1
                else f"grid={self.dims}, axis_names={self.axis_names}")
        return f"ProcessGroupMesh(p={self.p}, rank={self.rank}, {axes}, device={str(self.device)!r})"


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
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    return ProcessGroupMesh(axis_name, device=dev, grid=grid, axis_names=axis_names, timeout_s=timeout_s)


def fft_axis(mesh: Mesh) -> str:
    """Mesh axis the FFT decomposition shards over (``model`` when the
    mesh has it, else its last axis -- ``repro.core.sharding.fft_axis``)."""
    if "model" in mesh.shape:
        return "model"
    return list(mesh.shape)[-1]
