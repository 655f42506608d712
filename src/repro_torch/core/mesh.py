"""The port's meshes: the per-rank collectives the exchanges run on.

The reference runs its per-rank exchange code inside ``shard_map`` over
a jax ``Mesh`` (``repro.core.compat``), with ``lax.axis_index`` giving
the rank and ``lax.ppermute`` / ``lax.all_to_all`` moving the blocks.
The port runs the same per-rank code over a Python list of local
blocks, one per rank this process runs, and ``me`` a plain ``int``.
Two meshes supply the collectives, with the same methods:

:class:`SimMesh`
    All ``p`` ranks' blocks on one device, run in lock step; the
    collectives are copies between list entries. This is how P > 1
    schedules run on one card (NCCL will not place two ranks of one
    communicator on the same GPU) and in fast CPU tests. A posted
    message is copied when it is waited on, so sends and chunk
    callbacks run in program order on one stream: nothing overlaps.
:class:`ProcessGroupMesh`
    One rank per process over ``torch.distributed`` (NCCL for blocks on
    the card, gloo for blocks on the CPU); the list holds the one local
    block. :meth:`ProcessGroupMesh.ppermute_start` posts a message's
    send and receive at once (one ``batch_isend_irecv``) and returns;
    the exchange posts every ring step up front and runs each chunk
    callback as its receive completes, so the sends travel while the
    callbacks compute. On the card NCCL moves the bytes on its own
    stream and ``wait()`` only orders the compute stream after them.

The exchange code loops over :meth:`local_ranks` (``range(p)`` on the
simulated mesh, ``[rank]`` here) and never asks which mesh it has.
"""

from __future__ import annotations

import contextlib
import datetime
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Blocks = List[torch.Tensor]

#: Seconds a ``torch.distributed`` group waits on a message or collective
#: before it fails (a peer that never posts its half raises instead of
#: hanging the job).
DEFAULT_TIMEOUT_S = 120.0


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


def _shard_dim(axis_name: str, ndim: int, tail: Sequence[Optional[str]]) -> Optional[int]:
    """The dim a trailing partition spec ``tail`` shards on a 1-D mesh
    over ``axis_name`` (None when it shards none)."""
    dims = [ndim - len(tail) + i for i, a in enumerate(tail) if a is not None]
    if len(dims) > 1:
        raise ValueError(f"a 1-D mesh shards one dim, got tail spec {tuple(tail)}")
    for a in tail:
        if a is not None and a != axis_name:
            raise ValueError(f"tail spec names axis {a!r}; mesh axis is {axis_name!r}")
    return dims[0] if dims else None


class _AxisMesh:
    """What both meshes share: one named axis of ``p`` ranks whose
    blocks lie on ``device``."""

    p: int
    axis_name: str
    device: torch.device
    shape: dict

    def axis_size(self, axis_name: str) -> int:
        if axis_name not in self.shape:
            raise ValueError(f"mesh has axes {tuple(self.shape)}, not {axis_name!r}")
        return self.shape[axis_name]

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


class SimMesh(_AxisMesh):
    """``p`` ranks over one named axis, all on ``device``.

    ``shape`` maps the axis name to ``p``, like a jax ``Mesh``, so plan
    code reads ring sizes the same way in both packages."""

    def __init__(self, p: int, axis_name: str = "model", device=None):
        if int(p) < 1:
            raise ValueError(f"a mesh needs at least one rank, got p={p}")
        self.p = int(p)
        self.axis_name = axis_name
        self.device = resolve_device(device)
        self.shape = {axis_name: self.p}
        self.in_flight = 0
        self._rank: Optional[int] = None

    def local_ranks(self) -> List[int]:
        """The ranks whose blocks this process holds: all of them."""
        return list(range(self.p))

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
        """Rank of the per-rank code running now -- the lock-step
        counterpart of ``lax.axis_index`` for callbacks that depend on
        their own rank (the six-step twiddle)."""
        self.axis_size(axis_name)
        if self._rank is None:
            raise RuntimeError("axis_index is only defined inside per-rank code (SimMesh.running)")
        return self._rank

    # -- collectives over per-rank lists --------------------------------------
    def ppermute_start(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Pending:
        """Post a :meth:`ppermute`. The copies run when the message is
        waited on: one stream, program order, no overlap."""
        self._check(pieces)
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
        self._check(blocks)
        p = self.p
        size = blocks[0].shape[split_axis]
        if size % p:
            raise ValueError(f"all_to_all: axis of size {size} does not split into {p} pieces")
        pieces = [torch.chunk(b, p, dim=split_axis) for b in blocks]
        return [torch.cat([pieces[src][dst] for src in range(p)], dim=concat_axis) for dst in range(p)]

    # -- global <-> per-rank ----------------------------------------------------
    def split(self, x: torch.Tensor, tail: Sequence[Optional[str]]) -> Blocks:
        """Global array -> per-rank blocks, sharding the dim the trailing
        partition spec ``tail`` names (a schedule's ``in_tail``). The
        blocks are views of ``x``."""
        dim = _shard_dim(self.axis_name, x.ndim, tail)
        if dim is None:
            return [x] * self.p
        if x.shape[dim] % self.p:
            raise ValueError(
                f"dim {dim} of size {x.shape[dim]} is not divisible by the {self.p} "
                f"ranks of mesh axis {self.axis_name!r}"
            )
        return list(torch.chunk(x, self.p, dim=dim))

    def gather(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """Per-rank blocks -> global array (a schedule's ``out_tail``)."""
        self._check(blocks)
        dim = _shard_dim(self.axis_name, blocks[0].ndim, tail)
        if dim is None:
            return blocks[0]
        return torch.cat(list(blocks), dim=dim)

    # -- what a transform takes from and gives back to its caller ---------------
    def local_blocks(self, x, tail: Sequence[Optional[str]]) -> Blocks:
        """The caller's array -> the blocks this process runs: here the
        caller holds the global array."""
        return self.split(self.place(x), tail)

    def caller_array(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The blocks a transform produced -> what its caller gets: the
        global array."""
        return self.gather(blocks, tail)

    def global_shape(self, shape: Sequence[int], ndim: int) -> Tuple[int, ...]:
        """Global shape of a caller's array whose leading transform dim
        (``-ndim``) is the sharded one: the array itself here."""
        return tuple(shape)

    def global_input(self, x, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The caller's array -> the global array (for a whole-transform
        library call): the caller's array itself here."""
        return self.place(x)

    def global_output(self, y: torch.Tensor, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """A whole-transform result -> what its caller gets: all of it."""
        return y

    def __repr__(self) -> str:
        return f"SimMesh(p={self.p}, axis_name={self.axis_name!r}, device={str(self.device)!r})"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """What a ``torch.distributed`` call moves for ``t``: complex tensors
    as their real (..., 2) view (NCCL has no complex type)."""
    return torch.view_as_real(t) if t.is_complex() else t


class ProcessGroupMesh(_AxisMesh):
    """One rank per process over a ``torch.distributed`` group (the
    default one unless ``group`` is given): the counterpart of
    ``repro.core.compat.make_mesh_1d`` + ``shard_map``. Blocks lie on
    ``device`` (``None``: this process's card), which must match the
    group's backend -- NCCL for the card, gloo for the CPU.

    Join the group with :func:`init_process_mesh`, which also sets its
    timeout. A transform run on this mesh takes and returns the rank's
    own block, the counterpart of a sharded ``jax.Array``'s addressable
    shard; :meth:`split` and :meth:`gather` convert a global array."""

    def __init__(self, axis_name: str = "model", device=None, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: join a group with init_process_mesh first")
        self.group = group
        self.p = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        backend = str(dist.get_backend(group))
        if (backend == "nccl") != (self.device.type == "cuda"):
            raise ValueError(f"a {backend} group moves blocks on the "
                             f"{'card' if backend == 'nccl' else 'CPU'}, not on {self.device}")
        #: group rank -> global rank (what point-to-point calls address)
        self._global = dist.get_process_group_ranks(group or dist.group.WORLD)
        self.axis_name = axis_name
        self.shape = {axis_name: self.p}
        self.in_flight = 0

    def local_ranks(self) -> List[int]:
        """The ranks whose blocks this process holds: its own."""
        return [self.rank]

    @contextlib.contextmanager
    def running(self, me: int):
        """Per-rank code of rank ``me`` -- always this process's rank."""
        if me != self.rank:
            raise ValueError(f"process of rank {self.rank} cannot run rank {me}'s code")
        yield

    def axis_index(self, axis_name: str) -> int:
        self.axis_size(axis_name)
        return self.rank

    # -- collectives ------------------------------------------------------------
    def ppermute_start(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Pending:
        """Post this rank's send and receive of a ppermute as one
        ``batch_isend_irecv`` (grouped, so a ring of NCCL sends cannot
        deadlock) and return at once. The send buffer and the receive
        buffer are held until :meth:`Pending.wait`, so the caching
        allocator cannot hand them out while the transport still uses
        them; on the card ``wait`` orders the current stream after the
        transfer and does not block the host."""
        import torch.distributed as dist

        self._check(pieces)
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

        self._check(blocks)
        b, p = blocks[0], self.p
        if b.shape[split_axis] % p:
            raise ValueError(f"all_to_all: axis of size {b.shape[split_axis]} does not split into {p} pieces")
        inp = torch.stack(torch.chunk(b.resolve_conj(), p, dim=split_axis))
        out = torch.empty_like(inp)
        dist.all_to_all_single(_wire(out), _wire(inp), group=self.group)
        return [torch.cat(list(out.unbind(0)), dim=concat_axis)]

    # -- global <-> per-rank ----------------------------------------------------
    def split(self, x, tail: Sequence[Optional[str]]) -> Blocks:
        """Global array -> this rank's block (a view of ``x`` on the
        mesh's device)."""
        x = self.place(x)
        dim = _shard_dim(self.axis_name, x.ndim, tail)
        if dim is None:
            return [x]
        if x.shape[dim] % self.p:
            raise ValueError(
                f"dim {dim} of size {x.shape[dim]} is not divisible by the {self.p} "
                f"ranks of mesh axis {self.axis_name!r}"
            )
        return [torch.chunk(x, self.p, dim=dim)[self.rank]]

    def gather(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """This rank's block -> the global array, on every rank (one
        ``all_gather``; for tests and checks, never on the hot path)."""
        import torch.distributed as dist

        self._check(blocks)
        b = blocks[0].resolve_conj().contiguous()
        dim = _shard_dim(self.axis_name, b.ndim, tail)
        if dim is None:
            return b
        outs = [torch.empty_like(b) for _ in range(self.p)]
        dist.all_gather([_wire(o) for o in outs], _wire(b), group=self.group)
        return torch.cat(outs, dim=dim)

    # -- what a transform takes from and gives back to its caller ---------------
    def local_blocks(self, x, tail: Sequence[Optional[str]]) -> Blocks:
        """The caller's array -> the blocks this process runs: the
        caller holds its own block."""
        return [self.place(x)]

    def caller_array(self, blocks: Sequence[torch.Tensor], tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The blocks a transform produced -> the rank's own block."""
        self._check(blocks)
        return blocks[0]

    def global_shape(self, shape: Sequence[int], ndim: int) -> Tuple[int, ...]:
        """Global shape of a caller's block whose leading transform dim
        (``-ndim``) is the sharded one."""
        shape = list(shape)
        shape[-ndim] *= self.p
        return tuple(shape)

    def global_input(self, x, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """The caller's block -> the global array (for a whole-transform
        library call; every rank gathers it)."""
        return self.gather([self.place(x)], tail)

    def global_output(self, y: torch.Tensor, tail: Sequence[Optional[str]]) -> torch.Tensor:
        """A whole-transform result -> the rank's own block of it."""
        return self.split(y, tail)[0]

    def __repr__(self) -> str:
        return (f"ProcessGroupMesh(p={self.p}, rank={self.rank}, axis_name={self.axis_name!r}, "
                f"device={str(self.device)!r})")


Mesh = Union[SimMesh, ProcessGroupMesh]


def init_process_mesh(rank: int, world_size: int, init_method: str, *, axis_name: str = "model",
                      device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessGroupMesh:
    """Join the default ``torch.distributed`` group as ``rank`` of
    ``world_size`` and return its mesh. ``device=None`` is this rank's
    card (``cuda:rank % device_count``, made current) over NCCL;
    ``device="cpu"`` runs gloo. ``init_method`` is the rendezvous
    address, e.g. ``tcp://localhost:29500``: nothing here discovers a
    cluster. Every message and collective of the group fails after
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
    return ProcessGroupMesh(axis_name, device=dev)


def fft_axis(mesh: Mesh) -> str:
    """Mesh axis the FFT decomposition shards over (``model`` when the
    mesh has it, else its last axis -- ``repro.core.sharding.fft_axis``)."""
    if "model" in mesh.shape:
        return "model"
    return list(mesh.shape)[-1]
