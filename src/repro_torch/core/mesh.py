"""Simulated 1-D device mesh: all ``p`` ranks' local blocks on one device.

The reference runs its per-rank exchange code inside ``shard_map`` over
a jax ``Mesh``, with ``lax.axis_index`` giving the rank and
``lax.ppermute`` / ``lax.all_to_all`` moving the blocks. The port runs
the same per-rank code in lock step over a Python list that holds one
tensor per rank, with ``me`` a plain ``int``; :class:`SimMesh` supplies
the collectives as copies between list entries.

This is how P > 1 schedules run on one card: NCCL will not place two
ranks of one communicator on the same GPU. A ``torch.distributed``
communicator with the same primitives is the next slice (ROADMAP).

There is no overlap here. XLA overlapped the scatter ring's sends with
the per-chunk compute through async collective-permute; the simulated
mesh runs every send and every chunk callback in program order on one
stream.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

Blocks = List[torch.Tensor]


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


class SimMesh:
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
        self._rank: Optional[int] = None

    def axis_size(self, axis_name: str) -> int:
        if axis_name not in self.shape:
            raise ValueError(f"mesh has axes {tuple(self.shape)}, not {axis_name!r}")
        return self.shape[axis_name]

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
    def ppermute(self, pieces: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Blocks:
        """``out[dst] = pieces[src]`` for each ``(src, dst)`` pair, copied
        into a fresh receive tensor (an aliasing reassignment would move
        no bytes). Ranks that receive nothing get zeros, as in
        ``lax.ppermute``."""
        self._check(pieces)
        out: List[Optional[torch.Tensor]] = [None] * self.p
        for src, dst in perm:
            out[dst] = pieces[src].clone(memory_format=torch.contiguous_format)
        return [torch.zeros_like(pieces[i]) if o is None else o for i, o in enumerate(out)]

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
    def place(self, x) -> torch.Tensor:
        """The global array ``x`` (a tensor or array-like) on the mesh's
        device, moved there if it lies elsewhere: a transform runs where
        the mesh's ranks are, never where the caller's tensor happened
        to be made."""
        return torch.as_tensor(x, device=self.device)

    def _shard_dim(self, ndim: int, tail: Sequence[Optional[str]]) -> Optional[int]:
        dims = [ndim - len(tail) + i for i, a in enumerate(tail) if a is not None]
        if len(dims) > 1:
            raise ValueError(f"a 1-D mesh shards one dim, got tail spec {tuple(tail)}")
        for i, a in enumerate(tail):
            if a is not None and a != self.axis_name:
                raise ValueError(f"tail spec names axis {a!r}; mesh axis is {self.axis_name!r}")
        return dims[0] if dims else None

    def split(self, x: torch.Tensor, tail: Sequence[Optional[str]]) -> Blocks:
        """Global array -> per-rank blocks, sharding the dim the trailing
        partition spec ``tail`` names (a schedule's ``in_tail``). The
        blocks are views of ``x``."""
        dim = self._shard_dim(x.ndim, tail)
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
        dim = self._shard_dim(blocks[0].ndim, tail)
        if dim is None:
            return blocks[0]
        return torch.cat(list(blocks), dim=dim)

    def _check(self, blocks: Sequence[torch.Tensor]) -> None:
        if len(blocks) != self.p:
            raise ValueError(f"expected one block per rank ({self.p}), got {len(blocks)}")
        for b in blocks:
            if b.device != self.device:
                raise ValueError(f"a block lies on {b.device}, but the mesh's ranks are on {self.device}")

    def __repr__(self) -> str:
        return f"SimMesh(p={self.p}, axis_name={self.axis_name!r}, device={str(self.device)!r})"


def fft_axis(mesh: SimMesh) -> str:
    """Mesh axis the FFT decomposition shards over (``model`` when the
    mesh has it, else its last axis -- ``repro.core.sharding.fft_axis``)."""
    if "model" in mesh.shape:
        return "model"
    return list(mesh.shape)[-1]
