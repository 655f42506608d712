"""Pluggable collective-backend registry -- the paper's parcelport axis,
PyTorch port of ``repro.core.backends``.

HPX swaps its network layer (TCP / MPI / LCI parcelports) underneath one
collective interface, which is the paper's whole experimental axis.
Every slab-exchange strategy here is a registered
:class:`CollectiveBackend` bundling

- ``transpose(xs, mesh, axis_name, chunk_fn)`` -- the per-rank exchange
  over a list of local blocks (implementations in
  :mod:`repro_torch.core.transpose`);
- ``cost(m_bytes, p, prm, chunk_compute_s)`` -- the alpha-beta model of
  that same schedule (:mod:`repro_torch.core.comm_model`), which ranks
  backends before anything runs and powers ``backend="auto"``.

The registry names are the reference's, so schedule text, schedule
hashes and cost tables compare one for one between the two packages.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Type

from repro_torch.core import comm_model as cm
from repro_torch.core import transpose as tr
from repro_torch.core.comm_model import CommParams
from repro_torch.core.transpose import Blocks, ChunkFn


class CollectiveBackend:
    """One exchange strategy: implementation + cost model.

    ``kind`` is ``"shard_map"`` for backends with a per-rank exchange
    (the name keeps the reference's registry vocabulary) and
    ``"global"`` for a backend that takes over the whole transform (the
    ``xla_auto`` reference: one library ``torch.fft`` call on the
    gathered array). ``supports_chunk_fn``: whether ``transpose``
    streams chunks through a per-arrival callback (the overlap hook).
    """

    name: str = ""
    kind: str = "shard_map"
    supports_chunk_fn: bool = False

    def supports(self, p: int) -> bool:
        """Whether the schedule is defined for ``p`` shards."""
        return True

    def transpose(self, xs: Blocks, mesh, axis_name: str, chunk_fn: Optional[ChunkFn] = None, *,
                  n_chunks: Optional[int] = None) -> Blocks:
        """Per-rank (..., r, C) -> (..., c, R) exchange."""
        raise NotImplementedError(f"backend {self.name!r} has no shard_map transpose")

    def stream_reduce(self, xs: Blocks, mesh, axis_name: str, chunk_fn: ChunkFn, *,
                      n_chunks: Optional[int] = None) -> Blocks:
        """Streaming exchange-and-accumulate over this backend's own
        schedule (:func:`repro_torch.core.transpose._chunked_reduce`) --
        the hook the fused transpose+FFT stage rides. A ``chunk_fn`` with
        a keyword-only ``out`` accumulates each arrival into its slot of
        the own chunk's result (see :data:`~repro_torch.core.transpose.ChunkFn`)."""
        raise NotImplementedError(
            f"backend {self.name!r} is not chunk-streaming; fused stages "
            f"need a backend with supports_chunk_fn"
        )

    def cost(self, m_bytes: float, p: int, prm: CommParams = CommParams(),
             chunk_compute_s: float = 0.0, *, n_chunks: Optional[int] = None,
             fused: bool = True) -> float:
        """Predicted seconds for one exchange of a local block of
        ``m_bytes`` over ``p`` shards (alpha-beta model).
        ``chunk_compute_s`` is *per-chunk* compute (there are ``p``
        chunks): streaming backends overlap it (``fused=True``) or
        serialize it after the exchange (``fused=False``), as the
        monolithic collectives always do."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<CollectiveBackend {self.name!r} kind={self.kind}>"


_REGISTRY: Dict[str, CollectiveBackend] = {}


def register(cls: Type[CollectiveBackend]) -> Type[CollectiveBackend]:
    """Class decorator: instantiate and add to the registry by ``name``."""
    if not cls.name:
        raise ValueError(f"backend class {cls.__name__} must set a name")
    if cls.name in _REGISTRY:
        raise ValueError(f"backend {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls()
    return cls


def get(name: str) -> CollectiveBackend:
    """Look up a backend; unknown names list what *is* registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown collective backend {name!r}; registered backends: {list(available())}"
        ) from None


def available(kind: Optional[str] = None) -> Tuple[str, ...]:
    """Sorted names of every registered backend (of ``kind``, when given)."""
    return tuple(sorted(n for n, b in _REGISTRY.items() if kind is None or b.kind == kind))


def supporting(p: int, kind: Optional[str] = None) -> Tuple[str, ...]:
    """Sorted names of registered backends (of ``kind``, when given)
    whose schedule is defined for ``p`` shards -- the eligibility filter
    behind auto selection and ``Plan.predict``."""
    return tuple(n for n in available(kind) if _REGISTRY[n].supports(p))


def cheapest(
    m_bytes: float,
    p: int,
    prm: CommParams = CommParams(),
    *,
    names: Optional[Iterable[str]] = None,
    chunk_compute_s: float = 0.0,
    n_chunks: Optional[int] = None,
    fused: bool = True,
) -> str:
    """Cost-model argmin over (by default) every registered backend that
    supports ``p`` -- the ``backend="auto"`` rule. Ties break toward the
    lexicographically first name."""
    if names is None:
        names = supporting(p)
    costs = {}
    for n in sorted(names):
        b = get(n)
        if b.supports(p):
            costs[n] = b.cost(m_bytes, p, prm, chunk_compute_s, n_chunks=n_chunks, fused=fused)
    if not costs:
        raise ValueError(f"no registered backend supports P={p}")
    return min(costs, key=costs.__getitem__)


def cheapest_pair(
    m_bytes: float,
    p_rows: int,
    p_cols: int,
    prm: CommParams = CommParams(),
    *,
    names: Optional[Iterable[str]] = None,
    chunk_compute_s: float = 0.0,
    n_chunks: Optional[int] = None,
    fused: bool = True,
) -> Tuple[str, str]:
    """Per-axis cost-model argmin for a pencil grid: (backend_row,
    backend_col), each the :func:`cheapest` per-rank (``shard_map``)
    backend for its own sub-ring size. The two selections are
    independent -- each sub-exchange moves the local block over only its
    own axis, so the ranking decomposes (the 2-D ``backend="auto"``
    rule). ``m_bytes`` is the per-device local block."""
    if names is None:
        row_names = supporting(p_rows, kind="shard_map")
        col_names = supporting(p_cols, kind="shard_map")
    else:
        names = [n for n in names if get(n).kind == "shard_map"]
        row_names = col_names = names
    row = cheapest(m_bytes, p_rows, prm, names=row_names,
                   chunk_compute_s=chunk_compute_s, n_chunks=n_chunks, fused=fused)
    col = cheapest(m_bytes, p_cols, prm, names=col_names,
                   chunk_compute_s=chunk_compute_s, n_chunks=n_chunks, fused=fused)
    return row, col


# ---------------------------------------------------------------------------
# Built-in backends (the paper's strategies + beyond-paper additions)
# ---------------------------------------------------------------------------


@register
class AllToAllBackend(CollectiveBackend):
    """One fused all-to-all -- the paper's synchronized baseline."""

    name = "alltoall"

    def transpose(self, xs, mesh, axis_name, chunk_fn=None, *, n_chunks=None):
        return tr._alltoall(xs, mesh, axis_name)

    def cost(self, m_bytes, p, prm=CommParams(), chunk_compute_s=0.0, *,
             n_chunks=None, fused=True):
        # monolithic: all p chunk computes serialize after the collective
        return cm.t_alltoall(m_bytes, p, prm) + max(p, 1) * chunk_compute_s


@register
class ScatterBackend(CollectiveBackend):
    """P-1 direct sends (ring walk); arriving chunks stream through
    ``chunk_fn`` -- the paper's N-scatter decomposition."""

    name = "scatter"
    supports_chunk_fn = True

    def transpose(self, xs, mesh, axis_name, chunk_fn=None, *, n_chunks=None):
        return tr._scatter(xs, mesh, axis_name, chunk_fn, n_chunks)

    def stream_reduce(self, xs, mesh, axis_name, chunk_fn, *, n_chunks=None):
        return tr._chunked_reduce(xs, mesh, axis_name, chunk_fn, tr._ring_schedule, n_chunks)

    def cost(self, m_bytes, p, prm=CommParams(), chunk_compute_s=0.0, *,
             n_chunks=None, fused=True):
        if not fused:
            # streaming transport, compute serialized after it
            return cm.t_scatter_ring(m_bytes, p, prm, 0.0, n_chunks=n_chunks) + (
                max(p, 1) * chunk_compute_s
            )
        return cm.t_scatter_ring(m_bytes, p, prm, chunk_compute_s, n_chunks=n_chunks)


@register
class BisectionBackend(CollectiveBackend):
    """Bruck / hypercube exchange: ceil(log2 P) rounds of half-buffer
    messages -- wins when per-message latency dominates."""

    name = "bisection"

    def transpose(self, xs, mesh, axis_name, chunk_fn=None, *, n_chunks=None):
        return tr._bisection(xs, mesh, axis_name)

    def cost(self, m_bytes, p, prm=CommParams(), chunk_compute_s=0.0, *,
             n_chunks=None, fused=True):
        # monolithic: all p chunk computes serialize after the collective
        return cm.t_bisection(m_bytes, p, prm) + max(p, 1) * chunk_compute_s


@register
class PairwiseXorBackend(CollectiveBackend):
    """Pairwise XOR exchange (beyond-paper): P-1 symmetric swap rounds,
    round s pairing rank i with i XOR s. Power-of-two P only."""

    name = "pairwise_xor"
    supports_chunk_fn = True

    def supports(self, p: int) -> bool:
        return p >= 1 and (p & (p - 1)) == 0

    def transpose(self, xs, mesh, axis_name, chunk_fn=None, *, n_chunks=None):
        return tr._pairwise_xor(xs, mesh, axis_name, chunk_fn, n_chunks)

    def stream_reduce(self, xs, mesh, axis_name, chunk_fn, *, n_chunks=None):
        return tr._chunked_reduce(xs, mesh, axis_name, chunk_fn, tr._swap_schedule, n_chunks)

    def cost(self, m_bytes, p, prm=CommParams(), chunk_compute_s=0.0, *,
             n_chunks=None, fused=True):
        if not fused:
            return cm.t_pairwise(m_bytes, p, prm, 0.0, n_chunks=n_chunks) + (
                max(p, 1) * chunk_compute_s
            )
        return cm.t_pairwise(m_bytes, p, prm, chunk_compute_s, n_chunks=n_chunks)


@register
class XlaAutoBackend(CollectiveBackend):
    """The 'FFTW3 reference' analogue: one library ``torch.fft`` transform
    of the gathered global array (the reference hands the sharded array
    to XLA's FFT under GSPMD). Whole-transform backend -- no per-rank
    transpose; modeled as one fused all-to-all."""

    name = "xla_auto"
    kind = "global"

    def cost(self, m_bytes, p, prm=CommParams(), chunk_compute_s=0.0, *,
             n_chunks=None, fused=True):
        # monolithic: all p chunk computes serialize after the collective
        return cm.t_alltoall(m_bytes, p, prm) + max(p, 1) * chunk_compute_s
