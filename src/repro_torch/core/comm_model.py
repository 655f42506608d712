"""Alpha-beta cost model of the exchange strategies (the alpha-beta half
of ``repro.core.comm_model``, with the per-axis pencil sums).

Each strategy's time is priced as ``alpha`` per message plus bytes over
``beta``, the paper's Fig. 3 regime (per-message overhead vs bandwidth).
``backend="auto"`` and ``Plan.predict()`` rank strategies with it before
anything runs.

Defaults are NVIDIA H100 SXM figures from NVIDIA's data sheet, not
measurements: NVLink 4 moves 900 GB/s per GPU in all, 450 GB/s each
way, and HBM3 3.35 TB/s. ``ALPHA_S`` is a PLACEHOLDER -- no per-message
latency has been fitted on the card; the reference's ``calibrate`` (a
ppermute ping-pong fit) is not ported yet (ROADMAP A9). Every cost
function takes the params explicitly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# --- NVIDIA H100 SXM constants (NVIDIA's data sheet) -------------------------
NVLINK_BW = 450e9  # bytes/s per GPU, each way (900 GB/s bidirectional)
HBM_BW = 3.35e12  # bytes/s
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, CUDA cores, no tensor cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, TF32 tensor cores, dense (H100 SXM data sheet)
#: per-message latency: a PLACEHOLDER until calibrate is ported (ROADMAP A9)
ALPHA_S = 10e-6


@dataclasses.dataclass(frozen=True)
class CommParams:
    alpha_s: float = ALPHA_S  # per message (placeholder, see module doc)
    beta_bytes_s: float = NVLINK_BW  # per device, each way


def t_alltoall(m_bytes: float, p: int, prm: CommParams = CommParams()) -> float:
    """One fused all-to-all: every device ships (1-1/P)*M once; the fabric
    moves it in a single synchronized phase."""
    if p <= 1:
        return 0.0
    return prm.alpha_s + (1 - 1 / p) * m_bytes / prm.beta_bytes_s


def effective_chunks(p: int, n_chunks: Optional[int] = None) -> int:
    """Total chunks of a streaming exchange under an ``n_chunks`` target:
    ``q * p`` where ``q = ceil(n_chunks / p)`` sub-chunks per peer block
    (``None``/``<= p`` keeps the classic one-per-peer schedule). The
    model-side twin of :func:`repro_torch.core.transpose.subchunks_per_peer`
    -- the executed q additionally snaps to a divisor of the peer block's
    row count, which the byte-level model ignores."""
    if not n_chunks or n_chunks <= p:
        return max(p, 1)
    return max(1, -(-int(n_chunks) // p)) * max(p, 1)


def t_scatter_ring(m_bytes: float, p: int, prm: CommParams = CommParams(),
                   chunk_compute_s: float = 0.0,
                   n_chunks: Optional[int] = None) -> float:
    """Streaming ring: (P-1)*q direct sends of M/(P*q) each (q sub-chunks
    per peer block, q=1 classically); per-sub-chunk compute overlaps the
    next send (fully, if sub-chunk compute <= sub-chunk comm). When
    compute exceeds comm, the difference is exposed on every step, and
    the last sub-chunk's compute is always exposed (nothing left to
    overlap). ``chunk_compute_s`` stays *per peer chunk* (there are P),
    so costs stay comparable across n_chunks."""
    if p <= 1:
        return max(chunk_compute_s, 0.0)
    n = effective_chunks(p, n_chunks)
    q = n // p
    msgs = (p - 1) * q
    per_msg = prm.alpha_s + (m_bytes / n) / prm.beta_bytes_s
    sub_compute = chunk_compute_s / q
    exposed = max(0.0, sub_compute - per_msg) * msgs
    return msgs * per_msg + sub_compute + exposed


def t_bisection(m_bytes: float, p: int, prm: CommParams = CommParams()) -> float:
    """ceil(log2 P) rounds of M/2 each (Bruck): fewest messages, most
    bytes -- wins in the alpha-dominated small-chunk regime."""
    if p <= 1:
        return 0.0
    rounds = math.ceil(math.log2(p))
    return rounds * (prm.alpha_s + (m_bytes / 2) / prm.beta_bytes_s)


def t_pairwise(m_bytes: float, p: int, prm: CommParams = CommParams(),
               chunk_compute_s: float = 0.0,
               n_chunks: Optional[int] = None) -> float:
    """Pairwise XOR exchange: P-1 rounds, round s swapping the M/P chunk
    with partner (rank XOR s), power-of-two P. Same bytes and chunk
    streaming as the scatter ring; it differs in schedule, not overlap."""
    return t_scatter_ring(m_bytes, p, prm, chunk_compute_s, n_chunks)


#: Sub-axis exchanges per pencil transform, (n_row, n_col): fft3 is one
#: transpose per grid axis (+1 each under transpose_back); fft2
#: transforms each data dim over its own sub-ring with a transpose /
#: FFT / transpose-back pass, i.e. two exchanges per axis.
PENCIL_EXCHANGES = {2: (2, 2), 3: (1, 1)}


def pencil_exchanges(ndim: int, transpose_back: bool = False):
    """(n_row, n_col) sub-axis exchanges of one pencil transform."""
    try:
        n_row, n_col = PENCIL_EXCHANGES[ndim]
    except KeyError:
        raise ValueError(f"pencil decomposition supports ndim 2 or 3, got {ndim}") from None
    if transpose_back and ndim == 3:
        n_row, n_col = n_row + 1, n_col + 1
    return n_row, n_col


def t_pencil_axis(m_bytes: float, p_axis: int, backend: str, n_exchanges: int,
                  prm: CommParams = CommParams(), chunk_compute_s: float = 0.0, *,
                  first_m_bytes: Optional[float] = None, n_chunks: Optional[int] = None,
                  fused: bool = True) -> float:
    """Predicted seconds of all of one grid axis's sub-exchanges: the
    axis's backend costed at the axis's own sub-ring size.
    ``first_m_bytes`` sizes the axis's first exchange separately (the
    real pencil rfft2's first cols exchange ships the untransformed real
    block; every later one the Hermitian-truncated complex payload)."""
    from repro_torch.core import backends  # late: backends imports this module

    b = backends.get(backend)

    def one(m: float) -> float:
        return b.cost(m, p_axis, prm, chunk_compute_s, n_chunks=n_chunks, fused=fused)

    if first_m_bytes is None:
        return n_exchanges * one(m_bytes)
    return one(first_m_bytes) + (n_exchanges - 1) * one(m_bytes)


def t_pencil(m_bytes: float, p_rows: int, p_cols: int, backend_row: str, backend_col: str,
             prm: CommParams = CommParams(), *, ndim: int = 3, transpose_back: bool = False,
             chunk_compute_s: float = 0.0, first_col_m_bytes: Optional[float] = None,
             n_chunks: Optional[int] = None, fused: bool = True) -> float:
    """Predicted seconds of one pencil transform's communication: each
    sub-axis exchange costed by its own backend at its own sub-ring size
    (P_row or P_col), the axes summed (the FFT passes between them
    serialize the exchanges). ``m_bytes`` is the per-device local block
    (the half-spectrum block for a real transform, with
    ``first_col_m_bytes`` the rfft2's full-width real first exchange)."""
    n_row, n_col = pencil_exchanges(ndim, transpose_back)
    return t_pencil_axis(
        m_bytes, p_rows, backend_row, n_row, prm, chunk_compute_s, n_chunks=n_chunks, fused=fused,
    ) + t_pencil_axis(
        m_bytes, p_cols, backend_col, n_col, prm, chunk_compute_s,
        first_m_bytes=first_col_m_bytes, n_chunks=n_chunks, fused=fused,
    )
