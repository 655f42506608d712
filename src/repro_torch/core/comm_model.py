"""Alpha-beta cost model of the exchange strategies, its calibration
and the roofline terms (PyTorch port of ``repro.core.comm_model``).

Each strategy's time is priced as ``alpha`` per message plus bytes over
``beta``, the paper's Fig. 3 regime (per-message overhead vs bandwidth).
``backend="auto"`` and ``Plan.predict()`` rank strategies with it before
anything runs.

Defaults are NVIDIA H100 SXM figures from NVIDIA's data sheet, not
measurements: NVLink 4 moves 900 GB/s per GPU in all, 450 GB/s each
way, and HBM3 3.35 TB/s. ``ALPHA_S`` is a placeholder per-message
latency. :meth:`CommParams.calibrate` fits both constants to a mesh by
a ping-pong sweep over its own ``ppermute`` (NCCL on a
``ProcessGroupMesh``; on a ``SimMesh`` only a device copy, see
:func:`_pingpong_timer`), and :meth:`CommParams.refine_online` refits
them from observed exchange spans. Every cost function takes the params
explicitly.

The reference's HLO collective parser (``parse_collectives``) and
``core/hlo_analysis.py`` have no counterpart: the port compiles no
program text to parse. :class:`Roofline`'s terms come from the stage
schedule instead (:func:`roofline_from_schedule`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# --- NVIDIA H100 SXM constants (NVIDIA's data sheet) -------------------------
NVLINK_BW = 450e9  # bytes/s per GPU, each way (900 GB/s bidirectional)
HBM_BW = 3.35e12  # bytes/s
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, CUDA cores, no tensor cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, TF32 tensor cores, dense (H100 SXM data sheet)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 tensor cores, dense (H100 SXM data sheet)
#: per-message latency: a placeholder, not a measurement (see
#: CommParams.calibrate for the fitted value of a mesh)
ALPHA_S = 10e-6

#: Message sizes (bytes) swept by :meth:`CommParams.calibrate` -- wide
#: enough to pin both the latency intercept and the bandwidth slope on
#: the reference's fabric; NVLink's slope is poorly pinned below a few
#: MiB, so pass larger ``sizes`` there.
CALIBRATE_SIZES = (4096, 16384, 65536, 262144, 1048576, 4194304)

#: Largest physically-plausible fitted bandwidth (1 PB/s; the fastest
#: real fabrics are ~1 TB/s). Above this the fit's slope is float noise.
_BETA_FIT_MAX = 1e15


@dataclasses.dataclass(frozen=True)
class CommParams:
    alpha_s: float = ALPHA_S  # per message (placeholder, see module doc)
    beta_bytes_s: float = NVLINK_BW  # per device, each way

    @classmethod
    def calibrate(
        cls,
        mesh=None,
        axis_name: Optional[str] = None,
        *,
        sizes: Iterable[int] = CALIBRATE_SIZES,
        warmup: int = 1,
        iters: int = 5,
        timer: Optional[Callable[[int], float]] = None,
    ) -> "CommParams":
        """Fit alpha/beta to this mesh's fabric by measurement (the
        paper's Fig. 3 per-parcelport fit, as an API).

        Runs a ping-pong (one round trip = 2 hops) for each message size
        in ``sizes`` on the mesh and least-squares fits ``t_roundtrip =
        2*alpha + 2*m/beta``. ``timer(m_bytes) -> roundtrip seconds``
        overrides the measurement (tests inject synthetic timings; no
        mesh needed). When the sweep never leaves the latency regime the
        bandwidth is not identifiable: a warning, and the default beta
        (``NVLINK_BW``)."""
        import numpy as np

        sizes = [int(m) for m in sizes]
        if len(sizes) < 2:
            raise ValueError("calibrate needs >= 2 message sizes to fit alpha and beta")
        if timer is None:
            if mesh is None:
                raise ValueError("calibrate needs a mesh (or an injected timer)")
            timer = _pingpong_timer(mesh, axis_name, warmup=warmup, iters=iters)
        ts = np.asarray([float(timer(m)) for m in sizes])
        # least squares t = a + b*m; round trip = 2 hops
        slope, intercept = np.polyfit(np.asarray(sizes, dtype=float), ts, 1)
        alpha = max(float(intercept) / 2.0, 0.0)
        beta = 2.0 / float(slope) if slope > 0 else float("inf")
        # a non-positive or numerically-zero slope means the sweep never
        # left the latency-dominated regime (or was pure noise): an
        # "infinite bandwidth" fit would silently zero the beta term, so
        # fall back to the default constant and say so
        if not (0 < beta <= _BETA_FIT_MAX):
            import warnings

            warnings.warn(
                f"calibrate: bandwidth not identifiable from this sweep "
                f"(fitted slope {float(slope):.3e} s/byte); keeping the "
                f"default beta -- extend `sizes` upward to fix",
                RuntimeWarning,
                stacklevel=2,
            )
            beta = NVLINK_BW
        return cls(alpha_s=alpha, beta_bytes_s=beta)

    def refine_online(self, trace, *, min_spans: int = 2) -> Dict[Tuple[str, str], "CommParams"]:
        """Re-fit alpha/beta from observed Exchange spans.

        ``trace`` is a :class:`repro_torch.obs.trace.TraceRecorder` (its
        ``exchange_spans()`` are consumed), or any iterable of spans
        (``Span`` objects or their JSONL dicts). Each span contributes
        one point ``t = alpha * n_msgs + fit_bytes / beta`` with
        ``n_msgs`` / ``fit_bytes`` from the span's backend structure
        (:func:`exchange_fit_terms`).

        Returns a dict mapping ``(backend, payload_class)`` to a new
        frozen :class:`CommParams` (``self`` is never mutated), plus the
        pooled fit under ``("*", "*")``. Groups with fewer than
        ``min_spans`` points or a degenerate / negative fit keep this
        instance's constants for the unidentifiable coefficient."""
        import numpy as np

        if hasattr(trace, "exchange_spans"):
            spans = trace.exchange_spans()
        else:
            spans = [s for s in trace if _span_field(s, "cat") == "exchange"]
        groups: Dict[Tuple[str, str], list] = {}
        pooled: list = []
        for sp in spans:
            args = _span_field(sp, "args") or {}
            dur = _span_field(sp, "dur")
            backend = args.get("backend")
            p = args.get("p")
            block = args.get("block_bytes")
            if not (isinstance(backend, str) and isinstance(p, (int, float)) and p
                    and isinstance(block, (int, float)) and isinstance(dur, (int, float))
                    and dur > 0):
                continue
            msgs, fit_bytes = exchange_fit_terms(backend, int(p), float(block), args.get("n_chunks"))
            wire = args.get("wire_bytes", fit_bytes)
            row = (float(msgs), float(fit_bytes), float(dur))
            groups.setdefault((backend, payload_class(float(wire))), []).append(row)
            pooled.append(row)
        fits = dict(groups)
        fits[("*", "*")] = pooled
        return {key: self._fit_spans(rows, min_spans, np) for key, rows in fits.items()}

    def _fit_spans(self, rows, min_spans: int, np) -> "CommParams":
        if len(rows) < max(2, min_spans):
            return self
        a = np.asarray([[r[0], r[1]] for r in rows], dtype=float)
        y = np.asarray([r[2] for r in rows], dtype=float)
        if np.linalg.matrix_rank(a) < 2:
            return self
        (alpha, inv_beta), *_ = np.linalg.lstsq(a, y, rcond=None)
        new_alpha = float(alpha) if alpha > 0 else self.alpha_s
        beta = 1.0 / float(inv_beta) if inv_beta > 0 else float("inf")
        new_beta = beta if 0 < beta <= _BETA_FIT_MAX else self.beta_bytes_s
        return dataclasses.replace(self, alpha_s=new_alpha, beta_bytes_s=new_beta)


def _span_field(sp, name: str):
    """Span attribute access across Span objects and their JSONL dicts."""
    if isinstance(sp, dict):
        return sp.get(name)
    return getattr(sp, name, None)


#: (exclusive) upper edges of the observed-payload size classes the
#: online refinement groups spans by -- wire payloads below 64 KiB are
#: latency-shaped, above 8 MiB bandwidth-shaped.
PAYLOAD_CLASS_EDGES = ((64 * 1024, "small"), (8 * 1024 * 1024, "medium"))


def payload_class(wire_bytes: float) -> str:
    for edge, name in PAYLOAD_CLASS_EDGES:
        if wire_bytes < edge:
            return name
    return "large"


def exchange_fit_terms(backend: str, p: int, block_bytes: float,
                       n_chunks: Optional[int] = None) -> Tuple[float, float]:
    """(n_msgs, bytes-on-the-wire) one Exchange contributes to the
    alpha/beta regression -- the message/byte structure of each cost
    function below, inverted for fitting: ring backends send
    ``(P-1)*q`` messages of the wire payload, bisection ``ceil(log2 P)``
    rounds of half the block, all-to-all one fused phase (also the
    shape of unknown backends)."""
    if p <= 1:
        return 0.0, 0.0
    wire = block_bytes * (1 - 1 / p)
    if backend in ("scatter", "pairwise_xor"):
        q = effective_chunks(p, n_chunks) // p
        return float((p - 1) * q), wire
    if backend == "bisection":
        rounds = math.ceil(math.log2(p))
        return float(rounds), rounds * block_bytes / 2
    return 1.0, wire


def _pingpong_timer(mesh, axis_name: Optional[str], *, warmup: int, iters: int,
                    rounds: int = 10) -> Callable[[int], float]:
    """The mesh's round-trip timer: every rank ships an m-byte float32
    block one hop forward and one hop back over the mesh's own
    ``ppermute_start(...).wait()`` -- the messages the ring exchanges
    send. On a ``ProcessGroupMesh`` that is NCCL (gloo on the CPU)
    ``batch_isend_irecv``; on a ``SimMesh`` no message leaves the device
    and a round trip times two device copies, so its fit describes the
    card's copy engine, not a fabric. A grid mesh sweeps one ring of
    ``axis_name`` (default: ``fft_axis``).

    Each sample is one fence around ``rounds`` back-to-back round trips
    -- CUDA events on the card, so the host's time to post a message
    overlaps the transfers as it does in an exchange -- and the timer
    returns the median of ``iters`` samples per round trip. On a
    ``ProcessGroupMesh`` every rank returns the group's largest sample
    (one all-reduce), so all ranks fit the same constants."""
    import statistics
    import time

    import torch

    from repro_torch.core.mesh import fft_axis

    if axis_name is None:
        axis_name = fft_axis(mesh)
    ring, _ = mesh.rings(axis_name)[0]
    p = ring.p
    fwd = [(i, (i + 1) % p) for i in range(p)]
    bwd = [(i, (i - 1) % p) for i in range(p)]
    cuda = mesh.device.type == "cuda"

    def timer(m_bytes: int) -> float:
        n = max(int(m_bytes) // 4, 1)
        blocks = [torch.zeros(n, dtype=torch.float32, device=mesh.device) for _ in ring.local_ranks()]

        def round_trips() -> None:
            for _ in range(rounds):
                ring.ppermute_start(ring.ppermute_start(blocks, fwd).wait(), bwd).wait()

        for _ in range(warmup):
            round_trips()
        samples = []
        for _ in range(iters):
            if cuda:
                torch.cuda.synchronize(mesh.device)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                round_trips()
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) * 1e-3 / rounds)
            else:
                t0 = time.perf_counter()
                round_trips()
                samples.append((time.perf_counter() - t0) / rounds)
        return mesh.all_max([statistics.median(samples)])[0]

    timer.axis_name = axis_name  # resolved axis, inspectable by callers and tests
    return timer


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


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    """The three roofline terms of one transform, per device (per rank):
    ``flops`` operations, ``hbm_bytes`` device-memory bytes, and
    ``coll_bytes`` bytes shipped to other ranks, over ``chips`` ranks.
    ``peak_flops`` is the rate ``t_compute`` prices ``flops`` at -- one
    data-sheet peak, or the rate that prices a mix of tensor-core and
    CUDA-core work at its sum (:func:`roofline_from_schedule`)."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    peak_flops: float = PEAK_FLOPS_FP32

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def _dft_terms(n: int, rows: float, impl: str) -> List[Tuple[float, float]]:
    """(operations, peak) terms of one length-``n`` complex DFT pass over
    ``rows`` rows, as ``impl`` computes it. ``torch``: the radix-2 count
    ``5 n log2 n`` per row at the fp32 peak (the library FFT). ``matmul``:
    the dense four-step products of ``fftmath.fft_matmul`` (8 per complex
    multiply-add, 6 per twiddle) at the fp32 peak. ``kernel``: where the
    stage kernels take the split, the same products counted three times
    (3xTF32: three TF32 products per fp32 product) at the TF32 peak;
    the lengths they do not take fall back to ``matmul``."""
    from repro_torch.core import fftmath as lf

    if n <= 1:
        return []
    if impl == "torch":
        return [(5.0 * n * math.log2(n) * rows, PEAK_FLOPS_FP32)]
    if impl == "kernel":
        from repro_torch.kernels.ops import _kernel_factors

        factors = _kernel_factors(n)
        if factors is not None:
            n1, n2 = factors
            return [(3.0 * (8.0 * n * (n1 + n2) + 6.0 * n) * rows, PEAK_FLOPS_TF32)]

    def matmul_ops(m: int) -> float:
        m1 = lf.split_factor(m, lf.MAX_DFT)
        if m1 in (0, m):
            return 8.0 * m * m
        return 8.0 * m * m1 + 6.0 * m + m1 * matmul_ops(m // m1)

    return [(matmul_ops(n) * rows, PEAK_FLOPS_FP32)]


def roofline_from_schedule(sched, *, input_shape, impl: str, real_itemsize: int, complex_itemsize: int,
                           chips: int) -> Roofline:
    """The roofline of one rank running ``sched`` on a global input of
    ``input_shape`` (the port's stand-in for the reference's
    compiled-HLO roofline), walking one rank's block through the stages
    (:func:`repro_torch.core.schedule.stage_blocks`):

    - operations: each local FFT pass and each FFT folded into an
      exchange at its impl's count (:func:`_dft_terms`); a fused
      exchange's per-chunk pack (6 per output for a fresh chunk, 8 for an
      accumulating one), the six-step twiddle (6 per element), both at
      the fp32 peak;
    - device memory: one read of each stage's input block and one write
      of its output block; a Relayout or Trim is a view in the port and
      moves nothing;
    - shipped bytes: :func:`repro_torch.core.schedule.schedule_comm_bytes`.
    """
    from repro_torch.core import backends
    from repro_torch.core import schedule as sch

    if sched.global_backend is not None:
        impl = "torch"  # one library transform of the gathered array
    terms: List[Tuple[float, float]] = []
    hbm = 0.0
    for st, shape_in, shape_out, cplx_in, cplx_out in sch.stage_blocks(sched, input_shape):
        elems_in, elems_out = float(math.prod(shape_in)), float(math.prod(shape_out))
        if isinstance(st, (sch.Relayout, sch.Trim)):
            continue
        hbm += elems_in * (complex_itemsize if cplx_in else real_itemsize)
        hbm += elems_out * (complex_itemsize if cplx_out else real_itemsize)
        if isinstance(st, sch.LocalFFT):
            n = shape_in[st.axis]
            terms += _dft_terms(n, elems_in / n, impl)
        elif isinstance(st, (sch.LocalR2C, sch.LocalC2R)):
            # the library's r2c / c2r pass does half a c2c pass; the
            # matmul and kernel impls transform the complexified axis
            real_shape = shape_in if isinstance(st, sch.LocalR2C) else shape_out
            n = real_shape[-1]
            share = 0.5 if impl == "torch" else 1.0
            terms += [(f * share, pk) for f, pk in _dft_terms(n, math.prod(real_shape) / n, impl)]
        elif isinstance(st, sch.Twiddle):
            terms.append((6.0 * elems_in, PEAK_FLOPS_FP32))
        elif isinstance(st, sch.Exchange) and st.fft:
            n = shape_out[-1]
            if st.fused and st.p > 1 and backends.get(st.backend).supports_chunk_fn:
                # p chunks each packed into the whole accumulator: the
                # own chunk fresh, the p - 1 arrivals accumulating
                terms.append(((6.0 + 8.0 * (st.p - 1)) * elems_out, PEAK_FLOPS_FP32))
                n //= st.p  # the local FFT left after the exchange
            terms += _dft_terms(n, elems_out / n, impl)
    flops = sum(f for f, _ in terms)
    seconds = sum(f / pk for f, pk in terms)
    r_item, c_item = real_itemsize, complex_itemsize
    return Roofline(
        flops=flops, hbm_bytes=hbm, coll_bytes=sch.schedule_comm_bytes(sched, r_item, c_item), chips=chips,
        peak_flops=flops / seconds if seconds else PEAK_FLOPS_FP32,
    )
