"""Stage-schedule IR, PyTorch port of ``repro.core.schedule`` (slab and
pencil, c2c and r2c/c2r).

Every distributed transform lowers to a declarative tuple of **Stage**
records, and one interpreter (:func:`execute_schedule`) runs any
schedule over the local blocks of a mesh
(:mod:`repro_torch.core.mesh`), reusing
:func:`repro_torch.core.transpose.transpose_then_fft` /
``distributed_transpose``. The cost model and the byte accounting walk
the same object that executes.

The stage records, their field order and :meth:`Schedule.canonical`
are the reference's, byte for byte, so a schedule built here hashes
exactly as the reference's does for the same arguments.

Builders here: slab c2c (``fft2``, ``fft3``, the six-step ``fft1d``),
slab r2c/c2r (``rfft2``, ``irfft2``, ``rfft3``, ``irfft3``) and their
pencil counterparts over a 2-D grid (c2c ``fft2`` / ``fft3``, r2c/c2r
``rfft2`` / ``rfft3`` and inverses), whose exchanges each run over one
grid axis. The executor runs an exchange once per ring of its axis
(:meth:`repro_torch.core.mesh.SimMesh.rings`), so the transport code
stays 1-D.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import repro_torch.core.fftmath as lf
import repro_torch.core.transpose as tr
from repro_torch.core.mesh import Mesh


# ---------------------------------------------------------------------------
# Hermitian-length helpers (shared by the validator and the builders;
# re-exported by repro_torch.core.real for its public API)
# ---------------------------------------------------------------------------


def rfft_len(n: int) -> int:
    """Length of the Hermitian-non-redundant rfft output for a real
    length-``n`` axis (numpy's ``n//2 + 1``)."""
    return int(n) // 2 + 1


def padded_rfft_len(n: int, multiple: int, weight: int = 1) -> int:
    """Smallest ``hp >= rfft_len(n)`` with ``(weight * hp) % multiple == 0``.

    ``weight`` covers the slab fft3 case where the *flattened* axis
    ``D1 * Hp`` (not ``Hp`` itself) must divide the shard count."""
    hp = rfft_len(n)
    while (weight * hp) % multiple:
        hp += 1
    return hp


def _pad_disabled_hint(n: int, multiple: int, weight: int = 1) -> str:
    return (
        f"pass pad=True (pads the half spectrum to "
        f"{padded_rfft_len(n, multiple, weight)}, plan-recorded trim)"
    )


# ---------------------------------------------------------------------------
# Shard-divisibility validation (slab c2c and r2c)
# ---------------------------------------------------------------------------


def check_divisible(
    global_shape,
    ndim: int,
    *,
    p: Optional[int] = None,
    axis_name=None,
    p_rows: Optional[int] = None,
    p_cols: Optional[int] = None,
    row_axis=None,
    col_axis=None,
    real: bool = False,
    pad: bool = True,
):
    """Validate that ``global_shape`` can be sharded for this transform:
    slab over ``p`` ranks of ``axis_name``, or pencil over the
    ``p_rows`` x ``p_cols`` grid (pass ``p_rows``). The one copy behind
    ``pencil.check_divisible``, ``real.check_divisible_slab`` /
    ``check_divisible_pencil`` and the plan. Raises a ``ValueError``
    naming the offending data axis and mesh/grid dimension -- the
    plan-time guard, so the failure never surfaces as an opaque chunking
    error deep inside :mod:`repro_torch.core.transpose`.

    Returns ``(h, hp)`` for real problems (the Hermitian and
    shard-padded Hermitian lengths), ``None`` for c2c."""
    shape = tuple(global_shape)
    pencil = p_rows is not None

    if not real:
        if pencil:
            pr, pc = p_rows, p_cols

            def need(axis_from_end: int, divisor: int, why: str) -> None:
                size = shape[len(shape) - axis_from_end]
                if size % divisor:
                    raise ValueError(
                        f"pencil fft{ndim}: data axis -{axis_from_end} (global size "
                        f"{size}) is not divisible by {why} -- shape "
                        f"{shape} on grid {pr}x{pc} "
                        f"(row_axis={row_axis!r}, col_axis={col_axis!r})"
                    )

            if ndim == 3:
                need(3, pr, f"P_row={pr} ({row_axis!r})")
                need(2, pc, f"P_col={pc} ({col_axis!r})")
                need(2, pr, f"P_row={pr} ({row_axis!r}; the rows exchange re-shards it)")
                need(1, pc, f"P_col={pc} ({col_axis!r}; the cols exchange re-shards it)")
            elif ndim == 2:
                need(2, pr * pc, f"P_row*P_col={pr * pc} (both sub-rings re-shard it)")
                need(1, pr * pc, f"P_row*P_col={pr * pc} (both sub-rings re-shard it)")
            else:
                raise ValueError(f"pencil decomposition supports ndim 2 or 3, got {ndim}")
            return None
        ax = axis_name
        if ndim == 2:
            r, c = shape[-2:]
            for off, size in ((2, r), (1, c)):
                if size % p:
                    raise ValueError(
                        f"slab fft2: data axis -{off} (global size {size}) is not "
                        f"divisible by mesh axis {ax!r} (P={p}) -- shape {shape}"
                    )
        elif ndim == 3:
            d0, d1, d2 = shape[-3:]
            if d0 % p:
                raise ValueError(
                    f"slab fft3: data axis -3 (global size {d0}) is not divisible "
                    f"by mesh axis {ax!r} (P={p}) -- shape {shape}"
                )
            if (d1 * d2) % p:
                raise ValueError(
                    f"slab fft3: flattened axes (-2,-1) (size {d1}*{d2}={d1 * d2}) "
                    f"not divisible by mesh axis {ax!r} (P={p}) -- shape {shape}"
                )
        else:
            n = shape[-1]
            if n % (p * p):
                raise ValueError(
                    f"fft1d_large: data axis -1 (size {n}) must be divisible by "
                    f"P^2={p * p} of mesh axis {ax!r} -- shape {shape}"
                )
        return None

    if not pencil:
        if ndim == 2:
            r, c = shape[-2:]
            if r % p:
                raise ValueError(
                    f"real slab rfft2: data axis -2 (global size {r}) is not "
                    f"divisible by mesh axis {axis_name!r} (P={p}) -- shape {shape}"
                )
            h = rfft_len(c)
            if not pad and h % p:
                raise ValueError(
                    f"real slab rfft2: Hermitian axis -1 (N={c} -> N//2+1={h}) is "
                    f"not divisible by mesh axis {axis_name!r} (P={p}) and "
                    f"pad=False -- shape {shape}; {_pad_disabled_hint(c, p)}"
                )
            return h, (padded_rfft_len(c, p) if pad else h)
        if ndim == 3:
            d0, d1, d2 = shape[-3:]
            if d0 % p:
                raise ValueError(
                    f"real slab rfft3: data axis -3 (global size {d0}) is not "
                    f"divisible by mesh axis {axis_name!r} (P={p}) -- shape {shape}"
                )
            h = rfft_len(d2)
            if not pad and (d1 * h) % p:
                raise ValueError(
                    f"real slab rfft3: flattened axes (-2,-1) (size {d1}*{h}={d1 * h} "
                    f"after the Hermitian truncation of N={d2}) not divisible by "
                    f"mesh axis {axis_name!r} (P={p}) and pad=False -- shape "
                    f"{shape}; {_pad_disabled_hint(d2, p, d1)}"
                )
            return h, (padded_rfft_len(d2, p, weight=d1) if pad else h)
        raise NotImplementedError(
            f"real transforms support ndim 2 or 3, got ndim={ndim} "
            f"(1-D real: run the c2c fft1d_large on a complexified signal)"
        )

    pr, pc = p_rows, p_cols
    where = (
        f"shape {shape} on grid {pr}x{pc} "
        f"(row_axis={row_axis!r}, col_axis={col_axis!r})"
    )
    if ndim == 3:
        d0, d1, d2 = shape[-3:]
        if d0 % pr:
            raise ValueError(
                f"real pencil rfft3: data axis -3 (global size {d0}) is not "
                f"divisible by P_row={pr} ({row_axis!r}) -- {where}"
            )
        for divisor, why in ((pc, f"P_col={pc} ({col_axis!r})"),
                             (pr, f"P_row={pr} ({row_axis!r}; the rows "
                                  f"exchange re-shards it)")):
            if d1 % divisor:
                raise ValueError(
                    f"real pencil rfft3: data axis -2 (global size {d1}) is "
                    f"not divisible by {why} -- {where}"
                )
        h = rfft_len(d2)
        if not pad and h % pc:
            raise ValueError(
                f"real pencil rfft3: Hermitian axis -1 (N={d2} -> N//2+1={h}) "
                f"is not divisible by P_col={pc} ({col_axis!r}) and "
                f"pad=False -- {where}; {_pad_disabled_hint(d2, pc)}"
            )
        return h, (padded_rfft_len(d2, pc) if pad else h)
    if ndim == 2:
        r, c = shape[-2:]
        if r % (pr * pc):
            raise ValueError(
                f"real pencil rfft2: data axis -2 (global size {r}) is not "
                f"divisible by P_row*P_col={pr * pc} (both sub-rings re-shard "
                f"it) -- {where}"
            )
        if c % pc:
            raise ValueError(
                f"real pencil rfft2: data axis -1 (global size {c}) is not "
                f"divisible by P_col={pc} ({col_axis!r}) -- {where}"
            )
        h = rfft_len(c)
        if not pad and h % (pr * pc):
            raise ValueError(
                f"real pencil rfft2: Hermitian axis -1 (N={c} -> N//2+1={h}) "
                f"is not divisible by P_row*P_col={pr * pc} (both sub-rings "
                f"re-shard it) and pad=False -- {where}; "
                f"{_pad_disabled_hint(c, pr * pc)}"
            )
        return h, (padded_rfft_len(c, pr * pc) if pad else h)
    raise NotImplementedError(f"real pencil transforms support ndim 2 or 3, got {ndim}")


# ---------------------------------------------------------------------------
# Stage records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalFFT:
    """One local c2c FFT pass along ``axis`` (1/n factor when inverse)."""

    axis: int = -1
    inverse: bool = False


@dataclasses.dataclass(frozen=True)
class LocalR2C:
    """Local real-to-complex pass along the last axis (keeps H = N//2+1)."""


@dataclasses.dataclass(frozen=True)
class LocalC2R:
    """Local complex-to-real pass: half spectrum (length ``n_last//2+1``)
    to a real length-``n_last`` signal, carrying the 1/n factor."""

    n_last: int


@dataclasses.dataclass(frozen=True)
class HermitianPack:
    """Zero-pad the Hermitian axis from ``h`` to the shard-divisible
    ``hp`` (the pad is exactly zero, so downstream FFTs stay exact)."""

    h: int
    hp: int


@dataclasses.dataclass(frozen=True)
class Trim:
    """Keep the first ``h`` entries of the last axis (drop the shard pad
    where the Hermitian axis lands local again)."""

    h: int


@dataclasses.dataclass(frozen=True)
class Relayout:
    """Free local data movement: ``swap_last2`` / ``swap_outer``
    (axes -3,-2) / ``flatten2`` (merge the last two axes) /
    ``unflatten2`` (split the last axis into ``dims``)."""

    op: str
    dims: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Twiddle:
    """Six-step twiddle w_n^(j2*k1) of the 1-D large transform (N = r*c
    viewed row-major). Always immediately precedes an Exchange: on a
    chunk-streaming backend the executor folds it into that exchange's
    per-chunk compute; otherwise it is applied up-front to the block."""

    n: int
    r: int
    c: int


@dataclasses.dataclass(frozen=True)
class Exchange:
    """One collective transpose over mesh axis ``axis`` (ring size
    ``p``), dispatched through the backend registry. ``fft=True`` runs
    :func:`repro_torch.core.transpose.transpose_then_fft` -- the
    following FFT pass folded into the arriving chunks when ``fused``
    and the backend streams (conjugated tables when ``inverse``).
    ``elems`` is the per-device payload element count and ``payload``
    its wire dtype class -- the byte truth the cost model walks."""

    axis: str
    role: str  # 'slab' | 'row' | 'col'
    backend: str
    p: int
    elems: float
    payload: str = "complex"
    fft: bool = False
    inverse: bool = False
    fused: bool = False
    n_chunks: Optional[int] = None


# ---------------------------------------------------------------------------
# Schedule container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A lowered transform: stage tuple + the metadata the runner and
    the analyzers need. ``global_shape`` is the full data-side shape
    (batch dims included); ``in_tail``/``out_tail`` are the trailing
    partition-spec entries of the transform's input/output (leading
    batch dims are replicated). ``conj``/``scale`` implement the c2c
    inverse as the conjugate-wrap of the forward schedule.
    ``global_backend`` marks whole-transform backends: the stage list
    still carries the abstract exchange structure for cost/byte
    accounting, but execution is one library transform of the gathered
    array."""

    kind: str
    global_shape: Tuple[int, ...]
    ndim: int
    decomp: str
    real: bool
    inverse: bool
    transpose_back: bool
    stages: Tuple[object, ...]
    in_tail: Tuple[Optional[str], ...]
    out_tail: Tuple[Optional[str], ...]
    conj: bool = False
    scale: Optional[float] = None
    n_last: Optional[int] = None
    h: Optional[int] = None
    hp: Optional[int] = None
    global_backend: Optional[str] = None

    # -- identity ----------------------------------------------------------
    def canonical(self) -> str:
        """Stable text form: header + one dataclass repr per stage. This
        is what hashes, and what the golden snapshots diff."""
        head = (
            f"kind={self.kind}|shape={self.global_shape}|ndim={self.ndim}|"
            f"decomp={self.decomp}|real={self.real}|inverse={self.inverse}|"
            f"tb={self.transpose_back}|conj={self.conj}|scale={self.scale}|"
            f"n_last={self.n_last}|h={self.h}|hp={self.hp}|"
            f"in={self.in_tail}|out={self.out_tail}|gb={self.global_backend}"
        )
        return "\n".join([head] + [repr(st) for st in self.stages])

    def schedule_hash(self) -> str:
        """12-hex content hash of :meth:`canonical` -- two plans with the
        same hash execute the same pipeline."""
        return hashlib.sha256(self.canonical().encode()).hexdigest()[:12]

    # -- queries -----------------------------------------------------------
    def exchanges(self, role: Optional[str] = None) -> Tuple[Exchange, ...]:
        return tuple(
            st for st in self.stages
            if isinstance(st, Exchange) and (role is None or st.role == role)
        )

    def describe(self, *, params=None, chunk_compute_s: float = 0.0,
                 real_itemsize: int = 8, complex_itemsize: int = 8) -> str:
        return describe_schedule(
            self, params=params, chunk_compute_s=chunk_compute_s,
            real_itemsize=real_itemsize, complex_itemsize=complex_itemsize,
        )


# ---------------------------------------------------------------------------
# Cost / byte walks (the SAME object that executes)
# ---------------------------------------------------------------------------


def exchange_block_bytes(st: Exchange, real_itemsize: int, complex_itemsize: int) -> float:
    """Full per-device block bytes one Exchange re-shards (the alpha-beta
    ``m_bytes``); the wire ships ``(1 - 1/p)`` of it."""
    item = complex_itemsize if st.payload == "complex" else real_itemsize
    return st.elems * item


def exchange_wire_bytes(st: Exchange, real_itemsize: int, complex_itemsize: int) -> float:
    return exchange_block_bytes(st, real_itemsize, complex_itemsize) * (1 - 1 / st.p)


def schedule_comm_bytes(sched: Schedule, real_itemsize: int, complex_itemsize: int) -> float:
    """Total bytes each device ships per transform -- the sum of every
    Exchange stage's wire payload."""
    return sum(
        exchange_wire_bytes(st, real_itemsize, complex_itemsize)
        for st in sched.exchanges()
    )


def stage_seconds(st: Exchange, params, chunk_compute_s: float,
                  real_itemsize: int, complex_itemsize: int) -> float:
    """Alpha-beta predicted seconds of one Exchange stage, costed by its
    own backend at its own ring size with its own pipeline fields."""
    from repro_torch.core import backends

    b = backends.get(st.backend)
    return b.cost(
        exchange_block_bytes(st, real_itemsize, complex_itemsize),
        st.p, params, chunk_compute_s,
        n_chunks=st.n_chunks, fused=st.fused,
    )


def predict_seconds(sched: Schedule, params, chunk_compute_s: float,
                    real_itemsize: int, complex_itemsize: int,
                    role: Optional[str] = None) -> float:
    """Whole-schedule predicted seconds: the sum of :func:`stage_seconds`
    over its Exchange stages."""
    return sum(
        stage_seconds(st, params, chunk_compute_s, real_itemsize, complex_itemsize)
        for st in sched.exchanges(role)
    )


# ---------------------------------------------------------------------------
# Rewrites
# ---------------------------------------------------------------------------


def with_pipeline(sched: Schedule, fused: bool, n_chunks: Optional[int]) -> Schedule:
    """Rewrite every Exchange's pipeline fields (fused / sub-chunked)."""
    stages = tuple(
        dataclasses.replace(st, fused=bool(fused), n_chunks=n_chunks)
        if isinstance(st, Exchange) else st
        for st in sched.stages
    )
    return dataclasses.replace(sched, stages=stages)


def with_backends(sched: Schedule, *, slab: Optional[str] = None,
                  row: Optional[str] = None, col: Optional[str] = None) -> Schedule:
    """Rewrite Exchange backends by role -- backend candidates as
    schedule rewrites."""
    sub = {"slab": slab, "row": row, "col": col}

    def rw(st):
        if not isinstance(st, Exchange):
            return st
        nm = sub.get(st.role)
        return st if nm is None else dataclasses.replace(st, backend=nm)

    return dataclasses.replace(sched, stages=tuple(rw(st) for st in sched.stages))


def apply_variant(sched: Schedule, candidate: str, *, pipeline="auto") -> Schedule:
    """Measured-planner candidate id (``name``, ``name@u``,
    ``name@f<k>``, ``"row+col"`` pair key, with or without variant
    suffix) -> the rewritten schedule that candidate would execute. A
    plain name resolves to ``pipeline`` (default: fused)."""
    from repro_torch.core.plan import pipeline_is_default, split_pair
    from repro_torch.core.planner import parse_variant

    base, pipe = parse_variant(candidate)
    if pipe is None and not pipeline_is_default(pipeline):
        pipe = pipeline
    fused = True if pipe is None else pipe not in (False, 0)
    n_chunks = pipe if isinstance(pipe, int) and not isinstance(pipe, bool) and pipe > 0 else None
    if sched.decomp == "pencil":
        br, bc = split_pair(base)
        out = with_backends(sched, row=br, col=bc)
    else:
        out = with_backends(sched, slab=base)
    return with_pipeline(out, fused, n_chunks)


def stage_blocks(sched: Schedule, input_shape) -> List[Tuple[object, Tuple[int, ...], Tuple[int, ...], bool, bool]]:
    """One rank's block through the stage list, for a caller's global
    input of ``input_shape``: ``(stage, shape in, shape out, complex in,
    complex out)`` per stage. The ring size of each sharded axis is its
    exchanges' ``p``; an Exchange turns (..., a, b) into (..., b/p, a*p),
    as :func:`repro_torch.core.transpose.distributed_transpose` does."""
    sizes = {st.axis: st.p for st in sched.exchanges()}
    shape = list(input_shape)
    for i, axis in enumerate(sched.in_tail):
        if axis is not None:
            shape[len(shape) - len(sched.in_tail) + i] //= sizes.get(axis, 1)
    cplx = not (sched.real and not sched.inverse)
    out = []
    for st in sched.stages:
        before, was = tuple(shape), cplx
        if isinstance(st, LocalR2C):
            shape[-1] = rfft_len(shape[-1])
            cplx = True
        elif isinstance(st, LocalC2R):
            shape[-1] = st.n_last
            cplx = False
        elif isinstance(st, HermitianPack):
            shape[-1] = st.hp
        elif isinstance(st, Trim):
            shape[-1] = st.h
        elif isinstance(st, Relayout):
            if st.op == "swap_last2":
                shape[-1], shape[-2] = shape[-2], shape[-1]
            elif st.op == "swap_outer":
                shape[-3], shape[-2] = shape[-2], shape[-3]
            elif st.op == "flatten2":
                shape = shape[:-2] + [shape[-2] * shape[-1]]
            else:  # unflatten2
                shape = shape[:-1] + list(st.dims)
        elif isinstance(st, Exchange):
            a, b = shape[-2:]
            shape[-2:] = [b // st.p, a * st.p]
            cplx = cplx or st.fft
        out.append((st, before, tuple(shape), was, cplx))
    return out


# ---------------------------------------------------------------------------
# Builders (pure: shapes + names + ring sizes in, Schedule out)
# ---------------------------------------------------------------------------


def build_schedule(
    global_shape,
    *,
    ndim: int,
    inverse: bool = False,
    real: bool = False,
    decomp: str = "slab",
    axis_name=None,
    p: int = 1,
    row_axis=None,
    col_axis=None,
    p_rows: int = 1,
    p_cols: int = 1,
    backend: str = "alltoall",
    backend_row: str = "alltoall",
    backend_col: str = "alltoall",
    fused: bool = False,
    n_chunks: Optional[int] = None,
    transpose_back: bool = False,
    pad: bool = True,
    rows: Optional[int] = None,
) -> Schedule:
    """Lower one distributed transform to its stage schedule (the
    reference's signature). ``global_shape`` is the full data-side shape
    (real-side for r2c/c2r, batch dims included); for a pencil schedule
    pass the grid axes and sizes, for slab the mesh axis and its size.
    Real and pencil problems are validated here; slab c2c divisibility
    stays with the plan layer, as in the reference."""
    shape = tuple(global_shape)
    if decomp == "pencil":
        if real:
            return _pencil_real(shape, ndim, inverse, row_axis, col_axis, p_rows, p_cols,
                                backend_row, backend_col, fused, n_chunks, transpose_back, pad)
        return _pencil_c2c(shape, ndim, inverse, row_axis, col_axis, p_rows, p_cols,
                           backend_row, backend_col, fused, n_chunks, transpose_back)
    if real:
        return _slab_real(shape, ndim, inverse, axis_name, p, backend, fused, n_chunks,
                          transpose_back, pad)
    return _slab_c2c(shape, ndim, inverse, axis_name, p, backend, fused, n_chunks,
                     transpose_back, rows)


def _global_kind(backend: str) -> Optional[str]:
    from repro_torch.core import backends

    try:
        b = backends.get(backend)
    except (KeyError, ValueError):
        return None
    return backend if b.kind == "global" else None


def _slab_c2c(shape, ndim, inverse, ax, p, backend, fused, n_chunks, tb, rows):
    gb = _global_kind(backend)
    m = float(np.prod(shape)) / p

    def ex(fft=False, fuse=False):
        return Exchange(
            axis=ax, role="slab", backend=backend, p=p, elems=m,
            fft=fft, fused=fuse, n_chunks=n_chunks,
        )

    meta = dict(
        global_shape=shape, ndim=ndim, decomp="slab", real=False,
        inverse=inverse, transpose_back=tb, global_backend=gb,
    )
    if ndim == 2:
        stages = [LocalFFT(axis=-1), ex(fft=True, fuse=fused)]
        if tb:
            stages.append(ex())
        return Schedule(
            kind="fft2", stages=tuple(stages), in_tail=(ax, None),
            out_tail=(ax, None), conj=inverse,
            scale=float(shape[-1] * shape[-2]) if inverse else None, **meta,
        )
    if ndim == 3:
        d0, d1, d2 = shape[-3:]
        stages = (
            LocalFFT(axis=-1), LocalFFT(axis=-2), Relayout("flatten2"),
            ex(fft=True, fuse=fused), ex(), Relayout("unflatten2", (d1, d2)),
        )
        return Schedule(
            kind="fft3", stages=stages, in_tail=(ax, None, None),
            out_tail=(ax, None, None), conj=inverse,
            scale=float(d0 * d1 * d2) if inverse else None, **meta,
        )
    # ndim == 1: the six-step large transform (forward only)
    if inverse:
        raise NotImplementedError("1-D large inverse: conjugate externally")
    n = shape[-1]
    r = rows or p
    if n % r or (n // r) % p or r % p:
        if gb is not None:
            # the library reference FFTs any length -- keep the reference's
            # behaviour of not imposing the six-step factorization on it
            return Schedule(kind="fft1d", stages=(), in_tail=(ax,), out_tail=(ax,), **meta)
        raise ValueError(f"N={n} must factor as rows({r}) x cols with both divisible by P={p}")
    c = n // r
    stages = (
        Relayout("unflatten2", (r // p, c)),
        ex(fft=True, fuse=fused),
        Twiddle(n=n, r=r, c=c),
        ex(),
        LocalFFT(axis=-1),
        ex(),
        Relayout("flatten2"),
    )
    return Schedule(kind="fft1d", stages=stages, in_tail=(ax,), out_tail=(ax,), **meta)


def _slab_real(shape, ndim, inverse, ax, p, backend, fused, n_chunks, tb, pad):
    gb = _global_kind(backend)
    h, hp = check_divisible(shape, ndim, p=p, axis_name=ax, real=True, pad=pad)
    he = float(np.prod(shape[:-1])) * hp / p
    n_last = shape[-1]

    def ex(fft=False, fuse=False, inv=False):
        return Exchange(
            axis=ax, role="slab", backend=backend, p=p, elems=he,
            fft=fft, inverse=inv, fused=fuse, n_chunks=n_chunks,
        )

    meta = dict(
        global_shape=shape, ndim=ndim, decomp="slab", real=True,
        inverse=inverse, transpose_back=tb, n_last=n_last, h=h, hp=hp,
        global_backend=gb,
    )
    if ndim == 2:
        if not inverse:
            stages = [LocalR2C(), HermitianPack(h, hp), ex(fft=True, fuse=fused)]
            if tb:
                stages += [ex(), Trim(h)]
            return Schedule(
                kind="rfft2", stages=tuple(stages), in_tail=(ax, None),
                out_tail=(ax, None), **meta,
            )
        if tb:
            stages = [HermitianPack(h, hp), ex(fft=True, fuse=fused, inv=True)]
        else:
            stages = [LocalFFT(axis=-1, inverse=True)]
        stages += [ex(), Trim(h), LocalC2R(n_last)]
        return Schedule(
            kind="irfft2", stages=tuple(stages), in_tail=(ax, None),
            out_tail=(ax, None), **meta,
        )
    d1 = shape[-2]
    if not inverse:
        stages = (
            LocalR2C(), HermitianPack(h, hp), LocalFFT(axis=-2),
            Relayout("flatten2"), ex(fft=True, fuse=fused), ex(),
            Relayout("unflatten2", (d1, hp)), Trim(h),
        )
        return Schedule(
            kind="rfft3", stages=stages, in_tail=(ax, None, None),
            out_tail=(ax, None, None), **meta,
        )
    stages = (
        HermitianPack(h, hp), Relayout("flatten2"),
        ex(fft=True, fuse=fused, inv=True), ex(),
        Relayout("unflatten2", (d1, hp)), LocalFFT(axis=-2, inverse=True),
        Trim(h), LocalC2R(n_last),
    )
    return Schedule(
        kind="irfft3", stages=stages, in_tail=(ax, None, None),
        out_tail=(ax, None, None), **meta,
    )


def _pencil_c2c(shape, ndim, inverse, row, col, pr, pc, br, bc, fused, n_chunks, tb):
    check_divisible(shape, ndim, p_rows=pr, p_cols=pc, row_axis=row, col_axis=col)
    m = float(np.prod(shape)) / (pr * pc)

    def exr(fft=False, fuse=False):
        return Exchange(axis=row, role="row", backend=br, p=pr, elems=m,
                        fft=fft, fused=fuse, n_chunks=n_chunks)

    def exc(fft=False, fuse=False):
        return Exchange(axis=col, role="col", backend=bc, p=pc, elems=m,
                        fft=fft, fused=fuse, n_chunks=n_chunks)

    meta = dict(
        global_shape=shape, ndim=ndim, decomp="pencil", real=False,
        inverse=inverse, transpose_back=tb,
    )
    if ndim == 3:
        d0, d1, d2 = shape[-3:]
        stages = [
            LocalFFT(axis=-1), exc(fft=True, fuse=fused),
            Relayout("swap_outer"), exr(fft=True, fuse=fused),
        ]
        if tb:
            stages += [exr(), Relayout("swap_outer"), exc()]
        in_tail = (row, col, None)
        return Schedule(
            kind="fft3", stages=tuple(stages), in_tail=in_tail,
            out_tail=in_tail if tb else (col, row, None), conj=inverse,
            scale=float(d0 * d1 * d2) if inverse else None, **meta,
        )
    if tb:
        raise ValueError(
            "pencil fft2 already returns the natural layout; "
            "transpose_back applies to slab transforms and pencil fft3 only"
        )
    r_glob, c_glob = shape[-2:]
    stages = (
        Relayout("swap_last2"), exc(fft=True, fuse=fused), exc(),
        Relayout("swap_last2"), exr(fft=True, fuse=fused), exr(),
    )
    return Schedule(
        kind="fft2", stages=stages, in_tail=(row, col), out_tail=(row, col),
        conj=inverse, scale=float(r_glob * c_glob) if inverse else None, **meta,
    )


def _pencil_real(shape, ndim, inverse, row, col, pr, pc, br, bc, fused, n_chunks, tb, pad):
    h, hp = check_divisible(
        shape, ndim, p_rows=pr, p_cols=pc, row_axis=row, col_axis=col,
        real=True, pad=pad,
    )
    shards = pr * pc
    he = float(np.prod(shape[:-1])) * hp / shards
    n_last = shape[-1]

    def exr(fft=False, fuse=False, inv=False):
        return Exchange(axis=row, role="row", backend=br, p=pr, elems=he,
                        fft=fft, inverse=inv, fused=fuse, n_chunks=n_chunks)

    def exc(fft=False, fuse=False, inv=False, payload="complex", elems=None):
        return Exchange(axis=col, role="col", backend=bc, p=pc,
                        elems=he if elems is None else elems, payload=payload,
                        fft=fft, inverse=inv, fused=fuse, n_chunks=n_chunks)

    meta = dict(
        global_shape=shape, ndim=ndim, decomp="pencil", real=True,
        inverse=inverse, transpose_back=tb, n_last=n_last, h=h, hp=hp,
    )
    if ndim == 3:
        if not inverse:
            stages = [
                LocalR2C(), HermitianPack(h, hp), exc(fft=True, fuse=fused),
                Relayout("swap_outer"), exr(fft=True, fuse=fused),
            ]
            if tb:
                stages += [exr(), Relayout("swap_outer"), exc(), Trim(h)]
            in_tail = (row, col, None)
            return Schedule(
                kind="rfft3", stages=tuple(stages), in_tail=in_tail,
                out_tail=in_tail if tb else (col, row, None), **meta,
            )
        if tb:
            stages = [
                HermitianPack(h, hp), exc(), Relayout("swap_outer"),
                exr(fft=True, fuse=fused, inv=True),
            ]
        else:
            stages = [LocalFFT(axis=-1, inverse=True)]
        stages += [
            exr(fft=True, fuse=fused, inv=True), Relayout("swap_outer"),
            exc(), Trim(h), LocalC2R(n_last),
        ]
        return Schedule(
            kind="irfft3", stages=tuple(stages),
            in_tail=(row, col, None) if tb else (col, row, None),
            out_tail=(row, col, None), **meta,
        )
    if tb:
        raise ValueError(
            "pencil rfft2 already returns the natural layout; "
            "transpose_back applies to slab transforms and pencil rfft3 only"
        )
    real_elems = float(np.prod(shape)) / shards
    if not inverse:
        stages = (
            Relayout("swap_last2"), exc(payload="real", elems=real_elems),
            LocalR2C(), HermitianPack(h, hp), exc(), Relayout("swap_last2"),
            exr(fft=True, fuse=fused), exr(),
        )
        return Schedule(
            kind="rfft2", stages=stages, in_tail=(row, col),
            out_tail=(row, col), **meta,
        )
    stages = (
        exr(fft=True, fuse=fused, inv=True), exr(), Relayout("swap_last2"),
        exc(), Trim(h), LocalC2R(n_last),
        exc(payload="real", elems=real_elems), Relayout("swap_last2"),
    )
    return Schedule(
        kind="irfft2", stages=stages, in_tail=(row, col), out_tail=(row, col), **meta
    )


# ---------------------------------------------------------------------------
# Local r2c/c2r building blocks (re-exported by repro_torch.core.real;
# they live here so the executor has no real.py import)
# ---------------------------------------------------------------------------


def local_rfft(x: torch.Tensor, impl) -> torch.Tensor:
    """r2c along the last axis. ``torch`` uses the library rfft; the
    matmul and kernel impls have no r2c codelet, so they transform the
    complexified axis (complex64, as the reference does) and keep the
    non-redundant half."""
    if impl == "torch":
        return torch.fft.rfft(x, dim=-1)
    return lf.local_fft(x, axis=-1, impl=impl)[..., : rfft_len(x.shape[-1])]


def local_irfft(x: torch.Tensor, n: int, impl) -> torch.Tensor:
    """c2r along the last axis: half spectrum (length ``n//2+1``) to a
    real length-``n`` signal, carrying the 1/n factor."""
    if impl == "torch":
        return torch.fft.irfft(x, n=n, dim=-1)
    h = x.shape[-1]
    # rebuild the redundant half (X[n-k] = conj(X[k]), k = 1..n-h) and
    # run the impl's c2c inverse; the result is real up to roundoff
    tail = torch.conj(x[..., 1 : n - h + 1]).flip(-1)
    full = torch.cat([x, tail], dim=-1)
    return lf.local_fft(full, axis=-1, inverse=True, impl=impl).real


def pad_last(v: torch.Tensor, count: int) -> torch.Tensor:
    """``v`` with ``count`` zeros appended along the last axis."""
    if count == 0:
        return v
    return torch.nn.functional.pad(v, (0, count))


# ---------------------------------------------------------------------------
# The executor (over the local blocks of a mesh)
# ---------------------------------------------------------------------------


def _relayout(v: torch.Tensor, st: Relayout) -> torch.Tensor:
    if st.op == "swap_last2":
        return v.transpose(-1, -2)
    if st.op == "swap_outer":
        return v.transpose(-3, -2)
    if st.op == "flatten2":
        return v.reshape(v.shape[:-2] + (v.shape[-2] * v.shape[-1],))
    if st.op == "unflatten2":
        a, b = st.dims
        return v.reshape(v.shape[:-1] + (a, b))
    raise ValueError(f"unknown relayout op {st.op!r}")


def _twiddle_table(n: int, k1: torch.Tensor, j2: torch.Tensor, dtype) -> torch.Tensor:
    """exp(-2*pi*i*k1*j2/n) for integer index grids, computed in float64
    and cast (the tables stay at double precision whatever the data)."""
    ang = (-2.0 * np.pi / n) * (k1.to(torch.float64) * j2.to(torch.float64))
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


def _on_rings(vs, mesh: Mesh, axis: str, fn):
    """Run ``fn(blocks, ring)`` -- an exchange over the 1-D view ``ring``
    -- on every ring of mesh axis ``axis``, writing each ring's result
    blocks back into ``vs`` in place (one ring on a 1-D mesh or a
    process; every ring of the axis, one after another, on a simulated
    grid)."""
    for ring, idx in mesh.rings(axis):
        for k, v in zip(idx, fn([vs[k] for k in idx], ring)):
            vs[k] = v
    return vs


def _twiddled_exchange(vs, tw: Twiddle, ex: Exchange, mesh: Mesh):
    """Twiddle + the exchange it rides: fused into the per-chunk compute
    on streaming backends (applied to each sub-chunk as it arrives),
    up-front to the whole block otherwise. ``mesh`` is a 1-D ring view."""
    from repro_torch.core import backends

    n, r, c, p = tw.n, tw.r, tw.c, ex.p
    device = vs[0].device
    if backends.get(ex.backend).supports_chunk_fn:

        def tw_chunk(chunk: torch.Tensor, src: int, offset: int) -> torch.Tensor:
            # chunk (..., R/p, rows): my k1 block x src's j2 rows
            # [offset, offset+rows) of its C/p block.
            me = mesh.axis_index(ex.axis)
            k1 = me * (r // p) + torch.arange(r // p, device=device)
            j2 = src * (c // p) + offset + torch.arange(chunk.shape[-1], device=device)
            return chunk * _twiddle_table(n, k1[:, None], j2[None, :], chunk.dtype)

        return tr.distributed_transpose(
            vs, mesh, ex.axis, strategy=ex.backend, chunk_fn=tw_chunk, n_chunks=ex.n_chunks
        )
    out = []
    for me, v in zip(mesh.local_ranks(), vs):
        j2 = me * (c // p) + torch.arange(c // p, device=device)
        k1 = torch.arange(r, device=device)
        out.append(v * _twiddle_table(n, j2[:, None], k1[None, :], v.dtype))
    return tr.distributed_transpose(out, mesh, ex.axis, strategy=ex.backend)


def _execute_stages(vs, stages: Tuple[object, ...], mesh: Mesh, *, impl="torch"):
    """Interpret a run of stages over the local blocks ``vs`` (a list,
    updated in place block by block so a local pass frees each input
    block as it goes). Each exchange runs over every ring of its mesh
    axis (:func:`_on_rings`)."""
    p = len(vs)
    i = 0
    while i < len(stages):
        st = stages[i]
        if isinstance(st, LocalFFT):
            for k in range(p):
                vs[k] = lf.local_fft(vs[k], axis=st.axis, inverse=st.inverse, impl=impl)
        elif isinstance(st, LocalR2C):
            for k in range(p):
                vs[k] = local_rfft(vs[k], impl)
        elif isinstance(st, LocalC2R):
            for k in range(p):
                vs[k] = local_irfft(vs[k], st.n_last, impl)
        elif isinstance(st, HermitianPack):
            for k in range(p):
                vs[k] = pad_last(vs[k], st.hp - st.h)
        elif isinstance(st, Trim):
            for k in range(p):
                vs[k] = vs[k][..., : st.h]
        elif isinstance(st, Relayout):
            for k in range(p):
                vs[k] = _relayout(vs[k], st)
        elif isinstance(st, Twiddle):
            nxt = stages[i + 1] if i + 1 < len(stages) else None
            if not isinstance(nxt, Exchange):
                raise ValueError("Twiddle must immediately precede an Exchange")
            _on_rings(vs, mesh, nxt.axis, lambda blocks, ring: _twiddled_exchange(blocks, st, nxt, ring))
            i += 2
            continue
        elif isinstance(st, Exchange):
            if st.fft:
                _on_rings(vs, mesh, st.axis, lambda blocks, ring: tr.transpose_then_fft(
                    blocks, ring, st.axis, strategy=st.backend, impl=impl,
                    fused=st.fused, n_chunks=st.n_chunks, inverse=st.inverse,
                ))
            else:
                _on_rings(vs, mesh, st.axis, lambda blocks, ring: tr.distributed_transpose(
                    blocks, ring, st.axis, strategy=st.backend, n_chunks=st.n_chunks
                ))
        else:
            raise TypeError(f"unknown stage {st!r}")
        i += 1
    return vs


def execute_schedule(vs, sched: Schedule, mesh: Mesh, *, impl="torch", faults=None):
    """Interpret a schedule over the local blocks -- the single body
    behind every distributed transform (use :func:`run_schedule` for a
    caller's array). With ``faults`` (an armed fault plan) it is the
    chaos executor: the stages run segment by segment
    (:func:`_segments`, no spans, no fences), and the fault plan is
    consulted (:func:`_consult_faults`) before every Exchange segment, so
    an injected fault surfaces as a host exception at dispatch time; the
    numerics of a run in which nothing fires are the plain executor's."""
    vs = list(vs)
    if sched.conj:
        vs = [torch.conj_physical(v) for v in vs]
    if faults is None:
        vs = _execute_stages(vs, sched.stages, mesh, impl=impl)
    else:
        for start, seg in _segments(sched):
            if isinstance(seg[-1], Exchange):  # a Twiddle rides its Exchange
                _consult_faults(faults, _stage_label(seg[-1]), start + len(seg) - 1, mesh)
            vs = _execute_stages(vs, seg, mesh, impl=impl)
    for k in range(len(vs)):
        if sched.conj:
            vs[k] = torch.conj_physical(vs[k])
        if sched.scale is not None:
            vs[k] = vs[k] / sched.scale
    return vs


def simulate_specs(sched: Schedule, ndim: int) -> Tuple[Tuple[Optional[str], ...], ...]:
    """Walk the stage list symbolically and return the full-length
    partition spec at every stage boundary: ``specs[0]`` is the input
    spec, ``specs[i + 1]`` the spec after stage ``i``. An Exchange keeps
    the same spec positions sharded (it transposes the data of the last
    two local dims); a Relayout permutes/merges/splits spec entries as
    it moves the local dims; local stages never touch sharding. The
    final spec must land on the schedule's own ``out_tail``."""
    spec = [None] * (ndim - len(sched.in_tail)) + list(sched.in_tail)
    out = [tuple(spec)]
    for st in sched.stages:
        if isinstance(st, Relayout):
            if st.op == "swap_last2":
                spec[-1], spec[-2] = spec[-2], spec[-1]
            elif st.op == "swap_outer":
                spec[-3], spec[-2] = spec[-2], spec[-3]
            elif st.op == "flatten2":
                if spec[-1] is not None:
                    raise ValueError(
                        "flatten2 with the minor axis sharded has no "
                        "block-contiguous partition spec"
                    )
                spec = spec[:-2] + [spec[-2]]
            elif st.op == "unflatten2":
                spec = spec[:-1] + [spec[-1], None]
            else:  # pragma: no cover - _relayout already rejects these
                raise ValueError(f"unknown relayout op {st.op!r}")
        elif isinstance(st, (Twiddle, Exchange)):
            ex = st if isinstance(st, Exchange) else None
            if ex is not None and ex.p > 1 and spec[-2] != ex.axis:
                raise ValueError(
                    f"exchange over mesh axis {ex.axis!r} but simulated "
                    f"spec has {spec[-2]!r} sharded at position -2"
                )
        out.append(tuple(spec))
    expected = [None] * (len(out[-1]) - len(sched.out_tail)) + list(sched.out_tail)
    if list(out[-1]) != expected:
        raise ValueError(
            f"spec simulation of {sched.kind} schedule landed on "
            f"{out[-1]} but the schedule declares out_tail={sched.out_tail}"
        )
    return tuple(out)


def _library_reference(x: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """The whole-transform reference (the 'FFTW3 reference' analogue, the
    counterpart of the reference's GSPMD ``_xla_reference``): one
    library ``torch.fft`` transform of the gathered global array, in the
    schedule's output layout."""
    k, inv, tb = sched.kind, sched.inverse, sched.transpose_back
    if k == "fft2":
        out = torch.fft.ifft2(x) if inv else torch.fft.fft2(x)
        return out if tb else out.transpose(-1, -2)
    if k == "fft3":
        f3 = torch.fft.ifftn if inv else torch.fft.fftn
        return f3(x, dim=(-3, -2, -1))
    if k == "fft1d":
        return torch.fft.fft(x)
    if k == "rfft2":
        y = torch.fft.rfft2(x)
        if tb:
            return y
        y = y.transpose(-1, -2)
        return torch.nn.functional.pad(y, (0, 0, 0, sched.hp - y.shape[-2]))
    if k == "irfft2":
        if not tb:
            x = x[..., : sched.h, :].transpose(-1, -2)
        return torch.fft.irfft2(x, s=(sched.global_shape[-2], sched.n_last))
    if k == "rfft3":
        return torch.fft.rfftn(x, dim=(-3, -2, -1))
    if k == "irfft3":
        return torch.fft.irfftn(x, s=sched.global_shape[-3:], dim=(-3, -2, -1))
    raise ValueError(f"no whole-transform reference for schedule kind {k!r}")  # pragma: no cover


def run_schedule(x: torch.Tensor, sched: Schedule, mesh: Mesh, *, impl="torch", trace=None,
                 faults=None) -> torch.Tensor:
    """Run a schedule on the caller's array -- the global array on a
    :class:`~repro_torch.core.mesh.SimMesh`, the rank's own block on a
    :class:`~repro_torch.core.mesh.ProcessGroupMesh` -- moved to the
    mesh's device: cut it into the local blocks of the schedule's input
    spec, interpret the stages, and hand back the blocks of its output
    spec the same way. ``kind="global"`` backends instead run the whole
    transform as one library call on the gathered global array.

    With ``trace`` (a :class:`repro_torch.obs.trace.TraceRecorder`) the
    stages run segment by segment, each fenced and stamped with a span
    (:func:`_run_schedule_traced`); the default ``trace=None`` path is
    the plain executor.

    With ``faults`` (an *armed* :class:`repro_torch.runtime.faults.FaultPlan`)
    the stages run segment by segment, consulting the fault plan before
    every Exchange segment (and before a ``global:`` library dispatch),
    so a matching spec raises, stalls or reports device loss at exactly
    the stage it names (the chaos executor, :func:`execute_schedule`). An
    exhausted (``active() == False``) plan runs the plain executor. On a
    ``ProcessGroupMesh`` every rank passes a fault plan or none does:
    the ranks agree on "armed" (one ``mesh.all_max``) and, at each
    consulted stage, on whether any rank's plan fired
    (:func:`_consult_faults`), so all of them take the same path and
    raise together."""
    if faults is not None and not mesh.all_max([faults.active()])[0]:
        faults = None
    if faults is not None and sched.global_backend is not None:
        _consult_faults(faults, f"global:{sched.kind}", 0, mesh)
    if trace is not None:
        return _run_schedule_traced(x, sched, mesh, impl=impl, trace=trace, faults=faults)
    if sched.global_backend is not None:
        out = _library_reference(mesh.global_input(x, sched.in_tail), sched)
        return mesh.global_output(out, sched.out_tail)
    vs = execute_schedule(mesh.local_blocks(x, sched.in_tail), sched, mesh, impl=impl, faults=faults)
    return mesh.caller_array(vs, sched.out_tail)


#: Fault codes the ranks agree on (the largest wins): none, an injected
#: error, a device loss.
_NO_FAULT, _ERROR, _DEVICE_LOSS = 0, 1, 2


def _consult_faults(faults, label: str, index: int, mesh: Mesh) -> None:
    """``faults.on_stage(label, index=index)``, agreed across the ranks
    of a ``ProcessGroupMesh``: each rank consults its own plan (events,
    counters and stalls stay on the rank whose plan fired), then one
    ``mesh.all_max([code, alive, rank])`` tells every rank whether any
    plan fired, and each raises the same type -- ``DeviceLossFault`` if
    any rank lost a device (``alive``: the largest count reported),
    else ``InjectedFault`` -- naming the (highest) rank that fired. On a
    ``SimMesh`` (one controller) the plan's own exception propagates."""
    from repro_torch.runtime.faults import DeviceLossFault, InjectedFault

    code, alive, local = _NO_FAULT, -1, None
    try:
        faults.on_stage(label, index=index)
    except DeviceLossFault as e:
        code, local = _DEVICE_LOSS, e
        alive = -1 if e.alive is None else e.alive
    except InjectedFault as e:
        code, local = _ERROR, e
    if not mesh.caller_holds_block:
        if local is not None:
            raise local
        return
    code, alive, who = (int(v) for v in mesh.all_max([code, alive, mesh.rank if code else -1]))
    if code == _DEVICE_LOSS:
        raise DeviceLossFault(
            f"injected device loss at {label} on rank {who}"
            f"{'' if alive < 0 else f' ({alive} alive)'}",
            alive=None if alive < 0 else alive,
        ) from local
    if code == _ERROR:
        raise InjectedFault(f"injected fault at {label} on rank {who}") from local


def _segments(sched: Schedule) -> Tuple[Tuple[int, Tuple[object, ...]], ...]:
    """Cut the stage list into trace segments: every stage is its own
    segment except a Twiddle, which rides its following Exchange (the
    executor fuses them; the merged span reports on the Exchange)."""
    segs = []
    stages = sched.stages
    i = 0
    while i < len(stages):
        if isinstance(stages[i], Twiddle):
            segs.append((i, stages[i : i + 2]))
            i += 2
        else:
            segs.append((i, stages[i : i + 1]))
            i += 1
    return tuple(segs)


def _itemsizes(x: torch.Tensor) -> Tuple[int, int]:
    """(real, complex) itemsizes implied by the runtime dtype."""
    item = x.dtype.itemsize
    return (item // 2, item) if x.is_complex() else (item, 2 * item)


def exchange_span_args(st: Exchange, real_itemsize: int, complex_itemsize: int) -> Dict[str, object]:
    """The attribute payload every Exchange span carries -- the same
    byte walk the cost model uses, so observed spans and
    ``schedule_comm_bytes`` can never disagree."""
    return {
        "stage": "Exchange",
        "backend": st.backend,
        "role": st.role,
        "axis": st.axis,
        "p": st.p,
        "payload": st.payload,
        "fft": st.fft,
        "inverse": st.inverse,
        "fused": st.fused,
        "n_chunks": st.n_chunks,
        "block_bytes": exchange_block_bytes(st, real_itemsize, complex_itemsize),
        "wire_bytes": exchange_wire_bytes(st, real_itemsize, complex_itemsize),
    }


def _run_schedule_traced(x: torch.Tensor, sched: Schedule, mesh: Mesh, *, impl, trace,
                         faults=None) -> torch.Tensor:
    """Trace-mode executor: the stage list run one segment at a time
    (:func:`_segments`, each a slice of the stage list over the same
    blocks), a wall-clock span around each. On the card every span ends
    in ``torch.cuda.synchronize``, so it measures its stage's work and
    not the launch queue; the fences also keep stages from overlapping,
    so the spans of a run add up to more than ``plan.execute`` takes.
    The input's conjugation and the output's conjugation / scale get
    spans of their own (``Conj(in)``, ``Epilogue(conj/scale)``), and on
    a ``SimMesh`` so does assembling the global output from the ranks'
    blocks (``Gather(out)``). On a ``ProcessGroupMesh`` each rank records
    its spans under ``pid=rank``. With ``faults`` each Exchange segment
    consults it first, outside the span (``run_schedule`` consults it
    before a ``global:`` dispatch), so an injected raise leaves no
    half-open span in the recorder."""
    r_item, c_item = _itemsizes(x)
    device = mesh.device
    pid = mesh.rank if mesh.caller_holds_block else trace.pid

    def fence() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def span(name: str, cat: str = "stage", **args):
        with trace.span(name, cat=cat, **args) as sp:
            sp.pid = pid
            yield
            fence()

    if sched.global_backend is not None:
        with span(f"global:{sched.kind}", stage="Global", backend=sched.global_backend,
                  schedule=sched.schedule_hash()):
            out = _library_reference(mesh.global_input(x, sched.in_tail), sched)
            out = mesh.global_output(out, sched.out_tail)
        return out
    vs = mesh.local_blocks(x, sched.in_tail)
    fence()
    if sched.conj:
        with span("Conj(in)", stage="Conj"):
            vs = [torch.conj_physical(v) for v in vs]
    for start, seg in _segments(sched):
        report = seg[-1]  # the Exchange of a Twiddle+Exchange pair
        if isinstance(report, Exchange):
            cat = "exchange"
            args = exchange_span_args(report, r_item, c_item)
            if len(seg) > 1:
                args["twiddle"] = True
        else:
            cat = "stage"
            args = {"stage": type(report).__name__}
        args["index"] = start + len(seg) - 1
        if faults is not None and isinstance(report, Exchange):
            _consult_faults(faults, _stage_label(report), args["index"], mesh)
        with span(_stage_label(report), cat=cat, **args):
            vs = _execute_stages(vs, seg, mesh, impl=impl)
    if sched.conj or sched.scale is not None:
        with span("Epilogue(conj/scale)", stage="Epilogue"):
            for k in range(len(vs)):
                if sched.conj:
                    vs[k] = torch.conj_physical(vs[k])
                if sched.scale is not None:
                    vs[k] = vs[k] / sched.scale
    if mesh.caller_holds_block:
        return mesh.caller_array(vs, sched.out_tail)
    with span("Gather(out)", stage="Gather"):
        out = mesh.caller_array(vs, sched.out_tail)
    return out


# ---------------------------------------------------------------------------
# Pretty-printing (Plan.describe)
# ---------------------------------------------------------------------------


def _stage_label(st) -> str:
    if isinstance(st, Exchange):
        bits = [f"{st.role}:{st.axis}", st.backend, f"p={st.p}"]
        if st.fft:
            bits.append("ifft" if st.inverse else "fft")
        if st.fused:
            bits.append("fused" + (f"@{st.n_chunks}" if st.n_chunks else ""))
        if st.payload != "complex":
            bits.append(st.payload)
        return f"Exchange({', '.join(bits)})"
    if isinstance(st, LocalFFT):
        return f"LocalFFT(axis={st.axis}{', inverse' if st.inverse else ''})"
    if isinstance(st, LocalR2C):
        return "LocalR2C()"
    if isinstance(st, LocalC2R):
        return f"LocalC2R(n={st.n_last})"
    if isinstance(st, HermitianPack):
        return f"HermitianPack(h={st.h}, hp={st.hp})"
    if isinstance(st, Trim):
        return f"Trim(h={st.h})"
    if isinstance(st, Relayout):
        d = f", dims={st.dims}" if st.dims else ""
        return f"Relayout({st.op}{d})"
    if isinstance(st, Twiddle):
        return f"Twiddle(n={st.n}, r={st.r}, c={st.c})"
    return repr(st)


def describe_schedule(sched: Schedule, *, params=None, chunk_compute_s: float = 0.0,
                      real_itemsize: int = 8, complex_itemsize: int = 8) -> str:
    """Human-readable stage dump with per-stage predicted microseconds
    and wire bytes. Local stages show '-' in the modeled columns (the
    alpha-beta model prices exchanges; local compute rides
    ``chunk_compute_s``)."""
    from repro_torch.core import comm_model as cm

    prm = params or cm.CommParams()
    head = (
        f"schedule {sched.kind} [{sched.decomp}"
        f"{', inverse' if sched.inverse else ''}"
        f"{', transpose_back' if sched.transpose_back else ''}] "
        f"shape={sched.global_shape} hash={sched.schedule_hash()}"
    )
    lines = [head]
    if sched.global_backend is not None:
        lines.append(f"  (whole-transform reference backend: {sched.global_backend})")
    lines.append(f"  {'#':>2}  {'stage':<52} {'model us':>10} {'wire bytes':>12}")
    t_total = 0.0
    b_total = 0.0
    for i, st in enumerate(sched.stages):
        if isinstance(st, Exchange):
            t = stage_seconds(st, prm, chunk_compute_s, real_itemsize, complex_itemsize)
            b = exchange_wire_bytes(st, real_itemsize, complex_itemsize)
            t_total += t
            b_total += b
            lines.append(f"  {i:>2}  {_stage_label(st):<52} {t * 1e6:>10.2f} {b:>12.0f}")
        else:
            lines.append(f"  {i:>2}  {_stage_label(st):<52} {'-':>10} {'-':>12}")
    lines.append(
        f"  total modeled exchange time {t_total * 1e6:.2f} us, "
        f"wire bytes/device {b_total:.0f}"
    )
    return "\n".join(lines)
