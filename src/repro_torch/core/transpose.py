"""Distributed transpose strategies -- the paper's experimental axis,
PyTorch port of ``repro.core.transpose``.

The FFT slab exchange moves chunk *i* of every rank's local block to
rank *i* (each rank keeps 1/P and ships (1-1/P) of its data). The paper
realizes this with either one synchronized ``all-to-all`` or with N
``scatter`` collectives that let arriving chunks be transposed while the
rest of the communication is still in flight:

``alltoall``
    One fused all-to-all -- the paper's synchronized baseline.
``scatter``
    P-1 direct sends (a ring walk over distances 1..P-1), each arriving
    chunk processed by the per-chunk callback -- the paper's N-scatter.
``bisection``
    Bruck / hypercube exchange: ceil(log2 P) rounds of half-the-buffer
    messages. Beyond-paper.
``pairwise_xor``
    P-1 symmetric swap rounds with partner (me XOR s). Beyond-paper.

The per-rank code is the reference's, run over the local blocks of a
mesh (:mod:`repro_torch.core.mesh`): every function takes and returns a
list with one block per rank this process runs (all ``p`` on a
:class:`~repro_torch.core.mesh.SimMesh`, the own one on a
:class:`~repro_torch.core.mesh.ProcessGroupMesh`), and ``me`` is a
plain ``int`` from ``mesh.local_ranks()``. The local block is
``(..., r, C)`` with the global rows ``R = P*r`` sharded; the
transposed result is ``(..., c, R)`` with the global columns ``C = P*c``
sharded.

**Pipelining (``n_chunks``).** The streaming exchanges decouple the chunk
count from P: each peer block can be sub-chunked into ``q`` pieces so the
exchange ships ``(P-1)*q`` smaller messages.

**Overlap.** XLA overlapped the reference's sends with the per-chunk
compute through async collective-permute. Here it is written out: the
streaming exchanges post every message (send and receive) before the
first chunk callback runs, then run the callbacks on the own chunk and
on each message as it completes. On a ``ProcessGroupMesh`` the later
messages travel meanwhile (on the card, on NCCL's stream); the
simulated mesh copies each message when it is waited on, so there it
stays sequential.

**Compute fusion.** :func:`transpose_then_fft` folds the *next FFT
pass* into the exchange on streaming backends: the length-R DFT after a
transpose decomposes over source ranks (decimation in time, j = src*r +
j2), so each arriving chunk contributes a rank-1 outer product with one
DFT-matrix column. Monolithic backends fall back to transpose + local
FFT.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional

import torch

from repro_torch.core.mesh import Mesh

Blocks = List[torch.Tensor]

#: A registered backend name (see ``repro_torch.core.backends.available()``).
Strategy = str

#: chunk_fn(chunk, src) -> processed chunk. ``chunk`` is the (..., r, c)
#: block received from rank ``src``, already transposed to (..., c, r).
#: A chunk_fn may instead take (chunk, src, offset): under sub-chunked
#: pipelining it then receives each (..., c, r/q) piece as it arrives,
#: with ``offset`` the starting index within the source block's r rows.
#: Two-argument chunk_fns are only ever handed whole peer blocks.
#:
#: The streaming reduce (:func:`_chunked_reduce`) also takes a chunk_fn
#: with a keyword-only ``out`` parameter, ``(chunk, src, offset, *,
#: out=None)`` -- the signal is that parameter in its signature (found
#: by :func:`inspect.signature`; ``**kwargs`` does not count). Such a
#: chunk_fn returns a fresh result when ``out`` is None and otherwise
#: ADDS its result into ``out`` (a slot of the accumulator) in place.
ChunkFn = Callable[..., torch.Tensor]


def _split_chunks(x: torch.Tensor, p: int) -> torch.Tensor:
    """(..., r, C) -> (p, ..., r, c): chunk j holds columns [j*c, (j+1)*c)."""
    *lead, r, C = x.shape
    c = C // p
    x = x.reshape(*lead, r, p, c)
    return torch.movedim(x, -2, 0)


def _merge_rows(chunks: torch.Tensor) -> torch.Tensor:
    """(p, ..., r, c) -> (..., p*r, c): stack chunk j as rows [j*r, (j+1)*r)."""
    p = chunks.shape[0]
    chunks = torch.movedim(chunks, 0, -3)  # (..., p, r, c)
    *lead, _, r, c = chunks.shape
    return chunks.reshape(*lead, p * r, c)


def _transpose_local(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Pipelining helpers
# ---------------------------------------------------------------------------


def subchunks_per_peer(r: int, p: int, n_chunks: Optional[int]) -> int:
    """Sub-chunks q per peer block for an ``n_chunks`` total-chunk target:
    the largest divisor of ``r`` (the peer block's row count) not above
    ceil(n_chunks / p). ``None`` or ``n_chunks <= p`` keeps the classic
    one-chunk-per-peer schedule. Shared by the exchanges and the cost
    model (:func:`repro_torch.core.comm_model.effective_chunks`)."""
    if not n_chunks or n_chunks <= p:
        return 1
    q = min(max(1, -(-int(n_chunks) // p)), r)
    while r % q:
        q -= 1
    return q


def _chunk_fn_arity(fn: ChunkFn) -> int:
    """2 when ``fn`` takes (chunk, src), 3 when it also takes the
    sub-chunk row offset (see :data:`ChunkFn`)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # builtins / exotic callables
        return 2
    n = 0
    for prm in sig.parameters.values():
        if prm.kind == inspect.Parameter.VAR_POSITIONAL:
            return 3
        if prm.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        ):
            n += 1
    return 3 if n >= 3 else 2


def _chunk_fn_accumulates(fn: ChunkFn) -> bool:
    """Whether ``fn`` takes a keyword-only ``out`` to accumulate into
    (see :data:`ChunkFn`)."""
    try:
        prm = inspect.signature(fn).parameters.get("out")
    except (TypeError, ValueError):  # builtins / exotic callables
        return False
    return prm is not None and prm.kind == inspect.Parameter.KEYWORD_ONLY


def _call_chunk_fn(fn: ChunkFn, arity: int, chunk, src, offset: int):
    if arity >= 3:
        return fn(chunk, src, offset)
    return fn(chunk, src)


# ---------------------------------------------------------------------------
# Strategy: fused all-to-all (the paper's synchronized collective)
# ---------------------------------------------------------------------------


def _alltoall(xs: Blocks, mesh: Mesh, axis_name: str) -> Blocks:
    # (..., r, C) --split cols/concat rows--> (..., R, c) --local T--> (..., c, R)
    nd = xs[0].ndim
    ys = mesh.all_to_all(xs, split_axis=nd - 1, concat_axis=nd - 2)
    return [_transpose_local(y) for y in ys]


# ---------------------------------------------------------------------------
# Strategy: N-scatter ring (the paper's proposed decomposition)
# ---------------------------------------------------------------------------


def _post_rounds(chunks: List[torch.Tensor], mesh: Mesh, schedule, p: int, q: int, rq: int) -> list:
    """Post every peer round's ``q`` sub-chunk messages at once, before
    any chunk callback runs, and return ``(sources, t, pending)`` per
    message in round order: ``sources[i]`` is the rank local rank ``i``
    receives from. ``schedule(me, s, p)`` gives round s's ppermute
    ``perm`` (the same on every rank), the chunk slot ``me`` ships and
    the rank it receives from. Every send is a slice of the input, never
    a chunk callback's result (the reference's double-buffer dataflow)."""
    posted = []
    for s in range(1, p):
        steps = [schedule(me, s, p) for me in mesh.local_ranks()]
        for t in range(q):
            pieces = [chunks[i][st[1]][..., t * rq : (t + 1) * rq, :] for i, st in enumerate(steps)]
            posted.append(([st[2] for st in steps], t, mesh.ppermute_start(pieces, steps[0][0])))
    return posted


def _chunked_exchange(
    xs: Blocks,
    mesh: Mesh,
    axis_name: str,
    chunk_fn: Optional[ChunkFn],
    schedule,
    n_chunks: Optional[int] = None,
) -> Blocks:
    """Shared chunk-streaming exchange: P-1 peer rounds, each shipped as
    ``q`` sub-chunk messages (``q`` from :func:`subchunks_per_peer`),
    all posted up front (:func:`_post_rounds`).

    Each received piece is transposed (and optionally further processed
    by ``chunk_fn``) as it arrives -- 'the arriving data chunks can be
    transposed as soon as they are received' (paper, §3) -- while the
    later messages are still in flight; the own chunk is processed
    first, with no communication."""
    p = mesh.axis_size(axis_name)
    ranks = mesh.local_ranks()
    x0 = xs[0]
    r, c = x0.shape[-2], x0.shape[-1] // p
    chunks = [_split_chunks(x, p) for x in xs]  # per local rank (p, ..., r, c)
    q = subchunks_per_peer(r, p, n_chunks)
    rq = r // q
    arity = _chunk_fn_arity(chunk_fn) if chunk_fn is not None else 3
    per_sub = chunk_fn is None or arity >= 3
    posted = _post_rounds(chunks, mesh, schedule, p, q, rq)

    def process(me: int, piece: torch.Tensor, src: int, offset: int) -> torch.Tensor:
        out = _transpose_local(piece)  # (..., c, rows)
        if chunk_fn is not None:
            with mesh.running(me):
                out = _call_chunk_fn(chunk_fn, arity, out, src, offset)
        return out

    # parts[i]: (src, col_offset, processed (..., c, rows)) in arrival order
    parts: List[list] = [[] for _ in ranks]
    arrivals = [(list(ranks), t, None) for t in range(q)]  # the own chunk: no message
    arrivals += posted
    got: List[list] = [[] for _ in ranks]
    for srcs, t, pending in arrivals:
        if pending is None:
            pieces = [chunks[i][me][..., t * rq : (t + 1) * rq, :] for i, me in enumerate(ranks)]
        else:
            pieces = pending.wait()
        for i, me in enumerate(ranks):
            if per_sub:
                parts[i].append((srcs[i], t * rq, process(me, pieces[i], srcs[i], t * rq)))
                continue
            # 2-arg chunk_fn: stream the transport, process the whole
            # reassembled peer block (position-blind fusions only)
            got[i].append(_transpose_local(pieces[i]))
            if t == q - 1:
                whole = got[i][0] if q == 1 else torch.cat(got[i], dim=-1)
                got[i] = []
                with mesh.running(me):
                    parts[i].append((srcs[i], 0, chunk_fn(whole, srcs[i])))

    # Assemble (..., c, R): the piece from src j at row offset o supplies
    # columns [j*r + o, j*r + o + rows).
    out_blocks = []
    for i in range(len(ranks)):
        first = parts[i][0][2]
        out = torch.zeros(x0.shape[:-2] + (c, p * r), dtype=first.dtype, device=first.device)
        for src, off, part in parts[i]:
            out[..., src * r + off : src * r + off + part.shape[-1]] = part
        out_blocks.append(out)
    return out_blocks


def _chunked_reduce(
    xs: Blocks,
    mesh: Mesh,
    axis_name: str,
    chunk_fn: ChunkFn,
    schedule,
    n_chunks: Optional[int] = None,
) -> Blocks:
    """Streaming exchange-and-accumulate: like :func:`_chunked_exchange`
    (every message posted up front, the own chunk first, each callback
    as its message arrives) but the per-source results are *summed*, not
    concatenated -- the shape the fused DFT stage needs (each arriving
    chunk contributes to every output frequency of the cross-rank
    dimension).

    ``chunk_fn(chunk, src, offset)`` receives the RAW (untransposed)
    received piece (..., rows, c) -- rows ``[offset, offset + rows)`` of
    source ``src``'s block -- and returns a fresh tensor whose LAST axis
    is that source-row axis. Results sum over sources at equal offsets
    and concatenate along the last axis across offsets.

    A chunk_fn with a keyword-only ``out`` (see :data:`ChunkFn`) is
    handed the own chunk whole (offset 0, no message, so nothing to
    pipeline): its fresh (..., r) result is the accumulator, and each
    arriving sub-chunk is added into its column slot
    ``acc[..., offset : offset + rows]`` through ``out=`` -- no
    per-arrival temporary, no zero fill, no concatenation. Any other
    chunk_fn gets every piece, the own chunk's too, and its fresh results
    are summed in place (one accumulator per sub-chunk, concatenated at
    the end). The sum's order is the same either way: the own chunk's
    term, then each arrival's in posting order."""
    p = mesh.axis_size(axis_name)
    ranks = mesh.local_ranks()
    r = xs[0].shape[-2]
    chunks = [_split_chunks(x, p) for x in xs]
    q = subchunks_per_peer(r, p, n_chunks)
    rq = r // q
    posted = _post_rounds(chunks, mesh, schedule, p, q, rq)

    def call(me: int, piece: torch.Tensor, src: int, offset: int, **kw) -> torch.Tensor:
        with mesh.running(me):
            return chunk_fn(piece, src, offset, **kw)

    if _chunk_fn_accumulates(chunk_fn):
        accs = [call(me, chunks[i][me], me, 0) for i, me in enumerate(ranks)]
        for srcs, t, pending in posted:
            recv = pending.wait()
            for i, me in enumerate(ranks):
                call(me, recv[i], srcs[i], t * rq, out=accs[i][..., t * rq : (t + 1) * rq])
        return accs

    parts = [
        [call(me, chunks[i][me][..., t * rq : (t + 1) * rq, :], me, t * rq) for t in range(q)]
        for i, me in enumerate(ranks)
    ]
    for srcs, t, pending in posted:
        recv = pending.wait()
        for i, me in enumerate(ranks):
            parts[i][t].add_(call(me, recv[i], srcs[i], t * rq))
    return [pt[0] if q == 1 else torch.cat(pt, dim=-1) for pt in parts]


def _ring_schedule(me: int, s: int, p: int):
    # round s: ship the chunk destined to me+s; receive from me-s
    return [(i, (i + s) % p) for i in range(p)], (me + s) % p, (me - s) % p


def _swap_schedule(me: int, s: int, p: int):
    # round s: both ship to and receive from the same partner me^s
    return [(i, i ^ s) for i in range(p)], me ^ s, me ^ s


def _scatter(
    xs: Blocks,
    mesh: Mesh,
    axis_name: str,
    chunk_fn: Optional[ChunkFn] = None,
    n_chunks: Optional[int] = None,
) -> Blocks:
    """P-1 direct sends, a one-directional ring walk over distances
    1..P-1 -- the paper's N-scatter decomposition."""
    return _chunked_exchange(xs, mesh, axis_name, chunk_fn, _ring_schedule, n_chunks)


# ---------------------------------------------------------------------------
# Strategy: Bruck / bisection exchange (beyond-paper)
# ---------------------------------------------------------------------------


def _bisection(xs: Blocks, mesh: Mesh, axis_name: str) -> Blocks:
    """Bruck all-to-all: ceil(log2 P) rounds, each shipping the slots whose
    round-bit is set. Message count log P (vs P-1), bytes P/2 slots per
    round (vs 1 slot per step).

    Slot invariant: after the initial rotation, slot j at rank i holds the
    chunk destined to (i + j) mod P; slot j travels a total distance j by
    moving +2^t on each set bit t; the final flip+rotation orders the
    received chunks by source rank.
    """
    p = mesh.axis_size(axis_name)
    # Phase 1: rotate so slot j holds destination (me + j) mod p.
    ranks = mesh.local_ranks()
    bufs = [torch.roll(_split_chunks(x, p), -me, dims=0) for me, x in zip(ranks, xs)]

    # Phase 2: log rounds of exchange with rank (me + 2^t), shipping the
    # slots {j : bit t of j set} (half the buffer), the same on every rank.
    t = 0
    while (1 << t) < p:
        step = 1 << t
        idx = [j for j in range(p) if (j >> t) & 1]
        perm = [(i, (i + step) % p) for i in range(p)]
        recv = mesh.ppermute([b[idx] for b in bufs], perm)
        for i in range(len(ranks)):
            bufs[i][idx] = recv[i]
        t += 1

    # Phase 3: slot j now holds the chunk from source (me - j) mod p.
    out = []
    for me, buf in zip(ranks, bufs):
        by_src = torch.flip(torch.roll(buf, -(me + 1), dims=0), dims=(0,))
        out.append(_transpose_local(_merge_rows(by_src)))  # (..., c, R)
    return out


# ---------------------------------------------------------------------------
# Strategy: pairwise XOR exchange (beyond-paper)
# ---------------------------------------------------------------------------


def _pairwise_xor(
    xs: Blocks,
    mesh: Mesh,
    axis_name: str,
    chunk_fn: Optional[ChunkFn] = None,
    n_chunks: Optional[int] = None,
) -> Blocks:
    """Pairwise exchange: round s swaps one chunk with partner (me XOR s).
    XOR with a fixed s is an involution, so every round is a symmetric
    swap. Requires power-of-two P."""
    return _chunked_exchange(xs, mesh, axis_name, chunk_fn, _swap_schedule, n_chunks)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _check_columns(xs: Blocks, p: int, axis_name: str) -> None:
    if xs[0].shape[-1] % p:
        raise ValueError(
            f"column count {xs[0].shape[-1]} not divisible by the {p} shards of "
            f"mesh axis {axis_name!r} (plan-level shapes are validated by "
            f"plan_fft; direct callers must pre-chunk)"
        )


def distributed_transpose(
    xs: Blocks,
    mesh: Mesh,
    axis_name: str,
    *,
    strategy: str = "alltoall",
    chunk_fn: Optional[ChunkFn] = None,
    n_chunks: Optional[int] = None,
) -> Blocks:
    """Transpose a (..., R, C) array whose R axis is sharded over
    ``axis_name`` into a (..., C, R) array with C sharded: per-rank
    blocks (..., r, C) in, (..., c, R) out.

    ``strategy`` names a registered :mod:`repro_torch.core.backends`
    backend; ``chunk_fn`` is only honoured by chunk-streaming backends
    (``backend.supports_chunk_fn``). ``n_chunks`` (streaming backends, a
    hint elsewhere ignored) ships each peer block as ~``n_chunks/P``
    sub-messages.
    """
    from repro_torch.core import backends  # late import: backends registers over us

    backend = backends.get(strategy)
    if backend.kind != "shard_map":
        raise ValueError(
            f"backend {strategy!r} is a whole-transform backend with no "
            f"shard_map transpose; use it through fft2/fft3/plan_fft"
        )
    p = mesh.axis_size(axis_name)
    _check_columns(xs, p, axis_name)
    if chunk_fn is not None and not backend.supports_chunk_fn:
        raise ValueError(
            f"chunk_fn requires a chunk-streaming backend "
            f"(got {strategy!r}; streaming: "
            f"{[b for b in backends.available() if backends.get(b).supports_chunk_fn]})"
        )
    if p == 1:
        y = _transpose_local(xs[0])
        if chunk_fn is not None:
            with mesh.running(0):
                y = _call_chunk_fn(chunk_fn, _chunk_fn_arity(chunk_fn), y, 0, 0)
        return [y]
    if not backend.supports(p):
        raise ValueError(f"backend {strategy!r} does not support P={p}")
    return backend.transpose(xs, mesh, axis_name, chunk_fn, n_chunks=n_chunks)


def transpose_then_fft(
    xs: Blocks,
    mesh: Mesh,
    axis_name: str,
    *,
    strategy: str,
    impl: str = "torch",
    fused: bool = False,
    n_chunks: Optional[int] = None,
    inverse: bool = False,
) -> Blocks:
    """The pipelined overlap executor's unit step: transpose
    (..., r, C) -> (..., c, R) and FFT the result along its last (R)
    axis -- with the cross-rank stage of that FFT folded into the
    arriving chunks when ``fused`` and the backend streams.

    Decimation in time over source ranks (global row j = src*r + j2,
    output frequency k = k1 + P*k2):

        F[k1 + P*k2] = DFT_r over j2 [ T[k1, j2] * sum_src W_P[k1, src] * chunk_src[j2] ]

    The inner sum streams through :func:`_chunked_reduce`: each arriving
    chunk's contribution is a rank-1 outer product with one W_P column
    (times the elementwise twiddle) -- with ``impl="kernel"`` and
    complex64 data, one :func:`chunk_twiddle_pack_c64` launch per chunk:
    the own chunk's writes the accumulator, each arrival's adds into it.
    After the exchange only a *local* length-r FFT and the k-order
    relayout remain. The same identity conjugated gives the inverse
    transform (tables conjugate; the trailing local FFT carries 1/r and
    the stage adds the remaining 1/P).

    Unfused (or monolithic-backend, or P=1) calls lower to the plain
    transpose followed by a whole-axis local FFT.
    """
    import repro_torch.core.fftmath as lf
    from repro_torch.core import backends  # late import: backends registers over us

    backend = backends.get(strategy)
    p = mesh.axis_size(axis_name)
    if not (fused and backend.supports_chunk_fn and p > 1):
        ys = distributed_transpose(xs, mesh, axis_name, strategy=strategy, n_chunks=n_chunks)
        for i in range(len(ys)):
            ys[i] = lf.local_fft(ys[i], axis=-1, inverse=inverse, impl=impl)
        return ys
    # same guards the plain transpose enforces -- the fused path must not
    # trade its friendly errors for a reshape blow-up in _split_chunks
    _check_columns(xs, p, axis_name)
    if not backend.supports(p):
        raise ValueError(f"backend {strategy!r} does not support P={p}")

    r = xs[0].shape[-2]
    cdtype = torch.promote_types(xs[0].dtype, torch.complex64)
    device = xs[0].device
    w_p = lf.dft_matrix(p, cdtype, device)  # (k1, src)
    tw = lf.twiddle(p, r, cdtype, device)  # (k1, j2)
    if inverse:
        w_p, tw = w_p.conj(), tw.conj()

    use_kernel = impl == "kernel" and cdtype == torch.complex64

    def chunk_fn(chunk: torch.Tensor, src: int, offset: int, *, out=None) -> torch.Tensor:
        # chunk (..., rows, c) = rows [offset, offset+rows) of src's block;
        # the result (..., c, k1=p, j2=rows) is fresh, or added into out.
        rows = chunk.shape[-2]
        m = w_p[:, src, None] * tw[:, offset : offset + rows]  # (k1, j2) for this piece
        if use_kernel:
            from repro_torch.kernels import fft_stage

            # one launch, fresh or accumulating; the kernel takes the
            # chunk unit-stride along either axis (the own chunk of the
            # pencil fft2's swap_last2-transposed block: along its rows)
            return fft_stage.chunk_twiddle_pack_c64(chunk, m, out=out)
        from repro_torch.kernels import ref

        return ref.chunk_twiddle_pack_ref(chunk, m, out=out)

    acc = backend.stream_reduce([x.to(cdtype) for x in xs], mesh, axis_name, chunk_fn, n_chunks=n_chunks)
    for i in range(len(acc)):
        a = lf.local_fft(acc[i], axis=-1, inverse=inverse, impl=impl)  # j2 -> k2 (1/r if inverse)
        # F index k = k1 + P*k2 -> order (k2 major, k1 minor).
        out = _transpose_local(a)  # (..., c, k2=r, k1=p)
        out = out.reshape(out.shape[:-2] + (p * r,))
        acc[i] = out / p if inverse else out  # completes the 1/(p*r) = 1/R factor
    return acc
