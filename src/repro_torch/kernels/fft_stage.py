"""Wrappers of the Hopper kernels in ``csrc/fft_stage.cu``.

This is the compute hot-spot of the matmul-formulated local FFT
(:mod:`repro_torch.core.fftmath`). One four-step stage computes

    left  mode:  out = (W @ A) * T        (column DFT + twiddle, fused)
    right mode:  out = A @ W^T            (row DFT; final stage, T = 1)

on interleaved complex64 operands (:func:`stage_left_c64`,
:func:`stage_right_c64`, the entry points ``ops.fft_last_axis`` calls;
:func:`stage_left` and :func:`stage_right` keep the reference's planar
(re, im) signatures and pack around the same kernels), and
:func:`chunk_twiddle_pack_c64` is the fused exchange's per-chunk
callback (relayout + W_P-column x twiddle multiply in one launch, into
a fresh tensor or added to an accumulator).

Each wrapper takes the plain PyTorch version (:mod:`.ref`) for tensors
on the CPU. For CUDA tensors it launches its kernel or raises: it
checks device, dtype, shape and contiguity first, and raises if the
launch reports an error. :data:`LAUNCHES` counts kernel launches per
kernel (plain-path calls are not counted), so a run can show that its
main path went through the kernels; :data:`SHAPES` splits the count by
launch shape. The kernels choose their own tiles
and take any shape; the reference's Pallas block sizes (``bm``/``bn``)
have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

Planar = Tuple[torch.Tensor, torch.Tensor]

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"stage_left": 0, "stage_right": 0, "chunk_twiddle_pack_c64": 0}
#: kernel name -> {launch shape: launches} since the last :func:`reset_launches`;
#: the shape is (B, M, K, N) for the stages, (B, rows, c, p, mode, layout) for
#: the pack: mode "fresh" or "accumulate" (``out=``), layout "cols" or "rows"
#: (the chunk's unit-stride axis)
SHAPES: Dict[str, Dict[tuple, int]] = {name: {} for name in LAUNCHES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SHAPES[name].clear()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("fft_stage")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.stage_left_c64.argtypes = [ptr] * 4 + [i64, i32, i32, i32, ptr]
    lib.stage_left_c64.restype = i32
    lib.stage_right_c64.argtypes = [ptr] * 3 + [i64, i32, i32, i32, ptr]
    lib.stage_right_c64.restype = i32
    lib.chunk_twiddle_pack_c64.argtypes = [ptr, ptr, ptr, i32, i32, i64, i32, i32, i32] + [i64] * 5 + [ptr]
    lib.chunk_twiddle_pack_c64.restype = i32
    lib.fft_stage_error_string.argtypes = [i32]
    lib.fft_stage_error_string.restype = ctypes.c_char_p
    return lib


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU operands; raises for mixed
    or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"{name}: operands on different devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _check_launchable(name: str, dtype: torch.dtype, tensors) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (call .contiguous())")
        if t.is_conj() or t.is_neg():
            raise ValueError(f"{name}: operands must not be lazy conj/neg views (resolve them first)")


def _launch(name: str, shape: Tuple[int, ...], fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = _lib().fft_stage_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES[name] += 1
    SHAPES[name][shape] = SHAPES[name].get(shape, 0) + 1


def _check_planar_shapes(name: str, pairs) -> None:
    for label, (re, im), shape in pairs:
        if tuple(re.shape) != shape or tuple(im.shape) != shape:
            raise ValueError(
                f"{name}: {label} planes must be {shape}, got {tuple(re.shape)}/{tuple(im.shape)}"
            )


def _check_shapes(name: str, pairs) -> None:
    for label, x, shape in pairs:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {label} must be {shape}, got {tuple(x.shape)}")


def _left_dims(name: str, w: torch.Tensor, a: torch.Tensor):
    if a.ndim != 3 or w.ndim != 2:
        raise ValueError(f"{name}: w must be (M, K) and a (B, K, N), got {tuple(w.shape)}, {tuple(a.shape)}")
    B, K, N = a.shape
    return B, w.shape[0], K, N


def _right_dims(name: str, a: torch.Tensor, w: torch.Tensor):
    if a.ndim != 3 or w.ndim != 2:
        raise ValueError(f"{name}: a must be (B, M, K) and w (N, K), got {tuple(a.shape)}, {tuple(w.shape)}")
    B, M, K = a.shape
    return B, M, K, w.shape[0]


def stage_left_c64(w: torch.Tensor, a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Fused (W @ A) * T over interleaved complex64 operands.

    w: (M, K);  a: (B, K, N);  t: (M, N) -> (B, M, N), contiguous.
    """
    B, M, K, N = _left_dims("stage_left", w, a)
    _check_shapes("stage_left", (("w", w, (M, K)), ("t", t, (M, N))))
    if not _on_cuda("stage_left", w, a, t):
        return ref.stage_left_c64_ref(w, a, t)
    _check_launchable("stage_left", torch.complex64, (w, a, t))
    out = torch.empty((B, M, N), dtype=torch.complex64, device=a.device)
    if out.numel():
        _launch("stage_left", (B, M, K, N), _lib().stage_left_c64, a.device,
                w.data_ptr(), a.data_ptr(), t.data_ptr(), out.data_ptr(), B, M, K, N)
    return out


def stage_right_c64(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A @ W^T over interleaved complex64 operands.

    a: (B, M, K);  w: (N, K) -> (B, M, N). On the card the result is the
    ``.mT`` view of a (B, N, M) contiguous buffer -- the order
    :func:`repro_torch.kernels.ops.fft_last_axis` flattens to -- so its
    strides differ from the plain version's; the values do not.
    """
    B, M, K, N = _right_dims("stage_right", a, w)
    _check_shapes("stage_right", (("w", w, (N, K)),))
    if not _on_cuda("stage_right", a, w):
        return ref.stage_right_c64_ref(a, w)
    _check_launchable("stage_right", torch.complex64, (a, w))
    out = torch.empty((B, N, M), dtype=torch.complex64, device=a.device)
    if out.numel():
        _launch("stage_right", (B, M, K, N), _lib().stage_right_c64, a.device,
                a.data_ptr(), w.data_ptr(), out.data_ptr(), B, M, K, N)
    return out.mT


def stage_left(w: Planar, a: Planar, t: Planar) -> Planar:
    """Fused (W @ A) * T over planar-complex operands (the reference's
    signature); on the card it packs to complex64 and launches
    :func:`stage_left_c64`.

    w: (M, K) re/im;  a: (B, K, N) re/im;  t: (M, N) re/im -> (B, M, N).
    """
    B, M, K, N = _left_dims("stage_left", w[0], a[0])
    _check_planar_shapes("stage_left", (("w", w, (M, K)), ("a", a, (B, K, N)), ("t", t, (M, N))))
    operands = (*w, *a, *t)
    if not _on_cuda("stage_left", *operands):
        return ref.stage_left_ref(w, a, t)
    _check_launchable("stage_left", torch.float32, operands)
    return ref.to_planes(stage_left_c64(torch.complex(*w), torch.complex(*a), torch.complex(*t)))


def stage_right(a: Planar, w: Planar) -> Planar:
    """A @ W^T over planar-complex operands (the reference's signature);
    on the card it packs to complex64 and launches :func:`stage_right_c64`.

    a: (B, M, K) re/im;  w: (N, K) re/im -> (B, M, N).
    """
    B, M, K, N = _right_dims("stage_right", a[0], w[0])
    _check_planar_shapes("stage_right", (("a", a, (B, M, K)), ("w", w, (N, K))))
    operands = (*a, *w)
    if not _on_cuda("stage_right", *operands):
        return ref.stage_right_ref(a, w)
    _check_launchable("stage_right", torch.float32, operands)
    return ref.to_planes(stage_right_c64(torch.complex(*a), torch.complex(*w)))


def _pack_layout(chunk: torch.Tensor) -> Tuple[str, int]:
    """("cols", row stride) for a chunk whose columns are unit-stride --
    the kernel transposes it through shared memory -- or ("rows", column
    stride) for one whose rows are (a transposed block's own chunk), read
    straight along t. Any other layout raises: the wrapper never copies."""
    rows, c = chunk.shape[-2:]
    if c == 1 or chunk.stride(-1) == 1:
        return "cols", chunk.stride(-2)
    if rows == 1 or chunk.stride(-2) == 1:
        return "rows", chunk.stride(-1)
    raise ValueError(
        f"chunk_twiddle_pack_c64: the chunk must be unit-stride along its rows or its "
        f"columns, got strides {tuple(chunk.stride())}"
    )


def _flat(name: str, x: torch.Tensor, tail: int) -> torch.Tensor:
    """``x`` with its leading axes collapsed to one (a view, never a copy)."""
    try:
        return x.view(-1, *x.shape[x.ndim - tail :])
    except RuntimeError:
        raise ValueError(
            f"chunk_twiddle_pack_c64: the {name}'s leading axes must collapse to one stride"
        ) from None


def chunk_twiddle_pack_c64(
    chunk: torch.Tensor, m: torch.Tensor, *, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Fused twiddle+pack for one arriving exchange chunk (complex64).

    ``chunk``: (..., rows, c) -- the raw received piece (rows of the
    source block x my column block); ``m``: (p, rows) -- the W_P column
    for this source times the four-step twiddle slice for these rows.
    Without ``out`` it returns a fresh (..., c, p, rows) tensor, the
    chunk's contribution to the fused DFT stage's accumulator (see
    :func:`repro_torch.core.transpose.transpose_then_fft`); with ``out``
    ((..., c, p, rows), last axis unit-stride, any other strides -- e.g.
    one sub-chunk's slot of a larger accumulator) it adds that
    contribution to ``out`` in place and returns ``out``. One launch
    either way. The chunk may be a strided view unit-stride along its
    columns (read with its row stride) or along its rows (a transposed
    block's own chunk); any other layout raises.
    """
    name = "chunk_twiddle_pack_c64"
    if chunk.dtype != torch.complex64 or m.dtype != torch.complex64:
        raise ValueError(
            f"chunk_twiddle_pack_c64 is a complex64 kernel (pairs of f32, not "
            f"planar-f32 planes); got {chunk.dtype}/{m.dtype} (c128 callers use "
            f"the plain torch path)"
        )
    lead = tuple(chunk.shape[:-2])
    rows, c = chunk.shape[-2:]
    p = m.shape[0]
    if tuple(m.shape) != (p, rows):
        raise ValueError(f"m must be (p, rows)=({p}, {rows}), got {tuple(m.shape)}")
    if out is not None:
        if tuple(out.shape) != lead + (c, p, rows):
            raise ValueError(f"out must be {lead + (c, p, rows)}, got {tuple(out.shape)}")
        if out.dtype != torch.complex64:
            raise ValueError(f"{name}: out must be complex64, got {out.dtype}")
    operands = (chunk, m) if out is None else (chunk, m, out)
    if not _on_cuda(name, *operands):
        return ref.chunk_twiddle_pack_ref(chunk, m, out=out)
    _check_launchable(name, torch.complex64, (m,))
    for label, x in (("chunk", chunk), ("out", out)):
        if x is not None and (x.is_conj() or x.is_neg()):
            raise ValueError(f"{name}: {label} must not be a lazy conj/neg view")
    layout, cs = _pack_layout(chunk)
    flat = _flat("chunk", chunk, 2)
    B = flat.shape[0]
    mode = "fresh" if out is None else "accumulate"
    if out is None:
        out = torch.empty(lead + (c, p, rows), dtype=torch.complex64, device=chunk.device)
    elif rows > 1 and out.stride(-1) != 1:
        raise ValueError(f"{name}: out's last axis must be unit-stride, got strides {tuple(out.stride())}")
    oflat = _flat("out", out, 3)
    if out.numel():
        _launch(
            name, (B, rows, c, p, mode, layout), _lib().chunk_twiddle_pack_c64, chunk.device,
            flat.data_ptr(), m.data_ptr(), oflat.data_ptr(), int(mode == "accumulate"),
            int(layout == "rows"), B, rows, c, p, flat.stride(0), cs,
            oflat.stride(0), oflat.stride(1), oflat.stride(2),
        )
    return out
