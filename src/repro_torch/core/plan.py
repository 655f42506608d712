"""FFTW-style plan/executor front-end over the collective-backend
registry, PyTorch port of the slab c2c part of ``repro.core.plan``:

    mesh = SimMesh(4)                      # device=None: the card
    plan = plan_fft((n, n), mesh, backend="scatter", local_impl="kernel")
    y = plan.execute(x)                    # fft2(x).mT, C sharded
    x2 = plan.inverse(y)
    rplan = plan_fft((n, n), mesh, real=True)  # r2c: rfft2(x).mT, Hp rows

A :class:`Plan` validates the (global shape, mesh, shard axis, backend)
combination once, at construction -- shard-divisibility included, so a
bad shape fails here naming the offending data axis; resolves
``backend="auto"`` to the alpha-beta cost-model argmin over every
registered backend supporting the shard count; resolves ``pipeline=``;
and lowers each direction once to its stage schedule, which execution,
:meth:`Plan.predict` and :meth:`Plan.comm_bytes` all walk.

The mesh is a :class:`~repro_torch.core.mesh.SimMesh` (``execute``
takes and returns global arrays) or a
:class:`~repro_torch.core.mesh.ProcessGroupMesh` (each rank passes and
gets back its own block).

Ported so far: ``decomp="slab"`` c2c transforms (ndim 1, 2, 3) and r2c
/ c2r transforms (``real=True``, ndim 2, 3) under
``planner="estimate"``. The rest of the reference's surface raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

import repro_torch.core.schedule as sch
from repro_torch.core import backends
from repro_torch.core import comm_model as cm
from repro_torch.core.mesh import Mesh, fft_axis

_DTYPE_PARTNERS = {
    torch.float32: torch.complex64, torch.complex64: torch.float32,
    torch.float64: torch.complex128, torch.complex128: torch.float64,
}


def real_complex_pair(dtype) -> Tuple[torch.dtype, torch.dtype]:
    """The (real, complex) dtype pair containing ``dtype`` -- the single
    copy of the r2c dtype mapping (plan validation and byte accounting
    must agree on it). Raises for dtypes with no real/complex partner."""
    partner = _DTYPE_PARTNERS.get(dtype)
    if partner is None:
        raise ValueError(
            f"no real/complex dtype pair for {str(dtype).replace('torch.', '')}; real plans "
            f"support ['float32', 'float64']"
        )
    return (partner, dtype) if dtype.is_complex else (dtype, partner)


class SpectralAxis(NamedTuple):
    """One output axis of a plan's frequency-domain (spectrum) layout.

    ``orig`` is the original data axis it carries (negative index into
    the trailing transform dims), ``n`` that axis's real/complex global
    length, ``n_out`` the length in the spectrum layout (``rfft_len(n)``
    or its shard-padded version for the Hermitian axis of a real plan,
    ``n`` otherwise), and ``half`` whether the axis is
    Hermitian-truncated. The apps build wavenumber grids from this --
    see :func:`repro_torch.apps.spectral.wavenumbers`."""

    orig: int
    n: int
    n_out: int
    half: bool


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class Plan:
    """A validated, backend-resolved FFT plan over a mesh
    (:mod:`repro_torch.core.mesh`).

    Construct through :func:`plan_fft`. ``direction`` fixes what
    ``execute`` computes ("forward" or "inverse"); ``inverse`` always
    computes the opposite. The 1-D large transform has no inverse.
    """

    def __init__(
        self,
        global_shape: Tuple[int, ...],
        mesh: Mesh,
        *,
        ndim: int = 2,
        direction: str = "forward",
        backend: str = "auto",
        axis_name: Optional[str] = None,
        local_impl: str = "torch",
        transpose_back: bool = False,
        dtype=torch.complex64,
        params: Optional[cm.CommParams] = None,
        chunk_compute_s: float = 0.0,
        decomp: str = "slab",
        real: bool = False,
        pad: bool = True,
        pipeline="auto",
    ):
        if ndim not in (1, 2, 3):
            raise ValueError("ndim must be 1, 2 or 3")
        if direction not in ("forward", "inverse"):
            raise ValueError(f"direction must be 'forward' or 'inverse', got {direction!r}")
        if decomp not in ("slab", "pencil", "auto"):
            raise ValueError(f"decomp must be 'slab', 'pencil' or 'auto', got {decomp!r}")
        if decomp != "slab":
            raise _not_ported(f"decomp={decomp!r}", "A8 (core/grid.py + core/pencil.py)")
        if real and ndim == 1:
            raise NotImplementedError(
                "1-D real transform is not implemented: complexify and use ndim=1 c2c"
            )
        if not (
            pipeline in ("auto", True, False, None)
            or (isinstance(pipeline, int) and not isinstance(pipeline, bool) and pipeline >= 0)
        ):
            raise ValueError(
                f"pipeline must be 'auto', True/False, or a chunk-count int "
                f">= 0, got {pipeline!r}"
            )
        if ndim == 1 and direction == "inverse":
            # fail at plan time, not first execute (validate-once contract)
            raise NotImplementedError(
                "1-D large inverse is not implemented: plan forward and conjugate externally"
            )
        self.global_shape = tuple(global_shape)
        self.mesh = mesh
        self.axis_name = axis_name or fft_axis(mesh)
        self.ndim = ndim
        self.direction = direction
        self.real = bool(real)
        self.pad = bool(pad)
        self.dtype = dtype
        if self.real:
            # a real plan's dtype is the REAL input dtype; the matching
            # complex dtype (the spectrum side) is derived. Passing the
            # complex default through plan_fft maps to its real partner.
            try:
                self.dtype, self.cdtype = real_complex_pair(dtype)
            except ValueError:
                raise ValueError(
                    f"real plans take a real input dtype (float32/float64), "
                    f"got {str(dtype).replace('torch.', '')}"
                ) from None
        else:
            self.cdtype = dtype
        self.hermitian_len: Optional[int] = None
        self.padded_hermitian_len: Optional[int] = None
        self.local_impl = local_impl
        self.transpose_back = transpose_back
        self.params = params or cm.CommParams()
        self.chunk_compute_s = chunk_compute_s
        self.pipeline = "auto" if (pipeline is True or pipeline is None) else pipeline
        #: resolved by _resolve_pipeline once the backend is known
        self.fused: bool = False
        self.n_chunks: Optional[int] = None
        #: direction -> lowered stage schedule (the single pipeline truth)
        self._schedules: Dict[bool, sch.Schedule] = {}
        self.decomp = "slab"
        self._init_slab(backend)

    # -- pipelined overlap resolution -------------------------------------------
    def _pipeline_enabled(self) -> bool:
        """Whether ``pipeline=`` allows fusing at all (off only for False/0)."""
        return self.pipeline not in (False, 0)

    def _pipeline_n_chunks(self) -> Optional[int]:
        if isinstance(self.pipeline, int) and not isinstance(self.pipeline, bool):
            return int(self.pipeline) if self.pipeline > 0 else None
        return None

    def _resolve_pipeline(self) -> None:
        """Fused execution wherever a chunk-streaming backend rides a
        >1-shard ring (unless ``pipeline=False``)."""
        self.n_chunks = self._pipeline_n_chunks()
        if not self._pipeline_enabled():
            self.fused = False
            return
        b = self.backend_obj
        self.fused = bool(b.kind == "shard_map" and b.supports_chunk_fn and self.shards > 1)

    def _auto_chunk_compute_s(self, dtype=None) -> float:
        """Per-peer-chunk seconds of the fused stage's compute: the
        caller's ``chunk_compute_s`` when given, else a memory-bound
        napkin -- each arriving chunk's outer-product contribution
        writes one local block's worth of accumulator (``_cost_bytes /
        HBM_BW``, the H100's data-sheet rate). Zero on a one-shard ring."""
        if self.chunk_compute_s:
            return self.chunk_compute_s
        if self.shards <= 1:
            return 0.0
        return self._cost_bytes(dtype) / cm.HBM_BW

    def _init_slab(self, backend: str) -> None:
        self._schedules.clear()
        p = self.shards
        if self.real:
            self.hermitian_len, self.padded_hermitian_len = sch.check_divisible(
                self.global_shape, self.ndim, p=p, axis_name=self.axis_name, real=True, pad=self.pad
            )
        else:
            sch.check_divisible(self.global_shape, self.ndim, p=p, axis_name=self.axis_name)
        if not isinstance(backend, str) or "+" in backend:
            raise ValueError(
                f"slab plans take one backend name, got {backend!r} "
                f"(per-axis pairs are decomp='pencil')"
            )
        if "@" in backend:
            raise _not_ported(f"measured-planner variant id {backend!r}", "A9 (core/planner.py)")
        if backend == "auto":
            backend = backends.cheapest(
                self._cost_bytes(), p, self.params,
                chunk_compute_s=self._auto_chunk_compute_s(),
                n_chunks=self._pipeline_n_chunks(),
                fused=self._pipeline_enabled(),
            )
        self.backend_obj = backends.get(backend)  # raises listing the registry
        self.backend = backend
        if not self.backend_obj.supports(p):
            raise ValueError(f"backend {backend!r} does not support P={p}")
        self._resolve_pipeline()

    # -- geometry --------------------------------------------------------------
    @property
    def shards(self) -> int:
        return self.mesh.shape[self.axis_name]

    def local_bytes(self, dtype=None) -> float:
        """Bytes of one device's local block of the input (the real
        block, for a real plan)."""
        itemsize = self._dtype_pair(dtype)[0].itemsize if self.real else (dtype or self.dtype).itemsize
        return float(np.prod(self.global_shape)) * itemsize / self.shards

    def _dtype_pair(self, dtype=None) -> Tuple[torch.dtype, torch.dtype]:
        """(real, complex) dtype pair for a byte query: either side of
        the pair may be passed; None means the plan's own."""
        if dtype is None:
            return self.dtype, self.cdtype
        return real_complex_pair(dtype)

    def _cost_bytes(self, dtype=None) -> float:
        """Per-device block bytes the exchanges actually move -- the
        input block for c2c plans, the Hermitian-truncated (shard-padded)
        complex block for real plans. This is what the alpha-beta costs
        and ``backend='auto'`` price."""
        if not self.real:
            return self.local_bytes(dtype)
        citem = self._dtype_pair(dtype)[1].itemsize
        elems = float(np.prod(self.global_shape[:-1])) * self.padded_hermitian_len
        return elems * citem / self.shards

    def _byte_sizes(self, dtype=None) -> Tuple[int, int]:
        """(real_itemsize, complex_itemsize) a byte/cost query prices the
        schedule's Exchange payloads with; either side of the r2c pair
        may be passed, None means the plan's own dtypes."""
        if self.real:
            r, c = self._dtype_pair(dtype)
            return r.itemsize, c.itemsize
        item = (dtype or self.dtype).itemsize
        return item, item

    def comm_bytes(self, dtype=None) -> float:
        """Total bytes each device ships per transform, summed over every
        Exchange stage of the plan's own schedule (each re-shards its
        block over the P-ring, shipping (1-1/P) of it). Real plans count
        the Hermitian payload: every complex exchange moves the
        truncated ``Hp`` block (~half the c2c bytes at the same shape);
        the c2r inverse mirrors the chain, so the total is
        direction-agnostic."""
        r_item, c_item = self._byte_sizes(dtype)
        return sch.schedule_comm_bytes(self.schedule(), r_item, c_item)

    # -- the spectrum layout ---------------------------------------------------
    def spectral_axes(self) -> Tuple[SpectralAxis, ...]:
        """The plan's frequency-domain layout: one :class:`SpectralAxis`
        per trailing output dim of the forward transform (equivalently,
        per trailing input dim of the inverse), in output order. Works
        for c2c and real plans -- the apps key off it."""
        nd = self.ndim
        dims = self.global_shape[-nd:]
        natural = list(range(-nd, 0))
        order = [-1, -2] if (nd == 2 and not self.transpose_back) else natural
        # the output dim the slab keeps sharded: the Hermitian axis must
        # stay padded there (trimming would break divisibility)
        sharded = {0} if nd > 1 else set()
        axes = []
        for pos, orig in enumerate(order):
            n = dims[orig]
            half = self.real and orig == -1
            if half:
                n_out = self.padded_hermitian_len if pos in sharded else self.hermitian_len
            else:
                n_out = n
            axes.append(SpectralAxis(orig, n, n_out, half))
        return tuple(axes)

    def spectrum_shape(self) -> Tuple[int, ...]:
        """Global shape of the frequency-domain array (forward output /
        inverse input), batch dims included."""
        return self.global_shape[: -self.ndim] + tuple(a.n_out for a in self.spectral_axes())

    # -- cost model ------------------------------------------------------------
    def predict(self, dtype=None, chunk_compute_s: Optional[float] = None, *,
                fused: Optional[bool] = None, n_chunks: Optional[int] = None) -> Dict[str, float]:
        """Alpha-beta predicted seconds per backend for this problem: the
        plan's own schedule, rewritten to each backend supporting this
        shard count, walked by :func:`repro_torch.core.schedule.predict_seconds`.
        ``fused``/``n_chunks`` (default: the plan's own resolution)
        report the fused vs unfused variants of the same problem."""
        fused = self.fused if fused is None else fused
        n_chunks = self.n_chunks if n_chunks is None else n_chunks
        cc = self._auto_chunk_compute_s(dtype) if chunk_compute_s is None else chunk_compute_s
        r_item, c_item = self._byte_sizes(dtype)
        base = sch.with_pipeline(self.schedule(), fused, n_chunks)
        return {
            name: sch.predict_seconds(sch.with_backends(base, slab=name), self.params, cc, r_item, c_item)
            for name in backends.supporting(self.shards)
        }

    # -- the stage schedule (the single pipeline truth) ------------------------
    def schedule(self, inverse: Optional[bool] = None) -> sch.Schedule:
        """The stage schedule the given direction executes (None: the
        planned direction), built once per direction and cached."""
        inv = (self.direction == "inverse") if inverse is None else bool(inverse)
        cached = self._schedules.get(inv)
        if cached is not None:
            return cached
        if self.ndim == 1 and inv:
            raise NotImplementedError("1-D large inverse: conjugate externally")
        built = sch.build_schedule(
            self.global_shape, ndim=self.ndim, inverse=inv, real=self.real,
            decomp="slab", axis_name=self.axis_name, p=self.shards,
            backend=self.backend, fused=self.fused, n_chunks=self.n_chunks,
            transpose_back=self.transpose_back, pad=self.pad,
        )
        self._schedules[inv] = built
        return built

    def schedule_hash(self, inverse: Optional[bool] = None) -> str:
        """Content hash of the direction's stage schedule: equal to the
        reference plan's hash for the same arguments."""
        return self.schedule(inverse).schedule_hash()

    def describe(self, inverse: Optional[bool] = None, dtype=None) -> str:
        """Stage dump of the direction's schedule with per-stage predicted
        microseconds and wire bytes."""
        r_item, c_item = self._byte_sizes(dtype)
        return self.schedule(inverse).describe(
            params=self.params, chunk_compute_s=self._auto_chunk_compute_s(dtype),
            real_itemsize=r_item, complex_itemsize=c_item,
        )

    # -- execution -------------------------------------------------------------
    def _run(self, x, inverse: bool) -> torch.Tensor:
        return sch.run_schedule(x, self.schedule(inverse), self.mesh, impl=self.local_impl)

    def execute(self, x) -> torch.Tensor:
        """Run the planned direction on ``x``, moved to the mesh's
        device: the global array on a ``SimMesh``, the rank's own block
        on a ``ProcessGroupMesh`` (the result likewise)."""
        return self._run(x, self.direction == "inverse")

    def inverse(self, x) -> torch.Tensor:
        """Run the opposite of the planned direction. Not available for
        ``ndim=1`` (raises before executing anything)."""
        return self._run(x, self.direction != "inverse")

    # -- not ported yet --------------------------------------------------------
    def profile(self, *args, **kwargs):
        raise _not_ported("Plan.profile", "A11 (obs/ + the trace-mode executor)")

    def lower(self, *args, **kwargs):
        raise _not_ported("Plan.lower", "A9 (what Plan.lower/roofline report)")

    def roofline(self, *args, **kwargs):
        raise _not_ported("Plan.roofline", "A9 (what Plan.lower/roofline report)")

    def __repr__(self) -> str:
        return (
            f"Plan({'r2c' if self.real else 'c2c'}, shape={self.global_shape}, ndim={self.ndim}, "
            f"decomp={self.decomp!r}, P={self.shards}, "
            f"backend={self.backend!r}, direction={self.direction!r}, "
            f"dtype={str(self.dtype).replace('torch.', '')})"
        )


def plan_fft(
    global_shape: Tuple[int, ...],
    mesh: Mesh,
    *,
    ndim: int = 2,
    direction: str = "forward",
    backend: str = "auto",
    axis_name: Optional[str] = None,
    local_impl: str = "torch",
    transpose_back: bool = False,
    dtype=torch.complex64,
    params: Optional[cm.CommParams] = None,
    chunk_compute_s: float = 0.0,
    planner: str = "estimate",
    decomp: str = "slab",
    real: bool = False,
    pad: bool = True,
    pipeline="auto",
    faults=None,
) -> Plan:
    """Plan a distributed FFT (the FFTW ``plan`` analogue).

    ``pipeline`` controls the pipelined overlap executor: ``"auto"``
    (default) fuses each exchange's following FFT stage into its
    arriving chunks wherever the selected backend streams over a
    >1-shard ring; ``int n`` also sub-chunks each peer block toward
    ``n`` total chunks; ``False`` (or ``0``) runs the plain transpose +
    whole-axis local FFT.

    ``local_impl``: ``"torch"`` (the library FFT), ``"matmul"`` (four-step
    matmuls) or ``"kernel"`` (the Hopper kernels; their plain versions on
    the CPU). ``params=None`` means ``CommParams()`` (NVIDIA's H100
    data-sheet rates, placeholder latency). ``backend="auto"`` is the
    alpha-beta cost-model argmin; any name in
    ``repro_torch.core.backends.available()`` pins it.

    ``real=True`` plans the r2c/c2r pair (:mod:`repro_torch.core.real`):
    ``execute`` computes the distributed ``rfftn`` of a real array (and
    ``inverse`` the matching ``irfftn``; ``direction="inverse"`` swaps
    the two), every exchange after the local r2c pass shipping only the
    Hermitian-truncated ``N//2+1`` payload. ``dtype`` is then the real
    input dtype (float32/float64; the complex default maps to its real
    partner). ``pad=True`` (default) zero-pads the Hermitian axis to the
    next shard-divisible length (``Plan.padded_hermitian_len``);
    ``pad=False`` raises at plan time naming the offending axis.

    Not ported yet, each raising ``NotImplementedError``:
    ``planner="measure"``, ``faults=``, and decompositions other than
    ``"slab"``.
    """
    if planner not in ("estimate", "measure"):
        raise ValueError(f"planner must be 'estimate' or 'measure', got {planner!r}")
    if planner == "measure":
        raise _not_ported('planner="measure"', "A9 (core/planner.py)")
    if faults is not None:
        raise _not_ported("faults= (chaos injection)", "A12 (runtime/faults.py)")
    return Plan(
        global_shape, mesh, ndim=ndim, direction=direction, backend=backend,
        axis_name=axis_name, local_impl=local_impl,
        transpose_back=transpose_back, dtype=dtype, params=params,
        chunk_compute_s=chunk_compute_s, decomp=decomp, real=real, pad=pad, pipeline=pipeline,
    )
