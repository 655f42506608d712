"""FFTW-style plan/executor front-end over the collective-backend
registry, PyTorch port of ``repro.core.plan``:

    mesh = SimMesh(4)                      # device=None: the card
    plan = plan_fft((n, n), mesh, backend="scatter", local_impl="kernel")
    y = plan.execute(x)                    # fft2(x).mT, C sharded
    x2 = plan.inverse(y)
    rplan = plan_fft((n, n), mesh, real=True)  # r2c: rfft2(x).mT, Hp rows
    grid = SimMesh((2, 2), axis_names=("rows", "cols"))
    pplan = plan_fft((n, n), grid, decomp="pencil", backend=("scatter", "alltoall"))

A :class:`Plan` validates the (global shape, mesh, shard axes,
decomposition, backend) combination once, at construction --
shard-divisibility included, so a bad shape fails here naming the
offending data axis and mesh/grid dimension; resolves the
decomposition (``decomp="slab"``: one mesh axis, the paper's layout;
``"pencil"``: a 2-D :class:`~repro_torch.core.grid.ProcessGrid`, one
backend per grid axis; ``"auto"``: pencil whenever the mesh offers a
valid grid and the cost model does not prefer slab); resolves
``backend="auto"`` to the alpha-beta cost-model argmin (per grid axis
for pencil, :func:`~repro_torch.core.backends.cheapest_pair`) and
``pipeline=``; and lowers each direction once to its stage schedule,
which execution, :meth:`Plan.predict` and :meth:`Plan.comm_bytes` all
walk.

The mesh is a :class:`~repro_torch.core.mesh.SimMesh` (``execute``
takes and returns global arrays) or a
:class:`~repro_torch.core.mesh.ProcessGroupMesh` (each rank passes and
gets back its own block of the layout :meth:`Plan.input_spec` names).

Ported: c2c (ndim 1, 2, 3) and r2c / c2r (``real=True``, ndim 2, 3)
transforms, slab and pencil, under ``planner="estimate"`` and
``planner="measure"`` (:mod:`repro_torch.core.planner`), with the
plan's decision provenance (:meth:`Plan.why`), per-stage model
(:meth:`Plan.predict_stages`), traced profile (:meth:`Plan.profile`) and
roofline (:meth:`Plan.roofline`). ``faults=`` raises
``NotImplementedError`` naming its ROADMAP item. ``FFTPlan`` /
``make_plan`` remain as the reference's deprecation shims.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

import repro_torch.core.schedule as sch
from repro_torch.core import backends
from repro_torch.core import comm_model as cm
from repro_torch.core import grid as _grid
from repro_torch.core import pencil as _pencil
from repro_torch.core.distributed_fft import FFTConfig
from repro_torch.core.mesh import Mesh, fft_axis

#: Pair-key separator for pencil backend pairs ("scatter+bisection") --
#: registry names are identifiers, so '+' cannot appear inside one.
PAIR_SEP = "+"

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


class InputSpec(NamedTuple):
    """What a direction of a plan takes from its caller: the global
    ``shape``, the ``dtype`` and the trailing partition spec ``tail``
    (one mesh axis name or None per transform dim; leading batch dims
    are replicated) -- the counterpart of the reference's
    ``Plan.input_spec`` / ``input_sharding``. On a ``ProcessGroupMesh``
    each rank passes ``mesh.split(x, tail)[0]``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    tail: Tuple[Optional[str], ...]


def pair_key(backend_row: str, backend_col: str) -> str:
    return f"{backend_row}{PAIR_SEP}{backend_col}"


def pipeline_is_default(pipeline) -> bool:
    """Whether a ``pipeline=`` value is the default ("auto") setting.
    Identity-checked for True/None: ``1 == True`` in Python, but
    ``pipeline=1`` is an explicit one-chunk request, not the default."""
    return pipeline == "auto" or pipeline is True or pipeline is None


def split_pair(key) -> Tuple[str, str]:
    """(row, col) from a pair key, a 2-tuple/list, or a single name
    (applied to both axes)."""
    if isinstance(key, (tuple, list)):
        if len(key) != 2:
            raise ValueError(f"pencil backend pair must have 2 entries, got {key!r}")
        return str(key[0]), str(key[1])
    if PAIR_SEP in key:
        row, _, col = key.partition(PAIR_SEP)
        return row, col
    return key, key


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class Plan:
    """A validated, backend-resolved FFT plan over a mesh
    (:mod:`repro_torch.core.mesh`).

    Construct through :func:`plan_fft`. ``direction`` fixes what
    ``execute`` computes ("forward" or "inverse"); ``inverse`` always
    computes the opposite. The 1-D large transform has no inverse.

    Slab plans expose ``backend`` (one registry name); pencil plans
    expose ``backend_row`` / ``backend_col``, ``backend`` as the
    ``"row+col"`` pair key, and ``grid`` (the resolved
    :class:`~repro_torch.core.grid.ProcessGrid`). Pencil supports ndim
    2 and 3.
    """

    def __init__(
        self,
        global_shape: Tuple[int, ...],
        mesh: Mesh,
        *,
        ndim: int = 2,
        direction: str = "forward",
        backend="auto",
        axis_name: Optional[str] = None,
        local_impl: str = "torch",
        transpose_back: bool = False,
        dtype=torch.complex64,
        params: Optional[cm.CommParams] = None,
        chunk_compute_s: float = 0.0,
        decomp: str = "slab",
        row_axis: Optional[str] = None,
        col_axis: Optional[str] = None,
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
        if real and ndim == 1:
            raise NotImplementedError(
                "1-D real transform is not implemented: complexify and use ndim=1 c2c"
            )
        if isinstance(backend, str) and "@" in backend:
            # measured-planner candidate ids ("scatter@u", "scatter@f16",
            # Plan.backend of a variant winner) are valid backend specs:
            # the suffix is a pipeline override, so backend=plan.backend
            # always round-trips
            from repro_torch.core.planner import parse_variant

            backend, pipe_override = parse_variant(backend)
            if not pipeline_is_default(pipeline):
                raise ValueError(
                    f"backend variant suffix and pipeline={pipeline!r} "
                    f"both specify the pipeline; pass one or the other"
                )
            pipeline = pipe_override
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
        if (row_axis is None) != (col_axis is None):
            raise ValueError("pass both row_axis and col_axis, or neither")
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
        if params is None:
            # a fitted device kind (planner.ensure_calibrated, or an
            # imported wisdom file's calibration section) prices every
            # default-params plan with its measured constants
            from repro_torch.core import planner as _planner

            params = _planner.calibration_for(_planner.device_kind(mesh))
        self.params = params or cm.CommParams()
        self.chunk_compute_s = chunk_compute_s
        self.pipeline = "auto" if (pipeline is True or pipeline is None) else pipeline
        #: resolved by _resolve_pipeline once the backend(s) are known
        self.fused: bool = False
        self.n_chunks: Optional[int] = None
        # set by the measured planner (repro_torch.core.planner.plan_measured)
        self.planner = "estimate"
        self.measured: Optional[Dict[str, float]] = None
        #: candidate id -> "ExcType: msg" for candidates that raised
        #: mid-race (timed inf, excluded from the argmin)
        self.race_failures: Dict[str, str] = {}
        self.wisdom_hit = False
        self.wisdom_key: Optional[str] = None
        #: which channel picked the backend: "pinned" (the caller named
        #: it), "model-argmin" (alpha-beta auto), or -- set by
        #: plan_measured -- "measured-race" / "wisdom-hit" /
        #: "observed-overlay". Rendered by :meth:`why`.
        self.selection_channel = "pinned"
        #: direction -> lowered stage schedule (the single pipeline truth)
        self._schedules: Dict[bool, sch.Schedule] = {}
        self.grid: Optional[_grid.ProcessGrid] = None
        self.backend_row: Optional[str] = None
        self.backend_col: Optional[str] = None
        if decomp == "slab":
            if row_axis is not None:
                raise ValueError("row_axis/col_axis apply to decomp='pencil' (or 'auto') only")
            self.decomp = "slab"
            self._init_slab(backend)
        elif decomp == "pencil":
            self.decomp = "pencil"
            self._init_pencil(backend, row_axis, col_axis)
        else:
            self._init_auto(backend, axis_name, row_axis, col_axis)

    def _init_auto(self, backend, axis_name: Optional[str], row_axis: Optional[str],
                   col_axis: Optional[str]) -> None:
        """decomp='auto': pencil when the WHOLE pencil plan validates
        (grid, divisibility, per-axis backends) and a slab plan of at
        least the same parallelism does not predict cheaper, else slab
        -- a pinned backend that only works under one decomposition
        steers the choice instead of erroring."""
        if row_axis is not None:
            # explicitly configured grid axes are a user argument, not an
            # infeasibility signal: bad names raise, never fall back
            _grid.grid_from_mesh(self.mesh, row_axis, col_axis)
        pencil_err: Optional[ValueError] = None
        self.decomp = None
        if self.ndim in (2, 3) and not (self.ndim == 2 and self.transpose_back):
            try:
                self.decomp = "pencil"
                self._init_pencil(backend, row_axis, col_axis)
            except ValueError as e:
                pencil_err = e
                self.grid = None
                self.decomp = None
        if self.decomp == "pencil":
            # cost-aware tie-break: a degenerate (P, 1) grid doubles the
            # fft2 exchanges over the same ring, so slab wins it. The
            # trial shards over the largest of fft_axis and the grid axes
            trial_ax = axis_name
            if trial_ax is None:
                candidates = (fft_axis(self.mesh), self.grid.row_axis, self.grid.col_axis)
                trial_ax = max(candidates, key=lambda a: self.mesh.shape[a])
            try:
                trial = Plan(
                    self.global_shape, self.mesh, ndim=self.ndim, direction=self.direction,
                    backend=backend, axis_name=trial_ax, local_impl=self.local_impl,
                    transpose_back=self.transpose_back, dtype=self.dtype, params=self.params,
                    chunk_compute_s=self.chunk_compute_s, decomp="slab", real=self.real,
                    pad=self.pad, pipeline=self.pipeline,
                )
            except (ValueError, NotImplementedError):
                trial = None
            if (
                trial is not None
                and trial.shards >= self.shards
                and trial.predict()[trial.backend] < self.predict()[self.backend]
            ):
                self.grid = None
                self.backend_row = self.backend_col = None
                self.axis_name = trial_ax
                self.decomp = "slab"
                self._init_slab(backend)
        if self.decomp is None:
            self.decomp = "slab"
            try:
                self._init_slab(backend)
            except ValueError as e:
                if pencil_err is not None:
                    raise ValueError(
                        f"decomp='auto': neither decomposition fits this "
                        f"problem -- pencil: {pencil_err} -- slab: {e}"
                    ) from e
                raise

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
        >1-shard ring (unless ``pipeline=False``). Pencil legs fuse
        independently inside the schedule; ``fused`` records whether ANY
        leg can, which is what the cost model overlaps."""
        self.n_chunks = self._pipeline_n_chunks()
        if not self._pipeline_enabled():
            self.fused = False
            return
        if self.decomp == "pencil":
            legs = ((self.backend_row, self.grid.p_rows), (self.backend_col, self.grid.p_cols))
            self.fused = any(backends.get(b).supports_chunk_fn and p > 1 for b, p in legs)
            return
        b = self.backend_obj
        self.fused = bool(b.kind == "shard_map" and b.supports_chunk_fn and self.shards > 1)

    def _auto_chunk_compute_s(self, dtype=None) -> float:
        """Per-peer-chunk seconds of the fused stage's compute: the
        caller's ``chunk_compute_s`` when given, else a memory-bound
        napkin -- each arriving chunk's outer-product contribution
        writes one local block's worth of accumulator (``_cost_bytes /
        HBM_BW``, the H100's data-sheet rate). Zero when no exchange
        ring exceeds one shard."""
        if self.chunk_compute_s:
            return self.chunk_compute_s
        rings = max(self.grid.shape) if self.decomp == "pencil" else self.shards
        if rings <= 1:
            return 0.0
        return self._cost_bytes(dtype) / cm.HBM_BW

    def _init_slab(self, backend) -> None:
        self._schedules.clear()
        p = self.shards
        if self.real:
            self.hermitian_len, self.padded_hermitian_len = sch.check_divisible(
                self.global_shape, self.ndim, p=p, axis_name=self.axis_name, real=True, pad=self.pad
            )
        else:
            sch.check_divisible(self.global_shape, self.ndim, p=p, axis_name=self.axis_name)
        if not isinstance(backend, str) or PAIR_SEP in backend:
            raise ValueError(
                f"slab plans take one backend name, got {backend!r} "
                f"(per-axis pairs are decomp='pencil')"
            )
        if backend == "auto":
            self.selection_channel = "model-argmin"
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

    def _init_pencil(self, backend, row_axis: Optional[str], col_axis: Optional[str]) -> None:
        if self.ndim == 1:
            raise ValueError("pencil decomposition supports ndim 2 or 3 (1-D is slab-only)")
        if self.ndim == 2 and self.transpose_back:
            raise ValueError(
                "pencil fft2 already returns the natural layout; "
                "transpose_back applies to slab plans and pencil fft3 only"
            )
        self._schedules.clear()
        self.grid = g = _grid.grid_from_mesh(self.mesh, row_axis, col_axis)
        checked = sch.check_divisible(
            self.global_shape, self.ndim, p_rows=g.p_rows, p_cols=g.p_cols,
            row_axis=g.row_axis, col_axis=g.col_axis, real=self.real, pad=self.pad,
        )
        if self.real:
            self.hermitian_len, self.padded_hermitian_len = checked
        if isinstance(backend, str) and backend == "auto":
            self.selection_channel = "model-argmin"
            br, bc = backends.cheapest_pair(
                self._cost_bytes(), g.p_rows, g.p_cols, self.params,
                chunk_compute_s=self._auto_chunk_compute_s(),
                n_chunks=self._pipeline_n_chunks(),
                fused=self._pipeline_enabled(),
            )
        else:
            br, bc = split_pair(backend)
        self.backend_row, self.backend_col = br, bc
        self.backend = pair_key(br, bc)
        self.backend_obj = None  # per-axis backends; see backend_row/col
        self._resolve_pipeline()
        _pencil._check_backends(  # raises naming the axis
            _pencil.PencilConfig(backend_row=br, backend_col=bc), g
        )

    # -- geometry --------------------------------------------------------------
    @property
    def shards(self) -> int:
        if self.decomp == "pencil":
            return self.grid.size
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
        Exchange stage of the plan's own schedule -- each re-shards its
        block over its ring (P for slab, P_row / P_col per pencil
        sub-exchange), shipping (1-1/P_ring) of it. Real plans count the
        Hermitian payload (the pencil rfft2's first cols exchange ships
        the full-width block at the real dtype); the c2r inverse mirrors
        the chain, so the total is direction-agnostic."""
        r_item, c_item = self._byte_sizes(dtype)
        return sch.schedule_comm_bytes(self.schedule(), r_item, c_item)

    # -- the spectrum layout ---------------------------------------------------
    def _opposite_reverses_layout(self) -> bool:
        """Whether the opposite direction consumes the reversed-axes
        pencil layout (3-D c2c pencil without transpose_back: the
        forward output is fftn reversed, sharded (cols, rows))."""
        return self.decomp == "pencil" and self.ndim == 3 and not self.transpose_back

    def _spectrum_side(self, opposite: bool) -> bool:
        """Real plans only: whether the (possibly opposite) direction's
        input is the half spectrum (the c2r side) rather than the real
        array."""
        return (self.direction == "inverse") != opposite

    def spectral_axes(self) -> Tuple[SpectralAxis, ...]:
        """The plan's frequency-domain layout: one :class:`SpectralAxis`
        per trailing output dim of the forward transform (equivalently,
        per trailing input dim of the inverse), in output order. Works
        for c2c and real plans -- the apps key off it."""
        nd = self.ndim
        dims = self.global_shape[-nd:]
        natural = list(range(-nd, 0))
        if self.decomp == "pencil":
            order = natural if (nd == 2 or self.transpose_back) else natural[::-1]
        else:
            order = [-1, -2] if (nd == 2 and not self.transpose_back) else natural
        # output dims the decomposition keeps sharded: the Hermitian axis
        # must stay padded there (trimming would break divisibility)
        sharded = {0, 1} if self.decomp == "pencil" else ({0} if nd > 1 else set())
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

    def spectrum_tail(self) -> Tuple[Optional[str], ...]:
        """Trailing partition spec of the spectrum, position by position
        as :meth:`spectral_axes` orders it: slab shards its leading dim;
        pencil its two leading dims over (rows, cols), or (cols, rows)
        in the reversed 3-D layout."""
        if self.decomp == "pencil":
            row, col = self.grid.row_axis, self.grid.col_axis
            lead = (col, row) if self._opposite_reverses_layout() else (row, col)
        else:
            lead = (self.axis_name,)
        return lead + (None,) * (self.ndim - len(lead))

    def input_spec(self, dtype=None, opposite: bool = False) -> InputSpec:
        """The planned direction's input layout (``opposite=True``: the
        opposite direction's, which differs where it consumes the
        spectrum or the reversed-axes pencil layout): global shape,
        dtype and trailing partition spec."""
        nd = self.ndim
        if self.decomp == "pencil":
            row, col = self.grid.row_axis, self.grid.col_axis
            if self.real:
                if self._spectrum_side(opposite) and self._opposite_reverses_layout():
                    row, col = col, row
            elif opposite and self._opposite_reverses_layout():
                row, col = col, row
            tail = (row, col) + (None,) * (nd - 2)
        else:
            tail = (self.axis_name,) + (None,) * (nd - 1)
        shape = self.global_shape
        if self.real:
            if self._spectrum_side(opposite):
                return InputSpec(self.spectrum_shape(), dtype or self.cdtype, tail)
            return InputSpec(shape, dtype or self.dtype, tail)
        if opposite and self._opposite_reverses_layout():
            shape = shape[:-3] + tuple(reversed(shape[-3:]))
        return InputSpec(shape, dtype or self.dtype, tail)

    # -- cost model ------------------------------------------------------------
    def predict(self, dtype=None, chunk_compute_s: Optional[float] = None, *,
                fused: Optional[bool] = None, n_chunks: Optional[int] = None) -> Dict[str, float]:
        """Alpha-beta predicted seconds per backend for this problem: the
        plan's own schedule, rewritten to each backend supporting this
        shard count, walked by :func:`repro_torch.core.schedule.predict_seconds`.
        Pencil: one entry per ``"row+col"`` pair, each axis costed at its
        own sub-ring size (see :meth:`predict_axes`). ``fused``/``n_chunks``
        (default: the plan's own resolution) report the fused vs unfused
        variants of the same problem."""
        fused = self.fused if fused is None else fused
        n_chunks = self.n_chunks if n_chunks is None else n_chunks
        if self.decomp == "pencil":
            row_costs, col_costs = self.predict_axes(dtype, chunk_compute_s, fused=fused, n_chunks=n_chunks)
            return {pair_key(r, c): row_costs[r] + col_costs[c] for r in row_costs for c in col_costs}
        cc = self._auto_chunk_compute_s(dtype) if chunk_compute_s is None else chunk_compute_s
        r_item, c_item = self._byte_sizes(dtype)
        base = sch.with_pipeline(self.schedule(), fused, n_chunks)
        return {
            name: sch.predict_seconds(sch.with_backends(base, slab=name), self.params, cc, r_item, c_item)
            for name in backends.supporting(self.shards)
        }

    def predict_axes(self, dtype=None, chunk_compute_s: Optional[float] = None, *,
                     fused: Optional[bool] = None,
                     n_chunks: Optional[int] = None) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Pencil only: (row_costs, col_costs) -- per-backend predicted
        seconds of all of this transform's exchanges over that grid
        axis, each at its own sub-ring size. ``predict()[f"{r}+{c}"] ==
        row_costs[r] + col_costs[c]`` by construction."""
        if self.decomp != "pencil":
            raise ValueError("predict_axes is a pencil-plan method; use predict()")
        fused = self.fused if fused is None else fused
        n_chunks = self.n_chunks if n_chunks is None else n_chunks
        cc = self._auto_chunk_compute_s(dtype) if chunk_compute_s is None else chunk_compute_s
        r_item, c_item = self._byte_sizes(dtype)
        base = sch.with_pipeline(self.schedule(), fused, n_chunks)
        out = []
        for role, p_axis in (("row", self.grid.p_rows), ("col", self.grid.p_cols)):
            out.append({
                name: sch.predict_seconds(
                    sch.with_backends(base, **{role: name}), self.params, cc, r_item, c_item, role,
                )
                for name in backends.supporting(p_axis, kind="shard_map")
            })
        return out[0], out[1]

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
        if self.decomp == "pencil":
            g, shape = self.grid, self.global_shape
            row, col, pr, pc = g.row_axis, g.col_axis, g.p_rows, g.p_cols
            br, bc = self.backend_row, self.backend_col
            opposite = inv != (self.direction == "inverse")
            if not self.real and opposite and self._opposite_reverses_layout():
                # the opposite direction consumes the reversed-axes output,
                # sharded (cols, rows): swap the grid roles (and the
                # per-axis backends with them) so the transform reads that
                # sharding directly. Real plans never swap: each irfft
                # consumes exactly the layout its rfft produces.
                shape = shape[:-3] + tuple(reversed(shape[-3:]))
                row, col, pr, pc, br, bc = col, row, pc, pr, bc, br
            built = sch.build_schedule(
                shape, ndim=self.ndim, inverse=inv, real=self.real, decomp="pencil",
                row_axis=row, col_axis=col, p_rows=pr, p_cols=pc, backend_row=br, backend_col=bc,
                fused=self.fused, n_chunks=self.n_chunks,
                transpose_back=self.transpose_back, pad=self.pad,
            )
        else:
            built = sch.build_schedule(
                self.global_shape, ndim=self.ndim, inverse=inv, real=self.real,
                decomp="slab", axis_name=self.axis_name, p=self.shards,
                # backend_obj, not self.backend: a measured variant winner
                # reports its candidate id ("scatter@u") on .backend
                backend=self.backend_obj.name, fused=self.fused, n_chunks=self.n_chunks,
                transpose_back=self.transpose_back, pad=self.pad,
            )
        self._schedules[inv] = built
        return built

    def schedule_hash(self, inverse: Optional[bool] = None) -> str:
        """Content hash of the direction's stage schedule: equal to the
        reference plan's hash for the same arguments."""
        return self.schedule(inverse).schedule_hash()

    def predict_stages(self, inverse: Optional[bool] = None, dtype=None):
        """Per-stage cost decomposition: ``[(Exchange, predicted seconds,
        wire bytes), ...]`` over the direction's schedule at the plan's
        own backends and pipeline. The seconds sum to
        ``predict()[self.backend]`` and the bytes to :meth:`comm_bytes`."""
        r_item, c_item = self._byte_sizes(dtype)
        cc = self._auto_chunk_compute_s(dtype)
        base = sch.with_pipeline(self.schedule(inverse), self.fused, self.n_chunks)
        return [
            (st, sch.stage_seconds(st, self.params, cc, r_item, c_item),
             sch.exchange_wire_bytes(st, r_item, c_item))
            for st in base.exchanges()
        ]

    def describe(self, inverse: Optional[bool] = None, dtype=None) -> str:
        """The plan (with its grid) and a stage dump of the direction's
        schedule with per-stage predicted microseconds and wire bytes."""
        r_item, c_item = self._byte_sizes(dtype)
        return f"{self!r}\n" + self.schedule(inverse).describe(
            params=self.params, chunk_compute_s=self._auto_chunk_compute_s(dtype),
            real_itemsize=r_item, complex_itemsize=c_item,
        )

    def why(self) -> dict:
        """Decision provenance: why this backend won -- the selection
        channel (``pinned`` / ``model-argmin`` / ``measured-race`` /
        ``wisdom-hit`` / ``observed-overlay``), the timing table the
        decision took the argmin of (measured seconds for a measured
        plan, alpha-beta model seconds otherwise), the wisdom key
        consulted, and the calibration constants in force (fitted for
        this device kind, or the module defaults)."""
        from repro_torch.core import planner as _planner

        if self.planner == "measure" and self.measured:
            # failed candidates carry timing inf: they are reported under
            # "failed", not in the table or the argmin
            timings = {
                k: float(v) for k, v in self.measured.items()
                if isinstance(v, (int, float)) and math.isfinite(v)
            }
            timings_kind = "measured"
        else:
            timings = {k: float(v) for k, v in self.predict().items()}
            timings_kind = "model"
        argmin = min(sorted(timings), key=timings.__getitem__) if timings else None
        dev = _planner.device_kind(self.mesh)
        cell = _planner.calibration_cell(dev)
        return {
            "channel": self.selection_channel,
            "backend": self.backend,
            "decomp": self.decomp,
            "planner": self.planner,
            "fused": self.fused,
            "n_chunks": self.n_chunks,
            "timings_kind": timings_kind,
            "timings": timings,
            "argmin": argmin,
            "failed": dict(self.race_failures),
            "wisdom_key": self.wisdom_key,
            "wisdom_hit": self.wisdom_hit,
            "calibration": {
                "device_kind": dev,
                "alpha_s": float(self.params.alpha_s),
                "beta_bytes_s": float(self.params.beta_bytes_s),
                "source": (cell or {}).get("source", "default"),
                "calibrated": cell is not None,
            },
        }

    def why_text(self) -> str:
        """One-paragraph rendering of :meth:`why`: channel, winner, the
        top of the timing table, and the calibration constants in force."""
        w = self.why()
        cal = w["calibration"]
        table = sorted(w["timings"].items(), key=lambda kv: kv[1])
        shown = ", ".join(f"{k}={v * 1e6:.1f}us" for k, v in table[:4])
        if len(table) > 4:
            shown += f", ... ({len(table) - 4} more)"
        lines = [
            f"why: backend={w['backend']} via {w['channel']} (decomp={w['decomp']}, planner={w['planner']})",
            f"  {w['timings_kind']} table argmin={w['argmin']}: {shown}" if table else "  (no timing table)",
            f"  calibration[{cal['device_kind']}]: alpha={cal['alpha_s'] * 1e6:.2f}us "
            f"beta={cal['beta_bytes_s'] / 1e9:.1f}GB/s "
            f"({cal['source'] if cal['calibrated'] else 'default'})",
        ]
        if w["failed"]:
            lines.append(
                "  failed candidates (excluded from argmin): "
                + ", ".join(f"{k} ({v})" for k, v in sorted(w["failed"].items()))
            )
        if w["wisdom_key"]:
            lines.append(f"  wisdom_key: {w['wisdom_key']}")
        return "\n".join(lines)

    def zeros_input(self, dtype=None, opposite: bool = False) -> torch.Tensor:
        """Zeros of the (possibly opposite) direction's input layout on
        the mesh's device: the global array on a ``SimMesh``, the rank's
        block on a ``ProcessGroupMesh``."""
        spec = self.input_spec(dtype, opposite=opposite)
        shape = self.mesh.caller_shape(spec.shape, spec.tail)
        return torch.zeros(shape, dtype=spec.dtype, device=self.mesh.device)

    def profile(self, x=None, *, reps: int = 3, warmup: int = 1, inverse: Optional[bool] = None,
                trace=None, record: bool = True) -> "ProfileResult":
        """Execute the direction through the trace-mode executor and
        return one observed row per span next to :meth:`predict_stages`'
        model -- the paper's comm-vs-compute breakdown, measured on this
        plan.

        ``x=None`` profiles :meth:`zeros_input`. Spans land in ``trace``
        (a fresh :class:`repro_torch.obs.trace.TraceRecorder` if None;
        the result keeps it for export). ``warmup`` untraced-into-``trace``
        runs come first (the first call builds the kernels), then ``reps``
        timed runs, aggregated by median. ``record=True`` folds the total
        observed seconds into the planner's wisdom observed channel
        (:func:`repro_torch.core.planner.record_observed`; a no-op unless
        this plan came from ``planner="measure"``).

        Every span ends in a fence of the card, which also keeps stages
        from overlapping, so the observed sum exceeds ``execute``'s time:
        read the rows as an attribution of cost, not a throughput."""
        from repro_torch.obs.trace import TraceRecorder

        inv = (self.direction == "inverse") if inverse is None else bool(inverse)
        opposite = inv != (self.direction == "inverse")
        x = self.zeros_input(opposite=opposite) if x is None else self.mesh.place(x)
        built = self.schedule(inv)
        rec = trace if trace is not None else TraceRecorder()
        for _ in range(max(0, warmup)):
            sch.run_schedule(x, built, self.mesh, impl=self.local_impl, trace=TraceRecorder())
        per_rep = []
        for _ in range(max(1, reps)):
            m = rec.mark()
            sch.run_schedule(x, built, self.mesh, impl=self.local_impl, trace=rec)
            per_rep.append(rec.spans_since(m))
        preds = self.predict_stages(inv, x.dtype)
        rows = []
        k_ex = 0
        for pos, sp in enumerate(per_rep[0]):
            durs = sorted(spans[pos].dur for spans in per_rep)
            pred_s = wire = None
            if sp.cat == "exchange":
                pred_s = preds[k_ex][1]
                wire = sp.args.get("wire_bytes")
                k_ex += 1
            rows.append(ProfileRow(
                index=int(sp.args.get("index", pos)), stage=sp.name,
                kind=str(sp.args.get("stage", type(sp).__name__)), observed_s=durs[len(durs) // 2],
                predicted_s=pred_s, wire_bytes=wire, args=dict(sp.args),
            ))
        result = ProfileResult(rows=tuple(rows), schedule=built, trace=rec, reps=len(per_rep))
        if record:
            from repro_torch.core import planner

            planner.record_observed(self, result.observed_s)
        return result

    # -- execution -------------------------------------------------------------
    def _run(self, x, inverse: bool) -> torch.Tensor:
        return sch.run_schedule(x, self.schedule(inverse), self.mesh, impl=self.local_impl)

    def execute(self, x) -> torch.Tensor:
        """Run the planned direction on ``x``, moved to the mesh's
        device: the global array on a ``SimMesh``, the rank's own block
        (of :meth:`input_spec`'s layout) on a ``ProcessGroupMesh`` (the
        result likewise)."""
        return self._run(x, self.direction == "inverse")

    def inverse(self, x) -> torch.Tensor:
        """Run the opposite of the planned direction. Not available for
        ``ndim=1`` (raises before executing anything)."""
        return self._run(x, self.direction != "inverse")

    # -- analysis --------------------------------------------------------------
    def lower(self, inverse: Optional[bool] = None, dtype=None) -> sch.Schedule:
        """The direction's schedule, validated against that direction's
        input layout (its partition spec walked through every stage by
        :func:`~repro_torch.core.schedule.simulate_specs`); allocates
        nothing. The port has no compiler IR to lower to: the schedule
        is what executes (the reference returns jax's lowered program)."""
        inv = (self.direction == "inverse") if inverse is None else bool(inverse)
        spec = self.input_spec(dtype, opposite=inv != (self.direction == "inverse"))
        built = self.schedule(inv)
        sch.simulate_specs(built, len(spec.shape))
        return built

    def roofline(self, inverse: Optional[bool] = None) -> cm.Roofline:
        """The roofline terms of the direction, per rank, from its
        schedule (:func:`repro_torch.core.comm_model.roofline_from_schedule`:
        analytic operations at the local impl's peak, one read and one
        write of each stage's block, and :meth:`comm_bytes`)."""
        inv = (self.direction == "inverse") if inverse is None else bool(inverse)
        spec = self.input_spec(opposite=inv != (self.direction == "inverse"))
        r_item, c_item = self._byte_sizes()
        return cm.roofline_from_schedule(
            self.lower(inv), input_shape=spec.shape, impl=self.local_impl,
            real_itemsize=r_item, complex_itemsize=c_item, chips=self.mesh.p,
        )

    def __repr__(self) -> str:
        where = f"grid={self.grid.p_rows}x{self.grid.p_cols}" if self.decomp == "pencil" else f"P={self.shards}"
        return (
            f"Plan({'r2c' if self.real else 'c2c'}, shape={self.global_shape}, ndim={self.ndim}, "
            f"decomp={self.decomp!r}, {where}, "
            f"backend={self.backend!r}, direction={self.direction!r}, "
            f"dtype={str(self.dtype).replace('torch.', '')})"
        )


@dataclasses.dataclass(frozen=True)
class ProfileRow:
    """One traced span's observed wall clock vs the model's prediction.
    ``predicted_s`` / ``wire_bytes`` are None for non-Exchange rows (the
    alpha-beta model prices exchanges only). ``args`` is the span's
    attribute payload (backend, role, p, fused, n_chunks, ... for
    exchanges)."""

    index: int
    stage: str
    kind: str
    observed_s: float
    predicted_s: Optional[float] = None
    wire_bytes: Optional[float] = None
    args: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ProfileResult:
    """``Plan.profile`` output: per-span rows + the recorder holding the
    raw spans (exportable via ``result.trace.write_chrome_trace``)."""

    rows: Tuple[ProfileRow, ...]
    schedule: sch.Schedule
    trace: object
    reps: int

    @property
    def observed_s(self) -> float:
        return sum(r.observed_s for r in self.rows)

    @property
    def exchange_observed_s(self) -> float:
        return sum(r.observed_s for r in self.rows if r.kind == "Exchange")

    @property
    def predicted_s(self) -> float:
        return sum(r.predicted_s or 0.0 for r in self.rows)

    def exchange_rows(self) -> Tuple[ProfileRow, ...]:
        return tuple(r for r in self.rows if r.kind == "Exchange")

    def table(self) -> str:
        """The observed-vs-predicted stage table."""
        s = self.schedule
        head = (
            f"profile {s.kind} [{s.decomp}{', r2c' if s.real else ''}{', inverse' if s.inverse else ''}] "
            f"shape={s.global_shape} hash={s.schedule_hash()} reps={self.reps}"
        )
        lines = [head, f"  {'#':>2}  {'stage':<52} {'observed us':>12} {'model us':>10} {'wire bytes':>12}"]
        for r in self.rows:
            pred = f"{r.predicted_s * 1e6:.2f}" if r.predicted_s is not None else "-"
            wire = f"{r.wire_bytes:.0f}" if r.wire_bytes is not None else "-"
            lines.append(f"  {r.index:>2}  {r.stage:<52} {r.observed_s * 1e6:>12.2f} {pred:>10} {wire:>12}")
        lines.append(
            f"  total observed {self.observed_s * 1e6:.2f} us "
            f"(exchanges {self.exchange_observed_s * 1e6:.2f} us, model {self.predicted_s * 1e6:.2f} us)"
        )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.table()


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
    timer=None,
    use_wisdom: bool = True,
    decomp: str = "slab",
    row_axis: Optional[str] = None,
    col_axis: Optional[str] = None,
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
    the CPU). ``params=None`` means the constants stored for the mesh's
    device kind (:func:`repro_torch.core.planner.ensure_calibrated`),
    else ``CommParams()`` (NVIDIA's H100 data-sheet rates, placeholder
    latency). ``backend="auto"`` is the
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

    ``decomp`` picks the process decomposition: ``"slab"`` (default;
    one sharded data dim over mesh axis ``axis_name``), ``"pencil"``
    (two sharded data dims over a 2-D grid of the mesh, ``row_axis`` /
    ``col_axis``, conventionally ``("rows", "cols")``; each transpose is
    a sub-axis exchange with its own backend -- pass
    ``backend=("scatter", "bisection")`` or the ``"scatter+bisection"``
    pair key to pin, ``"auto"`` for the per-axis argmin; ndim 2 or 3),
    or ``"auto"`` (pencil whenever the mesh offers a valid grid for this
    shape and a slab plan of at least equal parallelism does not predict
    cheaper; else slab).

    ``planner`` picks the selection discipline (FFTW's ESTIMATE /
    MEASURE): ``"estimate"`` (default) as above; ``"measure"`` times every
    candidate on the mesh (:func:`repro_torch.core.planner.plan_measured`)
    and pins the measured argmin, consulting the wisdom store first --
    ``use_wisdom=False`` forces a race, ``timer(plan) -> seconds``
    replaces the clock (tests). A backend such as ``"scatter@u"`` (unfused)
    or ``"scatter@f8"`` (fused, 8 chunks) pins the pipeline too.

    Not ported yet, raising ``NotImplementedError``: ``faults=``.
    """
    if planner not in ("estimate", "measure"):
        raise ValueError(f"planner must be 'estimate' or 'measure', got {planner!r}")
    if planner == "estimate" and (timer is not None or use_wisdom is not True):
        # a forgotten planner="measure" would otherwise fall back to the
        # model with the injected timer never called
        raise ValueError("timer= and use_wisdom= require planner='measure'")
    if faults is not None:
        raise _not_ported("faults= (chaos injection)", "A12 (runtime/faults.py)")
    if planner == "measure":
        from repro_torch.core import planner as _planner

        return _planner.plan_measured(
            global_shape, mesh, ndim=ndim, direction=direction, backend=backend,
            axis_name=axis_name, local_impl=local_impl, transpose_back=transpose_back,
            dtype=dtype, params=params, chunk_compute_s=chunk_compute_s, timer=timer,
            use_wisdom=use_wisdom, decomp=decomp, row_axis=row_axis, col_axis=col_axis,
            real=real, pad=pad, pipeline=pipeline,
        )
    return Plan(
        global_shape, mesh, ndim=ndim, direction=direction, backend=backend,
        axis_name=axis_name, local_impl=local_impl,
        transpose_back=transpose_back, dtype=dtype, params=params,
        chunk_compute_s=chunk_compute_s, decomp=decomp, row_axis=row_axis, col_axis=col_axis,
        real=real, pad=pad, pipeline=pipeline,
    )


# ---------------------------------------------------------------------------
# Legacy shims (the reference keeps them one release): FFTPlan + make_plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Deprecated: thin shim over :class:`Plan` keeping the old field
    layout (``cfg.strategy`` is the backend; the pipeline is the plan's
    default). Use :func:`plan_fft` instead."""

    global_shape: Tuple[int, ...]
    mesh: Mesh
    axis_name: str
    cfg: FFTConfig = FFTConfig()
    ndim_transform: int = 2

    def __post_init__(self):
        plan = Plan(
            self.global_shape, self.mesh, ndim=self.ndim_transform, backend=self.cfg.strategy,
            axis_name=self.axis_name, local_impl=self.cfg.local_impl, transpose_back=self.cfg.transpose_back,
        )
        object.__setattr__(self, "_plan", plan)

    def input_spec(self, dtype=torch.complex64) -> InputSpec:
        return self._plan.input_spec(dtype)

    def execute(self, x) -> torch.Tensor:
        return self._plan.execute(x)

    def inverse(self, x) -> torch.Tensor:
        return self._plan.inverse(x)

    def lower(self, inverse: bool = False) -> sch.Schedule:
        return self._plan.lower(inverse)

    def comm_bytes(self, dtype=torch.complex64) -> float:
        return self._plan.comm_bytes(dtype)


def make_plan(
    global_shape: Tuple[int, ...],
    mesh: Mesh,
    *,
    axis_name: Optional[str] = None,
    strategy: str = "alltoall",
    local_impl: str = "torch",
    transpose_back: bool = False,
    ndim_transform: int = 2,
) -> FFTPlan:
    """Deprecated: use :func:`plan_fft` (``strategy`` -> ``backend``,
    ``ndim_transform`` -> ``ndim``)."""
    warnings.warn(
        "make_plan is deprecated; use repro_torch.core.plan_fft(shape, mesh, "
        "ndim=..., backend=...) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return FFTPlan(
        global_shape=tuple(global_shape), mesh=mesh, axis_name=axis_name or fft_axis(mesh),
        cfg=FFTConfig(strategy=strategy, local_impl=local_impl, transpose_back=transpose_back),
        ndim_transform=ndim_transform,
    )
