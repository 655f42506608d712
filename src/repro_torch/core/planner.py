"""Measurement-driven FFT planning -- the FFTW_MEASURE analogue (PyTorch
port of ``repro.core.planner``).

The paper's FFTW3 reference does not model which schedule is fastest,
it measures: ``FFTW_MEASURE`` times candidate plans on the actual
machine and caches the winner as wisdom. This module is the same
discipline for the distributed transforms:

- :func:`plan_fft(..., planner="measure") <repro_torch.core.plan.plan_fft>`
  times every registered backend that supports the shard count on the
  mesh -- expanded to (backend, n_chunks, fused) variants where the
  pipelined overlap executor applies (:func:`candidate_variants`) -- and
  pins the plan to the measured argmin, recording the per-candidate
  timing table on ``Plan.measured``;
- an FFTW-style wisdom store -- JSON, keyed exactly as the reference
  keys it (shape, ndim, dtype, P, candidate set, device kind, and the
  decomposition) -- is consulted before measuring, so a repeated
  identical plan is free. :func:`export_wisdom` / :func:`import_wisdom`
  round-trip it to a file the caller names (nothing here writes a file
  unasked);
- the alpha-beta constants feeding ``planner="estimate"`` can be
  measured: :meth:`repro_torch.core.comm_model.CommParams.calibrate`
  fits them to a ping-pong sweep, and :func:`ensure_calibrated` stores
  the fit per device kind, where every default-params plan finds it.

On a ``ProcessGroupMesh`` every rank runs the same code, and every
decision that leads into collectives -- whether to calibrate, whether
wisdom hits, each candidate's time and whether it failed -- is agreed
with one small all-reduce (``mesh.all_max``), so all ranks race, hit or
skip together and pin the same winner. Without that they would build
different plans and wait on each other's messages until the group's
timeout.

Device kinds keep fits and winners apart: a ``SimMesh`` (all ranks on
one device, no message leaves it) is ``"<device> (SimMesh)"``, so its
copy-engine fit or race winner never prices or pins a plan over NCCL.

``timer`` is injectable everywhere (``timer(plan) -> seconds``), so the
selection logic is testable without a fabric.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

WISDOM_VERSION = 1

#: In-process wisdom: key -> {"backend": name, "timings": {name: s}, ...}
_WISDOM: Dict[str, dict] = {}


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _sync() -> None:
    """Wait for the card, where this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall time (s) of ``fn(*args)``, each call fenced by a
    synchronize of the card so it times the work and not the launches."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def default_timer(warmup: int = 1, iters: int = 5) -> Callable:
    """``timer(plan) -> seconds``: ``plan.execute`` on a zeros input of
    the plan's own input layout (``Plan.input_spec``; on a
    ``ProcessGroupMesh`` the rank's block of it)."""

    def timer(plan) -> float:
        return time_fn(plan.execute, plan.zeros_input(), warmup=warmup, iters=iters)

    return timer


# ---------------------------------------------------------------------------
# Wisdom store
# ---------------------------------------------------------------------------


def device_kind(mesh) -> str:
    """Hardware identity of the mesh's ranks (wisdom and fits must not
    cross device kinds): the card's name (``"cpu"`` off the card) for a
    ``ProcessGroupMesh``, the same with ``" (SimMesh)"`` appended for a
    ``SimMesh``, whose exchanges are device copies, not messages."""
    dev = mesh.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return name if mesh.caller_holds_block else f"{name} (SimMesh)"


def wisdom_key(
    global_shape: Tuple[int, ...],
    ndim: int,
    dtype: str,
    p: int,
    backend_names: Tuple[str, ...],
    dev_kind: str,
    opts: str = "",
) -> str:
    """Stable string key for one measured problem (the reference's
    format, byte for byte)."""
    shape = "x".join(str(d) for d in global_shape)
    names = "+".join(sorted(backend_names))
    key = f"v{WISDOM_VERSION}|shape={shape}|ndim={ndim}|dtype={dtype}|P={p}|backends={names}|dev={dev_kind}"
    if opts:
        key += f"|{opts}"
    return key


def _valid_observed_cell(cell) -> bool:
    return (
        isinstance(cell, dict)
        and isinstance(cell.get("n"), (int, float))
        and cell.get("n", 0) > 0
        and isinstance(cell.get("s"), (int, float))
        and cell.get("s", -1.0) >= 0
    )


def _merge_observed(a, b) -> Dict[str, dict]:
    """Union two observed-timings channels: per-candidate sample counts
    add and means combine count-weighted. Malformed cells are dropped."""
    out: Dict[str, dict] = {}
    for side in (a, b):
        if not isinstance(side, dict):
            continue
        for name, cell in side.items():
            if not _valid_observed_cell(cell):
                continue
            prev = out.get(name)
            if prev is None:
                out[name] = {"n": cell["n"], "s": float(cell["s"])}
            else:
                n = prev["n"] + cell["n"]
                out[name] = {"n": n, "s": (prev["s"] * prev["n"] + float(cell["s"]) * cell["n"]) / n}
    return out


def effective_timings(entry) -> Dict[str, float]:
    """The timing table the planner's argmin consults: plan-time race
    medians overlaid by the observed channel where real executions have
    been recorded (``record_observed`` / ``Plan.profile``). Returns {}
    for malformed entries."""
    if not isinstance(entry, dict):
        return {}
    timings = entry.get("timings")
    eff = {
        k: float(v)
        for k, v in (timings.items() if isinstance(timings, dict) else ())
        if isinstance(v, (int, float))
    }
    obs = entry.get("observed")
    if isinstance(obs, dict):
        for name, cell in obs.items():
            if _valid_observed_cell(cell):
                eff[name] = float(cell["s"])
    return eff


def merge_wisdom_entry(old, new) -> dict:
    """Combine two wisdom entries for the same key: the timing tables
    union, the observed channels union count-weighted, and the pinned
    backend becomes the argmin of the combined :func:`effective_timings`.
    A malformed side loses to a well-formed one outright; the merge
    never raises."""
    old_t = old.get("timings") if isinstance(old, dict) else None
    new_t = new.get("timings") if isinstance(new, dict) else None
    if not isinstance(new_t, dict) or not new_t:
        return old if isinstance(old_t, dict) and old_t else new
    if not isinstance(old_t, dict) or not old_t:
        return new
    timings = dict(old_t)
    timings.update(new_t)
    merged = dict(new)
    merged["timings"] = timings
    observed = _merge_observed(old.get("observed"), new.get("observed"))
    if observed:
        merged["observed"] = observed
    eff = effective_timings(merged)
    merged["backend"] = min(sorted(eff), key=eff.__getitem__)
    return merged


def _atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` via a same-directory temp file +
    ``os.replace``, so a concurrent reader never sees half a file."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".wisdom.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def export_wisdom(path: Optional[str] = None, *, merge: bool = True) -> str:
    """Serialize accumulated wisdom to JSON; write it to ``path`` when
    given. Returns the JSON text either way.

    The write is atomic and, with ``merge`` (default), folds any wisdom
    already at ``path`` into the output via :func:`merge_wisdom_entry`,
    so two writers interleave instead of clobbering each other. The
    output carries a top-level ``calibration`` section beside
    ``entries``: the per-device-kind constants of the calibration store,
    merged against the file's the same way."""
    entries: Dict[str, dict] = dict(_WISDOM)
    calibration: Dict[str, dict] = {k: dict(c) for k, c in _CALIBRATION.items()}
    if path is not None and merge and os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            data = None  # unreadable existing file: overwrite it
        if isinstance(data, dict) and data.get("version") == WISDOM_VERSION:
            disk = data.get("entries")
            if isinstance(disk, dict):
                for key, entry in disk.items():
                    entries[key] = merge_wisdom_entry(entry, entries[key]) if key in entries else entry
            disk_cal = data.get("calibration")
            if isinstance(disk_cal, dict):
                for dev, cell in disk_cal.items():
                    if dev in calibration:
                        calibration[dev] = _merge_calibration_cell(cell, calibration[dev])
                    elif _valid_calibration_cell(cell):
                        calibration[dev] = cell
    doc = {"version": WISDOM_VERSION, "entries": entries}
    if calibration:
        doc["calibration"] = calibration
    text = json.dumps(doc, indent=2, sort_keys=True)
    if path is not None:
        _atomic_write(path, text)
    return text


def import_wisdom(source: str) -> int:
    """Merge wisdom from a JSON string or a path to a JSON file. Returns
    the number of entries merged; wrong-version files merge 0 (wisdom is
    advisory). Keys already known merge via :func:`merge_wisdom_entry`;
    the ``calibration`` section merges even without entries."""
    text = source
    if not source.lstrip().startswith(("{", "[")):
        with open(source) as f:  # not JSON text: a path (a missing file raises as such)
            text = f.read()
    data = json.loads(text)
    if not isinstance(data, dict) or data.get("version") != WISDOM_VERSION:
        return 0
    calibration = data.get("calibration")
    if isinstance(calibration, dict):
        for dev, cell in calibration.items():
            if _valid_calibration_cell(cell):
                _CALIBRATION[dev] = _merge_calibration_cell(_CALIBRATION.get(dev), cell)
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return 0
    for key, entry in entries.items():
        _WISDOM[key] = merge_wisdom_entry(_WISDOM[key], entry) if key in _WISDOM else entry
    return len(entries)


def parse_wisdom_key(key: str) -> Optional[dict]:
    """Decode a wisdom key back into the problem it describes, or None
    when the key is unparseable. Returns ``shape``, ``ndim``, ``dtype``,
    ``p``, ``dev``, ``decomp``, ``direction``, ``real``, ``pad``,
    ``transpose_back``, ``local_impl``, ``fuse_dft``, ``pipeline`` and --
    pencil keys -- ``grid`` and ``axes``."""
    fields: Dict[str, str] = {}
    parts = key.split("|")
    if not parts or parts[0] != f"v{WISDOM_VERSION}":
        return None
    for part in parts[1:]:
        name, sep, value = part.partition("=")
        if sep and name not in fields:  # opts fields never shadow base ones
            fields[name] = value
    try:
        out = {
            "shape": tuple(int(d) for d in fields["shape"].split("x")),
            "ndim": int(fields["ndim"]),
            "dtype": fields["dtype"],
            "p": int(fields["P"]),
            "dev": fields["dev"],
        }
    except (KeyError, ValueError):
        return None
    # the last |-field is the opts blob: comma-separated name=value pairs
    opts: Dict[str, str] = {}
    for part in parts[-1].split(","):
        name, sep, value = part.partition("=")
        if sep:
            opts[name] = value
    out["decomp"] = opts.get("decomp", "slab")
    out["direction"] = opts.get("dir", "forward")
    out["local_impl"] = opts.get("impl", "jnp")
    out["real"] = opts.get("real") == "1"
    out["pad"] = opts.get("pad", "1") == "1"
    out["transpose_back"] = opts.get("tb") == "1"
    out["fuse_dft"] = opts.get("fuse") == "1"
    out["pipeline"] = opts.get("pipe")  # None unless pinned at measure time
    if out["decomp"] == "pencil":
        try:
            rows, _, cols = opts["grid"].partition("x")
            row_ax, _, col_ax = opts["axes"].partition("+")
            out["grid"] = (int(rows), int(cols))
            out["axes"] = (row_ax, col_ax)
        except (KeyError, ValueError):
            return None
    return out


def wisdom_items():
    """Snapshot of the in-process wisdom store as (key, entry) pairs."""
    return list(_WISDOM.items())


def record_observed(plan, seconds, *, backend: Optional[str] = None) -> bool:
    """Fold one observed whole-transform execution time (seconds from
    real telemetry -- ``Plan.profile``, a trace span) into the wisdom
    observed channel of the plan's problem key: a count-weighted running
    mean per candidate, and the entry's pinned backend re-argmins over
    :func:`effective_timings`. Only plans from ``planner="measure"``
    carry a ``wisdom_key``; anything else (or a forgotten key, or a
    non-positive / NaN duration) is a no-op returning False."""
    key = getattr(plan, "wisdom_key", None)
    if key is None or not (seconds > 0):
        return False
    entry = _WISDOM.get(key)
    if not isinstance(entry, dict):
        return False
    name = backend if backend is not None else getattr(plan, "backend", None)
    if not isinstance(name, str):
        return False
    obs = entry.get("observed")
    if not isinstance(obs, dict):
        obs = entry["observed"] = {}
    cell = obs.get(name)
    if _valid_observed_cell(cell):
        n = cell["n"] + 1
        cell = {"n": n, "s": (cell["s"] * cell["n"] + float(seconds)) / n}
    else:
        cell = {"n": 1, "s": float(seconds)}
    obs[name] = cell
    eff = effective_timings(entry)
    if eff:
        entry["backend"] = min(sorted(eff), key=eff.__getitem__)
    return True


def forget_wisdom() -> None:
    """Drop all accumulated wisdom (``fftw_forget_wisdom``)."""
    _WISDOM.clear()


def wisdom_size() -> int:
    return len(_WISDOM)


def wisdom_report(*, stale_ratio: float = 2.0) -> List[dict]:
    """Decision-health report over the wisdom store: one row per entry
    with each candidate's observed mean over its race time; an entry
    whose observed mean drifts more than ``stale_ratio`` x (either way)
    from its race time is flagged ``stale``."""
    rows = []
    for key, entry in wisdom_items():
        if not isinstance(entry, dict):
            continue
        timings = entry.get("timings")
        timings = timings if isinstance(timings, dict) else {}
        obs = entry.get("observed")
        obs = obs if isinstance(obs, dict) else {}
        drifts: Dict[str, float] = {}
        observed_n = 0
        for name, cell in obs.items():
            if not _valid_observed_cell(cell):
                continue
            observed_n += int(cell["n"])
            race = timings.get(name)
            if isinstance(race, (int, float)) and race > 0:
                drifts[name] = float(cell["s"]) / float(race)
        stale = any(d > stale_ratio or d < 1.0 / stale_ratio for d in drifts.values())
        rows.append({
            "key": key,
            "backend": entry.get("backend"),
            "candidates": len(timings),
            "observed_n": observed_n,
            "drifts": drifts,
            "max_drift": max(drifts.values()) if drifts else None,
            "stale": stale,
        })
    return rows


# ---------------------------------------------------------------------------
# Calibration store (fitted alpha/beta per device kind)
# ---------------------------------------------------------------------------

#: device_kind -> {"alpha_s", "beta_bytes_s", "n", "source", "backends"?}
_CALIBRATION: Dict[str, dict] = {}

#: Module override for the auto-calibrate switch; None = consult the
#: ``REPRO_AUTO_CALIBRATE`` environment variable (default on).
_AUTO_CALIBRATE: Optional[bool] = None

#: Device kinds whose auto-calibration already failed this process.
_AUTO_CALIBRATE_FAILED: set = set()


def auto_calibrate_enabled() -> bool:
    """Whether ``plan_measured`` may run the calibration sweep on a
    fresh race. Default on; ``REPRO_AUTO_CALIBRATE=0`` (the test suite
    sets it) or :func:`set_auto_calibrate` ``(False)`` disables."""
    if _AUTO_CALIBRATE is not None:
        return _AUTO_CALIBRATE
    return os.environ.get("REPRO_AUTO_CALIBRATE", "1") != "0"


def set_auto_calibrate(enabled: Optional[bool]) -> None:
    """Override the auto-calibrate switch (None = back to the env var)."""
    global _AUTO_CALIBRATE
    _AUTO_CALIBRATE = enabled


def _valid_calibration_cell(cell) -> bool:
    return (
        isinstance(cell, dict)
        and isinstance(cell.get("alpha_s"), (int, float))
        and cell["alpha_s"] >= 0
        and isinstance(cell.get("beta_bytes_s"), (int, float))
        and cell["beta_bytes_s"] > 0
    )


def _merge_calibration_cell(old, new) -> dict:
    """Count-weighted merge of two calibration cells for one device kind
    (malformed sides lose outright; never raises). Per-backend
    sub-cells union the same way."""
    if not _valid_calibration_cell(new):
        return old if _valid_calibration_cell(old) else new
    if not _valid_calibration_cell(old):
        return new
    n_old = old.get("n") if isinstance(old.get("n"), (int, float)) and old.get("n", 0) > 0 else 1
    n_new = new.get("n") if isinstance(new.get("n"), (int, float)) and new.get("n", 0) > 0 else 1
    n = n_old + n_new
    merged = dict(new)
    merged["alpha_s"] = (old["alpha_s"] * n_old + new["alpha_s"] * n_new) / n
    merged["beta_bytes_s"] = (old["beta_bytes_s"] * n_old + new["beta_bytes_s"] * n_new) / n
    merged["n"] = n
    backends = {}
    for side in (old.get("backends"), new.get("backends")):
        if not isinstance(side, dict):
            continue
        for name, sub in side.items():
            backends[name] = _merge_calibration_cell(backends.get(name), sub)
    if backends:
        merged["backends"] = backends
    return merged


def record_calibration(dev_kind: str, params, *, source: str = "calibrate", n: int = 1,
                       backends: Optional[Dict[str, object]] = None) -> dict:
    """Fold fitted constants (a ``CommParams``) into the calibration
    store, count-weighted against what is known; ``backends`` maps
    backend names to their own fits. Returns the merged cell."""
    cell = {
        "alpha_s": float(params.alpha_s),
        "beta_bytes_s": float(params.beta_bytes_s),
        "n": int(n),
        "source": source,
    }
    if backends:
        cell["backends"] = {
            name: {"alpha_s": float(p.alpha_s), "beta_bytes_s": float(p.beta_bytes_s), "n": int(n)}
            for name, p in backends.items()
        }
    merged = _merge_calibration_cell(_CALIBRATION.get(dev_kind), cell)
    _CALIBRATION[dev_kind] = merged
    return merged


def calibration_cell(dev_kind: str) -> Optional[dict]:
    """The raw stored cell for a device kind (None when uncalibrated)."""
    cell = _CALIBRATION.get(dev_kind)
    return cell if _valid_calibration_cell(cell) else None


def calibration_for(dev_kind: str, backend: Optional[str] = None):
    """Fitted constants of a device kind as a ``CommParams`` (None when
    uncalibrated: callers use the module defaults). With ``backend``,
    that backend's own fit when one is stored, else the pooled one."""
    cell = calibration_cell(dev_kind)
    if cell is None:
        return None
    from repro_torch.core import comm_model as cm

    if backend is not None:
        sub = (cell.get("backends") or {}).get(backend)
        if _valid_calibration_cell(sub):
            return cm.CommParams(alpha_s=float(sub["alpha_s"]), beta_bytes_s=float(sub["beta_bytes_s"]))
    return cm.CommParams(alpha_s=float(cell["alpha_s"]), beta_bytes_s=float(cell["beta_bytes_s"]))


def calibration_items():
    """Snapshot of the calibration store as (device_kind, cell) pairs."""
    return list(_CALIBRATION.items())


def forget_calibration() -> None:
    """Drop all stored constants (tests; paired with :func:`forget_wisdom`)."""
    _CALIBRATION.clear()
    _AUTO_CALIBRATE_FAILED.clear()


def ensure_calibrated(mesh, axis_name: Optional[str] = None, *, timer: Optional[Callable] = None,
                      sizes=None, force: bool = False):
    """Run :meth:`CommParams.calibrate` once per device kind and record
    the fit under :func:`device_kind` -- the path ``plan_measured`` takes
    on a fresh race, and the call a host makes at startup. A known
    device kind returns its stored constants without measuring
    (``force=True`` sweeps again). ``timer(m_bytes) -> seconds`` injects
    a synthetic sweep (tests). On a ``ProcessGroupMesh`` every rank
    must call it with the same arguments: the sweep is a collective."""
    from repro_torch.core import comm_model as cm

    dev = device_kind(mesh)
    if not force:
        known = calibration_for(dev)
        if known is not None:
            return known
    kwargs = {} if sizes is None else {"sizes": sizes}
    params = cm.CommParams.calibrate(mesh, axis_name, timer=timer, **kwargs)
    record_calibration(dev, params, source="calibrate")
    return params


def _auto_calibrate(mesh) -> None:
    """Best-effort once-per-device-kind calibration on the fresh-race
    path: the ranks sweep together when any of them lacks a fit (one
    all-reduce decides). A failed sweep warns once and is not retried
    for that device kind -- planning never breaks because calibration
    did."""
    dev = device_kind(mesh)
    lacking = dev not in _CALIBRATION and dev not in _AUTO_CALIBRATE_FAILED
    if not mesh.all_max([float(lacking)])[0]:
        return
    try:
        ensure_calibrated(mesh, force=True)
    except Exception as e:  # noqa: BLE001 - advisory, never fatal
        _AUTO_CALIBRATE_FAILED.add(dev)
        warnings.warn(
            f"auto-calibration failed on {dev!r} ({e}); planning continues "
            f"with default CommParams (set REPRO_AUTO_CALIBRATE=0 to silence)",
            RuntimeWarning,
            stacklevel=3,
        )


# ---------------------------------------------------------------------------
# Measured planning
# ---------------------------------------------------------------------------


def candidate_backends(p: int) -> List[str]:
    """Backends eligible for measurement at this shard count."""
    from repro_torch.core import backends

    return list(backends.supporting(p))


#: Candidate-variant separator. A plain name is the backend at the
#: caller's own pipeline setting (fused by default where streaming);
#: ``name@u`` is the unfused run of the same backend, and ``name@f<k>``
#: the fused run with an n_chunks=k sub-chunked pipeline.
VARIANT_SEP = "@"


def parse_variant(candidate: str):
    """(base_backend, pipeline_override) of a measured-candidate id;
    ``None`` override means 'the caller's own pipeline setting'."""
    if VARIANT_SEP not in candidate:
        return candidate, None
    base, _, tag = candidate.rpartition(VARIANT_SEP)
    if tag == "u":
        return base, False
    if tag.startswith("f") and tag[1:].isdigit():
        return base, int(tag[1:])
    raise ValueError(
        f"unknown measured-candidate variant {candidate!r} "
        f"(expected 'name', 'name@u' or 'name@f<n_chunks>')"
    )


def variant_id(base: str, pipeline_override) -> str:
    """Inverse of :func:`parse_variant`."""
    if pipeline_override is None:
        return base
    if pipeline_override in (False, 0):
        return f"{base}{VARIANT_SEP}u"
    return f"{base}{VARIANT_SEP}f{int(pipeline_override)}"


def predict_candidate(plan, candidate: str, pipeline="auto") -> float:
    """Model prediction of one measured candidate id: the candidate
    applied to the plan's own stage schedule
    (:func:`repro_torch.core.schedule.apply_variant`) and the rewritten
    schedule costed stage by stage."""
    import repro_torch.core.schedule as sch

    rewritten = sch.apply_variant(plan.schedule(), candidate, pipeline=pipeline)
    r_item, c_item = plan._byte_sizes()
    return sch.predict_seconds(rewritten, plan.params, plan._auto_chunk_compute_s(), r_item, c_item)


def candidate_variants(names: List[str], *, decomp: str, p: int, p_rows: int = 1, p_cols: int = 1) -> List[str]:
    """Expand plain backend candidates into (backend, n_chunks, fused)
    variants: every streaming candidate also races its unfused twin
    (``@u``) and -- slab only, to keep the pencil pair field bounded --
    a 2P-chunk sub-chunked pipeline (``@f2P``)."""
    from repro_torch.core import backends
    from repro_torch.core.plan import split_pair

    out = list(names)
    for nm in names:
        if decomp == "pencil":
            br, bc = split_pair(nm)
            streams = (backends.get(br).supports_chunk_fn and p_rows > 1) or (
                backends.get(bc).supports_chunk_fn and p_cols > 1
            )
        else:
            streams = backends.get(nm).supports_chunk_fn and p > 1
        if streams:
            out.append(f"{nm}{VARIANT_SEP}u")
            if decomp != "pencil":
                out.append(f"{nm}{VARIANT_SEP}f{2 * p}")
    return out


def candidate_pairs(p_rows: int, p_cols: int) -> List[str]:
    """Every measurable ``"row+col"`` pair for a pencil grid: the cross
    product of shard_map backends supporting each sub-ring size."""
    from repro_torch.core import backends
    from repro_torch.core.plan import pair_key

    rows = backends.supporting(p_rows, kind="shard_map")
    cols = backends.supporting(p_cols, kind="shard_map")
    return [pair_key(r, c) for r in rows for c in cols]


def _agreed_hit(mesh, names: List[str], entry) -> Optional[str]:
    """The wisdom winner every rank holds for this key, or None when any
    rank lacks a usable entry or the ranks' winners differ (one
    all-reduce): then all of them race."""
    best = entry.get("backend") if isinstance(entry, dict) else None
    timings = entry.get("timings") if isinstance(entry, dict) else None
    idx = names.index(best) if best in names and isinstance(timings, dict) and timings else -1
    hi, neg_lo = mesh.all_max([idx, -idx])
    return names[idx] if idx >= 0 and hi == -neg_lo else None


def plan_measured(
    global_shape,
    mesh,
    *,
    ndim: int = 2,
    direction: str = "forward",
    backend: str = "auto",
    axis_name: Optional[str] = None,
    local_impl: str = "torch",
    transpose_back: bool = False,
    dtype=torch.complex64,
    params=None,
    chunk_compute_s: float = 0.0,
    timer: Optional[Callable] = None,
    use_wisdom: bool = True,
    warmup: int = 1,
    iters: int = 5,
    decomp: str = "slab",
    row_axis: Optional[str] = None,
    col_axis: Optional[str] = None,
    real: bool = False,
    pad: bool = True,
    pipeline="auto",
):
    """FFTW_MEASURE: time every candidate backend on the mesh, pin the
    plan to the measured argmin, and remember the answer as wisdom.

    ``backend="auto"`` measures every registered backend supporting P --
    under ``decomp="pencil"``, every ``"row+col"`` pair of shard_map
    backends supporting the sub-ring sizes. With the default
    ``pipeline="auto"`` the field expands to (backend, n_chunks, fused)
    variants (:func:`candidate_variants`). A pinned ``backend=`` name (or
    pair) restricts the base field to that one; a variant-suffixed one
    (``"scatter@u"``) pins the pipeline too. ``timer(plan) -> seconds``
    replaces the measurement when injected. A candidate that raises is
    timed ``inf``, kept out of the argmin and reported on
    ``Plan.race_failures``. On a ``ProcessGroupMesh`` each candidate's
    seconds are the largest over the ranks (an all-reduce), so every
    rank sees the same table and pins the same winner."""
    from repro_torch.core.mesh import fft_axis
    from repro_torch.core.plan import Plan, pair_key, pipeline_is_default, split_pair

    def build(candidate) -> Plan:
        base, pipe_override = parse_variant(candidate) if isinstance(candidate, str) else (candidate, None)
        plan = Plan(
            global_shape, mesh, ndim=ndim, direction=direction, backend=base, axis_name=axis_name,
            local_impl=local_impl, transpose_back=transpose_back, dtype=dtype, params=params,
            chunk_compute_s=chunk_compute_s, decomp=decomp, row_axis=row_axis, col_axis=col_axis,
            real=real, pad=pad, pipeline=pipeline if pipe_override is None else pipe_override,
        )
        if pipe_override is not None:
            plan.backend = candidate  # report the variant it actually is
        return plan

    # one probe plan resolves decomp="auto" and the grid and validates the
    # shape once; the candidates rebuild with the resolved decomposition
    probe = build(backend)
    p = probe.shards
    pinned_pipe = None
    if isinstance(backend, str) and backend != "auto":
        backend, pinned_pipe = parse_variant(backend)
    if pinned_pipe is not None and not pipeline_is_default(pipeline):
        raise ValueError(
            f"backend variant suffix and pipeline={pipeline!r} both specify "
            f"the pipeline; pass one or the other"
        )
    race_variants = pipeline_is_default(pipeline) and pinned_pipe is None
    if probe.decomp == "pencil":
        grid = probe.grid
        if backend == "auto":
            names = candidate_pairs(grid.p_rows, grid.p_cols)
        else:
            names = [variant_id(pair_key(*split_pair(backend)), pinned_pipe)]
        if race_variants:
            names = candidate_variants(names, decomp="pencil", p=p, p_rows=grid.p_rows, p_cols=grid.p_cols)
        placement = f"decomp=pencil,grid={grid.p_rows}x{grid.p_cols},axes={grid.row_axis}+{grid.col_axis}"
    else:
        ax = axis_name or fft_axis(mesh)
        names = candidate_backends(p) if backend == "auto" else [variant_id(backend, pinned_pipe)]
        if race_variants:
            names = candidate_variants(names, decomp="slab", p=p)
        placement = f"decomp=slab,ax={ax}"
    if not names:
        raise ValueError(f"no measurable backend supports P={p}")
    decomp = probe.decomp  # pin for the candidate builds
    if decomp == "slab":
        row_axis = col_axis = None  # auto may have fallen back from pencil

    key = wisdom_key(
        tuple(global_shape),
        ndim,
        str(probe.dtype).replace("torch.", ""),  # the resolved dtype (real plans: the real side)
        p,
        tuple(names),
        device_kind(mesh),
        opts=(
            f"mesh={'x'.join(f'{k}{v}' for k, v in mesh.shape.items())},"
            f"{placement},dir={direction},impl={local_impl},"
            # the reference's fuse_dft alias; the port spells fusion pipeline=
            f"fuse=0,tb={int(transpose_back)}"
            + (f",real=1,pad={int(pad)}" if real else "")
            + ("" if race_variants else f",pipe={pipeline}")
        ),
    )
    if use_wisdom:
        entry = _WISDOM.get(key)
        best = _agreed_hit(mesh, names, entry)
        if best is not None:
            plan = build(best)  # still validates shape/mesh/backend
            timings = entry["timings"]
            plan.planner = "measure"
            plan.measured = dict(timings)
            failed = entry.get("failed")
            plan.race_failures = dict(failed) if isinstance(failed, dict) else {}
            plan.wisdom_hit = True
            plan.wisdom_key = key
            # did the observed channel (real executions) overrule the
            # plan-time race argmin?
            raw = {k: float(v) for k, v in timings.items() if isinstance(v, (int, float))}
            race_best = min(sorted(raw), key=raw.__getitem__) if raw else None
            obs = entry.get("observed")
            observed = isinstance(obs, dict) and any(_valid_observed_cell(c) for c in obs.values())
            plan.selection_channel = "observed-overlay" if observed and best != race_best else "wisdom-hit"
            return plan
        # a malformed or stale entry (or one another rank lacks) is
        # dropped, and the race below measures afresh
        _WISDOM.pop(key, None)

    # fresh race: fit this device kind's alpha/beta first (once per
    # process; REPRO_AUTO_CALIBRATE=0 disables), so the candidates price
    # with measured constants. An injected timer measures no fabric, so
    # there is nothing to calibrate against.
    if timer is None and auto_calibrate_enabled():
        _auto_calibrate(mesh)

    timer = timer or default_timer(warmup=warmup, iters=iters)
    plans: Dict[str, Plan] = {}
    timings: Dict[str, float] = {}
    failures: Dict[str, str] = {}
    for name in names:
        # a candidate that raises mid-race is timed inf, kept out of the
        # argmin and noted in Plan.why() -- on every rank, whichever one
        # it raised on
        error = None
        try:
            plans[name] = build(name)
            seconds = float(timer(plans[name]))
        except Exception as e:  # noqa: BLE001 -- race isolation boundary
            seconds, error = float("inf"), f"{type(e).__name__}: {e}"
        timings[name] = mesh.all_max([seconds])[0]
        if not math.isfinite(timings[name]):
            failures[name] = error or "failed on another rank"
    finite = {k: v for k, v in timings.items() if math.isfinite(v)}
    if not finite:
        raise RuntimeError(f"measured race: every candidate failed for {key}: {failures}")
    best = min(sorted(finite), key=finite.__getitem__)

    _WISDOM[key] = {
        "backend": best,
        # finite timings only: inf is not JSON, and a failed candidate
        # must never win a later wisdom-hit argmin
        "timings": dict(finite),  # own copy: Plan.measured stays mutable
        "device_kind": device_kind(mesh),
        **({"failed": dict(failures)} if failures else {}),
    }
    plan = plans[best]
    plan.planner = "measure"
    plan.measured = timings
    plan.race_failures = failures
    plan.wisdom_hit = False
    plan.wisdom_key = key
    plan.selection_channel = "measured-race"
    return plan
