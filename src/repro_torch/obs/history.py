"""Benchmark history ledger + noise-aware regression detection -- the
port's own copy of ``repro.obs.history`` (standard library only, as
there; the same keys, schema and answers).

The paper's claims are *comparative* -- parcelport timings tracked
across backends, node counts, and runs (Figs. 4-6) -- but a single
``BENCH_fft.json`` snapshot that each run overwrites cannot show a
trajectory. This module makes performance legible over time:

- :func:`snapshot_from_bench` reduces one BENCH document (the
  ``{"schema", "meta", "rows"}`` JSON ``benchmarks/run.py --json``
  writes) to a compact snapshot record: commit, device kind, timestamp,
  the planner-accuracy score, and one scalar metric per
  ``section|config|metric`` key (:func:`row_metrics`);
- :func:`append_snapshot` appends it to an append-only JSONL ledger
  (``BENCH_history.jsonl``); :func:`read_history` loads the ledger,
  skipping malformed lines (the ledger is advisory telemetry -- a
  corrupt line must never brick the gate);
- :func:`detect_regressions` compares a new snapshot to the rolling
  median/MAD of the last K snapshots per key -- noise-aware: a value
  flags only when it exceeds BOTH the median by ``nsig`` robust sigmas
  (1.4826 * MAD) AND a relative floor (``min_ratio`` x median), so
  MAD-level jitter never trips the gate and a genuine 2x slowdown
  always does. A fresh ledger with fewer than ``min_snapshots`` prior
  points per key never false-fails (the reference's
  ``benchmarks/regress.py`` is a CLI over the same functions).

Keys are stable across runs by construction: they are derived from the
row's identifying fields (bench section, problem size, shard count,
decomposition, backend/variant, transform kind, serve load point), not
from row order.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

HISTORY_SCHEMA = 1

#: Metrics tracked per row kind. Direction "min" = lower is better
#: (regression = value rose); "max" = higher is better (tps).
_METRIC_DIRECTIONS = {
    "measured_us": "min",
    "p50_us": "min",
    "p99_us": "min",
    "warm_first_us": "min",
    "steady_p50_us": "min",
    "tps": "max",
}


def metric_direction(metric: str) -> str:
    return _METRIC_DIRECTIONS.get(metric, "min")


def _config_of(row: dict) -> Optional[str]:
    """Stable config string identifying one row within its section (the
    same identity ``benchmarks/planner_score.py`` groups races by, plus
    the backend/variant and the sweep knobs). None = untracked row."""
    bench = row.get("bench")
    if bench in ("fft2", "fft3_decomp", "real"):
        parts = [f"n{row.get('n')}", f"p{row.get('p')}"]
        if row.get("decomp"):
            parts.append(str(row["decomp"]))
        if row.get("grid"):
            parts.append(str(row["grid"]))
        if row.get("transform"):
            parts.append(str(row["transform"]))
        parts.append(str(row.get("backend")))
        return ",".join(parts)
    if bench == "overlap":
        fused = row.get("fused")
        tag = "fused" if fused else "unfused"
        if fused and row.get("n_chunks"):
            tag = f"fused{row['n_chunks']}"
        return f"{row.get('config')},{row.get('backend')},{tag}"
    if bench == "serve":
        kind = row.get("row")
        if kind == "load_sweep":
            return (
                f"load_sweep,n{row.get('n')},p{row.get('p')},{row.get('op')},"
                f"coalesce={int(bool(row.get('coalesce')))},load{row.get('load')}"
            )
        if kind == "warm_start":
            return f"warm_start,n{row.get('n')},p{row.get('p')},{row.get('op')}"
    return None


def _row_metric_names(row: dict) -> Tuple[str, ...]:
    if row.get("bench") == "serve":
        if row.get("row") == "load_sweep":
            return ("p50_us", "p99_us", "tps")
        return ("warm_first_us", "steady_p50_us")
    return ("measured_us",)


def row_metrics(row: dict) -> List[Tuple[str, float]]:
    """``[(key, value), ...]`` scalars one bench row contributes to the
    trajectory; key format ``section|config|metric``."""
    if not isinstance(row, dict):
        return []
    config = _config_of(row)
    if config is None:
        return []
    out = []
    for metric in _row_metric_names(row):
        v = row.get(metric)
        if isinstance(v, (int, float)) and v > 0:
            out.append((f"{row['bench']}|{config}|{metric}", float(v)))
    return out


def split_key(key: str) -> Tuple[str, str, str]:
    """Inverse of the key format: ``(section, config, metric)``."""
    section, _, rest = key.partition("|")
    config, _, metric = rest.rpartition("|")
    return section, config, metric


def snapshot_from_bench(
    doc: dict,
    *,
    commit: Optional[str] = None,
    device_kind: Optional[str] = None,
    timestamp: Optional[str] = None,
) -> dict:
    """Reduce one BENCH document to a ledger snapshot. ``commit`` /
    ``device_kind`` / ``timestamp`` default to the document's own meta
    fields (``run.py --json`` stamps them); pass explicitly to override."""
    meta = doc.get("meta") if isinstance(doc, dict) else None
    meta = meta if isinstance(meta, dict) else {}
    rows = doc.get("rows") if isinstance(doc, dict) else None
    rows = rows if isinstance(rows, list) else []
    metrics: Dict[str, float] = {}
    sections: Dict[str, int] = {}
    for row in rows:
        for key, value in row_metrics(row):
            metrics[key] = value
        if isinstance(row, dict) and isinstance(row.get("bench"), str):
            sections[row["bench"]] = sections.get(row["bench"], 0) + 1
    snap = {
        "schema": HISTORY_SCHEMA,
        "commit": commit or meta.get("commit") or "unknown",
        "device_kind": device_kind or meta.get("device_kind") or "unknown",
        "timestamp": timestamp or meta.get("timestamp") or "unknown",
        "sections": sections,
        "metrics": metrics,
    }
    score = meta.get("planner_score")
    if isinstance(score, dict):
        snap["planner_score"] = score
    return snap


# ---------------------------------------------------------------------------
# Ledger IO (append-only JSONL)
# ---------------------------------------------------------------------------


def append_snapshot(path: str, snap: dict) -> None:
    """Append one snapshot as a JSONL line. Append-only by design --
    history is immutable; a bad run is diagnosed, not erased."""
    line = json.dumps(snap, sort_keys=True)
    with open(path, "a") as f:
        f.write(line + "\n")


def read_history(path: str) -> List[dict]:
    """Load the ledger, oldest first. Malformed lines are skipped (the
    ledger is advisory -- same contract as the wisdom store); a missing
    file is an empty history, which the min-snapshots guard handles."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                snap = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(snap, dict) and isinstance(snap.get("metrics"), dict):
                out.append(snap)
    return out


# ---------------------------------------------------------------------------
# Noise-aware regression detection (rolling median / MAD)
# ---------------------------------------------------------------------------

#: MAD -> sigma for a normal distribution.
MAD_SIGMA = 1.4826


def _median(values: List[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    mid = n // 2
    return vs[mid] if n % 2 else 0.5 * (vs[mid - 1] + vs[mid])


def _mad(values: List[float], med: float) -> float:
    return _median([abs(v - med) for v in values])


def history_values(history: Iterable[dict], key: str, *, k: int = 8) -> List[float]:
    """The last ``k`` recorded values for one metric key, oldest first."""
    vals = []
    for snap in history:
        v = snap.get("metrics", {}).get(key)
        if isinstance(v, (int, float)) and v > 0:
            vals.append(float(v))
    return vals[-k:]


def detect_regressions(
    history: List[dict],
    snap: dict,
    *,
    k: int = 8,
    min_snapshots: int = 3,
    nsig: float = 4.0,
    min_ratio: float = 1.5,
) -> List[dict]:
    """Findings for every metric of ``snap`` that regressed against the
    rolling median/MAD of its last ``k`` historical values.

    A time-like metric (direction "min") flags when
    ``value > median + max(nsig * MAD_SIGMA * mad, (min_ratio-1) * median)``
    -- i.e. it must clear BOTH the robust noise band and a relative
    floor; a throughput metric ("max") mirrors the test downward. Keys
    with fewer than ``min_snapshots`` historical points are skipped (the
    fresh-ledger guard). Returns findings sorted worst-ratio first."""
    findings = []
    for key, value in sorted(snap.get("metrics", {}).items()):
        vals = history_values(history, key, k=k)
        if len(vals) < min_snapshots:
            continue
        med = _median(vals)
        if med <= 0:
            continue
        mad = _mad(vals, med)
        band = max(nsig * MAD_SIGMA * mad, (min_ratio - 1.0) * med)
        section, config, metric = split_key(key)
        direction = metric_direction(metric)
        if direction == "max":
            regressed = value < med - band
            ratio = med / value if value > 0 else float("inf")
        else:
            regressed = value > med + band
            ratio = value / med
        if regressed:
            findings.append(
                {
                    "key": key,
                    "section": section,
                    "config": config,
                    "metric": metric,
                    "value": value,
                    "median": med,
                    "mad": mad,
                    "ratio": ratio,
                    "n": len(vals),
                }
            )
    findings.sort(key=lambda f: -f["ratio"])
    return findings
