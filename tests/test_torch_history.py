"""The port's benchmark history ledger (``repro_torch.obs.history``)
against the reference's (``repro.obs.history``): the same keys,
snapshots and regression flags on the same documents -- the committed
``BENCH_fft.json`` and ``BENCH_history.jsonl`` (read only), rows of
every tracked section, and synthetic ledgers with a 2x slowdown and with
jitter at the trajectory's own MAD scale. Ledgers are written under
``tmp_path`` only."""

import copy
import json
import os

import pytest

import repro.obs.history as ref
import repro_torch.obs.history as port
from conftest import REPO
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

BENCH = os.path.join(REPO, "BENCH_fft.json")
HISTORY = os.path.join(REPO, "BENCH_history.jsonl")
KEY = "fft2|n256,p8,scatter|measured_us"
TPS = "serve|load_sweep,n128,p8,fft2,coalesce=1,load16|tps"


def _bench():
    with open(BENCH) as fh:
        return json.load(fh)


def _snap(metrics, commit="c0"):
    return {"schema": 1, "commit": commit, "device_kind": "cpu", "timestamp": "t", "sections": {},
            "metrics": dict(metrics)}


def _ledger(values, key=KEY):
    return [_snap({key: v}, commit=f"c{i}") for i, v in enumerate(values)]


def test_schema_and_directions_are_the_references():
    assert port.HISTORY_SCHEMA == ref.HISTORY_SCHEMA == 1
    assert port.MAD_SIGMA == ref.MAD_SIGMA
    for metric in ("measured_us", "p50_us", "p99_us", "warm_first_us", "steady_p50_us", "tps", "other"):
        assert port.metric_direction(metric) == ref.metric_direction(metric)


def test_row_metrics_of_every_committed_row_equal_the_references():
    rows = _bench()["rows"]
    assert rows
    for row in rows:
        assert port.row_metrics(row) == ref.row_metrics(row), row
    keys = [k for row in rows for k, _ in port.row_metrics(row)]
    for key in keys:
        assert port.split_key(key) == ref.split_key(key)
    assert {port.split_key(k)[0] for k in keys} >= {"fft2"}


@pytest.mark.parametrize("row", [
    {"bench": "fft3_decomp", "n": 64, "p": 8, "decomp": "pencil", "grid": "4x2", "backend": "alltoall+scatter",
     "measured_us": 3.0},
    {"bench": "real", "n": 64, "p": 4, "transform": "r2c", "backend": "scatter@f4", "measured_us": 2.5},
    {"bench": "overlap", "config": "c2c", "backend": "scatter", "fused": True, "n_chunks": 4, "measured_us": 9.0},
    {"bench": "overlap", "config": "c2c", "backend": "alltoall", "fused": False, "measured_us": 9.0},
    {"bench": "serve", "row": "load_sweep", "n": 128, "p": 8, "op": "fft2", "coalesce": True, "load": 16,
     "p50_us": 10.0, "p99_us": 20.0, "tps": 500.0},
    {"bench": "serve", "row": "warm_start", "n": 128, "p": 8, "op": "fft2", "warm_first_us": 5.0,
     "steady_p50_us": 1.0},
    {"bench": "moe", "measured_us": 1.0},
    {"bench": "fft2", "n": 1, "p": 1},
    "not a dict",
])
def test_row_metrics_of_each_section_equal_the_references(row):
    assert port.row_metrics(row) == ref.row_metrics(row)


def test_snapshot_of_the_committed_bench_equals_the_references():
    doc = _bench()
    assert port.snapshot_from_bench(doc) == ref.snapshot_from_bench(doc)
    kw = dict(commit="xyz", device_kind="NVIDIA H100", timestamp="t1")
    assert port.snapshot_from_bench(doc, **kw) == ref.snapshot_from_bench(doc, **kw)
    for bad in ({}, {"rows": "x", "meta": 3}, "not a dict"):
        assert port.snapshot_from_bench(bad) == ref.snapshot_from_bench(bad)


def test_committed_ledger_reads_alike_and_gates_alike():
    hist_port, hist_ref = port.read_history(HISTORY), ref.read_history(HISTORY)
    assert hist_port == hist_ref and hist_port
    snap = ref.snapshot_from_bench(_bench())
    assert port.detect_regressions(hist_port, snap, min_snapshots=1) == ref.detect_regressions(
        hist_ref, snap, min_snapshots=1)
    slow = copy.deepcopy(snap)
    slow["metrics"] = {k: 2.0 * v if ref.metric_direction(ref.split_key(k)[2]) == "min" else 0.5 * v
                       for k, v in snap["metrics"].items()}
    flags = port.detect_regressions(hist_port, slow, min_snapshots=1)
    assert flags == ref.detect_regressions(hist_ref, slow, min_snapshots=1)


def test_ledger_written_by_one_package_reads_in_the_other(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    port.append_snapshot(path, _snap({KEY: 1.0}))
    with open(path, "a") as fh:
        fh.write("{corrupt\n\"not a dict\"\n\n")
    ref.append_snapshot(path, _snap({KEY: 2.0}, commit="c1"))
    assert port.read_history(path) == ref.read_history(path)
    assert [s["commit"] for s in port.read_history(path)] == ["c0", "c1"]
    assert port.read_history(str(tmp_path / "missing.jsonl")) == []


@pytest.mark.parametrize("history, value, key, kw, flagged", [
    ([100.0, 103.0, 97.0, 101.0, 99.0, 102.0, 98.0, 100.0], 200.0, KEY, {}, True),  # a 2x slowdown
    ([100.0, 103.0, 97.0, 101.0, 99.0, 102.0, 98.0, 100.0], 104.0, KEY, {}, False),  # MAD-level jitter
    ([100.0, 103.0, 97.0, 101.0, 99.0, 102.0, 98.0, 100.0], 50.0, KEY, {}, False),  # a speedup
    ([100.0] * 8, 120.0, KEY, {}, False),  # many sigmas, under the relative floor
    ([100.0, 300.0, 80.0, 250.0, 90.0, 280.0, 110.0, 260.0], 300.0, KEY, {}, False),  # noisy history
    ([100.0, 100.0], 1000.0, KEY, {}, False),  # the fresh-ledger guard
    ([100.0] * 3, 1000.0, KEY, {"min_snapshots": 4}, False),
    ([1000.0] * 8 + [100.0] * 8, 210.0, KEY, {"k": 8}, True),  # the rolling window
    ([1000.0] * 8 + [100.0] * 8, 210.0, KEY, {"k": 16}, False),
    ([500.0, 510.0, 490.0, 505.0], 200.0, TPS, {}, True),  # throughput halves
    ([500.0, 510.0, 490.0, 505.0], 480.0, TPS, {}, False),
])
def test_regression_flags_equal_the_references(history, value, key, kw, flagged):
    hist, snap = _ledger(history, key), _snap({key: value})
    got = port.detect_regressions(hist, snap, **kw)
    assert got == ref.detect_regressions(hist, snap, **kw)
    assert bool(got) is flagged


def test_findings_order_equals_the_references():
    k2 = "real|n256,p8,r2c,scatter|measured_us"
    hist = [_snap({KEY: 100.0, k2: 10.0}, commit=f"c{i}") for i in range(4)]
    snap = _snap({KEY: 200.0, k2: 100.0})
    got = port.detect_regressions(hist, snap)
    assert got == ref.detect_regressions(hist, snap)
    assert [f["key"] for f in got] == [k2, KEY]
