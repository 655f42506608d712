#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing a line; any failure exits non-zero with no result:

1. device -- require CUDA, print the card's name and power limit
   (nvidia-smi), turn TF32 off for float32 matmuls and convolutions;
2. build  -- compile the port's CUDA kernels from this checkout (nvcc,
   one process per source, all started together);
3. kernels -- call each kernel's wrapper at the shapes the main path
   gives it, hold the result against its plain PyTorch version on the
   same inputs, and time kernel, plain version and library yardstick
   (a PyTorch call the port itself never makes) beside the bound:
   max(FLOPs / peak, bytes / HBM rate) at NVIDIA's H100 SXM data-sheet
   rates -- for the two 3xTF32 stage kernels both the fp32 CUDA-core
   bound and the tensor-core one (3 x FLOPs / TF32 peak, their
   ``bound_ms``); chunk_twiddle_pack_c64 in both modes (fresh, and
   accumulating into ``out=``) on each chunk layout the paths hand it,
   beside torch.mul / Tensor.addcmul_ and the fresh pack followed by
   Tensor.add_ (the exchange's path for a chunk_fn without ``out``);
   then fft_last_axis, and its glue (its time minus the two stage
   kernels');
4. main path -- plan_fft((16384, 16384), SimMesh(4), backend="scatter",
   local_impl="kernel"): the paper's slab fft2 over the N-scatter ring
   with the next FFT pass fused into the arriving chunks, on a 2 GiB
   complex64 array made on the card from --seed. The kernels' launch
   counters are zeroed just before the first execute and read just
   after it; the output is held against torch.fft.fft2(x).mT, the
   inverse must round-trip, and the unfused alltoall plan must agree;
5. real Poisson -- solve_poisson on a real 16384 x 16384 float32 field
   (1 GiB) through plan_fft(real=True, backend="scatter",
   local_impl="kernel") on SimMesh(4), fused: held against a float64
   torch.fft solve of the same field, the rfft2 / irfft2 round trip
   against torch.fft.rfft2;
6. rfft3 -- plan_fft((1024,) * 3, SimMesh(4), ndim=3, real=True) on a
   4 GiB float32 cube, held against torch.fft.rfftn, and its inverse;
7. NCCL -- one process per visible card (torch.multiprocessing.spawn),
   each a rank of a ProcessGroupMesh over NCCL running the c2c main
   path and phase 5's real solve on its own block, through the fused
   scatter ring, the unfused ring and the unfused alltoall; every rank
   holds the gathered result against SimMesh(P) on the same seed. On a
   machine with several cards this is the exchanges' comparison over
   NVLink. Then the ranks join a grid of auto_grid_shape(P) with one
   NCCL subgroup per ring of each axis and run phase 8's fused and
   unfused pencil plans on their own blocks, held against SimMesh with
   the same grid (one card: a 1x1 grid, no message moves);
8. pencil c2c -- plan_fft((16384, 16384), SimMesh((2, 2)),
   decomp="pencil", backend=("scatter", "scatter"), local_impl="kernel"),
   fused, on phase 4's 2 GiB array: held against torch.fft.fft2(x) (the
   natural layout), the inverse must round-trip, the unfused
   ("alltoall", "alltoall") plan must agree; timed beside phase 4's slab
   plan on the same transform;
9. pencil rfft3 -- plan_fft((1024,) * 3, SimMesh((2, 2)), ndim=3,
   real=True, decomp="pencil", backend="scatter") on phase 6's 4 GiB
   cube: the reversed layout with the Hermitian axis padded over P_col
   (513 -> 514), its first 513 entries held against
   torch.fft.rfftn(x).permute(2, 1, 0), and its inverse; timed beside
   phase 6's slab rfft3;
10. measured planner -- planner.ensure_calibrated(SimMesh(4)) (a device
   copy's fit, stored under "<card> (SimMesh)"), then
   plan_fft((16384, 16384), SimMesh(4), planner="measure",
   local_impl="kernel"): the race's timing table, why_text() and launch
   counts (it fails unless the race launched all three kernels); the
   winner held against torch.fft.fft2(x).mT; profile()'s per-stage rows
   of the winner and of phase 4's plan beside their plan.execute times,
   and roofline().as_dict().

Phase 7 also fits alpha and beta per rank over NCCL (the default sizes,
and sizes up to 64 MiB; on one card a rank's message to itself, a
copy), prints the backend="auto" pick under the fitted constants, and
races planner="measure" on the c2c main path: it fails unless every
rank names the same winner, whose result equals SimMesh's to 1e-6.

Phases 4-9 each zero the kernels' launch counters just before they run
and read them just after, the pack's split by mode; each fails if a
kernel of its path was never launched (at P = 1 a plan does not fuse,
so phase 7 launches the two stages only), phase 4 if its exchange did
not pack P own chunks fresh and P(P-1) arrivals accumulating, and
phases 8-9 if the path's peak memory reaches 40 GiB. Phases 4-6 and 8-9
print the shapes each kernel was launched at and time each kernel once
at every shape not timed before. Kernel times are CUDA-event medians of
runs of back-to-back calls. The second-to-last line is one JSON object
with a row per kernel, the pack's accumulate mode a row of its own
(``chunk_twiddle_pack_c64 accumulate``); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = 16384  # global (N, N) complex64: 2 GiB
P = 4  # simulated ranks
N3 = 1024  # the rfft3 phase: a (N3, N3, N3) float32 cube, 4 GiB
GRID = (2, 2)  # the pencil phases' simulated grid, (P_row, P_col)
GRID_AXES = ("rows", "cols")
PEAK_LIMIT_GIB = 40.0  # a path's peak device memory, of the 80 GB card
#: the launch shapes (fft_stage.SHAPES keys) phase 3 times each kernel at
KERNEL_PHASE_SHAPES = {
    "stage_left": {(4096, 512, 512, 32), (16384, 512, 512, 8)},
    "stage_right": {(4096, 512, 32, 32), (16384, 512, 8, 8)},
    "chunk_twiddle_pack_c64": {(1, N // P, N // P, P, mode, unit)
                               for mode in ("fresh", "accumulate") for unit in ("cols", "rows")},
}
PACK = "chunk_twiddle_pack_c64"
PACK_MODES = ("fresh", "accumulate")
NCCL_TIMEOUT_S = 300  # the process group's timeout in the NCCL phase
#: phase 7's second calibration sweep: past the default's 4 MiB to the
#: tens of MiB the slab exchanges send (128 MiB per message at P = 4)
NCCL_FIT_SIZES = (4096, 65536, 1 << 20, 4 << 20, 16 << 20, 64 << 20)
MAIN_PATH_REL_TOL = 1e-4  # two fp32 four-step passes at K = 512, float64-built tables
STAGE_RTOL, STAGE_ATOL = 2e-4, 2e-3  # the reference's per-stage tolerances
PACK_RTOL, PACK_ATOL = 1e-5, 1e-5  # one complex multiply per element
FFT_REL_TOL = 2e-5  # fft_last_axis vs the library FFT, relative to max


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over ``reps`` of the device ms per call of a run of
    back-to-back calls fenced by one pair of CUDA events: as many calls
    as fill ~2.5 ms (1 to 20), so the host's time to issue a call -- a
    wrapper's checks and allocation -- overlaps the kernels instead of
    leaving the card idle inside the fence."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    n = max(1, min(20, math.ceil(2.5 / max(run(1), 1e-3))))
    return statistics.median(run(n) for _ in range(reps))


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn()`` followed by a synchronize, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(torch, got, exp) -> float:
    return ((got - exp).abs().max() / exp.abs().max()).item()


def counted(torch, fft_stage, label: str, fn, expect=None):
    """Run ``fn`` with the launch counters zeroed just before and read
    just after; fail if a kernel of ``expect`` (default: all) was never
    launched. Returns (fn's result, launches, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fft_stage.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(fft_stage.LAUNCHES)
    for mode in PACK_MODES:  # the pack's launches split by mode (fft_stage.SHAPES keys)
        launches[f"{PACK} {mode}"] = sum(n for key, n in fft_stage.SHAPES[PACK].items() if key[4] == mode)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in fft_stage.LAUNCHES if expect is None else expect:
        check(launches[name] > 0, f"kernel {name} was not launched on the {label} path")
    return out, launches, peak


def bound(flops: float, nbytes: float, cm, peak: float = None):
    """(ms, "operations" | "bytes"): the least time for ``flops`` at
    ``peak`` (default: the fp32 CUDA-core peak) and ``nbytes`` at the HBM
    rate."""
    t_ops = flops / (peak or cm.PEAK_FLOPS_FP32)
    t_bytes = nbytes / cm.HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def pack_bound(b: int, rows: int, c: int, p: int, mode: str, cm):
    """(ms, by) of chunk_twiddle_pack_c64 on a (b, rows, c) chunk and m
    (p, rows): the chunk and m read once, the (b, c, p, rows) result
    written once -- and in accumulate mode read once too; one complex
    multiply (6 FLOPs) per output, and a complex add (2) to accumulate."""
    out = b * c * p * rows
    acc = mode == "accumulate"
    return bound((8.0 if acc else 6.0) * out, 8.0 * (b * rows * c + p * rows + (2 if acc else 1) * out), cm)


def tensor_core_bounds(row, flops, nbytes, cm):
    """Both bounds of a 3xTF32 tensor-core stage: the fp32 CUDA-core one
    and the tensor-core one (three TF32 products per fp32 product). The
    kernel runs on the tensor cores, so ``bound_ms`` is the latter."""
    row["bound_fp32_ms"], row["bound_fp32_by"] = bound(flops, nbytes, cm)
    row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, cm, cm.PEAK_FLOPS_TF32)
    row["bound_units"] = "3xTF32 tensor cores (mma.sync m16n8k8)"


def kernel_phase(torch, g, fft_stage, ref, ops, lf, cm):
    """Each kernel against its plain version at the main path's shapes."""
    dev = "cuda"
    rows = []

    def crand(*shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=g)

    def compare(got, exp, rtol, atol):
        got, exp = torch.view_as_real(got), torch.view_as_real(exp)
        return (got - exp).abs().max().item(), torch.allclose(got, exp, rtol=rtol, atol=atol)

    # stage_left: W (512, 512), A (B, 512, n2), T (512, n2) at both main-path
    # passes: (B=4096, n2=32) per rank before the exchange -- the row of the
    # JSON line -- and (B=16384, n2=8) after it
    timed = []
    for b, n2 in ((4096, 32), (16384, 8)):
        w = lf.dft_matrix(512, device=dev)
        t = lf.twiddle(512, n2, device=dev)
        a = crand(b, 512, n2)
        err, ok = compare(fft_stage.stage_left_c64(w, a, t), ref.stage_left_c64_ref(w, a, t), STAGE_RTOL, STAGE_ATOL)
        ms = median_ms(torch, lambda: fft_stage.stage_left_c64(w, a, t))
        lib_ms = median_ms(torch, lambda: torch.matmul(w, a) * t)
        print(f"kernel stage_left {(b, 512, 512, n2)}: max_abs_err={err:.3e} "
              f"(tol rtol={STAGE_RTOL} atol={STAGE_ATOL}) {'ok' if ok else 'MISMATCH'} ms={ms:.4f} "
              f"library_ms={lib_ms:.4f}", flush=True)
        check(ok, f"stage_left disagrees with its plain version at {(b, 512, n2)}")
        timed.append((w, a, t, err, ms, lib_ms))
    w, a, t, err, ms, lib_ms = timed[0]
    B, K, Nn = a.shape
    M = w.shape[0]
    flops = 8.0 * B * M * K * Nn + 6.0 * B * M * Nn
    nbytes = 8.0 * (M * K + B * K * Nn + M * Nn + B * M * Nn)
    rows.append(dict(
        name="stage_left", route="cuda", source="src/repro_torch/kernels/csrc/fft_stage.cu",
        replaces="src/repro/kernels/fft_stage.py:106", shape=[B, M, K, Nn], max_abs_err=err, ms=ms,
        ms_second_pass=timed[1][4], library_ms_second_pass=timed[1][5],
        plain_ms=median_ms(torch, lambda: ref.stage_left_c64_ref(w, a, t)),
        library="torch.matmul then * (two calls)", library_ms=lib_ms,
    ))
    tensor_core_bounds(rows[-1], flops, nbytes, cm)
    del timed, w, a, t

    # stage_right: A (B, 512, n2) @ W (n2, n2)^T, chained after stage_left
    timed = []
    for b, n2 in ((4096, 32), (16384, 8)):
        a = crand(b, 512, n2)
        w = lf.dft_matrix(n2, device=dev)
        err, ok = compare(fft_stage.stage_right_c64(a, w), ref.stage_right_c64_ref(a, w), STAGE_RTOL, STAGE_ATOL)
        ms = median_ms(torch, lambda: fft_stage.stage_right_c64(a, w))
        lib_ms = median_ms(torch, lambda: torch.matmul(a, w.T))
        print(f"kernel stage_right {(b, 512, n2, n2)}: max_abs_err={err:.3e} "
              f"(tol rtol={STAGE_RTOL} atol={STAGE_ATOL}) {'ok' if ok else 'MISMATCH'} ms={ms:.4f} "
              f"library_ms={lib_ms:.4f}", flush=True)
        check(ok, f"stage_right disagrees with its plain version at {(b, 512, n2)}")
        timed.append((a, w, err, ms, lib_ms))
    a, w, err, ms, lib_ms = timed[0]
    B, M, K = a.shape
    Nn = w.shape[0]
    flops = 8.0 * B * M * K * Nn
    nbytes = 8.0 * (B * M * K + Nn * K + B * M * Nn)
    rows.append(dict(
        name="stage_right", route="cuda", source="src/repro_torch/kernels/csrc/fft_stage.cu",
        replaces="src/repro/kernels/fft_stage.py:214", shape=[B, M, K, Nn], max_abs_err=err, ms=ms,
        ms_second_pass=timed[1][3], library_ms_second_pass=timed[1][4],
        plain_ms=median_ms(torch, lambda: ref.stage_right_c64_ref(a, w)),
        library="torch.matmul", library_ms=lib_ms,
    ))
    tensor_core_bounds(rows[-1], flops, nbytes, cm)
    del timed, a, w

    # chunk_twiddle_pack_c64 at the main path's shape, chunk (r, c) = (4096, 4096),
    # m (P, 4096), accumulator (4096, P, 4096): both modes against the plain
    # version on every chunk layout the paths hand it -- a received (contiguous)
    # chunk, the own chunk as a strided view of the rank's (4096, 16384) block, a
    # chunk unit-stride along its rows (the pencil fft2's transposed own chunk) --
    # and an accumulator that is a sub-chunk's column slot of a wider one
    r, c = N // P, N // P
    block = crand(r, N)
    m = crand(P, r)
    acc0 = crand(c, P, r)
    chunks = {"received": block[:, c:2 * c].contiguous(), "own, strided": block[:, :c],
              "transposed": crand(c, r).mT}
    wide = crand(c, P, 2 * r)
    accs = {"contiguous": acc0, "slot": wide[..., r:]}
    errs = {mode: 0.0 for mode in PACK_MODES}
    for label, chunk in chunks.items():
        got, exp = fft_stage.chunk_twiddle_pack_c64(chunk, m), ref.chunk_twiddle_pack_ref(chunk, m)
        err, ok = compare(got, exp, PACK_RTOL, PACK_ATOL)
        errs["fresh"] = max(errs["fresh"], err)
        print(f"kernel {PACK} fresh {(r, c)}x{P} ({label}): max_abs_err={err:.3e} "
              f"(tol rtol={PACK_RTOL} atol={PACK_ATOL}) {'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"{PACK} (fresh) disagrees with its plain version ({label})")
        for acc_label, acc in accs.items():
            if acc_label == "slot" and label != "received":
                continue
            out = acc.clone()
            check(fft_stage.chunk_twiddle_pack_c64(chunk, m, out=out) is out, f"{PACK} did not return out")
            err, ok = compare(out, acc.clone().add_(exp), PACK_RTOL, PACK_ATOL)
            errs["accumulate"] = max(errs["accumulate"], err)
            print(f"kernel {PACK} accumulate {(r, c)}x{P} ({label}, {acc_label} accumulator): "
                  f"max_abs_err={err:.3e} (tol rtol={PACK_RTOL} atol={PACK_ATOL}) {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            check(ok, f"{PACK} (accumulate) disagrees with its plain version ({label}, {acc_label})")
        del got, exp, out
    chunk, out = chunks["received"], acc0.clone()

    def pack(acc=None, ch=chunk):
        return fft_stage.chunk_twiddle_pack_c64(ch, m, out=acc)

    times = {mode: {label: median_ms(torch, lambda: pack(ch=ch, acc=None if mode == "fresh" else out))
                    for label, ch in chunks.items()} for mode in PACK_MODES}
    times["accumulate"]["received, slot accumulator"] = median_ms(torch, lambda: pack(acc=accs["slot"]))
    yardsticks = {
        "fresh": ("torch.mul, broadcast over a transposed view (one call)",
                  lambda: torch.mul(chunk.mT.unsqueeze(-2), m), lambda: ref.chunk_twiddle_pack_ref(chunk, m)),
        "accumulate": ("Tensor.addcmul_, broadcast over a transposed view (one call)",
                       lambda: out.addcmul_(chunk.mT.unsqueeze(-2), m),
                       lambda: ref.chunk_twiddle_pack_ref(chunk, m, out=out)),
    }
    for mode in PACK_MODES:
        library, lib_fn, plain_fn = yardsticks[mode]
        ms_bound, by = pack_bound(1, r, c, P, mode, cm)
        rows.append(dict(
            name=PACK if mode == "fresh" else f"{PACK} {mode}", mode=mode, route="cuda", source="src/repro_torch/kernels/csrc/fft_stage.cu",
            replaces="src/repro/kernels/fft_stage.py:171", shape=[1, r, c, P], max_abs_err=errs[mode],
            ms=times[mode]["received"], ms_by_chunk=times[mode], plain_ms=median_ms(torch, plain_fn),
            library=library, library_ms=median_ms(torch, lib_fn), bound_ms=ms_bound, bound_by=by,
        ))
    # an arrival's work for a chunk_fn without out: a fresh pack, then the add
    rows[-1]["pair"] = "the fresh pack then Tensor.add_"
    rows[-1]["pair_ms"] = median_ms(torch, lambda: out.add_(pack()))
    del block, chunks, chunk, m, acc0, accs, wide, out
    # the pair as fft_last_axis (the LocalFFT of the main path) vs the library FFT;
    # its glue is its time minus the two stage kernels' at the same shapes
    x = crand(N // P, N)
    y, exp = ops.fft_last_axis(x), torch.fft.fft(x)
    rel = ((y - exp).abs().max() / exp.abs().max()).item()
    del y, exp
    fft_ms = median_ms(torch, lambda: ops.fft_last_axis(x), reps=5)
    glue_ms = fft_ms - rows[0]["ms"] - rows[1]["ms"]
    print(f"fft_last_axis {tuple(x.shape)} (stage_left + stage_right): rel_err={rel:.3e} "
          f"(tol {FFT_REL_TOL}) ms={fft_ms:.3f} glue_ms={glue_ms:.3f} "
          f"torch.fft.fft ms={median_ms(torch, lambda: torch.fft.fft(x), reps=5):.3f}", flush=True)
    check(rel <= FFT_REL_TOL, "fft_last_axis disagrees with torch.fft.fft")
    for row in rows:
        extra = (f" bound_fp32_ms={row['bound_fp32_ms']:.4f} ({row['bound_fp32_by']}, fp32 CUDA cores) "
                 f"second pass ms={row['ms_second_pass']:.4f} library_ms={row['library_ms_second_pass']:.4f}"
                 if "bound_fp32_ms" in row else "")
        if "ms_by_chunk" in row:
            extra = " by chunk " + ", ".join(f"{k} {v:.4f}" for k, v in row["ms_by_chunk"].items())
            if "pair_ms" in row:
                extra += f"; pair ({row['pair']}) ms={row['pair_ms']:.4f}"
        print(f"kernel {row['name']} {tuple(row['shape'])}: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} ({row['library']}) bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}, {row.get('bound_units', 'fp32 CUDA cores')}){extra}", flush=True)
    return rows


def main_input(torch, seed: int):
    """The main path's (N, N) complex64 array, drawn on the card from a
    fresh generator at ``seed`` (phase 8 transforms the same array)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randn((N, N), dtype=torch.complex64, device="cuda", generator=g)


def cube_input(torch, seed: int):
    """The rfft3 phases' (N3, N3, N3) float32 cube, drawn likewise
    (phases 6 and 9 transform the same cube)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randn((N3, N3, N3), dtype=torch.float32, device="cuda", generator=g)


def main_path(torch, seed, fft_stage, plan_fft, SimMesh):
    x = main_input(torch, seed)
    plan = plan_fft((N, N), SimMesh(P), backend="scatter", local_impl="kernel")
    check(plan.fused, "the scatter plan did not resolve to the fused pipeline")
    t0 = time.perf_counter()
    y, launches, peak = counted(torch, fft_stage, "main", lambda: plan.execute(x))
    first_s = time.perf_counter() - t0
    shapes = launch_shapes(fft_stage)
    print(f"main path: {plan!r} fused={plan.fused} first execute {first_s * 1e3:.1f} ms, "
          f"launches {launches}, peak memory {peak:.2f} GiB", flush=True)
    print_shapes("main path", shapes)
    # one fused exchange: each rank's own chunk writes its accumulator, the
    # P - 1 arriving chunks add into it
    check(launches[f"{PACK} fresh"] == P and launches[f"{PACK} accumulate"] == P * (P - 1),
          f"the fused exchange did not pack {P} own chunks fresh and {P * (P - 1)} arrivals accumulating")

    oracle = torch.fft.fft2(x).mT
    scale = oracle.abs().max().item()
    err = (y - oracle).abs().max().item() / scale
    print(f"main path vs torch.fft.fft2(x).mT: rel_err={err:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(err <= MAIN_PATH_REL_TOL, "main path disagrees with torch.fft.fft2")
    check(tuple(y.shape) == (N, N) and bool(torch.isfinite(torch.view_as_real(y)).all()),
          "main path output is not finite with the expected shape")

    z = plan.inverse(y)
    rt = ((z - x).abs().max() / x.abs().max()).item()
    print(f"main path inverse round trip: rel_err={rt:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(rt <= MAIN_PATH_REL_TOL, "plan.inverse does not round-trip")
    del z

    a2a = plan_fft((N, N), SimMesh(P), backend="alltoall", pipeline=False, local_impl="kernel")
    y2 = a2a.execute(x)
    err2 = (y2 - oracle).abs().max().item() / scale
    print(f"alltoall pipeline=False vs torch.fft.fft2(x).mT: rel_err={err2:.3e} (tol {MAIN_PATH_REL_TOL})",
          flush=True)
    check(err2 <= MAIN_PATH_REL_TOL, "the unfused alltoall plan disagrees with torch.fft.fft2")
    del y2, oracle, y

    ms_scatter = host_ms(torch, lambda: plan.execute(x))
    ms_a2a = host_ms(torch, lambda: a2a.execute(x))
    ms_lib = median_ms(torch, lambda: torch.fft.fft2(x), reps=5)
    print(f"main path timing: plan.execute scatter fused {ms_scatter:.2f} ms, alltoall unfused "
          f"{ms_a2a:.2f} ms, torch.fft.fft2 {ms_lib:.2f} ms (median of 3 / 3 / 5), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, shapes, ms_scatter


def poisson_oracle(torch, f):
    """The float64 torch.fft solve of laplacian(u) = f on the periodic
    (2 pi)^2 box, zero mean."""
    n0, n1 = f.shape
    fh = torch.fft.rfft2(f.double())
    k0 = torch.fft.fftfreq(n0, d=1.0 / n0, dtype=torch.float64, device=f.device)[:, None]
    k1 = torch.fft.rfftfreq(n1, d=1.0 / n1, dtype=torch.float64, device=f.device)[None, :]
    k2 = k0 * k0 + k1 * k1
    k2[0, 0] = 1.0
    fh = -fh / k2
    fh[0, 0] = 0.0
    return torch.fft.irfft2(fh, s=(n0, n1))


def real_poisson(torch, g, fft_stage, plan_fft, SimMesh, solve_poisson):
    """Phase 5: the real Poisson solve at 16384^2 on SimMesh(4)."""
    f = torch.randn((N, N), dtype=torch.float32, device="cuda", generator=g)
    plan = plan_fft((N, N), SimMesh(P), real=True, backend="scatter", local_impl="kernel")
    check(plan.fused and plan.real, "the real scatter plan did not resolve to the fused r2c pipeline")
    u, launches, peak = counted(torch, fft_stage, "real Poisson", lambda: solve_poisson(f, plan))
    shapes = launch_shapes(fft_stage)
    print(f"real Poisson: {plan!r} fused={plan.fused} H={plan.hermitian_len} Hp={plan.padded_hermitian_len}, "
          f"launches {launches}, peak memory {peak:.2f} GiB", flush=True)
    check(tuple(u.shape) == (N, N) and u.dtype == torch.float32 and bool(torch.isfinite(u).all()),
          "the Poisson solution is not a finite float32 field of the input's shape")
    exp = poisson_oracle(torch, f)
    err = rel_err(torch, u.double(), exp)
    print(f"real Poisson vs float64 torch.fft solve: rel_err={err:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(err <= MAIN_PATH_REL_TOL, "solve_poisson disagrees with the float64 torch.fft solve")
    del u, exp

    y = plan.execute(f)
    ref = torch.fft.rfft2(f).mT
    h = plan.hermitian_len
    err = rel_err(torch, y[:h], ref)
    check(not y[h:].any(), "the padded Hermitian rows are not zero")
    z = plan.inverse(y)
    rt = rel_err(torch, z, f)
    print(f"rfft2 vs torch.fft.rfft2(x).mT: rel_err={err:.3e}; irfft2 round trip rel_err={rt:.3e} "
          f"(tol {MAIN_PATH_REL_TOL})", flush=True)
    check(err <= MAIN_PATH_REL_TOL and rt <= MAIN_PATH_REL_TOL, "rfft2/irfft2 disagree with torch.fft")
    del z, ref
    ms = host_ms(torch, lambda: plan.execute(f))
    ms_inv = host_ms(torch, lambda: plan.inverse(y))
    del y
    ms_solve = host_ms(torch, lambda: solve_poisson(f, plan))
    ms_lib = median_ms(torch, lambda: torch.fft.rfft2(f), reps=5)
    print(f"real Poisson timing: plan.execute (rfft2) {ms:.2f} ms, plan.inverse (irfft2) {ms_inv:.2f} ms, "
          f"solve_poisson {ms_solve:.2f} ms (median of 3), torch.fft.rfft2 {ms_lib:.2f} ms (median of 5), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print_shapes("real Poisson", shapes)
    return launches, shapes


def rfft3_phase(torch, seed, fft_stage, plan_fft, SimMesh):
    """Phase 6: rfft3 / irfft3 of a 1024^3 float32 cube on SimMesh(4)."""
    x = cube_input(torch, seed)
    plan = plan_fft(tuple(x.shape), SimMesh(P), ndim=3, real=True, backend="scatter", local_impl="kernel")
    y, launches, peak = counted(torch, fft_stage, "rfft3", lambda: plan.execute(x))
    shapes = launch_shapes(fft_stage)
    print(f"rfft3: {plan!r} fused={plan.fused} Hp={plan.padded_hermitian_len}, launches {launches}, "
          f"peak memory {peak:.2f} GiB", flush=True)
    check(tuple(y.shape) == (N3, N3, N3 // 2 + 1), "rfft3 output has the wrong shape")
    err = rel_err(torch, y, torch.fft.rfftn(x))
    print(f"rfft3 vs torch.fft.rfftn: rel_err={err:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(err <= MAIN_PATH_REL_TOL, "rfft3 disagrees with torch.fft.rfftn")
    z = plan.inverse(y)
    rt = rel_err(torch, z, x)
    print(f"irfft3 round trip: rel_err={rt:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(rt <= MAIN_PATH_REL_TOL, "irfft3 does not round-trip")
    del y, z
    ms = host_ms(torch, lambda: plan.execute(x))
    ms_lib = median_ms(torch, lambda: torch.fft.rfftn(x), reps=5)
    print(f"rfft3 timing: plan.execute {ms:.2f} ms (median of 3), torch.fft.rfftn {ms_lib:.2f} ms "
          f"(median of 5), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print_shapes("rfft3", shapes)
    return launches, shapes, ms


def launch_shapes(fft_stage) -> dict:
    """Kernel name -> {launch shape: launches} of the run just counted."""
    return {name: dict(shapes) for name, shapes in fft_stage.SHAPES.items()}


def print_shapes(label: str, shapes: dict) -> None:
    for name, by_shape in shapes.items():
        listed = ", ".join(f"{shape} x{n}" for shape, n in sorted(by_shape.items()))
        print(f"{label} launch shapes {name}: {listed or 'none'}", flush=True)


def check_peak(label: str, peak: float, what: str) -> None:
    print(f"{label}: peak memory {peak:.2f} GiB ({what}; limit {PEAK_LIMIT_GIB:.0f})", flush=True)
    check(peak < PEAK_LIMIT_GIB, f"{label} peaked at {peak:.2f} GiB, over {PEAK_LIMIT_GIB} GiB")


def time_launch_shapes(torch, g, fft_stage, ref, lf, cm, label: str, shapes: dict, done: set) -> None:
    """Each kernel once at every shape of ``shapes`` not in ``done`` (the
    (kernel, shape) pairs timed already, phase 3's included; the new ones
    are added): held against its plain version on random inputs, then
    kernel and plain timed (CUDA events, median of 5) beside the bound.
    A pack shape carries its mode and chunk layout."""
    def crand(*shape):
        return torch.randn(shape, dtype=torch.complex64, device="cuda", generator=g)

    for name, by_shape in shapes.items():
        for shape in sorted(set(by_shape) - {s for n, s in done if n == name}):
            done.add((name, shape))
            if name == "stage_left":
                b, m, k, n = shape
                w, a, t = lf.dft_matrix(m, device="cuda"), crand(b, k, n), lf.twiddle(m, n, device="cuda")
                run, plain = (lambda: fft_stage.stage_left_c64(w, a, t)), (lambda: ref.stage_left_c64_ref(w, a, t))
                flops, nbytes = 8.0 * b * m * k * n + 6.0 * b * m * n, 8.0 * (m * k + b * k * n + m * n + b * m * n)
                tol, (ms_bound, by) = (STAGE_RTOL, STAGE_ATOL), bound(3 * flops, nbytes, cm, cm.PEAK_FLOPS_TF32)
                check_pair = (run, plain)
            elif name == "stage_right":
                b, m, k, n = shape
                a, w = crand(b, m, k), lf.dft_matrix(n, device="cuda")
                run, plain = (lambda: fft_stage.stage_right_c64(a, w)), (lambda: ref.stage_right_c64_ref(a, w))
                flops, nbytes = 8.0 * b * m * k * n, 8.0 * (b * m * k + n * k + b * m * n)
                tol, (ms_bound, by) = (STAGE_RTOL, STAGE_ATOL), bound(3 * flops, nbytes, cm, cm.PEAK_FLOPS_TF32)
                check_pair = (run, plain)
            else:
                b, rows, c, p, mode, unit = shape
                chunk = crand(b, rows, c) if unit == "cols" else crand(b, c, rows).mT
                m, acc = crand(p, rows), (crand(b, c, p, rows) if mode == "accumulate" else None)
                out = None if acc is None else acc.clone()
                run = lambda: fft_stage.chunk_twiddle_pack_c64(chunk, m, out=out)  # noqa: E731
                plain = lambda: ref.chunk_twiddle_pack_ref(chunk, m, out=out)  # noqa: E731
                check_pair = (run, lambda: ref.chunk_twiddle_pack_ref(chunk, m, out=None if acc is None else acc.clone()))
                tol, (ms_bound, by) = (PACK_RTOL, PACK_ATOL), pack_bound(b, rows, c, p, mode, cm)
            got, exp = (torch.view_as_real(fn()) for fn in check_pair)
            err = (got - exp).abs().max().item()
            ok = torch.allclose(got, exp, rtol=tol[0], atol=tol[1])
            del got, exp
            ms, plain_ms = median_ms(torch, run, reps=5), median_ms(torch, plain, reps=5)
            print(f"kernel {name} {shape} (launched {by_shape[shape]}x on the {label} path): max_abs_err={err:.3e} "
                  f"(tol rtol={tol[0]} atol={tol[1]}) {'ok' if ok else 'MISMATCH'} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={ms_bound:.4f} ({by})", flush=True)
            check(ok, f"{name} disagrees with its plain version at {shape}")
            del run, plain, check_pair
            torch.cuda.empty_cache()


def pencil_c2c_phase(torch, seed, fft_stage, plan_fft, SimMesh, slab_ms: float):
    """Phase 8: the c2c main path's transform of the same array as a 2x2
    pencil plan."""
    x = main_input(torch, seed)
    mesh = SimMesh(GRID, axis_names=GRID_AXES)
    plan = plan_fft((N, N), mesh, decomp="pencil", backend=("scatter", "scatter"), local_impl="kernel")
    check(plan.fused, "the pencil scatter plan did not resolve to the fused pipeline")
    y, launches, peak = counted(torch, fft_stage, "pencil c2c", lambda: plan.execute(x))
    shapes = launch_shapes(fft_stage)
    print(f"pencil c2c: {plan!r} fused={plan.fused}, launches {launches}", flush=True)
    print_shapes("pencil c2c", shapes)
    check_peak("pencil c2c", peak, "plan.execute")
    check(tuple(y.shape) == (N, N) and bool(torch.isfinite(torch.view_as_real(y)).all()),
          "the pencil output is not finite with the expected shape")
    oracle = torch.fft.fft2(x)
    err = rel_err(torch, y, oracle)
    print(f"pencil c2c vs torch.fft.fft2(x): rel_err={err:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(err <= MAIN_PATH_REL_TOL, "the pencil plan disagrees with torch.fft.fft2")
    z = plan.inverse(y)
    rt = rel_err(torch, z, x)
    print(f"pencil c2c inverse round trip: rel_err={rt:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(rt <= MAIN_PATH_REL_TOL, "the pencil plan.inverse does not round-trip")
    del z, y
    a2a = plan_fft((N, N), mesh, decomp="pencil", backend=("alltoall", "alltoall"), pipeline=False,
                   local_impl="kernel")
    err2 = rel_err(torch, a2a.execute(x), oracle)
    print(f"pencil alltoall+alltoall pipeline=False vs torch.fft.fft2(x): rel_err={err2:.3e} "
          f"(tol {MAIN_PATH_REL_TOL})", flush=True)
    check(err2 <= MAIN_PATH_REL_TOL, "the unfused pencil plan disagrees with torch.fft.fft2")
    del oracle
    ms = host_ms(torch, lambda: plan.execute(x))
    ms_a2a = host_ms(torch, lambda: a2a.execute(x))
    print(f"pencil c2c timing: plan.execute scatter+scatter fused {ms:.2f} ms, alltoall+alltoall unfused "
          f"{ms_a2a:.2f} ms (median of 3); slab scatter fused (phase 4) {slab_ms:.2f} ms on the same transform",
          flush=True)
    check_peak("pencil c2c", torch.cuda.max_memory_allocated() / 2**30, "the whole phase")
    return launches, shapes


def pencil_rfft3_phase(torch, seed, fft_stage, plan_fft, SimMesh, slab_ms: float):
    """Phase 9: phase 6's rfft3 of the same cube as a 2x2 pencil plan
    (reversed layout)."""
    x = cube_input(torch, seed)
    plan = plan_fft(tuple(x.shape), SimMesh(GRID, axis_names=GRID_AXES), ndim=3, real=True, decomp="pencil",
                    backend="scatter", local_impl="kernel")
    y, launches, peak = counted(torch, fft_stage, "pencil rfft3", lambda: plan.execute(x))
    shapes = launch_shapes(fft_stage)
    h, hp = plan.hermitian_len, plan.padded_hermitian_len
    print(f"pencil rfft3: {plan!r} fused={plan.fused} H={h} Hp={hp}, launches {launches}", flush=True)
    print_shapes("pencil rfft3", shapes)
    check_peak("pencil rfft3", peak, "plan.execute")
    check(tuple(y.shape) == (hp, N3, N3) and hp == N3 // 2 + 2, "pencil rfft3 output has the wrong shape")
    err = rel_err(torch, y[:h], torch.fft.rfftn(x).permute(2, 1, 0))
    print(f"pencil rfft3 vs torch.fft.rfftn(x).permute(2, 1, 0): rel_err={err:.3e} (tol {MAIN_PATH_REL_TOL})",
          flush=True)
    check(err <= MAIN_PATH_REL_TOL, "pencil rfft3 disagrees with torch.fft.rfftn")
    check(not y[h:].any(), "the padded Hermitian entries are not zero")
    z = plan.inverse(y)
    rt = rel_err(torch, z, x)
    print(f"pencil irfft3 round trip: rel_err={rt:.3e} (tol {MAIN_PATH_REL_TOL})", flush=True)
    check(rt <= MAIN_PATH_REL_TOL, "pencil irfft3 does not round-trip")
    del y, z
    ms = host_ms(torch, lambda: plan.execute(x))
    print(f"pencil rfft3 timing: plan.execute {ms:.2f} ms (median of 3); slab rfft3 (phase 6) {slab_ms:.2f} ms "
          f"on the same transform", flush=True)
    check_peak("pencil rfft3", torch.cuda.max_memory_allocated() / 2**30, "the whole phase")
    return launches, shapes


def profile_lines(torch, label: str, plan, x) -> None:
    """``plan.profile``'s rows (median of 3 fenced runs after a warm-up)
    beside ``plan.execute``'s time on the same input, and the roofline."""
    res = plan.profile(x, reps=3, warmup=1)
    ms = host_ms(torch, lambda: plan.execute(x))
    print(f"{label} profile {plan.backend}: plan.execute {ms:.2f} ms (median of 3); spans sum "
          f"{res.observed_s * 1e3:.2f} ms (each span fenced), exchanges {res.exchange_observed_s * 1e3:.2f} ms, "
          f"model {res.predicted_s * 1e3:.3f} ms", flush=True)
    for r in res.rows:
        model = f" model {r.predicted_s * 1e3:.3f} ms, wire {r.wire_bytes:.0f} B" if r.predicted_s is not None else ""
        print(f"{label} profile {plan.backend} #{r.index} {r.stage}: {r.observed_s * 1e3:.3f} ms{model}", flush=True)
    print(f"{label} roofline {plan.backend}: {json.dumps(plan.roofline().as_dict())}", flush=True)


def measured_phase(torch, seed, fft_stage, plan_fft, SimMesh):
    """Phase 10: the SimMesh calibration and the measured race on the c2c
    main path's transform."""
    from repro_torch.core import planner

    mesh = SimMesh(P)
    fit = planner.ensure_calibrated(mesh)
    print(f"measured planner: calibrate [{planner.device_kind(mesh)}]: alpha={fit.alpha_s * 1e6:.3f} us "
          f"beta={fit.beta_bytes_s / 1e9:.2f} GB/s (a device copy: no message leaves the card)", flush=True)
    x = main_input(torch, seed)
    t0 = time.perf_counter()
    plan, launches, peak = counted(torch, fft_stage, "measured race", lambda: plan_fft(
        (N, N), mesh, planner="measure", local_impl="kernel"))
    table = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in sorted(plan.measured.items(), key=lambda kv: kv[1]))
    print(f"measured planner: race {time.perf_counter() - t0:.1f} s, winner {plan.backend}, launches {launches}, "
          f"peak memory {peak:.2f} GiB; table ms: {table}", flush=True)
    print(plan.why_text(), flush=True)
    check(not plan.race_failures, f"candidates failed in the race: {plan.race_failures}")
    y = plan.execute(x)
    oracle = torch.fft.fft2(x).mT
    err = rel_err(torch, y, oracle)
    print(f"measured winner {plan.backend} vs torch.fft.fft2(x).mT: rel_err={err:.3e} (tol {MAIN_PATH_REL_TOL})",
          flush=True)
    check(err <= MAIN_PATH_REL_TOL, "the measured winner disagrees with torch.fft.fft2")
    check(tuple(y.shape) == (N, N) and bool(torch.isfinite(torch.view_as_real(y)).all()),
          "the measured winner's output is not finite with the expected shape")
    del y, oracle
    profile_lines(torch, "measured planner", plan, x)
    if plan.backend != "scatter":
        profile_lines(torch, "measured planner", plan_fft((N, N), mesh, backend="scatter", local_impl="kernel"), x)
    return launches


NCCL_VARIANTS = (("scatter", "auto"), ("scatter", False), ("alltoall", False))  # (backend, pipeline)
NCCL_PENCIL_VARIANTS = ((("scatter", "scatter"), "auto"), (("alltoall", "alltoall"), False))


def nccl_rank(rank: int, world: int, init_method: str, seed: int, out_dir: str) -> None:
    """Phase 7, one rank: the c2c main path and the real Poisson solve on
    this rank's block over NCCL -- the fused scatter ring, the same ring
    unfused, and the unfused alltoall -- each held against the same plan
    on SimMesh(world) and the same seed (every rank checks the gathered
    result); then phase 8's pencil plans on a grid of auto_grid_shape(world)
    with one NCCL subgroup per ring, against SimMesh on the same grid."""
    import torch
    import torch.distributed as dist

    from repro_torch.apps import solve_poisson
    from repro_torch.core import ProcessGroupMesh, SimMesh, auto_grid_shape, init_process_mesh, plan_fft
    from repro_torch.kernels import fft_stage

    mesh = init_process_mesh(rank, world, init_method, timeout_s=NCCL_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        g = torch.Generator(device=mesh.device)
        g.manual_seed(seed)
        x = torch.randn((N, N), dtype=torch.complex64, device=mesh.device, generator=g)
        f = torch.randn((N, N), dtype=torch.float32, device=mesh.device, generator=g)
        sim = SimMesh(world, device=mesh.device)
        report = {"rank": rank, "P": world}
        for label, real, data in (("c2c main path", False, x), ("real Poisson", True, f)):
            block = mesh.split(data, ("model", None))[0]
            for backend, pipeline in NCCL_VARIANTS:
                kw = dict(real=real, backend=backend, pipeline=pipeline, local_impl="kernel")
                plan, ref = plan_fft((N, N), mesh, **kw), plan_fft((N, N), sim, **kw)
                exp = solve_poisson(data, ref) if real else ref.execute(data)
                run = (lambda: solve_poisson(block, plan)) if real else (lambda: plan.execute(block))
                expect = None if plan.fused else ("stage_left", "stage_right")
                got, launches, peak = counted(torch, fft_stage, f"NCCL {label}", run, expect)
                err = rel_err(torch, mesh.gather([got], ("model", None)), exp)
                check(err <= 1e-6, f"rank {rank}: ProcessGroupMesh {label} ({backend}, pipeline={pipeline}) "
                                   f"disagrees with SimMesh({world})")
                del got, exp
                report[f"{label} {backend} pipeline={pipeline}"] = dict(
                    fused=plan.fused, launches=launches, rel_err_vs_sim=err, sim=f"SimMesh({world})",
                    ms=host_ms(torch, run), peak_gib=peak)
        del f
        grid = auto_grid_shape(world)
        gmesh = ProcessGroupMesh(device=mesh.device, grid=grid, axis_names=GRID_AXES, timeout_s=NCCL_TIMEOUT_S)
        gsim = SimMesh(grid, axis_names=GRID_AXES, device=mesh.device)
        for backend, pipeline in NCCL_PENCIL_VARIANTS:
            kw = dict(decomp="pencil", backend=backend, pipeline=pipeline, local_impl="kernel")
            plan, ref = plan_fft((N, N), gmesh, **kw), plan_fft((N, N), gsim, **kw)
            block = gmesh.split(x, plan.input_spec().tail)[0]
            exp = ref.execute(x)
            expect = None if plan.fused else ("stage_left", "stage_right")
            got, launches, peak = counted(torch, fft_stage, "NCCL pencil c2c", lambda: plan.execute(block), expect)
            err = rel_err(torch, gmesh.gather([got], plan.schedule().out_tail), exp)
            check(err <= 1e-6, f"rank {rank}: ProcessGroupMesh grid {grid} pencil c2c ({plan.backend}, "
                               f"pipeline={pipeline}) disagrees with SimMesh({grid})")
            check(peak < PEAK_LIMIT_GIB, f"rank {rank}: NCCL pencil c2c peaked at {peak:.2f} GiB")
            del got, exp
            report[f"pencil c2c grid={grid[0]}x{grid[1]} {plan.backend} pipeline={pipeline}"] = dict(
                fused=plan.fused, launches=launches, rel_err_vs_sim=err, sim=f"SimMesh({grid})",
                ms=host_ms(torch, lambda: plan.execute(block)), peak_gib=peak)
        report["measured planner"] = nccl_measured(torch, mesh, sim, x, fft_stage, plan_fft)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    finally:
        dist.destroy_process_group()


def nccl_measured(torch, mesh, sim, x, fft_stage, plan_fft) -> dict:
    """Phase 7's planner part, one rank: fit alpha/beta over NCCL (the
    default sizes, then NCCL_FIT_SIZES, which is stored), the estimate
    pick under the stored fit, and the measured race on the c2c main
    path, whose winner every rank must name and whose result must equal
    SimMesh's."""
    import torch.distributed as dist

    from repro_torch.core import CommParams, planner

    fits = {}
    for label, calibrate in (("default sizes", lambda: CommParams.calibrate(mesh)),
                             ("sizes to 64 MiB", lambda: planner.ensure_calibrated(
                                 mesh, sizes=NCCL_FIT_SIZES, force=True))):
        t0 = time.perf_counter()
        fit = calibrate()
        fits[label] = dict(alpha_us=fit.alpha_s * 1e6, beta_gb_s=fit.beta_bytes_s / 1e9,
                           s=time.perf_counter() - t0)
    est = plan_fft((N, N), mesh, backend="auto", local_impl="kernel")
    out = dict(device_kind=planner.device_kind(mesh), fits=fits, estimate=est.backend,
               estimate_us={k: v * 1e6 for k, v in est.predict().items()})
    t0 = time.perf_counter()
    race, launches, _ = counted(torch, fft_stage, "NCCL measured race", lambda: plan_fft(
        (N, N), mesh, planner="measure", local_impl="kernel", use_wisdom=False),
        None if mesh.p > 1 else ("stage_left", "stage_right"))
    winners = [None] * mesh.p
    dist.all_gather_object(winners, race.backend)
    check(len(set(winners)) == 1, f"rank {mesh.rank}: the ranks' measured winners differ: {winners}")
    block = mesh.split(x, ("model", None))[0]
    got = mesh.gather([race.execute(block)], ("model", None))
    err = rel_err(torch, got, plan_fft((N, N), sim, backend=race.backend, local_impl="kernel").execute(x))
    check(err <= 1e-6, f"rank {mesh.rank}: the measured winner {race.backend} disagrees with SimMesh")
    out.update(winner=race.backend, winners=winners, race_s=time.perf_counter() - t0, launches=launches,
               measured_ms={k: v * 1e3 for k, v in race.measured.items()}, failed=race.race_failures,
               rel_err_vs_sim=err, why=race.why_text())
    return out


def nccl_phase(torch, seed: int):
    """Phase 7: one ProcessGroupMesh rank per visible card over NCCL."""
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(nccl_rank, args=(world, f"file://{os.path.join(tmp, 'rendezvous')}", seed, tmp),
                 nprocs=world, join=True)
        reports = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                reports.append(json.load(fh))
    for rep in reports:
        for key, r in rep.items():
            if isinstance(r, dict) and key != "measured planner":
                print(f"NCCL rank {rep['rank']}/{rep['P']} {key}: fused={r['fused']} launches {r['launches']} "
                      f"rel_err vs {r['sim']}={r['rel_err_vs_sim']:.3e} (tol 1e-06) "
                      f"ms={r['ms']:.2f} (median of 3) peak memory {r['peak_gib']:.2f} GiB", flush=True)
    for rep in reports:
        m = rep["measured planner"]
        who = f"NCCL rank {rep['rank']}/{rep['P']}"
        for label, fit in m["fits"].items():
            print(f"{who} calibrate [{m['device_kind']}] {label}: alpha={fit['alpha_us']:.3f} us "
                  f"beta={fit['beta_gb_s']:.2f} GB/s (sweep {fit['s']:.2f} s)", flush=True)
        table = ", ".join(f"{k} {v:.2f}" for k, v in sorted(m["estimate_us"].items(), key=lambda kv: kv[1]))
        print(f"{who} estimate pick under the fit: {m['estimate']} (model us: {table})", flush=True)
        table = ", ".join(f"{k} {v:.3f}" for k, v in sorted(m["measured_ms"].items(), key=lambda kv: kv[1]))
        print(f"{who} measured pick: {m['winner']} (every rank: {m['winners']}), rel_err vs SimMesh="
              f"{m['rel_err_vs_sim']:.3e} (tol 1e-06), race {m['race_s']:.1f} s, launches {m['launches']}, "
              f"table ms (largest over the ranks): {table}; failed {m['failed'] or 'none'}", flush=True)
        if rep["rank"] == 0:
            print(m["why"], flush=True)
    check(len({rep["measured planner"]["winner"] for rep in reports}) == 1, "the ranks' measured winners differ")
    return reports[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: the port's smoke run needs a GPU")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SmokeFailure(f"no src/repro_torch beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, src)

    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, seed {args.seed}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.apps import solve_poisson
    from repro_torch.core import SimMesh, auto_grid_shape, plan_fft
    from repro_torch.core import comm_model as cm
    from repro_torch.core import fftmath as lf
    from repro_torch.kernels import build, fft_stage, ops, ref

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({built})", flush=True)
    for name in build.sources():
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    rows = kernel_phase(torch, g, fft_stage, ref, ops, lf, cm)
    torch.cuda.empty_cache()
    done = {(name, shape) for name, shapes in KERNEL_PHASE_SHAPES.items() for shape in shapes}

    def time_shapes(label, shapes):
        time_launch_shapes(torch, g, fft_stage, ref, lf, cm, label, shapes, done)

    launches, shapes, slab_ms = main_path(torch, args.seed, fft_stage, plan_fft, SimMesh)
    torch.cuda.empty_cache()
    time_shapes("c2c main", shapes)
    by_path = {"c2c_main_path": launches}
    by_path["real_poisson"], shapes = real_poisson(torch, g, fft_stage, plan_fft, SimMesh, solve_poisson)
    torch.cuda.empty_cache()
    time_shapes("real Poisson", shapes)
    by_path["rfft3"], shapes, slab_rfft3_ms = rfft3_phase(torch, args.seed, fft_stage, plan_fft, SimMesh)
    torch.cuda.empty_cache()
    time_shapes("rfft3", shapes)
    nccl = nccl_phase(torch, args.seed)
    by_path["nccl_c2c"] = nccl["c2c main path scatter pipeline=auto"]["launches"]
    by_path["nccl_real_poisson"] = nccl["real Poisson scatter pipeline=auto"]["launches"]
    grid = auto_grid_shape(torch.cuda.device_count())
    by_path["nccl_pencil_c2c"] = nccl[f"pencil c2c grid={grid[0]}x{grid[1]} scatter+scatter pipeline=auto"][
        "launches"]
    by_path["pencil_c2c"], shapes = pencil_c2c_phase(torch, args.seed, fft_stage, plan_fft, SimMesh, slab_ms)
    torch.cuda.empty_cache()
    time_shapes("pencil c2c", shapes)
    by_path["pencil_rfft3"], shapes = pencil_rfft3_phase(torch, args.seed, fft_stage, plan_fft, SimMesh, slab_rfft3_ms)
    torch.cuda.empty_cache()
    time_shapes("pencil rfft3", shapes)
    by_path["measured_race"] = measured_phase(torch, args.seed, fft_stage, plan_fft, SimMesh)
    torch.cuda.empty_cache()
    for row in rows:  # the pack's rows count their own mode's launches
        key = f"{PACK} {row['mode']}" if "mode" in row else row["name"]
        row["launches"] = launches[key]
        row["launches_by_path"] = {path: counts[key] for path, counts in by_path.items()}

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
