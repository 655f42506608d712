"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``,
ported from ``repro.launch.train``.

Wires together the config registry, the synthetic data, the train step,
the checkpoint manager (atomic / async / keep-3; its leaf names are the
reference's, so a ``TrainState`` of whole leaves written by either
package restores in the other), the step monitor (straggler flags,
``input`` / ``step_fn`` spans), and the failure-recovery loop
(auto-resume from the latest checkpoint, ``elastic_mesh`` under
``--elastic``). Without ``--ckpt-dir`` a run checkpoints into a fresh
directory, so it never resumes another run's state. Runs on ``--device``
(default ``cuda``; it raises without a GPU unless given ``--device
cpu``).

Unlike the reference's serve launcher, ``--reduced`` is a plain
``store_true`` (default False), as in the reference's train launcher: a
bare ``--arch hymba-1.5b`` trains the full config.

In one process ``--model-parallel mp`` trains tensor-parallel over a
``(1, mp)`` ``SimMesh`` on the one device (``launch.mesh.make_local_mesh``;
``--elastic``: ``(n // mp, mp)``). Over processes -- under ``torchrun``,
or any ``torch.distributed`` world that ``RANK`` / ``WORLD_SIZE`` name --
every rank joins the world (``cpu:gloo,cuda:nccl`` on cards, gloo with
``--device cpu``) as the ``(world // mp, mp)`` ``('data', 'model')`` grid
and trains FSDP x TP on it (``train.make_train_step``): each rank builds
its blocks of the state, takes its rows of every batch, and writes its
blocks to the placed checkpoints (``step_<N>/proc<k>.npz``), which
restore onto whatever grid a restart gets (``--elastic``: the
survivors'). The loss log and history are the same on every rank::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2.5-32b --reduced --model-parallel 2
"""

from __future__ import annotations

import argparse
import logging
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import Model
from repro_torch.runtime import FailureInjector, Resume, StepMonitor, elastic_mesh, run_with_recovery
from repro_torch.train import init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument(
        "--ckpt-dir", default=None,
        help="checkpoint directory; a run resumes from the newest checkpoint there "
             "(default: a fresh directory under the temp dir)",
    )
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None, help="inject a failure (recovery demo)")
    ap.add_argument(
        "--fail-every", type=int, default=None,
        help="repeat the injected failure every N steps after --fail-at",
    )
    ap.add_argument(
        "--fail-times", type=int, default=1,
        help="total injected failures (with --fail-every; default one)",
    )
    ap.add_argument(
        "--elastic", action="store_true",
        help="rebuild the mesh from whatever devices are alive on each "
             "restart (may resume on fewer devices than the failed run)",
    )
    ap.add_argument(
        "--backoff-s", type=float, default=0.0,
        help="base restart backoff; grows exponentially, capped, jittered",
    )
    ap.add_argument("--attn-impl", default="chunked", choices=["chunked", "naive"])
    ap.add_argument(
        "--monitor-window", type=int, default=512,
        help="step-telemetry history bound (StepMonitor history_limit)",
    )
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap


def _broadcast(value):
    """Rank 0's ``value`` on every rank of the world (one object)."""
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def train(args, *, injector: Optional[FailureInjector] = None) -> dict:
    import torch.distributed as dist

    distributed = dist.is_available() and dist.is_initialized()
    cfg = get_config(args.arch, reduced=args.reduced)
    device = getattr(args, "device", None)
    tcfg = TrainConfig(
        learning_rate=args.lr,
        warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps,
        microbatch=args.microbatch,
        checkpoint_every=args.ckpt_every,
        seed=args.seed,
    )
    ds = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    if distributed:  # one directory for the job: rank 0's
        ckpt_dir = _broadcast(ckpt_dir)
    rank0 = not distributed or dist.get_rank() == 0
    if rank0:
        log.info("checkpoints in %s", ckpt_dir)
    monitor = StepMonitor(history_limit=getattr(args, "monitor_window", 512))
    injector = injector or FailureInjector(
        args.fail_at,
        every=getattr(args, "fail_every", None),
        times=getattr(args, "fail_times", 1),
    )
    history = {"loss": [], "restarts": 0, "ckpt_dir": ckpt_dir}
    managers = []  # the previous attempt's, whose placed save may still owe its manifest

    def loop(resume: Optional[Resume]):
        # the mesh (and the state on it) is rebuilt per attempt: under
        # --elastic a restart re-discovers whatever ranks are still alive
        for old in managers:
            old.wait()
        managers.clear()
        if getattr(args, "elastic", False):
            mesh = elastic_mesh(("data", "model"), model_parallel=args.model_parallel, device=device)
            if mesh is None:  # not a survivor: the others train on
                return
        else:
            mesh = make_local_mesh(args.model_parallel, device)
        model = Model(cfg, mesh=mesh, attn_impl=args.attn_impl, device=mesh.device)
        g = torch.Generator(device=model.device)
        g.manual_seed(tcfg.seed)
        state, _ = init_train_state(model, g, tcfg)
        layout = model.state_layout()
        ckpt = CheckpointManager(ckpt_dir, keep=3, mesh=mesh)
        managers.append(ckpt)
        start = 0
        # restore_latest walks back past corrupt/partial checkpoints --
        # a crash mid-save costs one interval, never the run
        latest, restored = ckpt.restore_latest(state, layout=layout)
        if latest is not None:
            state = restored
            start = latest
            if rank0 and resume is not None:
                log.info(
                    "restart %d (%s): resumed from checkpoint step %d on %d ranks",
                    resume.restarts, resume.cause, start, mesh.p,
                )
            elif rank0:
                log.info("resumed from checkpoint step %d", start)
            # the pre-failure EMA would flag every post-restart step
            monitor.reset()
        step_fn = make_train_step(model, tcfg, mesh)
        for step in range(start, args.steps):
            injector.maybe_fail(step)
            # a step spans input + device work so a slow host pipeline
            # flags (and names itself) like a slow device would
            monitor.start()
            t_in = time.perf_counter()
            batch = make_batch_arrays(ds.batch_at(step), mesh)
            input_s = time.perf_counter() - t_in
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            st = monitor.stop(
                tokens=args.batch * args.seq,
                spans=[("input", input_s), ("step_fn", time.perf_counter() - t_in - input_s)],
            )
            history["loss"].append(loss)
            if st.flagged and rank0:
                log.warning(
                    "straggler step %d: %.3fs (ema %.3fs, slowest stage: %s)",
                    step, st.seconds, monitor.ema, st.culprit,
                )
            if step % args.log_every == 0 and rank0:
                log.info(
                    "step %d loss %.4f gnorm %.3f %.0f tok/s",
                    step, loss, float(metrics["grad_norm"]), monitor.tokens_per_sec,
                )
            if (step + 1) % tcfg.checkpoint_every == 0 or step + 1 == args.steps:
                ckpt.save(step + 1, state, layout=layout)
        ckpt.wait()

    restarts = run_with_recovery(
        loop,
        max_restarts=2,
        backoff_s=getattr(args, "backoff_s", 0.0),
        seed=args.seed,
    )
    history["restarts"] = restarts
    history["straggler_report"] = monitor.straggler_report()
    return history


def _join_world(device) -> bool:
    """Join the ``torch.distributed`` world that ``RANK`` / ``WORLD_SIZE``
    (and ``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets them)
    name, unless joined already; False when the environment names none."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    from repro_torch.core import init_process_mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    init_process_mesh(rank, world, "env://", device=device)
    return True


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = build_argparser().parse_args(argv)
    joined = _join_world(args.device)
    try:
        hist = train(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    first = np.mean(hist["loss"][:5]) if hist["loss"] else float("nan")
    last = np.mean(hist["loss"][-5:]) if hist["loss"] else float("nan")
    print(f"loss {first:.4f} -> {last:.4f} over {len(hist['loss'])} steps "
          f"(restarts={hist['restarts']})")


if __name__ == "__main__":
    main()
