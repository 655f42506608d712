#!/usr/bin/env python3
"""DeepSeek-V3's MoE ring dispatch against the reference, over seeds, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/ring_gap_probe.py [--seeds 0 1 2]

For each initial-weight seed, one ``make_train_step`` of the reduced
DeepSeek-V3 (``tests/torch_train_common.fsdp_cfg``: 2 layers, float32,
microbatch 2) on ``SimMesh((2, 2))`` (a ring of 2 on ``model``) and on
``SimMesh((4, 1))`` (no ring), against the reference's ``jit_train_step``
on a host mesh of the same shape (4 host devices), on the plain batch and
on the one with -1 labels in one data block. Prints the three leaves whose
first moments lie farthest from the reference's, each relative to the
leaf's largest entry. ``tests/test_torch_train_fsdp.py`` holds the same
cells at seed 0. Imports both packages, as the tests do; nothing runs on
a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "deepseek-v3-671b"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    import torch_train_common as ttc
    from repro.configs import TrainConfig as RTrainConfig
    from repro.configs import get_config as rget
    from repro.core.compat import make_mesh
    from repro.models import Model as RModel
    from repro.optim import adamw as radamw
    from repro.train import TrainState as RTrainState
    from repro.train.step import jit_train_step
    from repro_torch.core import SimMesh
    from repro_torch.data import make_batch_arrays
    from repro_torch.models.model import Model
    from repro_torch.train import init_train_state, make_train_step, train_state_from_numpy

    torch.set_num_threads(1)
    cfg, tcfg = ttc.fsdp_cfg(ARCH), ttc.fsdp_tcfg()
    rtcfg = RTrainConfig(learning_rate=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps, microbatch=tcfg.microbatch)
    rcfg = dataclasses.replace(rget(ARCH, reduced=True), dtype="float32", **ttc.FSDP_ARCHS[ARCH])
    for grid in ((2, 2), (4, 1)):
        for seed in args.seeds:
            state, specs = init_train_state(Model(cfg, device="cpu"), torch.Generator().manual_seed(seed), tcfg)
            state_np = ttc.numpy_state(state)._replace(step=np.array(1, np.int32))  # the warmup's lr is 0 at step 0
            rstate = RTrainState(state_np.params, radamw.AdamWState(state_np.opt.count, state_np.opt.mu,
                                                                    state_np.opt.nu), state_np.step)
            mesh = make_mesh(grid, ("data", "model"))
            rstep = jit_train_step(RModel(rcfg, mesh), rtcfg, mesh, specs)
            model = Model(cfg, SimMesh(grid, axis_names=("data", "model"), device="cpu"), device="cpu")
            step = make_train_step(model, tcfg, model.mesh)
            for kind, batch in ttc.fsdp_batches(cfg).items():
                new, _ = rstep(jax.tree.map(np.array, rstate), batch)
                exp = ttc.flat(jax.tree.map(np.asarray, new.opt.mu))
                got, _ = step(train_state_from_numpy(state_np, "cpu"), make_batch_arrays(batch, device="cpu"))
                got = {k: v.detach().numpy() for k, v in ttc.flat(got.opt.mu).items()}
                errs = sorted(((np.abs(got[k] - e).max() / np.abs(e).max(), k) for k, e in exp.items()
                               if np.abs(e).max() > 0), reverse=True)
                print(f"{ARCH} reduced, SimMesh({grid}) vs the reference's {grid}, seed {seed}, {kind} batch: "
                      + ", ".join(f"{k} {e:.3e}" for e, k in errs[:3]), flush=True)


if __name__ == "__main__":
    main()
