#!/usr/bin/env python3
"""DeepSeek-V3's MoE ring dispatch against the reference, over seeds, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/ring_gap_probe.py [--seeds 0 1 2] [--float64]

For each initial-weight seed, one ``make_train_step`` of the reduced
DeepSeek-V3 (``tests/torch_train_common.fsdp_cfg``: 2 layers, float32,
microbatch 2) on ``SimMesh((2, 2))`` (a ring of 2 on ``model``) and on
``SimMesh((4, 1))`` (no ring), against the reference's ``jit_train_step``
on a host mesh of the same shape (4 host devices), on the plain batch and
on the one with -1 labels in one data block. Prints the three leaves whose
first moments lie farthest from the reference's, each relative to the
leaf's largest entry. ``tests/test_torch_train_fsdp.py`` holds the same
cells at seed 0.

``--float64`` asks which of the two float32 steps the gap belongs to: the
reference's step again with jax's x64 on and the model, the moments and
the microbatch accumulator in float64 (its float32 router and attention
products stay), on the plain batch, and each float32 step's distance from
it -- the reference's from a child process of this script (its float32
step does not trace under x64), the port's from this one.

Imports both packages, as the tests do; nothing runs on a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "deepseek-v3-671b"
GRIDS = ((2, 2), (4, 1))


def _state(seed: int):
    """The port's initial state at ``seed`` as numpy (step 1: the warmup's lr is 0 at step 0) and its specs."""
    import numpy as np
    import torch

    import torch_train_common as ttc
    from repro_torch.models.model import Model
    from repro_torch.train import init_train_state

    cfg, tcfg = ttc.fsdp_cfg(ARCH), ttc.fsdp_tcfg()
    state, specs = init_train_state(Model(cfg, device="cpu"), torch.Generator().manual_seed(seed), tcfg)
    return ttc.numpy_state(state)._replace(step=np.array(1, np.int32)), specs


def _reference_mu(state_np, specs, grid, batch, dtype: str = "float32"):
    """The reference's first moments after one ``jit_train_step`` on a host
    mesh of ``grid``, in ``dtype`` (float64 needs jax's x64 on), as flat
    float64 numpy."""
    import jax
    import numpy as np

    import torch_train_common as ttc
    from repro.configs import TrainConfig as RTrainConfig
    from repro.configs import get_config as rget
    from repro.core.compat import make_mesh
    from repro.models import Model as RModel
    from repro.optim import adamw as radamw
    from repro.train import TrainState as RTrainState
    from repro.train.step import jit_train_step

    tcfg = ttc.fsdp_tcfg()
    rtcfg = RTrainConfig(learning_rate=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps, microbatch=tcfg.microbatch, opt_state_dtype=dtype)
    rcfg = dataclasses.replace(rget(ARCH, reduced=True), dtype=dtype, **ttc.FSDP_ARCHS[ARCH])
    cast = lambda t: jax.tree.map(lambda a: np.asarray(a, dtype), t)  # noqa: E731
    rstate = RTrainState(cast(state_np.params), radamw.AdamWState(state_np.opt.count, cast(state_np.opt.mu),
                                                                  cast(state_np.opt.nu)), state_np.step)
    mesh = make_mesh(grid, ("data", "model"))
    new, _ = jit_train_step(RModel(rcfg, mesh), rtcfg, mesh, specs)(rstate, batch)
    return ttc.flat(jax.tree.map(lambda a: np.asarray(a, np.float64), new.opt.mu))


def _port_mu(state_np, grid, batch):
    import torch

    import torch_train_common as ttc
    from repro_torch.core import SimMesh
    from repro_torch.data import make_batch_arrays
    from repro_torch.models.model import Model
    from repro_torch.train import make_train_step, train_state_from_numpy

    cfg, tcfg = ttc.fsdp_cfg(ARCH), ttc.fsdp_tcfg()
    model = Model(cfg, SimMesh(grid, axis_names=("data", "model"), device="cpu"), device="cpu")
    got, _ = make_train_step(model, tcfg, model.mesh)(train_state_from_numpy(state_np, "cpu"),
                                                       make_batch_arrays(batch, device="cpu"))
    return {k: v.detach().numpy().astype("float64") for k, v in ttc.flat(got.opt.mu).items()}


def _worst(got, exp, n: int = 3) -> str:
    import numpy as np

    errs = sorted(((np.abs(got[k] - e).max() / np.abs(e).max(), k) for k, e in exp.items() if np.abs(e).max() > 0),
                  reverse=True)
    return ", ".join(f"{k} {e:.3e}" for e, k in errs[:n])


def _float64_x64_patch() -> None:
    """jax's x64 on, and the reference's microbatch accumulator (float32
    zeros in ``make_train_step``) in float64, so its float64 step traces."""
    import types

    import jax
    import jax.numpy as jnp

    import repro.train.step as rstep

    jax.config.update("jax_enable_x64", True)
    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    ns.zeros = lambda shape, dtype=None: jnp.zeros(shape, jnp.float64 if dtype in (None, jnp.float32) else dtype)
    rstep.jnp = ns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--float64", action="store_true", help="each float32 step against the reference in float64")
    ap.add_argument("--reference-to", help=argparse.SUPPRESS)  # the child: save the float32 reference's moments
    args = ap.parse_args()

    import numpy as np
    import torch

    import torch_train_common as ttc

    torch.set_num_threads(1)
    cfg = ttc.fsdp_cfg(ARCH)
    if args.reference_to:
        out = {(g, s): _reference_mu(*_state(s), g, ttc.fsdp_batches(cfg)["plain"]) for g in GRIDS for s in args.seeds}
        np.save(args.reference_to, np.array(out, dtype=object), allow_pickle=True)
        return
    if args.float64:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "reference_float32.npy")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--reference-to", path, "--seeds",
                            *map(str, args.seeds)], check=True)
            ref32 = np.load(path, allow_pickle=True).item()
        _float64_x64_patch()
        batch = ttc.fsdp_batches(cfg)["plain"]
        for grid in GRIDS:
            for seed in args.seeds:
                state_np, specs = _state(seed)
                exact = _reference_mu(state_np, specs, grid, batch, "float64")
                print(f"{ARCH} reduced, {grid}, seed {seed}, plain batch, against the reference in float64: the "
                      f"reference's float32 step {_worst(ref32[(grid, seed)], exact)}; the port's float32 step "
                      f"(SimMesh({grid})) {_worst(_port_mu(state_np, grid, batch), exact)}", flush=True)
        return
    for grid in GRIDS:
        for seed in args.seeds:
            state_np, specs = _state(seed)
            for kind, batch in ttc.fsdp_batches(cfg).items():
                exp = _reference_mu(state_np, specs, grid, batch)
                print(f"{ARCH} reduced, SimMesh({grid}) vs the reference's {grid}, seed {seed}, {kind} batch: "
                      + _worst(_port_mu(state_np, grid, batch), exp), flush=True)


if __name__ == "__main__":
    main()
