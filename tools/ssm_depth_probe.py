#!/usr/bin/env python3
"""How rounding grows through the depth of the random-weight xLSTM and
hymba stacks, in the reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/ssm_depth_probe.py [--depths 2 8 24 48]

For each arch at its reduced width (``get_config(arch, reduced=True)``)
cut or grown to each depth, with the reference's weights from one
``Model.init`` (rounded to bfloat16, so both dtypes run the same numbers),
and one batch of 24 tokens, prints the relative error (to the largest
logit) of the whole sequence's logits:

- the reference in bfloat16 against the reference in float32 (what the
  bf16 arithmetic itself costs at that depth);
- the port in bfloat16 against the port in float32;
- the port in bfloat16 against the reference in bfloat16;
- the port in float32 against the reference in float32 (float32 rounding
  in another order, grown through the depth).

Like the tests it imports both packages (the port never does); it runs
nothing on a GPU. Memory stays under 2 GB.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as r_get_config
from repro.models.model import Model as RModel
from repro_torch.models.model import Model, params_from_numpy


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def probe(arch: str, layers: int) -> dict:
    cfg = dataclasses.replace(r_get_config(arch, reduced=True), num_layers=layers, dtype="bfloat16")
    rmodel = RModel(cfg)
    params = jax.jit(lambda key: rmodel.init(key)[0])(jax.random.PRNGKey(1))
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = {"tokens": jnp.asarray(toks)}
    ref16 = jax.jit(rmodel.logits)(params, batch)
    ref32 = jax.jit(RModel(cfg32).logits)(params, batch)
    weights = params_from_numpy(params, device="cpu")
    port16 = Model(cfg, device="cpu").logits(weights, {"tokens": torch.as_tensor(toks)})
    port32 = Model(cfg32, device="cpu").logits(weights, {"tokens": torch.as_tensor(toks)})
    return {"ref bf16 vs ref f32": rel(ref16, ref32), "port bf16 vs port f32": rel(port16, port32),
            "port bf16 vs ref bf16": rel(port16, ref16), "port f32 vs ref f32": rel(port32, ref32)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 8, 24, 48])
    ap.add_argument("--archs", nargs="+", default=["xlstm-1.3b", "hymba-1.5b"])
    args = ap.parse_args(argv)
    for arch in args.archs:
        for layers in args.depths:
            row = probe(arch, layers)
            print(f"{arch} {layers} layers: " + ", ".join(f"{k} {v:.3e}" for k, v in row.items()), flush=True)


if __name__ == "__main__":
    main()
