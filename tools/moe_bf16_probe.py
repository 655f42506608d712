#!/usr/bin/env python3
"""Where the bfloat16 error of the MoE serving path comes from, on one GPU.

    python3 tools/moe_bf16_probe.py [--prompts N]

For each of chip_smoke.py's phase-15 models (DeepSeek-V3 at 5 layers,
Mixtral-8x22B at 12, full width, random weights, capacity_factor E / k so
nothing drops) and N prompts of chip_smoke.LM_BF16_SEQ + 1 tokens, prints
the relative error (to the largest logit) of

- prefill + 1 decode step against the bfloat16 whole sequence's logits
  (phase 14's comparison), with the routing free, and with every MoE
  layer's top-k held to the whole sequence's choices (so no routing flip
  between the two computations can add to it), and how many tokens' top-k
  sets differed per MoE layer;
- the same model with every layer dense (DeepSeek-V3 only:
  first_k_dense = num_layers), for the error without experts;
- prefill + decode and the bfloat16 whole sequence, each against a
  float32 oracle (a float32 Model on the same bfloat16 weights, each
  weight cast at its use).

Needs the card (~70 GiB free); nothing is built.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompts", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("moe_bf16_probe: needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    sys.path.insert(0, os.path.join(HERE, ".."))
    import chip_smoke as cs
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    s = cs.LM_BF16_SEQ
    record, held = [], []
    router = moe.router_topk

    def recorded_router(x, wr, k, **kw):
        w, idx, aux = router(x, wr, k, **kw)
        if held:  # the whole sequence's choices for these tokens
            idx = held.pop(0)
            w = torch.softmax(x.float() @ wr.float(), dim=-1).gather(1, idx)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        record.append(idx.sort(-1).values)
        return w, idx, aux

    def run(model, params, toks, hold=None):
        """(prefill logits, decode logits, each dispatch's sorted top-k)."""
        record.clear()
        held.extend(hold[0] if hold else [])
        state = model.init_decode_state(1, s + 1)
        state, pl = model.prefill(params, {"tokens": toks[:, :s]}, state)
        held.extend(hold[1] if hold else [])
        lg, _ = model.decode_step(params, toks[:, s:], state)
        return pl, lg, list(record)

    moe.router_topk = recorded_router
    try:
        for arch, cut in cs.MOE_CUTS.items():
            variants = [("moe", cut)]
            if cs.moe_cfg(arch, **cut).moe.first_k_dense:  # DeepSeek-V3: the same widths, every layer dense
                variants.append(("dense-only", dict(cut, first_k_dense=cut["num_layers"])))
            for variant, kw in variants:
                cfg = cs.moe_cfg(arch, no_drop=True, **kw)
                model, oracle = Model(cfg), Model(dataclasses.replace(cfg, dtype="float32"))
                g = torch.Generator(device="cuda")
                g.manual_seed(0)
                params, _ = model.init(g, dtype=torch.bfloat16)
                g.manual_seed(1)
                for n in range(args.prompts):
                    toks = torch.randint(0, cfg.vocab_size, (1, s + 1), device="cuda", generator=g)
                    record.clear()
                    whole = model.logits(params, {"tokens": toks})
                    choices = list(record)
                    exact = oracle.logits(params, {"tokens": toks})
                    pl, lg, free = run(model, params, toks)
                    err = [cs.lm_rel_err(pl, whole[:, s - 1]), cs.lm_rel_err(lg, whole[:, s])]
                    line = (f"{arch} {variant} prompt {n}: prefill + decode vs the bf16 whole sequence "
                            f"{err[0]:.3e}, {err[1]:.3e}")
                    if choices:
                        flips = [int((c[:s] != f).any(-1).sum()) for c, f in zip(choices, free[:len(choices)])]
                        at_decode = [int((c[s:] != f).any()) for c, f in zip(choices, free[len(choices):])]
                        hold = ([c[:s] for c in choices], [c[s:] for c in choices])
                        hpl, hlg, _ = run(model, params, toks, hold)
                        line += (f"; tokens whose top-k differs per MoE layer: {flips} of the {s} prefilled, "
                                 f"{at_decode} at the decoded one; routing held: "
                                 f"{cs.lm_rel_err(hpl, whole[:, s - 1]):.3e}, {cs.lm_rel_err(hlg, whole[:, s]):.3e}")
                    line += (f"; vs the float32 oracle: prefill + decode {cs.lm_rel_err(pl, exact[:, s - 1]):.3e}, "
                             f"{cs.lm_rel_err(lg, exact[:, s]):.3e}, the bf16 whole sequence "
                             f"{cs.lm_rel_err(whole[:, s - 1], exact[:, s - 1]):.3e}, "
                             f"{cs.lm_rel_err(whole[:, s], exact[:, s]):.3e}")
                    print(line, flush=True)
                    del whole, exact
                del model, oracle, params
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        moe.router_topk = router
    return 0


if __name__ == "__main__":
    sys.exit(main())
