"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``,
ported from ``repro.launch.serve``.

Spins up the slot-based engine on a reduced (default) or full
(``--no-reduced``) config with random weights, feeds it the reference's
stream of synthetic prompts (``numpy.random.default_rng(0)``), and
reports throughput. Runs on ``--device`` (default ``cuda``; it raises
without a GPU unless given ``--device cpu``).

The reference declares ``--reduced`` as ``store_true`` with
``default=True``, so it can never reach a full config; here it is a
``BooleanOptionalAction`` with the same default.
"""

from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs import ModelConfig, ServeConfig, get_config
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine


def prompt_stream(cfg: ModelConfig, requests: int, prompt_len: int, seed: int = 0) -> List[np.ndarray]:
    """The reference launcher's prompts: lengths 4..prompt_len, tokens
    uniform over the vocabulary, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, cfg.vocab_size, rng.integers(4, prompt_len + 1)).astype(np.int32)
        for _ in range(requests)
    ]


def build_engine(cfg: ModelConfig, scfg: ServeConfig, *, device=None, seed: int = 0, mesh=None) -> ServeEngine:
    """``Model(cfg, mesh)`` with random weights from a generator seeded
    with ``seed``, made in the model's compute dtype, behind a
    ServeEngine (on a ``ProcessGroupMesh``: every rank calls it, and each
    keeps its experts of the same weights)."""
    model = Model(cfg, mesh, attn_impl="chunked", device=device)
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    params, _ = model.init(g, dtype=model.dtype)
    return ServeEngine(model, params, scfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encdec:
        raise SystemExit("the serve launcher targets decoder-only archs (whisper needs audio prompts)")
    engine = build_engine(
        cfg,
        ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq, temperature=args.temperature),
        device=args.device,
    )
    prompts = prompt_stream(cfg, args.requests, args.prompt_len)
    t0 = time.perf_counter()
    results = engine.run(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    tok = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s aggregate)")
    for uid in sorted(results)[:4]:
        print(f"  req {uid}: {results[uid][:12]}")


if __name__ == "__main__":
    main()
