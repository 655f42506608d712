"""Batched LM serving engine: slot-based continuous batching (lite),
ported from ``repro.serve.engine``.

A fixed pool of ``max_batch`` slots shares one stacked decode state.
Requests prefill into a free slot (batch=1 prefill into a scratch state,
whose cache rows are then copied into the slot's rows in place); every
``step()`` decodes all ``max_batch`` rows together, idle ones included,
as the reference does; finished slots are freed for the next request.

Greedy decoding matches the reference token for token. Temperature
sampling draws from the same distribution with a ``torch.Generator``
seeded with the reference's integer, so its stream differs from the
reference's ``jax.random`` one.

On a model built on a ``ProcessGroupMesh`` (tensor-parallel, and a MoE
model's experts expert-parallel) the engine runs SPMD: every rank gets the same request stream and runs the
same program, and the ranks agree twice through ``mesh.host_max`` (a
CPU all-reduce over the group's gloo half): on each admission (the
prompt's checksum and length, ``max_new`` and the slot) and on each
step's sampled tokens. A rank whose stream or tokens differ makes every
rank raise :class:`~repro_torch.serve.spectral.StreamMismatch` at that
agreement.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.models.model import Model
from repro_torch.serve.queue import PendingQueue
from repro_torch.serve.spectral import StreamMismatch

#: The engine's agreement points on a process group; an agreement
#: carries its point, so ranks at different points raise.
_POINTS = ("admit", "step")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _set_slot(state, slot_state, idx: int) -> None:
    """Copy a batch=1 sub-state into batch row ``idx`` of the pool state,
    in place, walking each group's state tree (``NamedTuple`` s nested
    any way, as the reference maps over the whole pytree). Leaves are
    (L, B, ...) stacked per layer, the slot's (L, 1, ...), cast to the
    pool's dtype; the shared ``pos`` counter is skipped."""
    def copy(dst, src):
        if isinstance(dst, tuple):
            for d, s in zip(dst, src):
                copy(d, s)
        else:
            dst[:, idx] = src[:, 0]

    for name, pool in state.items():
        if name != "pos":
            copy(pool, slot_state[name])


class ServeEngine:
    def __init__(self, model: Model, params, scfg: ServeConfig):
        self.model = model
        self.params = model._cast(params)  # once, at load
        self.scfg = scfg
        self.cfg = model.cfg
        b, s = scfg.max_batch, scfg.max_seq
        self.state = model.init_decode_state(b, s)
        # per-slot bookkeeping (host side)
        self.slots: List[Optional[Request]] = [None] * b
        self.slot_pos = np.zeros(b, np.int32)  # valid length per slot
        self._uid = 0
        self._decode = model.decode_step
        self._prefill = model.prefill
        mesh = model.mesh
        self._spmd = mesh is not None and mesh.caller_holds_block
        self.agreements = 0  # host agreements on a process group, and their host seconds
        self.agreement_s = 0.0

    def _agree(self, point: str, values: Sequence[int]) -> None:
        """On a process group: one ``mesh.host_max`` over ``point`` and
        ``values`` and their negations (a fixed width, so any two points
        pair up); raises :class:`StreamMismatch` on every rank unless
        every rank passed the same ones."""
        if not self._spmd:
            return
        width = 1 + max(self.scfg.max_batch, 4)
        vals = [float(_POINTS.index(point) + 1)] + [float(v) for v in values]
        vals += [0.0] * (width - len(vals))
        t0 = time.perf_counter()
        got = self.model.mesh.host_max(vals + [-v for v in vals])
        self.agreement_s += time.perf_counter() - t0
        self.agreements += 1
        hi, lo = got[:width], [-v for v in got[width:]]
        if hi != lo:
            points = sorted({_POINTS[int(hi[0]) - 1], _POINTS[int(lo[0]) - 1]})
            raise StreamMismatch(
                f"the ranks' serving streams differ at {points}: largest {hi[1:]}, smallest {lo[1:]}; every rank "
                "must add the same prompts in the same order and sample the same tokens")

    # ------------------------------------------------------------- requests
    @torch.inference_mode()
    def add_request(self, prompt: np.ndarray, max_new: int = 32) -> Optional[int]:
        try:
            slot = self.slots.index(None)
        except ValueError:
            return None
        req = Request(self._uid, np.asarray(prompt, np.int32), max_new)
        self._agree("admit", [zlib.crc32(req.prompt.tobytes()), req.prompt.shape[0], max_new, slot])
        self._uid += 1
        scratch = self.model.init_decode_state(1, self.scfg.max_seq)
        tokens = torch.as_tensor(req.prompt[None, :], device=self.model.device)
        scratch, logits = self._prefill(self.params, {"tokens": tokens}, scratch)
        _set_slot(self.state, scratch, slot)
        self.slot_pos[slot] = req.prompt.shape[0] + self.cfg.meta_tokens
        req.out.append(int(torch.argmax(logits[0])))
        self.slots[slot] = req
        return slot

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One decode step for all slots; returns finished requests."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        tokens = np.zeros((self.scfg.max_batch, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].out[-1]
        # shared pos counter: slots decode in lockstep from the pool's pos;
        # per-slot validity is each row's cache length
        self.state["pos"] = int(self.slot_pos[active].max())
        logits, self.state = self._decode(
            self.params, torch.as_tensor(tokens, device=self.model.device), self.state
        )
        if self.scfg.temperature > 0:
            g = torch.Generator(device=logits.device)
            g.manual_seed(int(self._uid) + int(self.slot_pos.sum()))
            probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=g)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.cpu().numpy()
        self._agree("step", nxt.tolist())
        finished = []
        for i in active:
            r = self.slots[i]
            r.out.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if len(r.out) >= r.max_new or self.slot_pos[i] >= self.scfg.max_seq - 1:
                r.done = True
                finished.append(r)
                self.slots[i] = None
        return finished

    def run(self, prompts: List[np.ndarray], max_new: int = 32) -> Dict[int, List[int]]:
        """Serve all prompts to completion (the launcher's loop)."""
        results: Dict[int, List[int]] = {}
        pending = PendingQueue(prompts)
        while pending or any(s is not None for s in self.slots):
            while pending:
                if self.add_request(pending.peek(), max_new) is None:
                    break
                pending.pop()
            for r in self.step():
                results[r.uid] = r.out
        return results
