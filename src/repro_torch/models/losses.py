"""Losses, ported from ``repro.models.losses``: sequence-chunked softmax
cross-entropy (+ z-loss).

The (B, S, V) logit tensor is the single biggest activation at large
vocabularies. It is never materialized: the unembed product, the
logsumexp and the label gather run per sequence chunk, each chunk under
``torch.utils.checkpoint`` (non-reentrant), so autograd holds one
chunk's (B, chunk, V) logits at a time -- in the forward and again in
the backward, where the chunk is recomputed -- not all of them.

Numerics follow the reference's: the logits in float32 after the
unembedding, the softcap on them, ``lse`` and the gold logit in float32,
a mask from ``labels >= 0``, and the counts clamped at 1. The last chunk
is padded with zero rows and ignored labels, as the reference pads it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common


def _chunk_ce(x, labels, mask, unemb_fn: Callable, softcap_v: float):
    """x: (B, L, d); labels: (B, L). Returns (sum_nll, sum_z2, count)."""
    logits = common.softcap(unemb_fn(x).float(), softcap_v)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    z2 = (lse * lse) * mask
    return nll.sum(), z2.sum(), mask.sum()


def chunked_xent(
    x: torch.Tensor,  # (B, S, d) final hidden states
    labels: torch.Tensor,  # (B, S) int; -1 = ignore
    unemb_fn: Callable,
    *,
    seq_chunk: int = 1024,
    z_loss: float = 0.0,
    final_softcap: float = 0.0,
    count_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean_nll, mean_z_loss_term). Never materializes (B,S,V).
    ``count_sum``: where the caller holds its rows of a batch split over
    ranks, the global count of kept labels from the local one (a sum over
    the ranks): the result is then the rank's share of the global masked
    mean, and the shares sum to it (the reference's mean over the whole
    batch, not a mean of the ranks' means)."""
    s = x.shape[1]
    labels = labels.to(x.device)
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0)
    seq_chunk = min(seq_chunk, s)
    if s % seq_chunk:
        pad = seq_chunk - s % seq_chunk
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        s = s + pad
    nll = z2 = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, seq_chunk):
        sl = slice(start, start + seq_chunk)
        a, b, c = checkpoint(_chunk_ce, x[:, sl], labels[:, sl], mask[:, sl], unemb_fn, final_softcap,
                             use_reentrant=False)
        nll, z2, cnt = nll + a, z2 + b, cnt + c
    if count_sum is not None:
        cnt = count_sum(cnt)
    cnt = torch.clamp(cnt, min=1.0)
    return nll / cnt, z_loss * z2 / cnt


def full_xent(x, labels, unemb_fn: Callable, *, z_loss: float = 0.0, final_softcap: float = 0.0):
    """Unchunked oracle for tests."""
    labels = labels.to(x.device)
    logits = common.softcap(unemb_fn(x).float(), final_softcap)
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    cnt = torch.clamp(mask.sum(), min=1.0)
    nll = ((lse - gold) * mask).sum() / cnt
    zl = z_loss * ((lse * lse) * mask).sum() / cnt
    return nll, zl
