#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--fsdp]

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
7. NCCL -- run right after the build, while this process holds nothing
   on card 0 (after phases 3-6 it held ~11 GiB there, which rank 0 of a
   four-card run then lacked); one process per visible card
   (torch.multiprocessing.spawn),
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
   and roofline().as_dict();
11. serving under faults -- SpectralEngine(SimMesh(4), max_batch=8,
   plan_kwargs=dict(backend="scatter", local_impl="kernel")) on 4096^2
   complex64 fft and float32 poisson requests made on the card, every
   bucket (1, 2, 4, 8) warmed before any fault is armed: a clean stream
   of 32 fft + 8 poisson requests coalesced and then solo (p50 / p99
   latency, transforms/s, mean batch, the pool / stack / execute
   dispatch spans); a poisoned coalesced batch of 4 (3 resolve, 1 is
   quarantined); the breaker under an injected clock (two failures open
   the key, the degraded xla_auto dispatch launches no kernel, one probe
   re-closes it); and FaultPlan.rate(0.05, seed=7) over 64 requests.
   Every result is held against torch.fft.fft2(x).mT or a float64
   Poisson solve; the clean streams must launch all three kernels, the
   pack in both modes;
12. elastic recovery -- the reference's ELASTIC_CODE at 4096^2 with
   unfused alltoall and the kernels: SimMesh(4) fails at step 3 of 6,
   run_with_recovery resumes on elastic_mesh(max_devices=2) from the
   step-3 checkpoint, and the result must equal an uninterrupted
   SimMesh(2) run bitwise and SimMesh(4)'s to 1e-6;
13. overlap rings -- repro_torch.core.overlap's ring_all_gather,
   collective_matmul_ag, ring_reduce_scatter and ring_scatter_reduce on
   SimMesh(4) at Qwen2.5-32B's MLP widths (4096 tokens, d_model 5120,
   d_ff 27648, float32), each held against its dense torch answer
   (1e-5 relative) and timed beside it, and the gradient through
   ring_all_gather against 2x;
14. LM serving -- repro_torch's dense decoder LM with Qwen2.5-32B, after
   the earlier phases' memory is freed (fails unless the card has the
   weights + KV cache + 6 GiB free, before it starts and again before
   the full-depth model): (1) at full width, 2 layers, float32, a
   300-token prefill + 4 decode steps against Model.logits of the whole
   sequence (1e-4 relative to the largest logit), attention_chunked
   against attention_naive at that shape (1e-5), and one request's greedy
   tokens alone equal to its tokens among 8 slots; (2) all 64 layers in
   bfloat16, built as launch/serve.py builds them (launch.build_engine),
   its weights' bytes and its decode cache's equal to the dry run's
   (launch.dryrun) decode cell at 8 x 2048 on one rank, exactly;
   prefill + 1 decode step against the whole sequence's logits (3e-2);
   (3) that engine on the launcher's prompt stream (rng(0), 16 requests
   of 4-512 tokens, 64 new tokens each, ServeConfig()'s 8 slots and
   max_seq 2048, greedy): tokens/s, time to first token p50 / p99, the
   decode step's device ms (CUDA events) beside the host's ms to issue
   it and its kernels' ms (torch.profiler), each beside its bound, and
   peak memory (fails above 72 GiB); (4) launch.serve.main at its reduced
   default on the card; (5) attention_chunked at a 512-token prefill
   (bfloat16) timed beside F.scaled_dot_product_attention, which the
   port never calls. None of the FFT kernels runs here (``lm_serving``:
   0 launches each);
15. MoE + MLA serving -- DeepSeek-V3 (MLA, 256 experts top-8 + a shared
   one) and Mixtral-8x22B (8 experts top-2) at full width, each after
   phase 14's free-memory check: (1) 2 layers in float32 (DeepSeek: one
   dense + one MoE) at capacity_factor = E / k, where the capacity is
   every token and nothing drops: check 1 of phase 14 (1e-4 of the whole
   sequence's logits, isolation exact) and one MoE layer's einsum
   dispatch against the dense one (1e-5); (2) the depth cut to fit the
   card (DeepSeek 5 layers: its 3 dense + 2 MoE; Mixtral 12 of 56; the
   MTP head off) in bfloat16, built by launch.build_engine at the stock
   capacity_factor 1.25; on 8 prompts, with no drops (a capacity_factor
   = E / k Model on the same weights), prefill + 1 decode step and the
   whole sequence's logits, each against a float32 oracle (a float32
   Model on those bf16 weights): the median error of prefill + decode
   within 1.5 x the bf16 forward's own (which must stay under 0.1), and
   phase 14's comparison printed beside; (3) phase 14's stream on that engine at
   the stock factor, with the dropped share of each MoE layer's
   assignments in the first full-slot decode step, the decode step
   beside two bounds (all the weights: the einsum dispatch reads every
   expert; and only the experts that step routed to), peak memory
   (fails above 72 GiB); (4) launch.serve.main --arch at its reduced
   default; after phase 16, DeepSeek-V3's engine decodes one step (batch
   1, bfloat16) over a 131,072-position latent cache filled from the
   seed, whole on one rank and with its sequence over data on
   SimMesh((2, 2)): both steps' ms and the cache bytes a rank, no gate on
   speed. No FFT kernel runs here (``moe_serving_<arch>``: 0 each);
16. expert parallelism on SimMesh(4) -- each of phase 15's models split
   four ways on this card, on phase 15's weights (the same tensors: a
   rank's experts are views of the stacks): (1) on check 1's float32
   2-layer model, a 300-token prompt through the ring (4 divides it), its
   interleave=True form and the einsum dispatch over the ranks, each
   within 1e-5 of the one-rank logits, the einsum dispatch's aux within
   1e-6 of the one-rank aux, and each run must take the dispatch named
   (``moe.DISPATCHES``); (2) phase 14's stream at the stock factor on
   Model(cfg, SimMesh(4)) behind a ServeEngine: phase 14's report, the
   share of greedy tokens equal to phase 15's one-card engine, the
   dispatches that ran, and for DeepSeek-V3 one 512-token prefill and one
   MoE layer timed through the ring, the interleaved ring, the einsum
   dispatch and the one-rank model (``ep_sim_serving_<arch>``: 0 FFT
   launches each);
17. tensor parallelism on SimMesh(4) -- heads, d_ff and vocabulary split
   four ways on this card, each rank's block a view: (1) float32 at full
   width, 2 layers, on the one-rank model's weights: hidden of a 300-token
   prompt (the Megatron sequence-parallel rings), its prefill and 2 decode
   steps (the psum form), each within 1e-5 of the one-rank model, for
   Qwen2.5-32B (heads partition, and attn_partition="context"),
   Gemma2-9B, and phase 15's two check-1 models (run beside phase 16's
   check 1: tensor- and expert-parallel); the cache's sequence over data
   (seq_shard) on SimMesh((2, 2)): phase 15's check-1 DeepSeek-V3 (its
   latent cache) and Hymba-1.5B at 4 layers, 2 rows, a 300-token prompt
   written into both blocks and 2 decode steps within 1e-5 of one rank,
   flash_decode_combine counted; (2) Qwen2.5-32B at 8 of 64
   layers in bfloat16, phase 14's stream on one rank and on
   Model(cfg, SimMesh(4)) on the same weights: phase 14's report, the
   share of greedy tokens equal to one rank's; one prefill of 2 x 512
   tokens and one decode step on SimMesh(4), each one's activation
   collectives (``core.mesh.collectives``, one rank's share) equal to
   ``launch.dryrun``'s prefill / decode cell on MeshShape((1, 4)),
   counts and bytes of each kind, exactly; and one 512-token prompt's
   prefill beside hidden on both (``tp_sim_serving``: 0 FFT launches);
18. SSM and hybrid serving -- xLSTM-1.3B (24 mLSTM + sLSTM pairs) and
   Hymba-1.5B (attention beside Mamba heads, 128 meta tokens), each after
   phase 14's free-memory check: (1) at full width in float32 with the
   depth cut (xLSTM 2 layers, one pair; hymba 4, layer 1 windowed), a
   300-token (xLSTM) / 1200-token (hymba: 1328 positions with the meta
   tokens, past the 1024 window) prefill + 4 decode steps against the
   whole sequence's logits (2e-4, the reference's own chunkwise-vs-steps
   tolerance), and phase 14's slot isolation; (2) all 48 / 32 layers in
   bfloat16, built by launch.build_engine: on 8 prompts a prefill of 128
   + 1 decode step and the whole sequence, each against a float32 oracle
   on the same weights, phase 15's gate -- for xLSTM layer by layer, each
   layer on the oracle's input (its random-weight stack amplifies any
   rounding through the depth); (3) phase 14's stream, its
   report, the bound counting the recurrent state read and written once
   a step; (4) one 512-token prompt through each mixer alone on one layer
   (the mLSTM block, the sLSTM time loop, the Mamba block, hymba's
   attention); (5) launch.serve.main --arch at its reduced default
   (``ssm_serving_<arch>``: 0 FFT launches each).
19. the encoder-decoder and the SSM and hybrid models over a mesh
   (``encdec_mesh_phase``): (1) whisper-medium at full width, 2 encoder +
   2 decoder layers, float32, 2 utterances of 1500 frames: a 32-token
   prefill + 4 decode steps within 1e-4 of the whole decoder sequence,
   each row's greedy tokens alone and in the batch identical, and
   Model(cfg, SimMesh(4)) (heads and d_ff split, the odd vocabulary
   whole) within 1e-5 of one rank; (2) all 24 + 24 layers in bfloat16:
   phase 15's float32-oracle gate on 8 utterances, then 8 utterances of
   1500 frames with the start-of-transcript prompt and a decode state of
   448: time to first token (encoder, cross K/V, decoder prefill), 64
   greedy tokens, the decode step's device / host / kernel ms beside its
   bound (the decoder's weights, the unembedding, the cross K/V and the
   live self K/V read once), tokens/s, peak memory
   (``encdec_serving``); (3) xLSTM-1.3B (2 layers) and Hymba-1.5B (4)
   at full width in float32 on SimMesh(4) against one rank within 2e-4
   (logits of 300 / 1200 tokens, prefill, decode; the one-rank model with
   every weight moved one ulp printed beside), then both at full depth
   in bfloat16: a prefill of 8 prompts of 512 tokens and 8 decode steps,
   one rank beside SimMesh(4), and the decode state one rank of a
   4-rank group holds (``ssm_mesh_serving``);
20. training (``training_phase``): (1) float32, each custom backward
   against autograd through its plain version, every gradient within
   1e-5 of its largest entry -- the flash backward at Qwen2.5-32B's,
   Gemma2-9B's (softcap 50) and Hymba-1.5B's heads (its window crossed)
   against attention_naive, the Mamba backward at Hymba's d_inner and
   state against a sequential scan, and Hymba-1.5B at full width, 4
   layers, every leaf's gradient of Model.loss against the same weights
   with attn_impl="naive" and the sequential scan, then the same
   gradients with bf16 compute against the float32 ones, each leaf
   within 0.1 in norm; (2) Hymba-1.5B
   whole (32 layers, full width): init_train_state (float32 master
   weights and AdamW state), bf16 compute, remat full, 6 steps of
   make_train_step over SyntheticLM (2 x 4096 tokens) at TrainConfig's
   default lr 3e-4: finite losses and gradient norms, the last three steps'
   mean loss below the first three's, peak memory under 72 GiB; the
   dry run's state bytes (launch.dryrun, one rank) equal to the state's
   own, within 1 % of torch.cuda.memory_allocated's growth over
   init_train_state, its floor peak at most the measured one; the
   step's device ms (CUDA events) and host ms to issue it, tokens/s,
   the model-FLOP share of the bf16 dense peak, each custom backward's
   ms a layer; (3) launch/train.py's train() in-process, reduced, with
   a failure injected at step 6: one restart, 12 finite losses; (4) the
   step over a model axis: Model.loss on SimMesh((1, 2)) against one
   rank in float32, every leaf's gradient within 1e-5 of its largest
   one-rank entry, for check 1's Hymba-1.5B (25 / 5 heads: the context
   partition, beside Mamba's channel split) and Qwen2.5-32B at full
   width, 2 layers (heads, d_ff and its 152064-word vocabulary split,
   Megatron sequence parallelism); (5) 3 bf16 steps of check 1's Hymba
   on SimMesh((1, 2)) beside one rank: device ms, host ms to issue,
   peak memory, the last step's activation collectives equal to the dry
   run's walk (``one_process``) exactly (``training_tp``: 0 FFT
   launches); (6) the train launcher
   over a one-rank torch.distributed world on Hymba-1.5B at full width,
   1 layer, its checkpoint rewritten as the placed checkpoint of a
   (2, 2) grid by four gloo ranks on the host's CPU, and restored from
   those four files onto one rank on the card, bitwise; one float32 step of check 1's Hymba on SimMesh((2, 2))
   against one rank, its activation collectives equal to the walk's on
   that SimMesh (``one_process``: its one ``model`` ring on the whole
   batch) exactly (``training_fsdp``: 0 FFT launches). NCCL puts one
   rank on each card, so on one card no check runs FSDP itself.
21. the dry run (``dryrun_phase``): ``python -m repro_torch.launch.dryrun
   --all --mesh both`` as a subprocess (no card: a walk over the
   placement specs) must exit 0 with 64 ``_torch.json`` cells; one line
   a cell: GiB a rank (a floor), the bottleneck and the roofline's three
   times from the H100 data-sheet constants, the state's and the
   activation collectives' shipped bytes a rank (their sum the roofline's
   ``coll_bytes``, checked), beside the card's name and power limit (0
   FFT launches).

Phase 7 also fits alpha and beta per rank over NCCL (the default sizes,
and sizes up to 64 MiB; on one card a rank's message to itself, a
copy), prints the backend="auto" pick under the fitted constants, and
races planner="measure" on the c2c main path: it fails unless every
rank names the same winner, whose result equals SimMesh's to 1e-6.
Then its fault part: a FaultPlan.error armed on rank 0 only must make
every rank raise at the same Exchange, far inside the NCCL timeout, and
the clean run after it must equal SimMesh; on P > 1 cards the ranks
shrink P -> P/2 over dist.new_group (rank 0 checkpointing the gathered
state), and the survivors' result must equal an uninterrupted P/2 run
and SimMesh(P/2) bitwise (one card: P = 1 cannot shrink; phase 12 does).
Then SPMD serving: the host time of one agreement (mesh.host_max over
the group's gloo half, beside mesh.all_max over NCCL, idle and with
matmuls queued on the stream); phase 11's clean stream through
SpectralEngine on the ProcessGroupMesh, every rank submitting its own
block of each request, coalescing on and off, every block held against
SpectralEngine(SimMesh(P)) on the same stream (1e-6) and every rank
making the same batches; a poisoned batch and a breaker trip with the
faults on rank 0 only and each rank's clock offset differently, whose
counters must agree on every rank; and on P > 1 cards the engine's
remesh onto the P/2 survivors, bitwise equal to SimMesh(P/2)'s engine.
Then phase 13's rings over NCCL, each timed beside the library
collective that computes the same result (all_gather_into_tensor,
reduce_scatter_tensor, all-gather + torch.matmul). Last, expert
parallelism over NCCL (``nccl_moe``; alone: ``nccl_moe_phase``): for
each MoE arch at full width, 2 layers, float32, nothing dropped, the
one-card model first, then Model(cfg, ProcessGroupMesh) from the same
seed (each rank keeps its experts): the whole sequence's logits (256
tokens: the ring), prefill + 2 decode steps (the einsum dispatch over
the ranks) within 1e-5 of one card's, and a short stream through the
SPMD ServeEngine whose greedy tokens must equal one card's and every
rank's. On P > 1 cards it then serves DeepSeek-V3 at 12 layers (3 dense
+ 9 MoE) and Mixtral-8x22B at all 56 layers in bf16, both tensor- and
expert-parallel, on phase 14's stream at
the stock factor: every rank's tokens identical, peak memory under 72
GiB a card, tokens/s, time to first token, the decode step's device and
host ms, and DeepSeek-V3's prefill through the ring, the interleaved
ring and the einsum dispatch (one card: P = 1, the model is whole and
the dispatch runs on one rank; ``nccl_moe``: 0 FFT launches). Last,
tensor parallelism over NCCL (``nccl_tp``; alone: ``nccl_tp_phase``):
phase 17's float32 dense checks and phase 19's models' (whisper,
xLSTM, hymba: logits, prefill, decode) against one card, every rank's
outputs bitwise equal (the MoE check above holds its logits so too), and on
P > 1 cards Qwen2.5-32B at 64 layers served; on four cards DeepSeek-V3
(full width, its 2 dense layers, float32) with its latent cache's
sequence over data on a (2, 2) grid (``nccl_latent_seq``), a 300-token
prefill and 2 decode steps within 1e-5 of one card, half the latent
cache a rank; each served model prints
one decode step's collectives by name and checks its activation
collectives against the dry run's decode cell on every rank, exactly
(``nccl_tp``: 0 FFT launches),
and one train step of check 1's Hymba-1.5B (full width, 4 layers,
float32) on Model(cfg, ProcessGroupMesh) against one card from the same
seed: each rank's blocks of every gradient and of the parameters after
the step within 1e-5 of one card's, the leaves kept whole, the loss and
the gradient norm bitwise equal on every rank.
Last, training (``nccl_ddp``): make_ddp_compressed_step over a "data"
axis, Hymba-1.5B at full width and 4 layers in float32, each rank its
block of 8 x 512 tokens, 4 steps without compression and 4 with the
int8 all-gather: every rank's parameters equal after every step, the
int8 losses within 0.15 x the first of the uncompressed run's, the
bytes a step's gradient reduction moves (P = 1 on one card: no message).
Last, FSDP x TP (``nccl_fsdp``): one float32 step of check 1's Hymba and
of Qwen2.5-32B (full width, 2 layers) over grids (P, 1) and, at P >= 4,
(2, P / 2) against one card, every rank's blocks within 1e-5; on four
cards Qwen2.5-32B at 8 of 64 layers (~87 GB of float32 state, more than
one card holds) trained 3 bf16 steps on (4, 1), (2, 2) and (1, 4): step
ms, host ms, peak GiB, the bytes FSDP gathers and reduce-scatters. On
every grid the rank's state bytes and the bytes each kind of state
collective moved equal the dry run's prediction (launch.dryrun), printed
before the four-card steps, and on four cards every step's activation
collectives (over ``model``) equal the walk's, exactly, on every rank. At P = 1 the grid (1, 1) moves no message,
and the dry run predicts none. ``--fsdp`` runs this part over
every card and phase 20's check 6 alone (nothing built, no result line).

Phases 4-12 each zero the kernels' launch counters just before they run
and read them just after, the pack's split by mode; each fails if a
kernel of its path was never launched (at P = 1 a plan does not fuse,
so phase 7 launches the two stages only), phase 4 if its exchange did
not pack P own chunks fresh and P(P-1) arrivals accumulating, and
phases 8, 9 and 11 if the path's peak memory reaches 40 GiB. Phases 4-6,
8-9 and 11 print the shapes each kernel was launched at and time each
kernel once at every shape not timed before. Kernel times are CUDA-event medians of
runs of back-to-back calls. The second-to-last line is one JSON object
with a row per kernel, the pack's accumulate mode a row of its own
(``chunk_twiddle_pack_c64 accumulate``), its ``launches_by_path`` the
counts of every counted path, phases 7 (SPMD serving, ``nccl_moe``,
``nccl_tp``, ``nccl_ddp``, ``nccl_fsdp``), 11-12, 14 (``lm_serving``), 15 (``moe_serving_<arch>``), 16
(``ep_sim_serving_<arch>``), 17 (``tp_sim_serving``), 18
(``ssm_serving_<arch>``), 19 (``encdec_serving``,
``ssm_mesh_serving``), 20 (``training``,
``training_tp``, ``training_fsdp``) and 21 (``dryrun``) included;
the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import traceback
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
SERVE_N = 4096  # phases 11-12: 4096^2 complex64 requests (128 MiB) and float32 fields (64 MiB)
SERVE_BATCH = 8  # the engine's max_batch: buckets 1, 2, 4, 8 (a full fft bucket is 1 GiB)
SERVE_FFT, SERVE_POISSON = 32, 8  # phase 11's clean stream
CHAOS_REQUESTS, CHAOS_RATE, CHAOS_WAVE = 64, 0.05, 4  # serve_sweep.py's chaos row, at 4096^2, waves of 4
SERVE_KW = dict(backend="scatter", local_impl="kernel")
ELASTIC_STEPS, ELASTIC_FAIL_AT = 6, 3  # the reference's ELASTIC_CODE (tests/test_faults.py)
#: unfused alltoall: local FFTs and pure data movement, so a state is the
#: same at any rank count (the reference's ELASTIC_CODE setting)
ELASTIC_KW = dict(backend="alltoall", pipeline=False, local_impl="kernel")
STAGE_RTOL, STAGE_ATOL = 2e-4, 2e-3  # the reference's per-stage tolerances
PACK_RTOL, PACK_ATOL = 1e-5, 1e-5  # one complex multiply per element
FFT_REL_TOL = 2e-5  # fft_last_axis vs the library FFT, relative to max
#: the overlap rings' widths: Qwen2.5-32B's MLP (src/repro/configs/qwen2_5_32b.py:
#: d_model 5120, d_ff 27648) over 4096 tokens, float32
RING_TOKENS, RING_D_MODEL, RING_D_FF = 4096, 5120, 27648
RING_REL_TOL = 1e-5  # fp32 sums in another order, relative to the largest entry
RING_REPS = 5
AGREE_BUSY_N, AGREE_BUSY_MATMULS = 8192, 3  # float32 matmuls queued before an agreement (~20 ms each)
#: phase 14: Qwen2.5-32B (src/repro/configs/qwen2_5_32b.py: 64 layers,
#: d_model 5120, 40 / 8 heads, d_ff 27648, vocab 152064)
LM_ARCH = "qwen2.5-32b"
LM_SEQ, LM_DECODE = 300, 4  # check 1: a 300-token prefill, then 4 decode steps
LM_F32_LAYERS = 2
LM_F32_REL_TOL = 1e-4  # float32, TF32 off, float32 cache: prefill + decode vs the full sequence's logits
LM_ATTN_REL_TOL = 1e-5  # attention_chunked vs attention_naive, float32
LM_ISOLATION_LENGTHS, LM_ISOLATION_NEW = (37, 5, 120, 64, 9, 300, 18, 77), 8  # check 1's slot isolation
LM_BF16_SEQ = 128  # check 2's prompt at full depth
LM_BF16_REL_TOL = 3e-2  # bfloat16, 64 layers: prefill + decode vs the full sequence's logits
LM_REQUESTS, LM_PROMPT_LEN, LM_MAX_NEW = 16, 512, 64  # the stream, on launch/serve.py's prompts
LM_PEAK_LIMIT_GIB = 72.0
LM_HEADROOM_GIB = 6.0  # free memory needed beyond the weights and the KV cache
LM_TOP_KERNELS = 8  # the decode step's longest kernels, printed by name
#: phase 15: MoE + MLA serving at full width, depth cut to fit one card.
#: DeepSeek-V3 (src/repro/configs/deepseek_v3_671b.py: 61 layers, d_model
#: 7168, 128 heads, MLA q / kv ranks 1536 / 512, rope 64, nope 128, v 128,
#: 256 routed experts top-8 + 1 shared, expert d_ff 2048, dense d_ff 18432,
#: vocab 129280) at its 3 dense + 2 MoE layers; Mixtral-8x22B
#: (src/repro/configs/mixtral_8x22b.py: 56 layers, d_model 6144, 48 / 8
#: heads, d_ff 16384, 8 experts top-2, vocab 32768) at 12 layers
MOE_CUTS = {"deepseek-v3-671b": dict(num_layers=5), "mixtral-8x22b": dict(num_layers=12)}
MOE_F32_CUTS = {"deepseek-v3-671b": dict(num_layers=2, first_k_dense=1), "mixtral-8x22b": dict(num_layers=2)}
MOE_DISPATCH_REL_TOL = 1e-5  # einsum vs dense dispatch, float32, nothing dropped
#: check 2 of phase 15, bfloat16 at the cut depth against a float32 oracle
#: (the same bfloat16 weights through a float32 Model): over MOE_BF16_ROWS
#: prompts the median error of prefill + decode may exceed the median error
#: of the bfloat16 whole-sequence forward itself by this factor (a routing
#: flip in one row moves that row's logits by 0.2-0.35), and that error
#: must stay under MOE_BF16_FLOOR_LIMIT
MOE_BF16_ROWS, MOE_BF16_NOISE_RATIO, MOE_BF16_FLOOR_LIMIT = 8, 1.5, 0.1
#: phase 16: phase 15's models expert-parallel on SimMesh(EP_P), every
#: rank on this card; phase 7's MoE part: the same over NCCL, one rank a card
EP_P = 4
EP_REL_TOL = 1e-5  # float32, nothing dropped: a dispatch over the ranks vs the one-rank model's logits
EP_PREFILL, EP_REPS = 512, 3  # the dispatches' prefill timing: one 512-token prompt, median of 3
#: phase 7's MoE part: a float32 2-layer check (MOE_F32_CUTS) on a prompt
#: every rank count up to 8 divides, then (P > 1) the served depths: with
#: the routed experts split P = 4 ways and the rest replicated, bf16
#: weights are 57.9 GiB a card (DeepSeek-V3, 3 dense + 9 MoE layers) and
#: 62.6 GiB (Mixtral-8x22B, 48 of 56 layers; all 56 would be 72.9)
NCCL_MOE_SEQ, NCCL_MOE_DECODE = 256, 2
NCCL_MOE_PROMPTS, NCCL_MOE_NEW = (64, 37, 128, 20), 4  # the float32 engine's stream, 4 slots
NCCL_MOE_CUTS = {"deepseek-v3-671b": dict(num_layers=12), "mixtral-8x22b": dict(num_layers=56)}
#: phase 17: tensor parallelism on SimMesh(TP_P), every rank on this card;
#: phase 7's TP part: the same over NCCL. Float32 checks at TP_F32_LAYERS
#: layers (the dense archs here; the MoE archs on phase 15's check-1
#: weights), within TP_REL_TOL of the one-rank model on the same weights.
#: With heads, d_ff and vocabulary split as well, Mixtral-8x22B's 56
#: layers take 65.5 GiB a card of bf16 weights over four cards (the
#: experts 63.0, the rest 9.93 / 4).
TP_P = 4
TP_REL_TOL = 1e-5  # float32: psums and rings add the ranks' partials in another order than one rank's GEMM
TP_F32 = (("qwen2.5-32b", {}), ("qwen2.5-32b", {"attn_partition": "context"}), ("gemma2-9b", {}))
TP_F32_LAYERS, TP_DECODE = 2, 2
#: phase 7's TP part also runs phase 19's models' float32 checks (logits,
#: prefill, decode) at 2 layers (hymba 4: layer 1 windowed), whisper's
#: encoder over ENCDEC_FRAMES frames
TP_F32_MORE = (("whisper-medium", {"encoder_layers": 2}), ("xlstm-1.3b", {}), ("hymba-1.5b", {"num_layers": 4}))
TP_SERVE_LAYERS = 8  # phase 17's bf16 serving: Qwen2.5-32B at full width, 8 of 64 layers
TP_PREFILL, TP_REPS = 512, 3  # one 512-token prompt: prefill (psum form) beside hidden (the rings)
TP_COUNT_BATCH = 2  # phase 17's counted prefill and decode step: 2 rows of TP_PREFILL
#: the serving cache's sequence over ``data`` (``seq_shard``, the reference's
#: long_500k): phase 17 on SimMesh(SEQ_GRID) over ("data", "model") -- phase
#: 15's check-1 DeepSeek-V3 (its latent cache) and Hymba-1.5B at 4 layers
#: (its KV cache, head dim cut over model) -- and phase 7 on four cards over
#: NCCL (DeepSeek-V3, half the latent cache a rank); phase 15 times one bf16
#: decode step of its DeepSeek-V3 over a SEQ_LONG-position latent cache
SEQ_GRID = (2, 2)
SEQ_AXES = ("data", "model")
SEQ_HYMBA_LAYERS = 4
SEQ_LONG, SEQ_REPS = 131072, 5
NCCL_SEQ_LAYERS = 2  # phase 7's check: DeepSeek-V3's first two layers, both dense
#: phase 18: SSM and hybrid serving on one card at full width and depth.
#: xLSTM-1.3B (src/repro/configs/xlstm_1p3b.py: 48 layers as 24 mLSTM +
#: sLSTM pairs, d_model 2048, mLSTM 4 heads of 1024 (expand 2), sLSTM 4
#: heads, vocab 50304); Hymba-1.5B (src/repro/configs/hymba_1p5b.py: 32
#: layers, d_model 1600, 25 / 5 heads of 64, d_ff 5504, Mamba d_inner 3200
#: and state 16, window 1024 but layers 0, 16 and 31 global, 128 meta
#: tokens, vocab 32001)
SSM_ARCHS = ("xlstm-1.3b", "hymba-1.5b")
#: check 1, float32 at full width: xLSTM one pair on a prompt its chunk
#: (64) does not divide; hymba layers 0, 2, 3 global and 1 windowed, on a
#: prompt past the window with the meta tokens (1328 positions)
SSM_F32_LAYERS = {"xlstm-1.3b": 2, "hymba-1.5b": 4}
SSM_F32_SEQ = {"xlstm-1.3b": 300, "hymba-1.5b": 1200}
SSM_F32_REL_TOL = 2e-4  # the reference's own chunkwise-vs-decode-steps tolerance (tests/test_ssm.py:28-30)
SSM_MIXER_SEQ, SSM_MIXER_REPS = 512, 3  # check 4: one prompt through each mixer alone, one layer
#: check 2 layer by layer: the reference's random-weight xLSTM amplifies
#: rounding through its depth (tools/ssm_depth_probe.py, reduced width, on
#: the CPU: the reference's own bf16 logits 1.19 from its float32 ones at
#: 48 layers; two float32 orders 8.8e-7 apart at 2 layers, 3.1e-3 at 48),
#: so no whole-model bf16 gate can hold; each layer runs in bf16 on the
#: float32 oracle's input and phase 15's gate holds per layer
SSM_BF16_LAYERWISE = ("xlstm-1.3b",)
#: phase 19: whisper-medium (src/repro/configs/whisper_medium.py: 24
#: encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff 4096, vocab
#: 51865, gelu, layernorm, sinusoidal positions) served at the Model level
#: (the launcher refuses encoder-decoders, as the reference's does), and
#: phase 18's models over SimMesh(TP_P)
ENCDEC_ARCH = "whisper-medium"
ENCDEC_FRAMES = 1500  # 30 s of audio after whisper's conv stem (the reference's stub feeds frame embeddings)
ENCDEC_SOT = (50258, 50259, 50359, 50363)  # <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
ENCDEC_BATCH, ENCDEC_MAX_SEQ, ENCDEC_NEW = 8, 448, 64  # 8 utterances, whisper's decoder context, new tokens
ENCDEC_F32_LAYERS, ENCDEC_F32_SEQ = 2, 32  # check 1: 2 + 2 layers, a 32-token decoder prompt
ENCDEC_REPS = 3
SSM_TP_BATCH, SSM_TP_PREFILL, SSM_TP_DECODE = 8, 512, 8  # check 3 at full depth: 8 slots
#: check 3's float32 gate is SSM_F32_REL_TOL (phase 18's), not TP_REL_TOL:
#: over 300 tokens xLSTM's recurrences carry a one-ulp change of every
#: weight to 6.7e-6 of its logits, and the split products to 1.3-1.7e-5
#: (float32, TF32 off, NVIDIA H100 80GB HBM3)

#: phase 20: training on one card. Hymba-1.5B (phase 18's config) whole --
#: 32 layers, full width, float32 master weights and AdamW state, bf16
#: compute, remat "full" -- over SyntheticLM at train_4k's length: 2 x 4096
#: tokens a step (4224 positions with the meta tokens), 5 steps at the
#: train launcher's warmup. Check 1 holds the bf16 gradients to float32
#: ones, so these steps only show that the whole model trains: 5 keep a
#: first-three / last-three loss comparison (6 until check 6 needed the
#: room: each step is ~13.5 s)
TRAIN_ARCH = "hymba-1.5b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 5
#: TrainConfig's own default lr (the LM default), with launch/train.py's
#: warmup rule max(steps // 20, 5): at the launcher's 3e-3 (its smoke-size
#: default) the full-width model's loss rose 10.88 -> 11.69 in 10 steps
#: (NVIDIA H100 80GB HBM3, 700.00 W)
TRAIN_LR = 3e-4
#: check 1, float32 (TF32 off): each custom backward against autograd
#: through its plain version, every gradient within TRAIN_REL_TOL of its
#: largest entry (a leaf's, for the model)
TRAIN_REL_TOL = 1e-5
#: check 1's model in bf16 compute (float32 master weights, as the step
#: runs it) against its float32 gradients: each leaf's error within
#: TRAIN_BF16_TOL of that leaf's gradient in the 2-norm. bf16 keeps 8 bits
#: (unit roundoff 2^-9) and the error compounds over the layers' products:
#: the reduced Hymba (4 layers, width 64, 2 x 128 tokens) on the CPU
#: measured 0.025-0.038 a leaf; a dropped cast or a wrong bf16 product
#: errs by the gradient's own size
TRAIN_BF16_TOL = 0.1
TRAIN_FLASH_SEQ = 1024
TRAIN_HYMBA_POSITIONS = 2176  # past Hymba's window of 1024, meta tokens included
TRAIN_MAMBA_SEQ, TRAIN_MAMBA_BATCH = 1024, 2
TRAIN_F32_LAYERS, TRAIN_F32_SEQ = 4, 1200  # layer 1 windowed; 1328 positions
#: check 3: the launcher in-process, reduced, with an injected failure
TRAIN_LAUNCH_ARGS = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "12", "--batch", "4", "--seq", "64",
                     "--ckpt-every", "4", "--fail-at", "6"]
#: phase 7's training part: the compressed data-parallel step, Hymba-1.5B
#: at full width and 4 layers in float32, each rank its block of a batch of
#: 8 x 512, 4 steps a mode; the int8 run's loss within 0.15 x the first
#: loss of the uncompressed one (tests/test_elastic.py's gate)
DDP_LAYERS, DDP_BATCH, DDP_SEQ, DDP_STEPS = 4, 8, 512, 4
DDP_DRIFT = 0.15
#: phase 20's check 4: the step over a model axis of TRAIN_TP_P ranks on this
#: card (SimMesh((1, TRAIN_TP_P))), float32 (TF32 off), every leaf's gradient
#: against one rank's on the same weights and tokens within TRAIN_REL_TOL of
#: its largest entry: check 1's Hymba-1.5B (25 / 5 heads, which 2 divides
#: neither: the context partition, beside Mamba's channel split) and
#: Qwen2.5-32B at full width and TRAIN_TP_LAYERS layers (heads, d_ff and its
#: 152064-word vocabulary split; Megatron sequence parallelism on)
TRAIN_TP_P = 2
TRAIN_TP_ARCH, TRAIN_TP_LAYERS, TRAIN_TP_SEQ = "qwen2.5-32b", 2, 512
#: check 5: TRAIN_TP_STEPS bf16 steps of check 1's 4-layer Hymba on
#: SimMesh((1, TRAIN_TP_P)) beside one rank, TRAIN_TP_BATCH x TRAIN_TP_STEP_SEQ
#: tokens a step (1152 positions with the meta tokens)
TRAIN_TP_STEPS, TRAIN_TP_BATCH, TRAIN_TP_STEP_SEQ = 3, 2, 1024
#: check 6: (a) the train launcher over a one-rank process group (the world
#: of this process alone, cpu:gloo,cuda:nccl) on Hymba-1.5B at full width
#: cut to TRAIN_PG_LAYERS layers (launch.train's get_config patched, as
#: ssm_cfg cuts check 1's), TRAIN_PG_STEPS steps of TRAIN_PG_BATCH x
#: TRAIN_PG_SEQ, one checkpoint of whole leaves at the end (one rank cuts
#: nothing); four gloo processes on the host's CPU, the ranks of a (2, 2)
#: ('data', 'model') grid, each restore their blocks of it and write them
#: as one placed checkpoint (each its proc<k>.npz, rank 0's manifest
#: last), which restores from its four files onto one rank on the card
#: (and so onto SimMesh((2, 2)), whose state holds the same whole leaves),
#: bitwise. NCCL puts one rank on each card, so no
#: check on one card runs FSDP itself: phase 7's nccl_fsdp does on four.
#: (b) one float32 step of check 1's 4-layer Hymba on SimMesh((2, 2)),
#: microbatch 2, labels -1 in the first half of the positions of the first
#: half of each microbatch's rows, against one rank's: TP over model
#: beside a data axis that holds the whole batch in one process.
#: Hymba-1.5B whole in (a) writes and twice reads a 23.6 GB checkpoint:
#: 192.8 s on an H100 (PERF.md, section 6)
TRAIN_PG_LAYERS, TRAIN_PG_STEPS, TRAIN_PG_BATCH, TRAIN_PG_SEQ = 1, 2, 2, 256
TRAIN_GRID_BATCH, TRAIN_GRID_SEQ = 4, 512
#: phase 7's TP training check: one step of check 1's Hymba over NCCL on
#: 1 x NCCL_TRAIN_SEQ tokens (640 positions: every P of 1, 2, 4 divides them)
NCCL_TRAIN_SEQ = 512


#: phase 7's FSDP part (nccl_fsdp): one make_train_step (microbatch 2,
#: float32, TF32 off) over a grid of every card of the machine, (P, 1) and
#: at P >= 4 also (2, P / 2) ('data', 'model'), of check 1's Hymba-1.5B
#: (TRAIN_F32_LAYERS layers) and Qwen2.5-32B (FSDP_QWEN_LAYERS of 64 layers)
#: at full width, on FSDP_BATCH x FSDP_SEQ tokens (every P of 1, 2, 4
#: splits each microbatch's rows): each rank's blocks of every first moment
#: ((1 - b1) times the clipped gradient) and updated weight against one
#: card's step, the loss and the gradient norm bitwise equal on every rank
FSDP_QWEN_LAYERS = 2
FSDP_BATCH, FSDP_SEQ, FSDP_MICRO = 8, 256, 2
#: its four-card part: Qwen2.5-32B at FSDP_BIG_LAYERS of 64 layers, 3.90 B
#: layer params and 1.56 B of embedding and unembedding: float32 weights,
#: gradients and both moments take ~87 GB, which no one card holds.
#: FSDP_BIG_STEPS steps in bf16 compute on (P, 1), (2, P / 2) and (1, P),
#: FSDP_BIG_BATCH x FSDP_BIG_SEQ tokens a step
FSDP_BIG_LAYERS, FSDP_BIG_STEPS, FSDP_BIG_BATCH, FSDP_BIG_SEQ = 8, 3, 4, 1024
#: the dry run (launch.dryrun) beside what the card holds and moves: its
#: predicted state within DRYRUN_ALLOC_TOL of torch.cuda.memory_allocated's
#: growth over init_train_state (the allocator rounds each block up); its
#: bytes a rank otherwise exact. Phase 21 runs its CLI over the
#: DRYRUN_CELLS arch x shape x mesh cells of the production meshes
DRYRUN_ALLOC_TOL = 0.01
DRYRUN_CELLS = 64
#: the executed half: one rank's step traced on the meta device
#: predicts the peak within DRYRUN_PEAK_TOL of torch.cuda.max_memory_allocated
#: over the same step, and the FLOPs FlopCounterMode counts in it exactly;
#: phase 21's CLI runs within DRYRUN_CLI_S seconds and reports every cell
#: whose peak exceeds a card (``launch.dryrun.CARD_BYTES``)
DRYRUN_PEAK_TOL = 0.05
DRYRUN_CLI_S = 120.0
#: the cells whose peak exceeds a card: Mixtral-8x22B's training state on
#: both meshes (its 8 experts do not divide ``model``: the reference's
#: own spec); every serving cell fits since the cache is cut as the
#: reference's ``decode_state_shardings`` cuts it
DRYRUN_OVER = ("mixtral-8x22b train_4k multi", "mixtral-8x22b train_4k single")


class SmokeFailure(RuntimeError):
    pass


class FakeClock:
    """An injected clock phase 11's breaker advances by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


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


def warm_buckets(torch, eng, buckets, ops=("fft",)) -> None:
    """Plan each bucket's fft (complex64) and Poisson (float32, real)
    shape into the engine's pool and run zeros through both directions,
    before any request is timed or any fault armed."""
    for b in buckets:
        for op in ops:
            real = op == "poisson"
            eng.pool.warm((b, SERVE_N, SERVE_N), 2, torch.float32 if real else torch.complex64, real)


def serve_inputs(torch, seed, device="cuda"):
    """Phase 11's stream: SERVE_FFT complex64 and SERVE_POISSON float32
    SERVE_N^2 fields from a generator at ``seed`` (the same on every rank)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = SERVE_N
    xs = [torch.randn((n, n), dtype=torch.complex64, device=device, generator=g) for _ in range(SERVE_FFT)]
    fs = [torch.randn((n, n), dtype=torch.float32, device=device, generator=g) for _ in range(SERVE_POISSON)]
    return xs, fs


def serve_stream(eng, xs, fs, own=lambda a: a):
    """Submit phase 11's clean stream (a Poisson field after every fourth
    fft request), flush and block every request; returns (op, input,
    future) in submission order. ``own`` turns an input into what the
    caller submits: the global field, or on a ProcessGroupMesh its block."""
    futs = []
    for i, x in enumerate(xs):
        futs.append(("fft", x, eng.submit("fft", own(x))))
        if i % 4 == 3:
            futs.append(("poisson", fs[i // 4], eng.submit("poisson", own(fs[i // 4]))))
    eng.flush()
    for _, _, f in futs:
        f.block()
    return futs


def serving_phase(torch, seed, fft_stage, SimMesh):
    """Phase 11: SpectralEngine(SimMesh(4), max_batch=8) with the fused
    scatter ring and the kernels: clean serving (coalescing on, then
    off), a poisoned batch, the breaker's degradation and re-probe, and
    a 5 % chaos rate. Returns (launches by path, launch shapes)."""
    from repro_torch.runtime import CircuitBreaker, FaultPlan, InjectedFault, RetryPolicy
    from repro_torch.serve import SpectralEngine

    n, mesh, buckets = SERVE_N, SimMesh(P), (1, 2, 4, SERVE_BATCH)
    xs, fs = serve_inputs(torch, seed)
    by_path, shapes, peaks = {}, {}, []

    def check_result(label, op, inp, y):
        exp = poisson_oracle(torch, inp) if op == "poisson" else torch.fft.fft2(inp).mT
        err = rel_err(torch, y.double() if op == "poisson" else y, exp)
        check(tuple(y.shape) == (n, n) and err <= MAIN_PATH_REL_TOL,
              f"{label}: a {op} result disagrees with torch.fft (rel_err {err:.3e})")
        return err

    # 1. clean serving: serve_sweep's two arms
    for coalesce in (True, False):
        arm = "coalesced" if coalesce else "solo"
        eng = SpectralEngine(mesh, max_batch=SERVE_BATCH, max_wait_s=0.005, coalesce=coalesce, plan_kwargs=SERVE_KW)
        warm_buckets(torch, eng, buckets if coalesce else (1,), ("fft", "poisson"))
        eng.reset_stats()
        t0 = time.perf_counter()
        futs, launches, peak = counted(torch, fft_stage, f"serving ({arm})", lambda: serve_stream(eng, xs, fs))
        elapsed = time.perf_counter() - t0
        peaks.append(peak)
        check(all(launches[f"{PACK} {mode}"] > 0 for mode in PACK_MODES),
              f"serving ({arm}) did not launch the pack in both modes: {launches}")
        for name, by_shape in launch_shapes(fft_stage).items():
            for shape, k in by_shape.items():
                shapes.setdefault(name, {})[shape] = shapes.get(name, {}).get(shape, 0) + k
        errs = [check_result(f"serving ({arm})", op, inp, f.result()) for op, inp, f in futs]
        s = eng.stats()
        lat, st = s["latency_s"], s["stages_s"]
        print(f"serving ({arm}): {len(futs)} requests ({SERVE_FFT} fft {n}^2 complex64, {SERVE_POISSON} poisson "
              f"float32) in {elapsed * 1e3:.1f} ms, {len(futs) / elapsed:.1f} transforms/s, latency p50 "
              f"{lat['p50'] * 1e3:.2f} ms p99 {lat['p99'] * 1e3:.2f} ms, mean batch {s['mean_batch']:.2f} "
              f"({s['batches']} batches, padded {s['padded']}), dispatch spans p50/p99 ms: "
              + ", ".join(f"{k} {v['p50'] * 1e3:.3f}/{v['p99'] * 1e3:.3f}" for k, v in st.items())
              + f"; max rel_err {max(errs):.3e} (tol {MAIN_PATH_REL_TOL}), launches {launches}, "
              f"peak memory {peak:.2f} GiB", flush=True)
        by_path[f"serving_{arm}"] = launches
        del futs, eng
        torch.cuda.empty_cache()
    print_shapes("serving", shapes)

    # 2. poison: one coalesced batch of 4, two injected faults, no retries
    eng = SpectralEngine(mesh, max_batch=SERVE_BATCH, max_wait_s=100.0, retry=RetryPolicy(max_retries=0),
                         plan_kwargs=SERVE_KW)
    warm_buckets(torch, eng, (1, 4))
    eng.set_faults(FaultPlan.error(match="Exchange", times=2))
    futs = [eng.submit("fft", x) for x in xs[:4]]
    eng.drain()
    failed = [i for i, f in enumerate(futs) if f.failed()]
    check(len(failed) == 1, f"poison: {len(failed)} requests quarantined, not 1")
    for i, f in enumerate(futs):
        if i not in failed:
            check_result("poison", "fft", xs[i], f.result())
    try:
        futs[failed[0]].result()
        check(False, "poison: the quarantined future did not re-raise")
    except InjectedFault:
        pass
    m = eng.metrics()
    check((m["errors"], m["batch_splits"], m["quarantined"]) == (2, 1, 1), f"poison counters: {m}")
    print(f"serving poison: 4 coalesced requests, FaultPlan.error(match='Exchange', times=2), no retries: "
          f"3 resolved correctly, request {failed[0]} quarantined; errors={m['errors']} "
          f"batch_splits={m['batch_splits']} quarantined={m['quarantined']}", flush=True)
    del futs, eng

    # 3. the breaker: two failures open the key, the next dispatch is degraded
    # to xla_auto (no kernel), and after reset_after_s one probe re-closes it
    clk = FakeClock()
    eng = SpectralEngine(mesh, max_batch=1, clock=clk, retry=RetryPolicy(max_retries=0),
                         breaker=CircuitBreaker(failure_threshold=2, reset_after_s=5.0, clock=clk),
                         plan_kwargs=SERVE_KW)
    warm_buckets(torch, eng, (1,))
    eng.set_faults(FaultPlan.error(match="Exchange", times=2))

    def one(x):
        fut = eng.submit("fft", x)
        eng.drain()
        return fut

    check(all(one(x).failed() for x in xs[:2]) and eng.breaker.stats()["opened"] == 1,
          "breaker: two injected failures did not open the key")
    deg, dl, _ = counted(torch, fft_stage, "serving degraded", lambda: one(xs[2]), expect=())
    check(deg.degraded and deg.backend == "xla_auto", "breaker: the open key was not degraded to xla_auto")
    check(not any(dl.values()), f"breaker: the degraded dispatch launched port kernels: {dl}")
    err_deg = check_result("degraded", "fft", xs[2], deg.result())
    eng.set_faults(None)
    clk.advance(6.0)
    probe, pl, _ = counted(torch, fft_stage, "serving probe", lambda: one(xs[3]))
    err_probe = check_result("probe", "fft", xs[3], probe.result())
    b = eng.breaker.stats()
    check(probe.degraded is False and b["reclosed"] == 1 and b["probes"] == 1 and b["open"] == 0,
          f"breaker: the probe did not re-close the key: {b}")
    by_path["serving_degraded"] = dl
    print(f"serving breaker: failure_threshold=2 reset_after_s=5 (injected clock): breaker_opened={b['opened']} "
          f"reclosed={b['reclosed']} probes={b['probes']}; degraded dispatch (xla_auto) rel_err {err_deg:.3e}, "
          f"launches {dl}; probe rel_err {err_probe:.3e}, launches {pl}", flush=True)
    del deg, probe, eng

    # 4. chaos: serve_sweep's chaos row, a seeded 5 % of Exchange executions poisoned
    eng = SpectralEngine(mesh, max_batch=SERVE_BATCH, max_wait_s=0.005, retry=RetryPolicy(max_retries=1),
                         plan_kwargs=SERVE_KW)
    warm_buckets(torch, eng, buckets)
    eng.reset_stats()
    eng.set_faults(FaultPlan.rate(CHAOS_RATE, seed=7))

    def chaos():
        done, failed = [], 0
        for wave in range(CHAOS_REQUESTS // CHAOS_WAVE):
            lo = (wave * CHAOS_WAVE) % len(xs)
            futs = [(x, eng.submit("fft", x)) for x in xs[lo:lo + CHAOS_WAVE]]
            eng.flush()
            for x, f in futs:
                try:
                    f.block()
                    done.append((x, f))
                except InjectedFault:
                    failed += 1  # quarantined: isolated to its own future
        return done, failed

    t0 = time.perf_counter()
    (done, failed), launches, peak = counted(torch, fft_stage, "serving chaos", chaos, ("stage_left", "stage_right"))
    elapsed = time.perf_counter() - t0
    peaks.append(peak)
    errs = [check_result("chaos", "fft", x, f.result()) for x, f in done]
    s = eng.stats()
    fl = s["faults"]
    check(len(done) + failed == CHAOS_REQUESTS, "chaos: a request neither completed nor failed")
    print(f"serving chaos: FaultPlan.rate({CHAOS_RATE}, seed=7), RetryPolicy(max_retries=1), {CHAOS_REQUESTS} fft "
          f"requests in waves of {CHAOS_WAVE}: completed {len(done)} failed {failed} in {elapsed * 1e3:.1f} ms "
          f"({len(done) / elapsed:.1f} completed/s), latency p50 {s['latency_s']['p50'] * 1e3:.2f} ms p99 "
          f"{s['latency_s']['p99'] * 1e3:.2f} ms (completed only), mean batch {s['mean_batch']:.2f}; errors="
          f"{fl['errors']} retries={fl['retries']} batch_splits={fl['batch_splits']} quarantined={fl['quarantined']} "
          f"failed_requests={fl['failed_requests']} degraded_dispatches={fl['degraded_dispatches']} breaker="
          f"{fl['breaker']}; max rel_err {max(errs):.3e}, launches {launches}", flush=True)
    by_path["serving_chaos"] = launches
    del done, eng, xs, fs
    check_peak("serving", max(peaks), "the heaviest counted run")
    return by_path, shapes


def elastic_run(torch, ckdir, alive, x0, forcing, injector=None, make_mesh=None) -> dict:
    """The reference's ELASTIC_CODE: ELASTIC_STEPS forced steps of
    ``state = ifft2(fft2(state + forcing)) / 2`` through a PlanPool plan
    on ``make_mesh(alive["n"])`` (default ``elastic_mesh``), checkpointed
    after each step; ``injector`` fails a step and the crash takes half
    the ranks, and ``run_with_recovery`` resumes on the survivors from
    the newest checkpoint. On a ProcessGroupMesh each rank steps its own
    block, rank 0 checkpoints the gathered state and a ``mesh.all_max``
    barrier follows; a rank ``elastic_mesh`` leaves out returns at once."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import SimulatedFailure, elastic_mesh, run_with_recovery
    from repro_torch.serve import PlanPool

    make_mesh = make_mesh or (lambda k: elastic_mesh(("model",), max_devices=k, timeout_s=NCCL_TIMEOUT_S))
    ckpt = CheckpointManager(ckdir, keep=2)
    out = {}

    def loop(resume):
        mesh = make_mesh(alive["n"])
        if mesh is None:
            out["left"] = True
            return
        plan, _ = PlanPool(mesh, plan_kwargs=ELASTIC_KW).get(tuple(x0.shape), 2, x0.dtype, False)
        tail = plan.input_spec().tail
        blocks = mesh.caller_holds_block
        own = (lambda a: mesh.split(a, tail)[0]) if blocks else (lambda a: a)
        whole = (lambda v: mesh.gather([v], tail)) if blocks else (lambda v: v)
        state, start = x0, 0
        latest, restored = ckpt.restore_latest({"x": x0})
        if latest is not None:
            state, start = restored["x"], latest
            out.setdefault("resumed_at", (start, mesh.p))
        v = own(state)
        for step in range(start, ELASTIC_STEPS):
            if injector is not None:
                try:
                    injector.maybe_fail(step)
                except SimulatedFailure:
                    alive["n"] //= 2
                    raise
            v = plan.inverse(plan.execute(v + own(forcing[step]))) * 0.5
            full = whole(v)
            if not blocks or mesh.rank == 0:
                ckpt.save(step + 1, {"x": full}, blocking=True)
            mesh.all_max([0.0])  # the checkpoint is on disk before any rank reads it
        out["x"] = whole(v)

    out["restarts"] = run_with_recovery(loop, max_restarts=2, sleep=lambda s: None)
    return out


def elastic_inputs(torch, seed, device="cuda"):
    g = torch.Generator(device=device)
    g.manual_seed(seed + 42)
    draw = lambda: torch.randn((SERVE_N, SERVE_N), dtype=torch.complex64, device=device, generator=g)  # noqa: E731
    return draw(), [draw() for _ in range(ELASTIC_STEPS)]


def elastic_phase(torch, seed, fft_stage):
    """Phase 12: the elastic scenario at 4096^2 on the card: SimMesh(4)
    fails at step 3, resumes on elastic_mesh(max_devices=2) from the
    step-3 checkpoint, and must equal an uninterrupted SimMesh(2) run
    bitwise (and SimMesh(4)'s to 1e-6). Returns the resumed run's launches."""
    from repro_torch.runtime import FailureInjector

    x0, forcing = elastic_inputs(torch, seed)
    with tempfile.TemporaryDirectory() as tmp:
        inj = FailureInjector(ELASTIC_FAIL_AT)
        t0 = time.perf_counter()
        got, launches, peak = counted(torch, fft_stage, "elastic recovery",
                                      lambda: elastic_run(torch, f"{tmp}/resume", {"n": P}, x0, forcing, inj),
                                      ("stage_left", "stage_right"))
        resumed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref2 = elastic_run(torch, f"{tmp}/p2", {"n": P // 2}, x0, forcing)
        ref2_s = time.perf_counter() - t0
        ref4 = elastic_run(torch, f"{tmp}/p4", {"n": P}, x0, forcing)
    check(inj.fired_steps == [ELASTIC_FAIL_AT] and got["restarts"] == 1, "elastic: the injected failure did not fire once")
    check(got["resumed_at"] == (ELASTIC_FAIL_AT, P // 2), f"elastic: resumed at {got.get('resumed_at')}")
    check(ref2["restarts"] == 0 and "resumed_at" not in ref2, "elastic: the uninterrupted run restarted")
    y = got["x"]
    check(tuple(y.shape) == (SERVE_N, SERVE_N) and bool(torch.isfinite(torch.view_as_real(y)).all()),
          "elastic: the resumed state is not finite with the expected shape")
    bitwise2, bitwise4 = torch.equal(y, ref2["x"]), torch.equal(y, ref4["x"])
    err4 = rel_err(torch, y, ref4["x"])
    state = x0.to(torch.complex128)
    for f in forcing:
        state = torch.fft.ifft2(torch.fft.fft2(state + f)) * 0.5
    err64 = rel_err(torch, y.to(torch.complex128), state)
    print(f"elastic recovery: {SERVE_N}^2 complex64, {ELASTIC_STEPS} steps, {ELASTIC_KW}: FailureInjector("
          f"{ELASTIC_FAIL_AT}) fired at {inj.fired_steps}, restarts {got['restarts']}, resumed at step/ranks "
          f"{got['resumed_at']} (elastic_mesh(max_devices={P // 2})); vs uninterrupted SimMesh({P // 2}): bitwise "
          f"{bitwise2}; vs uninterrupted SimMesh({P}): bitwise {bitwise4}, rel_err {err4:.3e} (tol 1e-06); vs the "
          f"complex128 torch.fft run: rel_err {err64:.3e} (tol {MAIN_PATH_REL_TOL}); resumed run {resumed_s:.2f} s, "
          f"uninterrupted SimMesh({P // 2}) {ref2_s:.2f} s (checkpoints included), launches {launches}, "
          f"peak memory {peak:.2f} GiB", flush=True)
    check(bitwise2, f"elastic: the resumed state differs from the uninterrupted SimMesh({P // 2}) run")
    check(err4 <= 1e-6, f"elastic: the resumed state differs from SimMesh({P})'s by {err4:.3e}")
    check(err64 <= MAIN_PATH_REL_TOL, f"elastic: the resumed state differs from torch.fft's by {err64:.3e}")
    return launches


def ring_inputs(torch, seed, p, device):
    """The rings' inputs, the same on every rank: tokens x (RING_TOKENS,
    RING_D_MODEL), an up-projection w (RING_D_MODEL, RING_D_FF), and one
    (RING_TOKENS, RING_D_MODEL) partial sum per rank (a down-projection's
    output before its reduction)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + 7)
    x = torch.randn((RING_TOKENS, RING_D_MODEL), device=device, generator=g)
    w = torch.randn((RING_D_MODEL, RING_D_FF), device=device, generator=g) / math.sqrt(RING_D_MODEL)
    parts = [torch.randn((RING_TOKENS, RING_D_MODEL), device=device, generator=g) for _ in range(p)]
    return x, w, parts


def events_ms(torch, fn, reps: int = RING_REPS) -> float:
    """Median CUDA-event ms of ``reps`` single calls after one warm-up: a
    fixed count, so every rank of a group enters its collectives as often."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ring_cases(torch, mesh, seed) -> list:
    """The four rings of repro_torch.core.overlap at Qwen2.5-32B's MLP
    widths on ``mesh`` (SimMesh: every rank's blocks on this card; over
    NCCL: this rank's): each held against its dense answer (RING_REL_TOL,
    relative to the largest entry) and timed (median of RING_REPS, CUDA
    events) beside the one library call that computes the same result --
    the torch.distributed collective on a process group, the dense torch
    equivalent on a SimMesh -- with the peak memory it adds to what is
    live; then one backward
    through ring_all_gather, whose gradient must be 2x. Returns a row per
    function."""
    import torch.distributed as dist

    from repro_torch.core import collective_matmul_ag, ring_all_gather, ring_reduce_scatter, ring_scatter_reduce

    ax, p, dev, pg = "model", mesh.p, mesh.device, mesh.caller_holds_block
    x, w, parts = ring_inputs(torch, seed, p, dev)
    mine = mesh.local_ranks()
    rows_of, cols_of = mesh.split(x, (ax, None)), mesh.split(x, (None, ax))
    own_parts = [parts[r] for r in mine]
    total = torch.stack(parts).sum(0)
    scattered = [total.chunk(p)[r] for r in mine]
    y = torch.matmul(x, w)
    del parts, total

    def lib_gather():
        out = torch.empty_like(x)
        dist.all_gather_into_tensor(out, rows_of[0], group=mesh.group)
        return [out]

    def lib_matmul():
        t, kc = cols_of[0].shape
        out = torch.empty((p * t, kc), device=dev)  # the blocks stacked along dim 0
        dist.all_gather_into_tensor(out, cols_of[0].contiguous(), group=mesh.group)
        return [torch.matmul(out.view(p, t, kc).permute(1, 0, 2).reshape(x.shape), w)]

    def lib_scatter():
        out = torch.empty((RING_TOKENS // p, RING_D_MODEL), device=dev)
        dist.reduce_scatter_tensor(out, own_parts[0], group=mesh.group)
        return [out]

    if pg:
        libs = [(lib_gather, "dist.all_gather_into_tensor"),
                (lib_matmul, "dist.all_gather_into_tensor + torch.matmul"),
                (lib_scatter, "dist.reduce_scatter_tensor"), (lib_scatter, "dist.reduce_scatter_tensor")]
    else:
        dense_scatter = (lambda: list(torch.stack(own_parts).sum(0).chunk(p)), "torch.stack + sum + chunk")
        libs = [(lambda: [torch.cat(rows_of)] * p, "torch.cat"),
                (lambda: [torch.matmul(torch.cat(cols_of, dim=-1), w)] * p, "torch.cat + torch.matmul"),
                dense_scatter, dense_scatter]
    cases = [
        ("ring_all_gather", lambda: ring_all_gather(rows_of, mesh, ax, axis=0), [x] * len(mine)),
        ("collective_matmul_ag", lambda: collective_matmul_ag(cols_of, w, mesh, ax), [y] * len(mine)),
        ("ring_reduce_scatter", lambda: ring_reduce_scatter(own_parts, mesh, ax, axis=0), scattered),
        ("ring_scatter_reduce", lambda: ring_scatter_reduce(own_parts, mesh, ax, lambda c, src: c, split_axis=0),
         scattered),
    ]
    def peak_gib(fn):
        """The peak device memory ``fn`` adds to what is live already."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**30

    out = []
    for (name, fn, exp), (lib, lib_name) in zip(cases, libs):
        got, peak = peak_gib(fn)
        err = max(rel_err(torch, a, b) for a, b in zip(got, exp))
        del got
        lib_got, lib_peak = peak_gib(lib)
        lib_err = max(rel_err(torch, a, b) for a, b in zip(lib_got, exp))
        del lib_got
        check(err <= RING_REL_TOL, f"{mesh!r}: {name} disagrees with its dense answer (rel_err {err:.3e})")
        check(lib_err <= RING_REL_TOL, f"{mesh!r}: {lib_name} disagrees with the dense answer (rel_err {lib_err:.3e})")
        out.append(dict(name=name, ms=events_ms(torch, fn), library=lib_name, library_ms=events_ms(torch, lib),
                        rel_err=err, library_rel_err=lib_err, peak_gib=peak, library_peak_gib=lib_peak))
    xs = [b.clone().requires_grad_(True) for b in rows_of]
    (sum((o ** 2).sum() for o in ring_all_gather(xs, mesh, ax, axis=0)) / p).backward()  # the ranks' mean
    err = max(rel_err(torch, a.grad, 2 * b) for a, b in zip(xs, rows_of))
    check(err <= RING_REL_TOL, f"{mesh!r}: the gradient through ring_all_gather is not 2x (rel_err {err:.3e})")
    out.append(dict(name="ring_all_gather backward", rel_err=err))
    return out


def print_rings(who: str, rows) -> None:
    for r in rows:
        if "ms" not in r:
            print(f"{who} {r['name']}: d(mean of sum(gather(x)^2))/dx vs 2x rel_err {r['rel_err']:.3e} "
                  f"(tol {RING_REL_TOL})", flush=True)
            continue
        print(f"{who} {r['name']} at T={RING_TOKENS} d_model={RING_D_MODEL} d_ff={RING_D_FF} float32: "
              f"{r['ms']:.3f} ms vs {r['library']} {r['library_ms']:.3f} ms (median of {RING_REPS}, CUDA events); "
              f"rel_err vs dense {r['rel_err']:.3e} (library {r['library_rel_err']:.3e}, tol {RING_REL_TOL}); "
              f"peak memory above the inputs {r['peak_gib']:.3f} GiB (library {r['library_peak_gib']:.3f})",
              flush=True)


def rings_phase(torch, seed, SimMesh) -> None:
    """Phase 13: the overlap rings on SimMesh(4), every rank on this card."""
    print_rings(f"rings SimMesh({P})", ring_cases(torch, SimMesh(P), seed))


def lm_rel_err(got, exp) -> float:
    return ((got.float() - exp.float()).abs().max() / exp.float().abs().max()).item()


def lm_cache_bytes_per_token(cfg) -> int:
    """The engine's bfloat16 cache of one token over every layer: K and V,
    or MLA's latent and rope key (none for xLSTM: its state is recurrent)."""
    if cfg.family == "ssm":
        return 0
    if cfg.mla is not None:
        return 2 * cfg.num_layers * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
    return 2 * 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim_


def lm_kv_bytes(cfg, scfg) -> int:
    """The engine's bfloat16 cache for every layer and slot, over its
    max_seq positions and the meta tokens (hymba's 128) in front."""
    return lm_cache_bytes_per_token(cfg) * scfg.max_batch * (scfg.max_seq + cfg.meta_tokens)


def lm_check_free(torch, label: str, need: float) -> None:
    """Free what the earlier phases left (reference cycles first: the
    cache can only return blocks nothing refers to), then fail unless
    ``need`` bytes are free on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"{label}: {free / 2**30:.2f} GiB free of {total / 2**30:.2f}, need {need / 2**30:.2f} "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated by this process)", flush=True)
    check(free >= need, f"{label}: {free} bytes free on the card, the phase needs {int(need)}")


def lm_agreement(torch, model, params, g, seq: int = LM_SEQ):
    """A ``seq``-token prefill + LM_DECODE decode steps (float32 cache)
    against Model.logits of the whole sequence: (rel errs, max |logit|)."""
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (1, seq + LM_DECODE), device="cuda", generator=g)
    full = model.logits(params, {"tokens": toks})
    state = model.init_decode_state(1, seq + LM_DECODE, cache_dtype=torch.float32)
    state, pl = model.prefill(params, {"tokens": toks[:, :seq]}, state)
    errs = [lm_rel_err(pl, full[:, seq - 1])]
    for t in range(LM_DECODE):
        lg, state = model.decode_step(params, toks[:, seq + t:seq + t + 1], state)
        errs.append(lm_rel_err(lg, full[:, seq + t]))
    return errs, full.abs().max().item()


def lm_isolation(torch, model, params, g, label: str) -> None:
    """tests/test_serve.py::test_batched_matches_single at ServeConfig()'s
    8 slots: request 0's greedy tokens alone and among the others."""
    from repro_torch.configs import ServeConfig
    from repro_torch.serve import ServeEngine

    prompts = [torch.randint(0, model.cfg.vocab_size, (n,), device="cuda", generator=g).int().cpu().numpy()
               for n in LM_ISOLATION_LENGTHS]
    solo = ServeEngine(model, params, ServeConfig()).run(prompts[:1], max_new=LM_ISOLATION_NEW)
    among = ServeEngine(model, params, ServeConfig()).run(prompts, max_new=LM_ISOLATION_NEW)
    print(f"{label} slot isolation at full width: request 0 alone {solo[0]}, among {len(prompts)} slots "
          f"{among[0]}", flush=True)
    check(among[0] == solo[0], f"{label}: a request's greedy tokens among 8 slots differ from its solo tokens")


def lm_width_checks(torch, seed) -> None:
    """Check 1: Qwen2.5-32B at full width, LM_F32_LAYERS layers, float32
    (TF32 off since phase 1)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_F32_LAYERS, dtype="float32")
    model = Model(cfg)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = model.init(g)
    errs, top = lm_agreement(torch, model, params, g)
    print(f"LM serving {LM_ARCH} full width, {LM_F32_LAYERS} layers, float32 (float32 cache): prefill of {LM_SEQ} + "
          f"{LM_DECODE} decode steps vs logits of the full sequence, rel_err (to max |logit| "
          f"{top:.3f}) {', '.join(f'{e:.3e}' for e in errs)} (tol {LM_F32_REL_TOL})", flush=True)
    check(max(errs) <= LM_F32_REL_TOL, f"LM prefill/decode vs full logits: {max(errs):.3e} > {LM_F32_REL_TOL}")

    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = torch.randn((1, LM_SEQ, h, hd), device="cuda", generator=g)
    k, v = (torch.randn((1, LM_SEQ, kvh, hd), device="cuda", generator=g) for _ in range(2))
    spec = A.AttnSpec(causal=True)
    err = lm_rel_err(A.attention_chunked(q, k, v, spec, kv_chunk=cfg.attn_kv_chunk), A.attention_naive(q, k, v, spec))
    print(f"LM serving attention_chunked vs attention_naive at q {tuple(q.shape)} k/v {tuple(k.shape)} float32: "
          f"rel_err {err:.3e} (tol {LM_ATTN_REL_TOL})", flush=True)
    check(err <= LM_ATTN_REL_TOL, f"attention_chunked vs attention_naive: {err:.3e} > {LM_ATTN_REL_TOL}")
    lm_isolation(torch, model, params, g, "LM serving")


def lm_stream(torch, eng, prompts, max_new: int):
    """Serve ``prompts`` on ``eng`` through ServeEngine.run, timing each
    add_request (host clock, to its first token on the host) and each
    decode step (CUDA events, and the host's time to issue it). Returns
    (results, wall s, start, [(prompt len, add ms, end)], [(active slots,
    live KV entries, device ms, issue ms)])."""
    arrivals, steps = [], []
    add, decode = eng.add_request, eng._decode

    def timed_add(prompt, n):
        t0 = time.perf_counter()
        slot = add(prompt, n)
        t1 = time.perf_counter()
        if slot is not None:
            arrivals.append((len(prompt), (t1 - t0) * 1e3, t1))
        return slot

    def timed_decode(params, tokens, state):
        active = [i for i, r in enumerate(eng.slots) if r is not None]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = decode(params, tokens, state)
        issue = (time.perf_counter() - t0) * 1e3
        end.record()
        steps.append((len(active), int(eng.slot_pos[active].sum()), start, end, issue))
        return out

    eng.add_request, eng._decode = timed_add, timed_decode  # the engine's own calls, timed
    try:
        t0 = time.perf_counter()
        results = eng.run(prompts, max_new=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng.add_request  # the class's method again (an instance's bound copy would be a cycle that keeps eng)
        eng._decode = decode
    return results, wall, t0, arrivals, [(a, live, s.elapsed_time(e), issue) for a, live, s, e, issue in steps]


def lm_decode_kernels(torch, eng):
    """One decode step of all slots under torch.profiler: (its kernels'
    device ms, [(kernel, launches, ms)] for the LM_TOP_KERNELS longest),
    or (None, []) when the profiler sees no device time."""
    tokens = torch.zeros((eng.scfg.max_batch, 1), dtype=torch.int32, device="cuda")
    return profiled_kernels(torch, lambda: eng._decode(eng.params, tokens, eng.state))


def profiled_kernels(torch, fn):
    """``fn()`` once under torch.profiler: lm_decode_kernels' numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:LM_TOP_KERNELS]
    return (us / 1e3 if us else None), [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in top]


def lm_build(torch, seed, cfg, scfg, launch, label: str):
    """The engine as repro_torch.launch.serve builds it, in bfloat16:
    (engine, bytes of weights)."""
    t0 = time.perf_counter()
    eng = launch.build_engine(cfg, scfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in lm_leaves(eng.params))
    print(f"{label} {cfg.name}: {cfg.num_layers} layers in bfloat16 initialised on the card in {init_s:.1f} s, "
          f"{nbytes / 2**30:.2f} GiB of weights, KV cache {lm_kv_bytes(cfg, scfg) / 2**30:.2f} GiB "
          f"({scfg.max_batch} slots x {scfg.max_seq})", flush=True)
    return eng, nbytes


def dry_run_serve_check(torch, eng, cfg, scfg, nbytes: int, label: str) -> None:
    """Phase 14's dry-run check: ``launch.dryrun``'s decode cell of ``cfg``
    at the engine's max_batch x max_seq on one rank predicts the
    weights' bytes (``lm_build``'s nbytes) and the decode state's (the
    cache the engine allocated) exactly, and its executed half the peak of
    one decode step of every slot on the engine's state (max_memory_allocated)
    within DRYRUN_PEAK_TOL."""
    args, rep = dry_run_cell(cfg, "decode", scfg.max_seq, scfg.max_batch)
    weights, cache = state_bytes_of(args, ("params/",)), state_bytes_of(args, ("state/",))
    held = tensor_bytes(t for t in lm_leaves(eng.state) if hasattr(t, "element_size"))
    peak = decode_step_peak(torch, eng, scfg)
    mem = rep["memory"]
    prel = (mem["peak_device_bytes"] - peak) / peak
    print(f"{label} dry run (launch.dryrun.cell_report, decode {scfg.max_batch} x {scfg.max_seq}, one rank): weights "
          f"{weights} B predicted, {nbytes} B held; decode state {cache} B predicted, {held} B allocated by the "
          f"engine; executed half ({rep['trace_s']:.1f} s on the meta device): peak "
          f"{mem['peak_device_bytes']} B ({mem['peak_device_bytes'] / 2**30:.2f} GiB, temporaries "
          f"{mem['temp_bytes'] / 2**20:.1f} MiB) against one decode step's measured {peak} B ({peak / 2**30:.2f} GiB, "
          f"max_memory_allocated; rel diff {prel:+.2e}, tol {DRYRUN_PEAK_TOL}) ({card()})", flush=True)
    check(weights == nbytes, f"{label}: the dry run predicts {weights} B of weights, the engine holds {nbytes} B")
    check(cache == held, f"{label}: the dry run predicts {cache} B of decode state, the engine holds {held} B")
    check(abs(prel) <= DRYRUN_PEAK_TOL, f"{label}: the dry run's decode peak {mem['peak_device_bytes']} B is "
          f"{prel:+.2%} from the measured {peak} B")


def decode_step_peak(torch, eng, scfg) -> int:
    """max_memory_allocated over one decode step of every slot on the
    engine's own state at its last position (the dry run's decode cell);
    the slots' lengths and the position put back after, so the stream
    that follows starts from the engine's fresh state."""
    saved = [(t, t.clone()) for t in lm_leaves(eng.state) if hasattr(t, "dtype") and not t.is_floating_point()]
    pos = eng.state["pos"]
    eng.state["pos"] = scfg.max_seq - 1
    tokens = torch.zeros((scfg.max_batch, 1), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = eng.model.decode_step(eng.params, tokens, eng.state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    for t, c in saved:
        t.copy_(c)
    eng.state["pos"] = pos
    return peak


def lm_bf16_agreement(torch, seed, model, params) -> None:
    """Check 2 of phase 14: a LM_BF16_SEQ-token prefill + 1 decode step
    of the bfloat16 model against the whole sequence's logits."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (1, LM_BF16_SEQ + 1), device="cuda", generator=g)
    full = model.logits(params, {"tokens": toks})
    state = model.init_decode_state(1, LM_BF16_SEQ + 1)
    state, pl = model.prefill(params, {"tokens": toks[:, :LM_BF16_SEQ]}, state)
    lg, _ = model.decode_step(params, toks[:, LM_BF16_SEQ:], state)
    errs = (lm_rel_err(pl, full[:, LM_BF16_SEQ - 1]), lm_rel_err(lg, full[:, LM_BF16_SEQ]))
    print(f"LM serving {cfg.name} full depth, bfloat16: prefill of {LM_BF16_SEQ} + 1 decode step vs logits of "
          f"the full sequence, rel_err {errs[0]:.3e}, {errs[1]:.3e} (tol {LM_BF16_REL_TOL})", flush=True)
    check(max(errs) <= LM_BF16_REL_TOL, f"LM full depth prefill/decode vs logits: {max(errs):.3e} > {LM_BF16_REL_TOL}")


def lm_serve_stream(torch, eng, cfg, launch):
    """Check 3: the launcher's stream on ``eng``, then one decode step
    under the profiler."""
    prompts = launch.prompt_stream(cfg, LM_REQUESTS, LM_PROMPT_LEN)
    stream = lm_stream(torch, eng, prompts, LM_MAX_NEW)
    results = stream[0]
    check(sorted(results) == list(range(LM_REQUESTS)), f"LM stream: results for {sorted(results)}")
    check(all(len(v) == LM_MAX_NEW and all(0 <= t < cfg.vocab_size for t in v) for v in results.values()),
          "LM stream: a request did not get its max_new tokens in the vocabulary")
    return stream, lm_decode_kernels(torch, eng)


def lm_full_depth(torch, seed, cfg, scfg, launch):
    """Checks 2 and 3: Qwen2.5-32B at all its layers in bfloat16, built the
    way repro_torch.launch.serve builds it, then the launcher's stream."""
    eng, nbytes = lm_build(torch, seed, cfg, scfg, launch, "LM serving")
    dry_run_serve_check(torch, eng, cfg, scfg, nbytes, "LM serving")
    lm_bf16_agreement(torch, seed, eng.model, eng.params)
    return nbytes, lm_serve_stream(torch, eng, cfg, launch)


def lm_leaves(tree):
    """The tensors of a tree of dicts, or of a state's (named) tuples."""
    if isinstance(tree, (dict, tuple)):
        for v in tree.values() if isinstance(tree, dict) else tree:
            yield from lm_leaves(v)
    else:
        yield tree


def lm_yardstick(torch, seed, A) -> None:
    """Check 5: the port's attention_chunked at a 512-token prefill of
    Qwen2.5-32B beside F.scaled_dot_product_attention (which the port
    never calls)."""
    import torch.nn.functional as F

    from repro_torch.core.comm_model import PEAK_FLOPS_BF16

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    q = torch.randn((1, 512, 40, 128), device="cuda", generator=g, dtype=torch.bfloat16)
    k, v = (torch.randn((1, 512, 8, 128), device="cuda", generator=g, dtype=torch.bfloat16) for _ in range(2))
    spec = A.AttnSpec(causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                              is_causal=True, enable_gqa=True).transpose(1, 2)

    err = lm_rel_err(A.attention_chunked(q, k, v, spec), sdpa())
    ms = median_ms(torch, lambda: A.attention_chunked(q, k, v, spec))
    lib_ms = median_ms(torch, sdpa)
    flops = 2 * 2 * 40 * 512 * 512 * 128 / 2  # QK^T and PV, the causal half
    print(f"LM serving yardstick: attention_chunked q {tuple(q.shape)} k/v {tuple(k.shape)} bfloat16 causal "
          f"{ms:.4f} ms vs F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) {lib_ms:.4f} ms "
          f"(median, CUDA events; bound {flops / PEAK_FLOPS_BF16 * 1e3:.4f} ms in operations); rel_err vs it "
          f"{err:.3e}", flush=True)


def stream_summary(stream, scfg) -> dict:
    """lm_stream's numbers as one dict: tokens/s, time to first token
    (add_request on the host) p50 / p99, and the full-slot decode step's
    device ms (CUDA events) and host ms to issue it, medians."""
    from repro_torch.runtime.monitor import percentiles

    results, wall, _, arrivals, steps = stream
    tok = sum(len(v) for v in results.values())
    a = percentiles([ms for _, ms, _ in arrivals], (50, 99))
    full = [st for st in steps if st[0] == scfg.max_batch]
    return dict(tokens=tok, wall_s=wall, tok_s=tok / wall, ttft_p50_ms=a["p50"], ttft_p99_ms=a["p99"],
                steps=len(steps), decode_device_ms=statistics.median(st[2] for st in full),
                decode_host_ms=statistics.median(st[3] for st in full))


def lm_stream_report(torch, label, cfg, scfg, nbytes, stream, kernels, peak, launches, cm, routed=None,
                     state=None, active=None) -> float:
    """Print the stream's tokens/s, time to first token, the full-slot
    decode step's device / host / kernel ms beside its bound (the weights
    and the live cache read once, and ``state``: (bytes a step must move
    besides, what they are); ``routed``: (bytes of the weights a step's
    routing needs, what they are) for a second bound), and check the peak
    memory; ``active``: the params a token touches (default
    ``cfg.active_param_count()``), for the prefill bound. Returns the
    median full-slot step's device ms."""
    from repro_torch.runtime.monitor import percentiles

    results, wall, t0, arrivals, steps = stream
    kernel_ms, top = kernels
    sm = stream_summary(stream, scfg)
    tok, dev_ms, issue_ms = sm["tokens"], sm["decode_device_ms"], sm["decode_host_ms"]
    a = {"p50": sm["ttft_p50_ms"], "p99": sm["ttft_p99_ms"]}
    t = percentiles([(end - t0) * 1e3 for _, _, end in arrivals], (50, 99))
    full = [s for s in steps if s[0] == scfg.max_batch]
    kv_live = statistics.median(s[1] for s in full) * lm_cache_bytes_per_token(cfg)
    extra = 0 if state is None else state[0]
    decode_bound = (nbytes + kv_live + extra) / cm.HBM_BW * 1e3
    s_med = statistics.median(n for n, _, _ in arrivals)
    active = cfg.active_param_count() if active is None else active
    prefill_bound = max(2 * active * s_med / cm.PEAK_FLOPS_BF16, nbytes / cm.HBM_BW) * 1e3
    print(f"{label} stream: {LM_REQUESTS} requests (prompts 4-{LM_PROMPT_LEN} tokens from rng(0), median "
          f"{s_med:.0f}), max_new {LM_MAX_NEW}, {scfg.max_batch} slots, max_seq {scfg.max_seq}, greedy: {tok} tokens "
          f"in {wall:.2f} s, {tok / wall:.1f} tok/s aggregate, {len(steps)} decode steps", flush=True)
    print(f"{label} time to first token: add_request to its first token on the host p50 {a['p50']:.1f} ms p99 "
          f"{a['p99']:.1f} ms (prefill bound at the median prompt {prefill_bound:.2f} ms); from the stream's start "
          f"p50 {t['p50']:.1f} ms p99 {t['p99']:.1f} ms", flush=True)
    kern = ("not measured (the profiler saw no device time)" if kernel_ms is None
            else f"{kernel_ms:.2f} ms (torch.profiler, one step)")
    also = "" if routed is None else (f"; {routed[1]}: bound {(routed[0] + kv_live) / cm.HBM_BW * 1e3:.2f} ms "
                                      f"({routed[0] / 1e9:.2f} GB)")
    besides = "" if state is None else f" + {state[0] / 1e9:.3f} GB: {state[1]}"
    print(f"{label} decode step with {scfg.max_batch} active slots ({len(full)} steps): device {dev_ms:.2f} ms "
          f"(CUDA events, median), host {issue_ms:.2f} ms to issue it, its kernels {kern}; bound "
          f"{decode_bound:.2f} ms ({nbytes / 1e9:.2f} GB of weights + {kv_live / 1e9:.3f} GB of live KV{besides} at "
          f"{cm.HBM_BW / 1e12:.2f} TB/s){also}", flush=True)
    for name, count, ms in top:
        print(f"  decode step kernel {name}: {count} launches, {ms:.2f} ms", flush=True)
    print(f"{label} peak memory {peak:.2f} GiB (limit {LM_PEAK_LIMIT_GIB}); FFT kernel launches {launches}",
          flush=True)
    check(peak <= LM_PEAK_LIMIT_GIB, f"{label} peak memory {peak:.2f} GiB > {LM_PEAK_LIMIT_GIB}")
    return dev_ms


def lm_launcher(arch: str, launch, label: str) -> None:
    """repro_torch.launch.serve.main at its reduced default, on the card."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", arch])
    print(f"{label} launcher --arch {arch} (reduced, on the card): {out.getvalue().strip()}", flush=True)
    check(out.getvalue().startswith("served "), f"repro_torch.launch.serve --arch {arch} printed no served line")


def lm_serving_phase(torch, seed, fft_stage, cm):
    """Phase 14: the LM serving path with Qwen2.5-32B on one card."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models import attention as A

    cfg, scfg = get_config(LM_ARCH), ServeConfig()
    need = 2 * cfg.param_count() + lm_kv_bytes(cfg, scfg) + LM_HEADROOM_GIB * 2**30
    lm_check_free(torch, "LM serving before check 1", need)
    lm_width_checks(torch, seed)
    lm_check_free(torch, "LM serving before the full-depth model", need)
    (nbytes, (stream, kernels)), launches, peak = counted(
        torch, fft_stage, "LM serving", lambda: lm_full_depth(torch, seed, cfg, scfg, launch), expect=())
    torch.cuda.empty_cache()
    lm_stream_report(torch, "LM serving", cfg, scfg, nbytes, stream, kernels, peak, launches, cm)
    lm_launcher(LM_ARCH, launch, "LM serving")
    lm_yardstick(torch, seed, A)
    return launches


def moe_cfg(arch: str, *, no_drop: bool = False, dtype=None, **cut):
    """``arch``'s full-width config with depth cut (``num_layers``,
    ``first_k_dense``), the MTP head off (a training head serving never
    runs), and with ``no_drop`` capacity_factor = E / k (capacity = every
    token: nothing drops)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    moe = dataclasses.replace(cfg.moe, **{k: v for k, v in cut.items() if k == "first_k_dense"})
    if no_drop:
        moe = dataclasses.replace(moe, capacity_factor=moe.num_experts / moe.top_k)
    cfg = dataclasses.replace(cfg, num_layers=cut["num_layers"], mtp_depth=0, moe=moe)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def moe_width_checks(torch, seed, arch: str) -> None:
    """Check 1 of phase 15: ``arch`` at full width, MOE_F32_CUTS' depth,
    float32, no drops: prefill + decode against the whole sequence,
    isolation, and one MoE layer's einsum dispatch against the dense one."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.model import Model, _layer

    label = f"MoE serving {arch}"
    cfg = moe_cfg(arch, no_drop=True, dtype="float32", **MOE_F32_CUTS[arch])
    lm_check_free(torch, f"{label} before check 1", 4 * cfg.param_count() + LM_HEADROOM_GIB * 2**30)
    model = Model(cfg)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = model.init(g)
    errs, top = lm_agreement(torch, model, params, g)
    print(f"{label} full width, {cfg.num_layers} layers ({[(gr.name, gr.count) for gr in model.groups]}), float32 "
          f"(float32 cache), capacity_factor {cfg.moe.capacity_factor:g} (E/k: no drops): prefill of {LM_SEQ} + "
          f"{LM_DECODE} decode steps vs logits of the full sequence, rel_err (to max |logit| {top:.3f}) "
          f"{', '.join(f'{e:.3e}' for e in errs)} (tol {LM_F32_REL_TOL})", flush=True)
    check(max(errs) <= LM_F32_REL_TOL, f"{label} prefill/decode vs full logits: {max(errs):.3e} > {LM_F32_REL_TOL}")
    lm_isolation(torch, model, params, g, label)

    ffn = _layer(params["moe"], 0)["ffn"]
    x = torch.randn((1, LM_SEQ, cfg.d_model), device="cuda", generator=g)
    dense_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="dense"))
    einsum_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="einsum"))
    with torch.inference_mode():
        (got, aux), (exp, aux_d) = moe.apply_moe(ffn, x, einsum_cfg), moe.apply_moe(ffn, x, dense_cfg)
    err = lm_rel_err(got, exp)
    print(f"{label} one MoE layer at x {tuple(x.shape)} float32: einsum dispatch (capacity "
          f"{moe._capacity(LM_SEQ, cfg.moe.top_k, cfg.moe.num_experts, cfg.moe.capacity_factor)}) vs dense dispatch "
          f"rel_err {err:.3e} (tol {MOE_DISPATCH_REL_TOL}), aux {aux.item():.6f} / {aux_d.item():.6f}", flush=True)
    check(err <= MOE_DISPATCH_REL_TOL, f"{label} einsum vs dense dispatch: {err:.3e} > {MOE_DISPATCH_REL_TOL}")
    ep_width_checks(torch, g, model, params, f"EP SimMesh({EP_P}) {arch}")
    tp_width_check(torch, g, model, params, f"TP SimMesh({TP_P}) {arch}")
    if cfg.mla is not None:  # phase 17's sequence cut of the latent cache
        seq_width_check(torch, g, model, params, f"TP SimMesh({SEQ_GRID}) {arch}")


def ep_interleaved(moe, on: bool):
    """A context in which the ring runs its per-arrival FFN
    (``_ring_exchange_ffn(interleave=True)``) when ``on``: the reference's
    own test patches its module the same way."""
    import contextlib
    import functools

    @contextlib.contextmanager
    def patched():
        orig = moe._ring_exchange_ffn
        if on:
            moe._ring_exchange_ffn = functools.partial(orig, interleave=True)
        try:
            yield
        finally:
            moe._ring_exchange_ffn = orig

    return patched()


EP_DISPATCHES = (("ring", "ring", False), ("ring interleave=True", "ring", True), ("einsum", "einsum", False))


def ep_model(cfg, mesh, dispatch: str):
    import dataclasses

    from repro_torch.models.model import Model

    return Model(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch)), mesh)


def ep_width_checks(torch, g, model, params, label: str) -> None:
    """Check 1 of phase 16: the float32 model of phase 15's check 1 (no
    drops) on SimMesh(EP_P), on the same weights (each rank's experts a
    view of the stacks): the ring over a LM_SEQ-token sequence (EP_P
    divides it), its interleave=True form and the einsum dispatch over the
    ranks, each within EP_REL_TOL of the one-rank logits; the einsum
    dispatch's aux against the one-rank aux."""
    from repro_torch.core import SimMesh
    from repro_torch.models import moe

    cfg = model.cfg
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, LM_SEQ), device="cuda", generator=g)}
    one = model.logits(params, batch)
    one_aux = model.hidden(params, batch)[1].item()
    mesh, errs = SimMesh(EP_P), {}
    for name, dispatch, interleave in EP_DISPATCHES:
        moe.DISPATCHES.clear()
        with ep_interleaved(moe, interleave):
            errs[name] = lm_rel_err(ep_model(cfg, mesh, dispatch).logits(params, batch), one)
        errs[name + " ran"] = dict(moe.DISPATCHES)
    aux = ep_model(cfg, mesh, "einsum").hidden(params, batch)[1].item()
    aux_err = abs(aux - one_aux) / abs(one_aux)
    print(f"{label} full width, {cfg.num_layers} layers, float32, capacity_factor {cfg.moe.capacity_factor:g} (no "
          f"drops), {LM_SEQ}-token prompt: logits vs the one-rank model on the same weights, rel_err "
          + ", ".join(f"{n} {errs[n]:.3e} (ran {errs[n + ' ran']})" for n, _, _ in EP_DISPATCHES)
          + f" (tol {EP_REL_TOL}); einsum aux {aux:.6f} vs one rank {one_aux:.6f} (rel {aux_err:.2e}, tol 1e-6)",
          flush=True)
    for name, dispatch, _ in EP_DISPATCHES:
        check(errs[name] <= EP_REL_TOL, f"{label} {name}: {errs[name]:.3e} > {EP_REL_TOL}")
        check(set(errs[name + " ran"]) == {(dispatch, EP_P)}, f"{label} {name} ran {errs[name + ' ran']}")
    check(aux_err <= 1e-6, f"{label}: the einsum dispatch's aux {aux} differs from the one-rank {one_aux}")


def ep_prefill_ms(torch, mesh, cfg, params, seed: int, one_rank: bool = False) -> dict:
    """The prefill of one EP_PREFILL-token prompt (the same tokens on
    every rank) through each dispatch of EP_DISPATCHES on ``mesh``, and
    the first MoE layer's apply_moe on that many random tokens, each
    CUDA-event ms, median of EP_REPS (every rank runs the same calls, so
    each enters its collectives as often); with ``one_rank`` also the
    model without a mesh (the weights must be whole: a SimMesh's)."""
    from repro_torch.models import moe
    from repro_torch.models.model import Model, _layer

    g = torch.Generator(device=mesh.device)
    g.manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab_size, (1, EP_PREFILL), device=mesh.device, generator=g)
    x = torch.randn((1, EP_PREFILL, cfg.d_model), device=mesh.device, generator=g).to(getattr(torch, cfg.dtype))
    ffn = _layer(params["moe"], 0)["ffn"]

    def timed(model, on):
        return (events_ms(torch, lambda: model.prefill(params, {"tokens": toks}, model.init_decode_state(1, EP_PREFILL)),
                          reps=EP_REPS),
                events_ms(torch, lambda: moe.apply_moe(ffn, x, model.cfg, mesh=on), reps=EP_REPS))

    out = {}
    for name, dispatch, interleave in EP_DISPATCHES:
        with ep_interleaved(moe, interleave):
            out[name], out[name + " one MoE layer"] = timed(ep_model(cfg, mesh, dispatch), mesh)
    if one_rank:
        out["one rank"], out["one rank one MoE layer"] = timed(Model(cfg), None)
    return out


def print_prefill_ms(label: str, ms: dict) -> None:
    print(f"{label} expert exchange at one {EP_PREFILL}-token prefill (CUDA events, median of {EP_REPS}): "
          + ", ".join(f"{n} {ms[n]:.2f} ms (one MoE layer {ms[n + ' one MoE layer']:.2f})" for n, _, _ in EP_DISPATCHES)
          + (f"; one rank {ms['one rank']:.2f} ms (one MoE layer {ms['one rank one MoE layer']:.2f})"
             if "one rank" in ms else ""), flush=True)


def ep_sim_serving(torch, seed, fft_stage, cm, eng, cfg, scfg, nbytes, launch, one_card: dict) -> dict:
    """Phase 16's serving: phase 15's bfloat16 weights (the same tensors)
    behind Model(cfg, SimMesh(EP_P)), phase 14's stream at the stock
    factor (the ring for a prompt EP_P divides, the einsum dispatch over
    the ranks otherwise and for every decode step); the share of greedy
    tokens equal to phase 15's one-card engine; for MLA (DeepSeek-V3) the
    dispatches' prefill ms. Returns its FFT kernel launches."""
    from repro_torch.core import SimMesh
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine

    label = f"EP SimMesh({EP_P}) {cfg.name}"
    mesh = SimMesh(EP_P)
    eng.state = None  # phase 15's caches
    ep = ServeEngine(Model(cfg, mesh), eng.params, scfg)
    moe.DISPATCHES.clear()
    (stream, kernels), launches, peak = counted(
        torch, fft_stage, label, lambda: lm_serve_stream(torch, ep, cfg, launch), expect=())
    ran = dict(moe.DISPATCHES)
    del ep
    torch.cuda.empty_cache()
    lm_stream_report(torch, label, cfg, scfg, nbytes, stream, kernels, peak, launches, cm)
    results = stream[0]
    same = sum(a == b for u, toks in one_card.items() for a, b in zip(results[u], toks))
    total = sum(len(t) for t in one_card.values())
    print(f"{label} greedy tokens equal to phase 15's one-card engine on the same stream and weights: {same} of "
          f"{total} ({same / total:.4f}); dispatches that ran {ran}", flush=True)
    check(any(d == "einsum" and p == EP_P for d, p in ran), f"{label}: no einsum dispatch over {EP_P} ranks ran: {ran}")
    if cfg.mla is not None:
        print_prefill_ms(label, ep_prefill_ms(torch, mesh, cfg, eng.params, seed, one_rank=True))
    return launches


def bf16_oracle_agreement(torch, seed, model, params, label: str, what: str) -> None:
    """Check 2 of phases 15 and 18: ``model`` (bfloat16; MoE: no drops) on
    MOE_BF16_ROWS prompts of LM_BF16_SEQ + 1 tokens, one at a time: its
    prefill + 1 decode step and its whole-sequence logits, each against a
    float32 oracle (a float32 Model on the same weights, each weight cast
    at its use). With random experts the bfloat16 forward itself is a few
    1e-2 from the oracle, so the path is held to it (MOE_BF16_NOISE_RATIO
    on the medians); phase 14's comparison with the bfloat16 whole
    sequence is printed beside. ``what``: the model's setting, for the
    printed line."""
    import dataclasses

    from repro_torch.models.model import Model

    oracle = Model(dataclasses.replace(model.cfg, dtype="float32"))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    path, own, vs_whole = [], [], []
    for _ in range(MOE_BF16_ROWS):
        toks = torch.randint(0, model.cfg.vocab_size, (1, LM_BF16_SEQ + 1), device="cuda", generator=g)
        exact = oracle.logits(params, {"tokens": toks})
        whole = model.logits(params, {"tokens": toks})
        state = model.init_decode_state(1, LM_BF16_SEQ + 1)
        state, pl = model.prefill(params, {"tokens": toks[:, :LM_BF16_SEQ]}, state)
        lg, _ = model.decode_step(params, toks[:, LM_BF16_SEQ:], state)
        for got, at in ((pl, LM_BF16_SEQ - 1), (lg, LM_BF16_SEQ)):
            path.append(lm_rel_err(got, exact[:, at]))
            own.append(lm_rel_err(whole[:, at], exact[:, at]))
            vs_whole.append(lm_rel_err(got, whole[:, at]))
        del exact, whole, state
    med_path, med_own = statistics.median(path), statistics.median(own)

    def row(errs):
        return ", ".join(f"{e:.3e}" for e in errs)

    print(f"{label} {model.cfg.num_layers} layers, bfloat16, {what}{MOE_BF16_ROWS} prompts "
          f"of {LM_BF16_SEQ} + 1 decode step, rel_err (prefill, decode per prompt) vs a float32 oracle on the same "
          f"weights: prefill + decode {row(path)} (median {med_path:.3e}); the bfloat16 whole sequence {row(own)} "
          f"(median {med_own:.3e}); tol: median {MOE_BF16_NOISE_RATIO} x the whole sequence's, which must stay "
          f"under {MOE_BF16_FLOOR_LIMIT}. Prefill + decode vs the bfloat16 whole sequence (phase 14's check, "
          f"{LM_BF16_REL_TOL} there): {row(vs_whole)}", flush=True)
    check(med_own <= MOE_BF16_FLOOR_LIMIT, f"{label}: the bfloat16 forward's median error {med_own:.3e} > "
          f"{MOE_BF16_FLOOR_LIMIT}")
    check(med_path <= MOE_BF16_NOISE_RATIO * med_own, f"{label}: prefill + decode median error {med_path:.3e} > "
          f"{MOE_BF16_NOISE_RATIO} x the bfloat16 forward's {med_own:.3e}")


def moe_full_depth(torch, seed, arch: str, scfg, launch):
    """Checks 2 and 3 of phase 15: ``arch`` at MOE_CUTS' depth in
    bfloat16, built as launch/serve.py builds it; the agreement with no
    drops (a Model at capacity_factor E/k on the same weights), then the
    launcher's stream at the stock factor, recording which assignments
    one full-slot decode step kept in each MoE layer."""
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    label = f"MoE serving {arch}"
    cfg = moe_cfg(arch, **MOE_CUTS[arch])
    eng, nbytes = lm_build(torch, seed, cfg, scfg, launch, "MoE serving")
    bf16_oracle_agreement(torch, seed, Model(moe_cfg(arch, no_drop=True, **MOE_CUTS[arch])), eng.params, label,
                          "capacity_factor E/k (no drops), ")
    routed, recording = [], [False]
    dispatch, decode = moe._dispatch_indices, eng._decode

    def recorded_dispatch(idx, e, cap):
        out = dispatch(idx, e, cap)
        if recording[0]:
            routed.append((idx, out[2]))
        return out

    def first_full_step(params, tokens, state):
        recording[0] = not routed and all(r is not None for r in eng.slots)
        try:
            return decode(params, tokens, state)
        finally:
            recording[0] = False

    moe._dispatch_indices, eng._decode = recorded_dispatch, first_full_step
    try:
        stream, kernels = lm_serve_stream(torch, eng, cfg, launch)
    finally:
        moe._dispatch_indices, eng._decode = dispatch, decode
    return cfg, nbytes, stream, kernels, routed, eng


def moe_serving_phase(torch, seed, fft_stage, cm) -> dict:
    """Phases 15 and 16: MoE + MLA serving, DeepSeek-V3 and Mixtral-8x22B
    at full width on one card, then expert-parallel on SimMesh(EP_P) on
    the same weights; returns each model's FFT kernel launches."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch import serve as launch
    from repro_torch.models import moe

    scfg, by_path = ServeConfig(), {}
    for arch in MOE_CUTS:
        label = f"MoE serving {arch}"
        moe_width_checks(torch, seed, arch)
        cfg = moe_cfg(arch, **MOE_CUTS[arch])
        lm_check_free(torch, f"{label} before the cut-depth model",
                      2 * cfg.param_count() + lm_kv_bytes(cfg, scfg) + LM_HEADROOM_GIB * 2**30)
        (cfg, nbytes, stream, kernels, routed, eng), launches, peak = counted(
            torch, fft_stage, label, lambda: moe_full_depth(torch, seed, arch, scfg, launch), expect=())
        torch.cuda.empty_cache()
        mo = cfg.moe
        check(len(routed) == cfg.num_layers - mo.first_k_dense, f"{label}: {len(routed)} dispatches recorded")
        dropped = [1 - keep.float().mean().item() for _, keep in routed]
        experts = [int(idx.unique().numel()) for idx, _ in routed]
        eff = mo.expert_d_ff or cfg.d_ff
        per_expert = 3 * cfg.d_model * eff * 2  # gate, up, down in bfloat16
        needed = nbytes - sum(mo.num_experts - n for n in experts) * per_expert
        print(f"{label} dropped share of one full-slot decode step's {scfg.max_batch * mo.top_k} assignments "
              f"(capacity {moe._capacity(scfg.max_batch, mo.top_k, mo.num_experts, mo.capacity_factor)}) per MoE "
              f"layer: {', '.join(f'{d:.4f}' for d in dropped)}; distinct experts routed {experts} of "
              f"{mo.num_experts}", flush=True)
        lm_stream_report(torch, label, cfg, scfg, nbytes, stream, kernels, peak, launches, cm,
                         routed=(needed, "reading only the routed experts"))
        lm_launcher(arch, launch, label)
        by_path[f"moe_serving_{arch}"] = launches
        by_path[f"ep_sim_serving_{arch}"] = ep_sim_serving(torch, seed, fft_stage, cm, eng, cfg, scfg, nbytes, launch,
                                                           stream[0])
        if cfg.mla is not None:
            eng.state = None  # the engine's caches
            torch.cuda.empty_cache()
            latent_seq_decode(torch, seed, eng, cfg)
        del eng
    return by_path


def tp_runs(torch, model, params, toks, n: int, enc=None, logits: bool = False, states=None) -> list:
    """``model``'s hidden states (``logits``: its logits) of the first
    ``n`` tokens, then a prefill of them and the decode steps to the end
    of ``toks`` (float32 cache): [hidden, prefill logits, decode
    logits...]. ``enc``: the encoder-decoder's frame embeddings;
    ``states``: a list the final decode state is appended to."""
    def batch(t):
        return {"tokens": t} if enc is None else {"enc_embeds": enc, "tokens": t}

    out = [model.logits(params, batch(toks[:, :n])) if logits else model.hidden(params, batch(toks[:, :n]))[0]]
    state = model.init_decode_state(toks.shape[0], toks.shape[1], cache_dtype=torch.float32)
    state, pl = model.prefill(params, batch(toks[:, :n]), state)
    out.append(pl)
    for t in range(n, toks.shape[1]):
        lg, state = model.decode_step(params, toks[:, t:t + 1], state)
        out.append(lg)
    if states is not None:
        states.append(state)
    return out


def kv_cache_bytes(state) -> int:
    """The bytes of a decode state's self-attention KV caches (every
    ``KVCache``'s K and V; not whisper's cross K / V)."""
    from repro_torch.models.attention import KVCache

    def walk(t):
        if isinstance(t, KVCache):
            return t.k.numel() * t.k.element_size() + t.v.numel() * t.v.element_size()
        return sum(walk(x) for x in t) if isinstance(t, tuple) else 0

    return sum(walk(v) for v in state.values())


def tp_width_check(torch, g, model, params, label: str, **kw) -> None:
    """Check 1 of phase 17: ``model``'s float32 weights (the same tensors;
    each rank's block a view) on Model(cfg, SimMesh(TP_P)) -- ``kw``
    overrides the config, e.g. the attention partition -- against the
    one-rank model: hidden (LM_SEQ tokens, which TP_P divides: the
    sequence-parallel rings), a prefill and TP_DECODE decode steps (the
    psum form), each within TP_REL_TOL."""
    import dataclasses

    from repro_torch.core import SimMesh
    from repro_torch.models.model import Model

    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (1, LM_SEQ + TP_DECODE), device="cuda", generator=g)
    one = tp_runs(torch, model, params, toks, LM_SEQ)
    tp = Model(dataclasses.replace(cfg, **kw), SimMesh(TP_P))
    check(tp.seq_parallel(LM_SEQ), f"{label}: hidden over {LM_SEQ} tokens does not take the sequence-parallel rings")
    errs = [lm_rel_err(a, b) for a, b in zip(tp_runs(torch, tp, params, toks, LM_SEQ), one)]
    print(f"{label}{' ' + str(kw) if kw else ''} full width, {cfg.num_layers} layers, float32 (float32 cache): vs the one-rank model on "
          f"the same weights, rel_err hidden ({LM_SEQ} tokens, sequence-parallel rings) {errs[0]:.3e}, prefill "
          f"{errs[1]:.3e}, {TP_DECODE} decode steps {', '.join(f'{e:.3e}' for e in errs[2:])} (tol {TP_REL_TOL})",
          flush=True)
    check(max(errs) <= TP_REL_TOL, f"{label} {kw}: {max(errs):.3e} > {TP_REL_TOL}")


def tp_dense_checks(torch, seed) -> None:
    """Check 1 of phase 17 for the dense archs: TP_F32's configs at full
    width, TP_F32_LAYERS layers, float32, each on its own weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    for arch, kw in TP_F32:
        cfg = dataclasses.replace(get_config(arch), num_layers=TP_F32_LAYERS, dtype="float32")
        model = Model(cfg)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        params, _ = model.init(g)
        tp_width_check(torch, g, model, params, f"TP SimMesh({TP_P}) {arch}", **kw)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()


def tp_prefill_ms(torch, models, params, seed: int) -> dict:
    """One TP_PREFILL-token prompt through each of ``models`` (label ->
    Model): prefill (the psum form) and hidden (the sequence-parallel
    rings where the model splits), CUDA-event ms, median of TP_REPS."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 4)
    first = next(iter(models.values()))
    toks = torch.randint(0, first.cfg.vocab_size, (1, TP_PREFILL), device=first.device, generator=g)
    out = {}
    for name, m in models.items():
        out[f"{name} prefill"] = events_ms(torch, lambda: m.prefill(params, {"tokens": toks},
                                                                    m.init_decode_state(1, TP_PREFILL)), reps=TP_REPS)
        out[f"{name} hidden"] = events_ms(torch, lambda: m.hidden(params, {"tokens": toks}), reps=TP_REPS)
    return out


def tp_counted_check(torch, model, params, cfg, seed: int, label: str) -> None:
    """Phase 17's dry-run check: one TP_PREFILL-token prefill of
    TP_COUNT_BATCH rows and one decode step on ``model`` (SimMesh(TP_P)),
    each's activation collectives (``core.mesh.collectives``, one rank's
    share) equal to ``launch.dryrun``'s prefill / decode cell on
    ``MeshShape((1, TP_P))`` at the same rows, prompt and cache, exactly."""
    from repro_torch.core.mesh import collectives, reset_collectives
    from repro_torch.launch.mesh import MeshShape

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 5)
    toks = torch.randint(0, cfg.vocab_size, (TP_COUNT_BATCH, TP_PREFILL), device=model.device, generator=g)
    mesh = MeshShape((1, TP_P), ("data", "model"))
    state = model.init_decode_state(TP_COUNT_BATCH, TP_PREFILL + 1)
    for kind, seq in (("prefill", TP_PREFILL), ("decode", TP_PREFILL + 1)):
        walk = walk_activation(cfg, kind, seq, TP_COUNT_BATCH, mesh)
        print(f"{label} dry run before its {kind} ({TP_COUNT_BATCH} x {seq}, MeshShape((1, {TP_P}))): activation "
              f"collectives {sum(walk['counts'].values())} calls, {sum(walk['bytes'].values())} B assembled a rank "
              f"({card()})", flush=True)
        reset_collectives()
        if kind == "prefill":
            state, _ = model.prefill(params, {"tokens": toks}, state)
        else:
            model.decode_step(params, toks[:, :1], state)
        torch.cuda.synchronize()
        check_counted(f"{label} {kind}", walk, collectives("activation"))
        check(not any(collectives("state")["counts"].values()), f"{label}: a SimMesh counted state collectives")
    del state
    torch.cuda.empty_cache()


def seq_runs(torch, model, params, toks, n: int, seq_shard: bool):
    """A prefill of ``toks[:, :n]`` and a decode step for each later token
    on a float32 cache of ``toks.shape[1]`` positions (``seq_shard``: its
    sequence over ``data``): ([prefill logits, decode logits...], the
    state)."""
    state = model.init_decode_state(toks.shape[0], toks.shape[1], cache_dtype=torch.float32, seq_shard=seq_shard)
    state, pl = model.prefill(params, {"tokens": toks[:, :n]}, state)
    out = [pl]
    for t in range(n, toks.shape[1]):
        lg, state = model.decode_step(params, toks[:, t:t + 1], state)
        out.append(lg)
    return out, state


def latent_bytes(state) -> int:
    """The bytes of a decode state's latent caches (every ``MLACache``'s
    ``ckv`` and ``k_rope``)."""
    from repro_torch.models.attention import MLACache

    return sum(c.ckv.numel() * c.ckv.element_size() + c.k_rope.numel() * c.k_rope.element_size()
               for c in state.values() if isinstance(c, MLACache))


def seq_width_check(torch, g, model, params, label: str) -> None:
    """Phase 17's sequence cut: ``model``'s float32 weights (the same
    tensors) on Model(cfg, SimMesh(SEQ_GRID)) over ("data", "model") with
    ``seq_shard`` -- the cache's LM_SEQ + TP_DECODE positions (and the
    meta tokens) in two blocks over ``data``, the prompt's LM_SEQ written
    into both -- against the one-rank model: a prefill and TP_DECODE
    decode steps within TP_REL_TOL, and ``attention.flash_decode_combine``
    must have run (its calls counted). One row for each ``data``
    coordinate: the MoE ring's islands take the rows over ``data``, as the
    reference's ``x_spec`` does (its shard_map refuses a batch the axis
    does not divide)."""
    from repro_torch.core import SimMesh
    from repro_torch.models import attention
    from repro_torch.models.model import Model

    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (SEQ_GRID[0], LM_SEQ + TP_DECODE), device="cuda", generator=g)
    one, _ = seq_runs(torch, model, params, toks, LM_SEQ, False)
    cut = Model(cfg, SimMesh(SEQ_GRID, axis_names=SEQ_AXES))
    calls, combine = [], attention.flash_decode_combine
    attention.flash_decode_combine = lambda *a: calls.append(1) or combine(*a)
    try:
        got, _ = seq_runs(torch, cut, params, toks, LM_SEQ, True)
    finally:
        attention.flash_decode_combine = combine
    sc, s_tot = cut.serve_tp.kv_seq, toks.shape[1] + cfg.meta_tokens
    check(sc is not None and sc.blocks == SEQ_GRID[0], f"{label}: the cache's sequence is not cut over data")
    errs = [lm_rel_err(a, b) for a, b in zip(got, one)]
    print(f"{label} full width, {cfg.num_layers} layers, float32 (float32 cache), seq_shard on SimMesh({SEQ_GRID}) "
          f"{SEQ_AXES}: the cache's {s_tot} positions in {sc.blocks} blocks of {s_tot // sc.blocks} over data, a "
          f"{LM_SEQ}-token prompt written into both; vs the one-rank model on the same weights, rel_err prefill "
          f"{errs[0]:.3e}, {TP_DECODE} decode steps {', '.join(f'{e:.3e}' for e in errs[1:])} (tol {TP_REL_TOL}); "
          f"flash_decode_combine calls {len(calls)}", flush=True)
    check(len(calls) > 0, f"{label}: the sequence-cut decode never combined its blocks")
    check(max(errs) <= TP_REL_TOL, f"{label} seq_shard: {max(errs):.3e} > {TP_REL_TOL}")


def seq_hymba_check(torch, seed) -> None:
    """Phase 17's sequence cut of a KV cache: Hymba-1.5B at full width,
    SEQ_HYMBA_LAYERS layers (layer 1 windowed), float32; its 5 KV heads
    of 64 cut along the head dim over ``model`` as well."""
    from repro_torch.models.model import Model

    model = Model(ssm_cfg("hymba-1.5b", SEQ_HYMBA_LAYERS, "float32"))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = model.init(g)
    seq_width_check(torch, g, model, params, f"TP SimMesh({SEQ_GRID}) hymba-1.5b")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def latent_seq_decode(torch, seed, eng, cfg) -> None:
    """Phase 15's long-context decode: the engine's DeepSeek-V3 (MOE_CUTS'
    depth, bfloat16 weights), batch 1, one decode step at position
    SEQ_LONG - 1 of a SEQ_LONG-position bfloat16 latent cache filled from
    the seed (no prefill), whole on one rank and with its sequence over
    ``data`` on SimMesh(SEQ_GRID) on the same weights: each step's CUDA-
    event ms (median of SEQ_REPS), its logits' distance between the two,
    the cache bytes a rank holds; no gate on speed."""
    from repro_torch.core import SimMesh
    from repro_torch.models.attention import MLACache
    from repro_torch.models.model import Model

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 9)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), device="cuda", generator=g)
    runs = {}
    for name, model, cut in (("one rank", eng.model, False),
                             (f"SimMesh({SEQ_GRID}) seq_shard", Model(cfg, SimMesh(SEQ_GRID, axis_names=SEQ_AXES)), True)):
        state = model.init_decode_state(1, SEQ_LONG, seq_shard=cut)
        caches = [c for c in state.values() if isinstance(c, MLACache)]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 10)  # the same cache for both
        for c in caches:
            c.ckv.normal_(generator=gen)
            c.k_rope.normal_(generator=gen)

        def step():
            for c in caches:
                c.length.fill_(SEQ_LONG - 1)
            state["pos"] = SEQ_LONG - 1
            return model.decode_step(eng.params, tok, state)[0]

        with torch.inference_mode():
            logits = step()
            ms = events_ms(torch, step, reps=SEQ_REPS)
        blocks = model.serve_tp.kv_seq.blocks if cut else 1
        runs[name] = (logits.float(), ms, latent_bytes(state), blocks)
        del state, caches
        torch.cuda.empty_cache()
    (one, one_ms, nbytes, _), (got, ms, _, blocks) = runs.values()
    print(f"MoE serving {cfg.name} {cfg.num_layers} layers bf16, batch 1, one decode step at position {SEQ_LONG - 1} of "
          f"a {SEQ_LONG}-position latent cache filled from the seed ({nbytes} B bf16 in all): one rank "
          f"{one_ms:.3f} ms, SimMesh({SEQ_GRID}) with its sequence over data {ms:.3f} ms (CUDA events, median of "
          f"{SEQ_REPS}; the SimMesh runs every rank's blocks on this card); a rank's block of the cut cache "
          f"{nbytes // blocks} B (1/{blocks}, what a process of the grid holds); logits rel_err between the two "
          f"{lm_rel_err(got, one):.3e} (bf16, not gated) ({card()})", flush=True)


def tp_serving_phase(torch, seed, fft_stage, cm) -> dict:
    """Phase 17: tensor parallelism on SimMesh(TP_P), one card. Check 1
    (the dense archs; the MoE archs ran beside phase 16's check 1), then
    Qwen2.5-32B at full width and TP_SERVE_LAYERS layers in bfloat16:
    phase 14's stream on one rank and on Model(cfg, SimMesh(TP_P)) on the
    same weights (views), the TP engine's report and its share of greedy
    tokens equal to one rank's; one TP_PREFILL-token prompt's prefill
    beside hidden. Returns the FFT kernels' launches (0)."""
    import dataclasses

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.core import SimMesh
    from repro_torch.launch import serve as launch
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine

    tp_dense_checks(torch, seed)
    seq_hymba_check(torch, seed)
    cfg, scfg = dataclasses.replace(get_config(LM_ARCH), num_layers=TP_SERVE_LAYERS), ServeConfig()
    label = f"TP SimMesh({TP_P}) {cfg.name}"
    lm_check_free(torch, f"{label} before serving", 2 * cfg.param_count() + 2 * lm_kv_bytes(cfg, scfg)
                  + LM_HEADROOM_GIB * 2**30)
    eng, nbytes = lm_build(torch, seed, cfg, scfg, launch, "TP serving one rank")
    one = lm_serve_stream(torch, eng, cfg, launch)[0]
    eng.state = None  # the one-rank engine's caches
    tp = ServeEngine(Model(cfg, SimMesh(TP_P)), eng.params, scfg)
    (stream, kernels), launches, peak = counted(
        torch, fft_stage, label, lambda: lm_serve_stream(torch, tp, cfg, launch), expect=())
    tp.state = None
    torch.cuda.empty_cache()
    print(f"{label} one rank on the same weights and stream: {stream_summary(one, scfg)}", flush=True)
    lm_stream_report(torch, label, cfg, scfg, nbytes, stream, kernels, peak, launches, cm)
    same = sum(a == b for u, toks in one[0].items() for a, b in zip(stream[0][u], toks))
    total = sum(len(t) for t in one[0].values())
    print(f"{label} greedy tokens equal to one rank's on the same stream and weights: {same} of {total} "
          f"({same / total:.4f})", flush=True)
    tp_counted_check(torch, tp.model, eng.params, cfg, seed, label)
    ms = tp_prefill_ms(torch, {"one rank": eng.model, f"SimMesh({TP_P})": tp.model}, eng.params, seed)
    print(f"{label} one {TP_PREFILL}-token prompt, bfloat16, {TP_SERVE_LAYERS} layers (CUDA events, median of "
          f"{TP_REPS}): " + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f" (prefill: the psum form, one psum a sublayer; hidden: the sequence-parallel rings)", flush=True)
    del eng, tp
    gc.collect()
    torch.cuda.empty_cache()
    return {"tp_sim_serving": launches}


def ssm_cfg(arch: str, layers: int = 0, dtype: str = ""):
    """``arch``'s full-width config, depth cut to ``layers`` and in
    ``dtype`` where given."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers, dtype=dtype or cfg.dtype)


def ssm_state_bytes(state) -> int:
    """The bytes of a decode state's recurrent leaves: every leaf but the
    KV caches' (the mLSTM (C, n, m), the conv windows, the sLSTM and
    Mamba states)."""
    from repro_torch.models.attention import KVCache

    def walk(t):
        if isinstance(t, KVCache):
            return 0
        if isinstance(t, tuple):
            return sum(walk(a) for a in t)
        return t.numel() * t.element_size()

    return sum(walk(v) for k, v in state.items() if k != "pos")


def ssm_width_checks(torch, seed, arch: str) -> None:
    """Check 1 of phase 18: ``arch`` at full width, SSM_F32_LAYERS' depth,
    float32 (TF32 off since phase 1): a SSM_F32_SEQ-token prefill +
    LM_DECODE decode steps against the whole sequence's logits, and
    phase 14's slot isolation."""
    from repro_torch.models.model import Model

    label = f"SSM serving {arch}"
    model = Model(ssm_cfg(arch, SSM_F32_LAYERS[arch], "float32"))
    cfg, seq = model.cfg, SSM_F32_SEQ[arch]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = model.init(g)
    errs, top = lm_agreement(torch, model, params, g, seq)
    layers = [model._flag(grp, i) for grp in model.groups for i in range(grp.count)]
    where = (f", layers global {layers} (window {cfg.window_size}), {cfg.meta_tokens} meta tokens"
             if cfg.window_size else "")
    print(f"{label} full width, {cfg.num_layers} layers{where}, float32 (float32 state and cache): prefill of {seq} + "
          f"{LM_DECODE} decode steps vs logits of the full sequence, rel_err (to max |logit| {top:.3f}) "
          f"{', '.join(f'{e:.3e}' for e in errs)} (tol {SSM_F32_REL_TOL})", flush=True)
    check(max(errs) <= SSM_F32_REL_TOL, f"{label} prefill/decode vs full logits: {max(errs):.3e} > {SSM_F32_REL_TOL}")
    lm_isolation(torch, model, params, g, label)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def ssm_full_depth(torch, seed, arch: str, scfg, launch):
    """Checks 2 and 3 of phase 18: ``arch`` at all its layers in bfloat16,
    built as launch/serve.py builds it: the float32-oracle agreement, then
    the launcher's stream."""
    cfg = ssm_cfg(arch)
    eng, nbytes = lm_build(torch, seed, cfg, scfg, launch, "SSM serving")
    if arch in SSM_BF16_LAYERWISE:
        ssm_bf16_layerwise(torch, seed, eng.model, eng.params, f"SSM serving {arch}")
    else:
        bf16_oracle_agreement(torch, seed, eng.model, eng.params, f"SSM serving {arch}", "")
    stream, kernels = lm_serve_stream(torch, eng, cfg, launch)
    return cfg, nbytes, stream, kernels, eng


def ssm_bf16_layerwise(torch, seed, model, params, label: str) -> None:
    """Check 2 of phase 18 layer by layer (SSM_BF16_LAYERWISE): on
    MOE_BF16_ROWS prompts of LM_BF16_SEQ + 1 tokens (one batch: nothing
    couples the rows of a recurrent model), every layer of the bfloat16
    ``model`` runs on the float32 oracle's input to that layer (rounded to
    bf16), so no layer inherits another's rounding: its prefill of the
    first LM_BF16_SEQ positions + 1 decode step (its own state) and its
    whole-sequence pass, each layer's increment (output - input) against
    the oracle layer's at the last two positions of each prompt; phase
    15's gate over every (prompt, layer, position). The bf16 model's own
    residual stream rides along through the depth, and its distance from
    the oracle's is printed (the growth that rules out a whole-model
    gate)."""
    import dataclasses

    from repro_torch.models.model import Model, _layer, _state_layer, _write_back

    oracle = Model(dataclasses.replace(model.cfg, dtype="float32"))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    rows = MOE_BF16_ROWS
    toks = torch.randint(0, model.cfg.vocab_size, (rows, LM_BF16_SEQ + 1), device="cuda", generator=g)
    path, own, drift = [], [], []
    with torch.inference_mode():
        x32 = oracle._embed_in(params, {"tokens": toks})
        x16 = x32.to(model.dtype)  # the bf16 model's own stream
        state = model.init_decode_state(rows, LM_BF16_SEQ + 1)
        for grp in model.groups:
            for i in range(grp.count):
                p, flag = _layer(params[grp.name], i), model._flag(grp, i)
                y32 = oracle._trunk_block(grp, p, x32, flag)[0]
                xin = x32.to(model.dtype)
                whole = model._trunk_block(grp, p, xin, flag)[0]
                view = _state_layer(state[grp.name], i)
                pre, new = model._prefill_block(grp, p, xin[:, :-1], view, flag, tp=model.serve_tp)
                _write_back(view, new)
                dec, _ = model._decode_block(grp, p, xin[:, -1:], view, flag, tp=model.serve_tp)
                d32 = y32 - x32
                for got, at in ((pre[:, -1], -2), (dec[:, 0], -1)):
                    for r in range(rows):
                        path.append(lm_rel_err(got[r].float() - xin[r, at].float(), d32[r, at]))
                        own.append(lm_rel_err(whole[r, at].float() - xin[r, at].float(), d32[r, at]))
                x16 = model._trunk_block(grp, p, x16, flag)[0]
                drift.append(statistics.median(lm_rel_err(x16[r], y32[r]) for r in range(rows)))
                x32 = y32
    med_path, med_own = statistics.median(path), statistics.median(own)
    shown = [(d, e) for d, e in enumerate(drift, 1) if d & (d - 1) == 0 or d == len(drift)]
    print(f"{label} {model.cfg.num_layers} layers, bfloat16, layer by layer on a float32 oracle's input (same "
          f"weights), {rows} prompts of {LM_BF16_SEQ} + 1 decode step: each layer's increment at the prompt's last "
          f"position (prefill) and the next (decode), rel_err vs the oracle layer's over {len(path)} (prompt, "
          f"layer, position): prefill + decode median {med_path:.3e} (max {max(path):.3e}); the bf16 "
          f"whole-sequence pass of the layer median {med_own:.3e} (max {max(own):.3e}); tol: median "
          f"{MOE_BF16_NOISE_RATIO} x the whole pass's, which must stay under {MOE_BF16_FLOOR_LIMIT}. The bf16 "
          f"model's own stream vs the oracle's (median over the prompts, not gated), by block: "
          + ", ".join(f"{d}: {e:.3e}" for d, e in shown), flush=True)
    check(med_own <= MOE_BF16_FLOOR_LIMIT, f"{label}: the bf16 layers' median error {med_own:.3e} > "
          f"{MOE_BF16_FLOOR_LIMIT}")
    check(med_path <= MOE_BF16_NOISE_RATIO * med_own, f"{label}: prefill + decode layers' median error "
          f"{med_path:.3e} > {MOE_BF16_NOISE_RATIO} x the whole pass's {med_own:.3e}")


def ssm_mixers_ms(torch, seed, eng) -> dict:
    """Check 4 of phase 18: one SSM_MIXER_SEQ-token prompt (and hymba's
    meta tokens) through each mixer of ``eng``'s first layer alone, on its
    bfloat16 weights and a fresh state: CUDA-event ms, median of
    SSM_MIXER_REPS."""
    from repro_torch.models import attention as A
    from repro_torch.models import blocks, ssm
    from repro_torch.models.model import _layer, _state_layer

    model = eng.model
    cfg, grp = model.cfg, model.groups[0]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 5)
    x = torch.randn((1, SSM_MIXER_SEQ + cfg.meta_tokens, cfg.d_model), device="cuda", generator=g).to(model.dtype)
    p = _layer(eng.params[grp.name], 0)
    st = _state_layer(model.init_decode_state(1, SSM_MIXER_SEQ)[grp.name], 0)
    if grp.kind == "hymba":
        spec = blocks._attn_spec(cfg, is_global=True)
        fns = {"Mamba block (chunked doubling scan)": lambda: ssm.apply_mamba(p["mamba"], x, cfg, st.mamba),
               "attention (prefill, chunked)": lambda: A.prefill_attention(p["attn"], x, st.kv, cfg, spec)}
    else:
        fns = {"mLSTM block (chunkwise)": lambda: ssm.apply_mlstm_block(p["m"], x, cfg, st.m),
               "sLSTM block (time loop)": lambda: ssm.apply_slstm_block(p["s"], x, cfg, st.s)}
    return {name: events_ms(torch, fn, reps=SSM_MIXER_REPS) for name, fn in fns.items()}


def ssm_serving_phase(torch, seed, fft_stage, cm) -> dict:
    """Phase 18: SSM and hybrid serving, xLSTM-1.3B and Hymba-1.5B at full
    width and depth on one card; returns each model's FFT kernel launches."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch import serve as launch

    scfg, by_path, t0 = ServeConfig(), {}, time.perf_counter()
    for arch in SSM_ARCHS:
        label = f"SSM serving {arch}"
        ssm_width_checks(torch, seed, arch)
        cfg = ssm_cfg(arch)
        lm_check_free(torch, f"{label} before the full-depth model",
                      2 * cfg.param_count() + lm_kv_bytes(cfg, scfg) + LM_HEADROOM_GIB * 2**30)
        (cfg, nbytes, stream, kernels, eng), launches, peak = counted(
            torch, fft_stage, label, lambda: ssm_full_depth(torch, seed, arch, scfg, launch), expect=())
        torch.cuda.empty_cache()
        state = ssm_state_bytes(eng.state)
        print(f"{label} decode state at {scfg.max_batch} slots x {scfg.max_seq}: {state / 2**30:.3f} GiB recurrent "
              f"(float32) + {lm_kv_bytes(cfg, scfg) / 2**30:.3f} GiB KV cache (bfloat16); {nbytes / 2 / 1e9:.3f} B "
              f"params (ModelConfig.param_count() {cfg.param_count() / 1e9:.3f} B)", flush=True)
        lm_stream_report(torch, label, cfg, scfg, nbytes, stream, kernels, peak, launches, cm,
                         state=(2 * state, "the recurrent state read and written once"), active=nbytes // 2)
        ms = ssm_mixers_ms(torch, seed, eng)
        print(f"{label} one {SSM_MIXER_SEQ}-token prompt{' (+ meta tokens)' if cfg.meta_tokens else ''}, bfloat16, "
              f"each mixer alone on one layer (CUDA events, median of {SSM_MIXER_REPS}): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
              + f"; x {cfg.num_layers // 2 if cfg.family == 'ssm' else cfg.num_layers} layers", flush=True)
        lm_launcher(arch, launch, label)
        by_path[f"ssm_serving_{arch}"] = launches
        del eng, stream
        gc.collect()
        torch.cuda.empty_cache()
    print(f"SSM serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


def encdec_cfg(layers: int = 0, dtype: str = ""):
    """whisper-medium at full width, both stacks cut to ``layers`` and in
    ``dtype`` where given."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC_ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers, encoder_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype)


def encdec_batch(enc, toks) -> dict:
    return {"enc_embeds": enc, "tokens": toks}


def encdec_greedy(torch, model, params, enc, prompt, steps: int, s_max: int):
    """A prefill of ``prompt`` over ``enc``, then ``steps`` greedy decode
    steps: (the tokens (B, steps + 1), [per-step logits])."""
    state = model.init_decode_state(prompt.shape[0], s_max, cache_dtype=torch.float32)
    state, lg = model.prefill(params, encdec_batch(enc, prompt), state)
    toks, logits = [torch.argmax(lg, -1)], [lg]
    for _ in range(steps):
        lg, state = model.decode_step(params, toks[-1][:, None], state)
        toks.append(torch.argmax(lg, -1))
        logits.append(lg)
    return torch.stack(toks, 1), logits


def encdec_width_checks(torch, seed) -> None:
    """Check 1 of phase 19: whisper-medium at full width (d_model 1024, 16
    heads, d_ff 4096, vocab 51865), ENCDEC_F32_LAYERS encoder and decoder
    layers, float32 (TF32 off since phase 1), 2 utterances of
    ENCDEC_FRAMES frames: a prefill of ENCDEC_F32_SEQ decoder tokens +
    LM_DECODE decode steps against the whole decoder sequence's logits;
    each row's greedy tokens alone and beside the other; and
    Model(cfg, SimMesh(TP_P)) on the same weights (heads and d_ff split
    four ways, the odd vocabulary whole) against the one-rank model:
    logits, prefill and TP_DECODE decode steps within TP_REL_TOL."""
    from repro_torch.core import SimMesh
    from repro_torch.models.model import Model

    label = f"encoder-decoder {ENCDEC_ARCH}"
    model = Model(encdec_cfg(ENCDEC_F32_LAYERS, "float32"))
    cfg, n = model.cfg, ENCDEC_F32_SEQ
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = model.init(g)
    enc = torch.randn((2, ENCDEC_FRAMES, cfg.d_model), device="cuda", generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, n + LM_DECODE), device="cuda", generator=g)
    full = model.logits(params, encdec_batch(enc, toks))
    state = model.init_decode_state(2, n + LM_DECODE, cache_dtype=torch.float32)
    state, pl = model.prefill(params, encdec_batch(enc, toks[:, :n]), state)
    errs = [lm_rel_err(pl, full[:, n - 1])]
    for t in range(LM_DECODE):
        lg, state = model.decode_step(params, toks[:, n + t:n + t + 1], state)
        errs.append(lm_rel_err(lg, full[:, n + t]))
    print(f"{label} full width, {cfg.encoder_layers} + {cfg.num_layers} layers, float32 (float32 cache), 2 x "
          f"{ENCDEC_FRAMES} frames: prefill of {n} + {LM_DECODE} decode steps vs logits of the whole decoder "
          f"sequence, rel_err (to max |logit| {full.abs().max().item():.3f}) {', '.join(f'{e:.3e}' for e in errs)} "
          f"(tol {LM_F32_REL_TOL}); cross K/V {tuple(state['cross'].k.shape)} {state['cross'].k.dtype}", flush=True)
    check(max(errs) <= LM_F32_REL_TOL, f"{label} prefill/decode vs full logits: {max(errs):.3e} > {LM_F32_REL_TOL}")
    both, _ = encdec_greedy(torch, model, params, enc, toks[:, :n], LM_ISOLATION_NEW, n + LM_ISOLATION_NEW + 1)
    alone = [encdec_greedy(torch, model, params, enc[r:r + 1], toks[r:r + 1, :n], LM_ISOLATION_NEW,
                           n + LM_ISOLATION_NEW + 1)[0][0] for r in range(2)]
    print(f"{label} batch rows isolated: greedy tokens in the batch {both.tolist()}, each row alone "
          f"{[a.tolist() for a in alone]}", flush=True)
    check(all(torch.equal(both[r], alone[r]) for r in range(2)), f"{label}: a row's greedy tokens depend on the other")
    tp = Model(cfg, SimMesh(TP_P))
    check(not tp.tp.splits(cfg.vocab_size) and tp.tp.splits(cfg.num_heads), f"{label}: unexpected placement")
    one = tp_runs(torch, model, params, toks[:, :n + TP_DECODE], n, enc, logits=True)
    got = tp_runs(torch, tp, params, toks[:, :n + TP_DECODE], n, enc, logits=True)
    errs = [lm_rel_err(a, b) for a, b in zip(got, one)]
    print(f"{label} Model(cfg, SimMesh({TP_P})) on the same weights (heads and d_ff split, vocabulary "
          f"{cfg.vocab_size} whole): rel_err vs one rank, logits {errs[0]:.3e}, prefill {errs[1]:.3e}, "
          f"{TP_DECODE} decode steps {', '.join(f'{e:.3e}' for e in errs[2:])} (tol {TP_REL_TOL})", flush=True)
    check(max(errs) <= TP_REL_TOL, f"{label} SimMesh({TP_P}) vs one rank: {max(errs):.3e} > {TP_REL_TOL}")
    del model, params, tp, state, full
    gc.collect()
    torch.cuda.empty_cache()


def encdec_oracle_agreement(torch, seed, model, params, label: str) -> None:
    """Check 2's gate, bf16_oracle_agreement's form on the encoder-decoder:
    MOE_BF16_ROWS utterances of ENCDEC_FRAMES frames, each with the start
    sequence and one more token: the bfloat16 prefill + 1 decode step and
    the bfloat16 whole decoder sequence, each against a float32 oracle on
    the same weights (each weight cast at its use)."""
    import dataclasses

    from repro_torch.models.model import Model

    oracle = Model(dataclasses.replace(model.cfg, dtype="float32"))
    cfg = model.cfg
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    n = len(ENCDEC_SOT)
    path, own = [], []
    for _ in range(MOE_BF16_ROWS):
        enc = torch.randn((1, ENCDEC_FRAMES, cfg.d_model), device="cuda", generator=g).to(model.dtype)
        nxt = torch.randint(0, cfg.vocab_size, (1, 1), device="cuda", generator=g)
        toks = torch.cat([torch.tensor([ENCDEC_SOT], device="cuda"), nxt], 1)
        exact = oracle.logits(params, encdec_batch(enc, toks))
        whole = model.logits(params, encdec_batch(enc, toks))
        state = model.init_decode_state(1, n + 1)
        state, pl = model.prefill(params, encdec_batch(enc, toks[:, :n]), state)
        lg, _ = model.decode_step(params, toks[:, n:], state)
        for got, at in ((pl, n - 1), (lg, n)):
            path.append(lm_rel_err(got, exact[:, at]))
            own.append(lm_rel_err(whole[:, at], exact[:, at]))
        del exact, whole, state
    med_path, med_own = statistics.median(path), statistics.median(own)
    print(f"{label} {cfg.encoder_layers} + {cfg.num_layers} layers, bfloat16, {MOE_BF16_ROWS} utterances of "
          f"{ENCDEC_FRAMES} frames, the start sequence + 1 decode step, rel_err vs a float32 oracle on the same "
          f"weights: prefill + decode {', '.join(f'{e:.3e}' for e in path)} (median {med_path:.3e}); the bfloat16 "
          f"whole sequence median {med_own:.3e}; tol: median {MOE_BF16_NOISE_RATIO} x the whole sequence's, which "
          f"must stay under {MOE_BF16_FLOOR_LIMIT}", flush=True)
    check(med_own <= MOE_BF16_FLOOR_LIMIT, f"{label}: the bfloat16 forward's median error {med_own:.3e} > "
          f"{MOE_BF16_FLOOR_LIMIT}")
    check(med_path <= MOE_BF16_NOISE_RATIO * med_own, f"{label}: prefill + decode median error {med_path:.3e} > "
          f"{MOE_BF16_NOISE_RATIO} x the bfloat16 forward's {med_own:.3e}")


def encdec_serve(torch, seed, model, params) -> dict:
    """Check 2's run: ENCDEC_BATCH utterances of ENCDEC_FRAMES frames (made
    on the card from ``seed``), each with the start-of-transcript prompt,
    a decode state of ENCDEC_MAX_SEQ; time to first token (the encoder,
    the cross K/V and the decoder prefill; CUDA events, median of
    ENCDEC_REPS), then ENCDEC_NEW new tokens greedily (the prefill's and
    ENCDEC_NEW - 1 decode steps, each timed on the device and on the
    host), then one more step under torch.profiler."""
    cfg = model.cfg
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7)
    enc = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model), device="cuda", generator=g).to(model.dtype)
    prompt = torch.tensor([ENCDEC_SOT] * ENCDEC_BATCH, device="cuda")

    def first():
        return model.prefill(params, encdec_batch(enc, prompt), model.init_decode_state(ENCDEC_BATCH, ENCDEC_MAX_SEQ))

    ttft = events_ms(torch, first, reps=ENCDEC_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, lg = first()
    toks, steps = [torch.argmax(lg, -1)], []
    for _ in range(ENCDEC_NEW - 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        h0 = time.perf_counter()
        lg, state = model.decode_step(params, toks[-1][:, None], state)
        issue = (time.perf_counter() - h0) * 1e3
        end.record()
        toks.append(torch.argmax(lg, -1))
        steps.append((state["pos"], start, end, issue))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = torch.stack(toks, 1)
    check(out.shape == (ENCDEC_BATCH, ENCDEC_NEW) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"encoder-decoder greedy tokens {tuple(out.shape)} out of range")
    kernels = profiled_kernels(torch, lambda: model.decode_step(params, toks[-1][:, None], state))
    return dict(ttft_ms=ttft, wall_s=wall, tokens=out.numel(), state=state,
                steps=[(pos, s.elapsed_time(e), issue) for pos, s, e, issue in steps], kernels=kernels,
                first=out[0, :8].tolist())


def encdec_full_depth(torch, seed, cm, fft_stage) -> dict:
    """Check 2 of phase 19: whisper-medium at all 24 + 24 layers in
    bfloat16 (random weights from ``seed``, made on the card): the
    float32-oracle gate, then encdec_serve; prints its report beside the
    decode step's bound (the decoder's weights and the unembedding, the
    cross K/V and the live self-attention K/V, each read once)."""
    from repro_torch.models.model import Model

    label = f"encoder-decoder {ENCDEC_ARCH}"
    cfg = encdec_cfg()
    cross = 2 * 2 * cfg.num_layers * ENCDEC_BATCH * ENCDEC_FRAMES * cfg.num_kv_heads * cfg.head_dim_
    self_kv = lm_cache_bytes_per_token(cfg) * ENCDEC_BATCH * ENCDEC_MAX_SEQ
    lm_check_free(torch, f"{label} before the full-depth model", 2 * cfg.param_count() + cross + self_kv
                  + LM_HEADROOM_GIB * 2**30)

    def run():
        model = Model(cfg)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        t0 = time.perf_counter()
        params, _ = model.init(g, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        encdec_oracle_agreement(torch, seed, model, params, label)
        rep = encdec_serve(torch, seed, model, params)
        return model, params, init_s, rep

    (model, params, init_s, rep), launches, peak = counted(torch, fft_stage, label, run, expect=())
    def size(tree):
        return sum(t.numel() * t.element_size() for t in lm_leaves(tree))

    nbytes = size(params)
    dec = params["decoder"]  # a step reads all of it but the cross wk / wv (their K/V are precomputed)
    read = size(dec) - size(dec["cross"]["wk"]) - size(dec["cross"]["wv"]) + size(params["embed"]["unembed"])
    enc_macs = size(params["encoder"]) / 2 * ENCDEC_BATCH * ENCDEC_FRAMES  # the products, one MAC a weight a frame
    attn_macs = 2 * cfg.encoder_layers * ENCDEC_BATCH * ENCDEC_FRAMES ** 2 * cfg.d_model  # QK^T and PV
    cross_held = sum(t.numel() * t.element_size() for t in rep["state"]["cross"])
    check(cross_held == cross, f"{label}: cross K/V {cross_held} bytes, {cross} expected")
    pos = statistics.median(p for p, _, _ in rep["steps"])
    live = lm_cache_bytes_per_token(cfg) * ENCDEC_BATCH * pos
    bound_ms = (read + cross + live) / cm.HBM_BW * 1e3
    dev = statistics.median(ms for _, ms, _ in rep["steps"])
    host = statistics.median(h for _, _, h in rep["steps"])
    kernel_ms, top = rep["kernels"]
    kern = ("not measured (the profiler saw no device time)" if kernel_ms is None
            else f"{kernel_ms:.3f} ms (torch.profiler, one step)")
    print(f"{label} {cfg.encoder_layers} + {cfg.num_layers} layers in bfloat16 initialised on the card in "
          f"{init_s:.1f} s, {nbytes / 2**30:.2f} GiB of weights ({nbytes / 2 / 1e9:.3f} B params; "
          f"ModelConfig.param_count() {cfg.param_count() / 1e9:.3f} B); cross K/V {cross / 2**30:.3f} GiB, self K/V "
          f"{self_kv / 2**30:.3f} GiB ({ENCDEC_BATCH} x {ENCDEC_MAX_SEQ})", flush=True)
    print(f"{label} {ENCDEC_BATCH} utterances of {ENCDEC_FRAMES} frames, prompt {list(ENCDEC_SOT)}: time to first "
          f"token (encoder + cross K/V + decoder prefill) {rep['ttft_ms']:.2f} ms (CUDA events, median of "
          f"{ENCDEC_REPS}; the encoder's weight products {2 * enc_macs / 1e12:.2f} TFLOP, "
          f"{2 * enc_macs / cm.PEAK_FLOPS_BF16 * 1e3:.2f} ms at the bf16 peak, and its attention "
          f"{2 * attn_macs / 1e12:.2f} TFLOP in float32 products); {rep['tokens']} greedy tokens "
          f"({ENCDEC_NEW} each) in {rep['wall_s']:.3f} s, {rep['tokens'] / rep['wall_s']:.1f} tok/s; row 0 "
          f"starts {rep['first']}", flush=True)
    print(f"{label} decode step with {ENCDEC_BATCH} rows ({len(rep['steps'])} steps): device {dev:.3f} ms (CUDA "
          f"events, median), host {host:.3f} ms to issue it, its kernels {kern}; bound {bound_ms:.3f} ms "
          f"({read / 1e9:.3f} GB of decoder weights but the cross wk / wv, and the unembedding + {cross / 1e9:.3f} "
          f"GB of cross K/V + "
          f"{live / 1e9:.4f} GB of live self K/V at {cm.HBM_BW / 1e12:.2f} TB/s)", flush=True)
    for name, count, ms in top:
        print(f"  decode step kernel {name}: {count} launches, {ms:.3f} ms", flush=True)
    print(f"{label} peak memory {peak:.2f} GiB (limit {LM_PEAK_LIMIT_GIB}); FFT kernel launches {launches}",
          flush=True)
    check(peak <= LM_PEAK_LIMIT_GIB, f"{label} peak memory {peak:.2f} GiB > {LM_PEAK_LIMIT_GIB}")
    del model, params, rep
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def ulp_perturbed(torch, params, seed: int):
    """A copy of float32 ``params`` with every value moved by one float32
    ulp (2^-24 relative), up or down at random: the one-rank model's
    outputs on it are a float32 floor -- how far a one-ulp change at every
    product, as reordered sums make, moves this model."""
    g = torch.Generator(device=params["embed"]["table"].device)
    g.manual_seed(seed + 9)

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if not t.is_floating_point():
            return t
        return t * (1 + (torch.randint(0, 2, t.shape, device=t.device, generator=g).to(t.dtype) * 2 - 1) * 2.0 ** -24)

    return move(params)


def rank_view(p: int):
    """One rank's view of a ``p``-rank group on this card (a SimMesh that
    holds its blocks): a Model on it makes one rank's state shapes."""
    from repro_torch.core import SimMesh

    class RankView(SimMesh):
        caller_holds_block = True

    return RankView(p)


def state_bytes(state) -> int:
    """The bytes of every tensor of a decode state."""
    return sum(t.numel() * t.element_size() for k, v in state.items() if k != "pos" for t in lm_leaves(v))


def ssm_mesh_width_check(torch, seed, arch: str) -> None:
    """Check 3 of phase 19, float32: ``arch`` at full width and
    SSM_F32_LAYERS' depth (TF32 off), on one rank and on
    Model(cfg, SimMesh(TP_P)) on the same weights: logits of
    SSM_F32_SEQ tokens, their prefill and TP_DECODE decode steps within
    SSM_F32_REL_TOL, the one-rank model with every weight moved one ulp
    (``ulp_perturbed``) printed beside: the recurrences carry any
    reordered float32 sum, as every psum makes, past TP_REL_TOL over 300
    tokens at xLSTM's width."""
    from repro_torch.core import SimMesh
    from repro_torch.models.model import Model

    label = f"SSM SimMesh({TP_P}) {arch}"
    model = Model(ssm_cfg(arch, SSM_F32_LAYERS[arch], "float32"))
    cfg, n = model.cfg, SSM_F32_SEQ[arch]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = model.init(g)
    toks = torch.randint(0, cfg.vocab_size, (1, n + TP_DECODE), device="cuda", generator=g)
    one = tp_runs(torch, model, params, toks, n, logits=True)
    floor = max(lm_rel_err(a, b) for a, b in zip(tp_runs(torch, model, ulp_perturbed(torch, params, seed), toks, n,
                                                         logits=True), one))
    errs = [lm_rel_err(a, b) for a, b in zip(tp_runs(torch, Model(cfg, SimMesh(TP_P)), params, toks, n, logits=True),
                                             one)]
    print(f"{label} full width, {cfg.num_layers} layers, float32 (float32 state and cache): vs the one-rank model on "
          f"the same weights, rel_err logits ({n} tokens) {errs[0]:.3e}, prefill {errs[1]:.3e}, {TP_DECODE} decode "
          f"steps {', '.join(f'{e:.3e}' for e in errs[2:])} (tol {SSM_F32_REL_TOL}; within {TP_REL_TOL}: "
          f"{max(errs) <= TP_REL_TOL}); the one-rank model itself with every weight moved one ulp: {floor:.3e}",
          flush=True)
    check(max(errs) <= SSM_F32_REL_TOL, f"{label}: {max(errs):.3e} > {SSM_F32_REL_TOL}")
    del model, params, one
    gc.collect()
    torch.cuda.empty_cache()


def ssm_mesh_serving(torch, seed, arch: str) -> None:
    """Check 3 of phase 19 at full depth in bfloat16: ``arch`` on one rank
    and on Model(cfg, SimMesh(TP_P)) on the same weights: a prefill of
    SSM_TP_BATCH prompts of SSM_TP_PREFILL tokens (CUDA events, after one
    untimed run), then SSM_TP_DECODE greedy decode steps of all of them
    (device ms, median); the share of greedy tokens equal to one rank's,
    and the decode state one rank of a TP_P-rank group holds."""
    from repro_torch.core import SimMesh
    from repro_torch.models.model import Model

    label = f"SSM SimMesh({TP_P}) {arch}"
    cfg, b, n = ssm_cfg(arch), SSM_TP_BATCH, SSM_TP_PREFILL
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 8)
    one = Model(cfg)
    params, _ = one.init(g, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (b, n), device="cuda", generator=g)
    out = {}
    for name, model in (("one rank", one), (f"SimMesh({TP_P})", Model(cfg, SimMesh(TP_P)))):
        def prefill():
            return model.prefill(params, {"tokens": toks}, model.init_decode_state(b, n + SSM_TP_DECODE))

        prefill()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, lg = prefill()
        end.record()
        end.synchronize()
        steps, picked = [], [torch.argmax(lg, -1)]
        for _ in range(SSM_TP_DECODE):
            s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s0.record()
            lg, state = model.decode_step(params, picked[-1][:, None], state)
            s1.record()
            picked.append(torch.argmax(lg, -1))
            steps.append((s0, s1))
        torch.cuda.synchronize()
        out[name] = dict(prefill=start.elapsed_time(end), decode=statistics.median(a.elapsed_time(e) for a, e in steps),
                         toks=torch.stack(picked, 1), state=state_bytes(state))
        del state
        gc.collect()
        torch.cuda.empty_cache()
    rank = state_bytes(Model(cfg, rank_view(TP_P)).init_decode_state(b, n + SSM_TP_DECODE))
    a, c = out["one rank"]["toks"], out[f"SimMesh({TP_P})"]["toks"]
    print(f"{label} {cfg.num_layers} layers bfloat16, {b} prompts of {n} tokens: prefill (CUDA events) "
          + ", ".join(f"{k} {v['prefill']:.1f} ms" for k, v in out.items()) + f"; decode step of {b} rows (median "
          f"of {SSM_TP_DECODE}) " + ", ".join(f"{k} {v['decode']:.2f} ms" for k, v in out.items())
          + f"; greedy tokens equal to one rank's {int((a == c).sum())} of {a.numel()}; decode state "
          f"{out['one rank']['state'] / 2**30:.3f} GiB on one rank, {rank / 2**30:.3f} GiB a rank of a {TP_P}-rank "
          f"group", flush=True)
    del one, params, out
    gc.collect()
    torch.cuda.empty_cache()


def encdec_mesh_phase(torch, seed, fft_stage, cm) -> dict:
    """Phase 19: the encoder-decoder and the SSM and hybrid models over a
    mesh, one card: whisper-medium's checks 1 and 2, then xLSTM-1.3B and
    Hymba-1.5B on SimMesh(TP_P) (check 3). Returns the FFT kernels'
    launches (0) of check 2 and of check 3's serving."""
    t0 = time.perf_counter()
    encdec_width_checks(torch, seed)
    by_path = {"encdec_serving": encdec_full_depth(torch, seed, cm, fft_stage)}
    for arch in SSM_ARCHS:
        ssm_mesh_width_check(torch, seed, arch)
    _, by_path["ssm_mesh_serving"], _ = counted(
        torch, fft_stage, "SSM SimMesh serving", lambda: [ssm_mesh_serving(torch, seed, a) for a in SSM_ARCHS],
        expect=())
    print(f"encoder-decoder and SSM mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


def train_grads(torch, fn, inputs):
    """The gradients of ``fn(*inputs)`` (a scalar) with respect to
    ``inputs``, recorded on fresh leaves."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*leaves), leaves)


def worst_rel(torch, got, exp) -> float:
    """The largest of each pair's error relative to its largest entry."""
    return max(((g.float() - e.float()).abs().max() / e.float().abs().max().clamp_min(1e-30)).item()
               for g, e in zip(got, exp))


def train_flash_checks(torch, g) -> list:
    """Check 1 of phase 20, attention: the flash backward (chunked) against
    autograd through attention_naive, float32, at three archs' heads."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.blocks import _attn_spec

    gem, hym = get_config("gemma2-9b"), get_config(TRAIN_ARCH)
    cases = [("Qwen2.5-32B", 40, 8, 128, TRAIN_FLASH_SEQ, A.AttnSpec()),
             ("Gemma2-9B softcap 50", gem.num_heads, gem.num_kv_heads, gem.head_dim_, TRAIN_FLASH_SEQ,
              A.AttnSpec(softcap=gem.attn_logit_softcap)),
             (f"Hymba-1.5B window {hym.window_size} + {hym.meta_tokens} prefix", hym.num_heads, hym.num_kv_heads,
              hym.head_dim_, TRAIN_HYMBA_POSITIONS, _attn_spec(hym, is_global=False))]
    out = []
    for label, h, kvh, hd, s, spec in cases:
        q = torch.randn((1, s, h, hd), device="cuda", generator=g)
        k = torch.randn((1, s, kvh, hd), device="cuda", generator=g)
        v = torch.randn((1, s, kvh, hd), device="cuda", generator=g)
        w = torch.randn((1, s, h, hd), device="cuda", generator=g)
        got = train_grads(torch, lambda q, k, v: (A.attention(q, k, v, spec, impl="chunked") * w).sum(), (q, k, v))
        exp = train_grads(torch, lambda q, k, v: (A.attention_naive(q, k, v, spec) * w).sum(), (q, k, v))
        err = worst_rel(torch, got, exp)
        print(f"training check 1: flash backward {label} ({h} / {kvh} heads of {hd}, {s} positions, kv chunk 512), "
              f"float32: dq, dk, dv vs autograd through attention_naive, worst rel_err {err:.3e} "
              f"(tol {TRAIN_REL_TOL})", flush=True)
        check(err <= TRAIN_REL_TOL, f"training: flash backward {label} {err:.3e} > {TRAIN_REL_TOL}")
        out.append((label, err))
        del q, k, v, w, got, exp
    return out


def sequential_mamba(torch, xc, dt, bmat, cmat, a, dskip, h0, *, chunk=None):
    """The selective scan one step at a time, no in-place write: the plain
    version autograd differentiates (``chunk`` ignored)."""
    ys, h = [], h0
    for t in range(xc.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * xc[:, t])[..., None] * bmat[:, t, None, :]
        ys.append((h * cmat[:, t, None, :]).sum(-1) + dskip * xc[:, t])
    return torch.stack(ys, 1), h


def train_mamba_check(torch, g) -> float:
    """Check 1 of phase 20, Mamba: the manual backward against autograd
    through the sequential scan, float32, at Hymba's d_inner and state."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S

    cfg = get_config(TRAIN_ARCH)
    b, s, di, n = TRAIN_MAMBA_BATCH, TRAIN_MAMBA_SEQ, int(cfg.ssm.expand * cfg.d_model), cfg.ssm.state_dim
    xc = torch.randn((b, s, di), device="cuda", generator=g)
    dt = torch.rand((b, s, di), device="cuda", generator=g) * 0.1
    bm, cm = (torch.randn((b, s, n), device="cuda", generator=g) for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").expand(di, n).contiguous()
    dskip = torch.ones((di,), device="cuda")
    h0 = torch.randn((b, di, n), device="cuda", generator=g) * 0.1
    wy, wh = torch.randn((b, s, di), device="cuda", generator=g), torch.randn((b, di, n), device="cuda", generator=g)

    def loss(core):
        def f(*xs):
            y, hl = core(*xs, chunk=cfg.ssm.chunk)
            return (y * wy).sum() + (hl * wh).sum()
        return f

    inputs = (xc, dt, bm, cm, a, dskip, h0)
    got = train_grads(torch, loss(S.mamba_core), inputs)
    exp = train_grads(torch, loss(lambda *xs, chunk: sequential_mamba(torch, *xs)), inputs)
    err = worst_rel(torch, got, exp)
    print(f"training check 1: Mamba backward (d_inner {di}, state {n}, {b} x {s} tokens, chunk {cfg.ssm.chunk}), "
          f"float32: the 7 cotangents vs autograd through the sequential scan, worst rel_err {err:.3e} "
          f"(tol {TRAIN_REL_TOL})", flush=True)
    check(err <= TRAIN_REL_TOL, f"training: Mamba backward {err:.3e} > {TRAIN_REL_TOL}")
    return err


def train_model_check(torch, seed) -> float:
    """Check 1 of phase 20, the model: Hymba-1.5B at full width and
    TRAIN_F32_LAYERS layers (layer 1 windowed), float32: the gradient of
    every leaf of Model.loss through the custom backward passes against
    the same weights with attn_impl="naive" and the sequential scan; then
    the same gradients with bf16 compute against the float32 ones
    (TRAIN_BF16_TOL), the step's dtype held to a float32 oracle."""
    from repro_torch.models import ssm as S
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves, unflatten

    model = Model(ssm_cfg(TRAIN_ARCH, TRAIN_F32_LAYERS, "float32"))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = model.init(g)
    toks = torch.randint(0, model.cfg.vocab_size, (1, TRAIN_F32_SEQ + 1), device="cuda", generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = leaves(params)

    def grads(m):
        return train_grads(torch, lambda *ps: m.loss(unflatten(params, list(ps)), batch)[0], flat)

    got = grads(model)
    fused = S.mamba_core
    S.mamba_core = lambda *xs, chunk: sequential_mamba(torch, *xs)
    try:
        exp = grads(Model(model.cfg, attn_impl="naive"))
    finally:
        S.mamba_core = fused
    errs = [((a - e).abs().max() / e.abs().max().clamp_min(1e-30)).item() for a, e in zip(got, exp)
            if e.abs().max() > 0]
    err = max(errs)
    layers = [model._flag(grp, i) for grp in model.groups for i in range(grp.count)]
    print(f"training check 1: Hymba-1.5B full width, {TRAIN_F32_LAYERS} layers global {layers} (window "
          f"{model.cfg.window_size}, {model.cfg.meta_tokens} meta tokens), float32, {TRAIN_F32_SEQ} tokens: every "
          f"leaf's gradient of Model.loss ({len(flat)} leaves) vs attn_impl='naive' + the sequential scan, worst "
          f"rel_err {err:.3e} (tol {TRAIN_REL_TOL}; median {statistics.median(errs):.3e})", flush=True)
    check(err <= TRAIN_REL_TOL, f"training: Hymba-1.5B gradients {err:.3e} > {TRAIN_REL_TOL}")
    del exp
    bf16 = grads(Model(ssm_cfg(TRAIN_ARCH, TRAIN_F32_LAYERS, "bfloat16")))
    norm_errs = [((b - a).norm() / a.norm().clamp_min(1e-30)).item() for b, a in zip(bf16, got) if a.norm() > 0]
    finite = all(bool(torch.isfinite(b).all()) for b in bf16)
    bf_err = max(norm_errs) if finite else math.inf
    print(f"training check 1: the same {len(flat)} leaves' gradients with bf16 compute (float32 master weights) vs "
          f"float32: worst ||bf16 - f32|| / ||f32|| {bf_err:.3e} (tol {TRAIN_BF16_TOL}; median "
          f"{statistics.median(norm_errs):.3e})", flush=True)
    check(bf_err <= TRAIN_BF16_TOL, f"training: Hymba-1.5B bf16 gradients {bf_err:.3e} from float32 > {TRAIN_BF16_TOL}")
    del model, params, got, bf16
    return err


def train_layer_ms(torch, g, cfg) -> dict:
    """One layer's flash and Mamba forward and custom backward at the
    step's shapes, bf16 inputs as the step gives them (CUDA events, median
    of 3)."""
    from repro_torch.models import attention as A
    from repro_torch.models import ssm as S
    from repro_torch.models.blocks import _attn_spec

    b, s = TRAIN_BATCH, TRAIN_SEQ + cfg.meta_tokens
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    spec = _attn_spec(cfg, is_global=False)
    q, k, v = (torch.randn((b, s, n, hd), device="cuda", generator=g, dtype=torch.bfloat16).requires_grad_()
               for n in (h, kvh, kvh))
    out = {}
    with torch.no_grad():
        out["flash fwd"] = events_ms(torch, lambda: A.attention(q, k, v, spec, impl="chunked"), reps=3)
    with torch.enable_grad():
        o = A.attention(q, k, v, spec, impl="chunked")
    do = torch.randn_like(o)
    out["flash bwd"] = events_ms(torch, lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True), reps=3)
    del q, k, v, o, do
    di, n = int(cfg.ssm.expand * cfg.d_model), cfg.ssm.state_dim
    s = -(-s // cfg.ssm.chunk) * cfg.ssm.chunk  # apply_mamba pads to whole chunks
    xs = [torch.randn((b, s, di), device="cuda", generator=g), torch.rand((b, s, di), device="cuda", generator=g) * 0.1,
          torch.randn((b, s, n), device="cuda", generator=g), torch.randn((b, s, n), device="cuda", generator=g),
          -torch.ones((di, n), device="cuda", dtype=torch.bfloat16), torch.ones((di,), device="cuda", dtype=torch.bfloat16),
          torch.zeros((b, di, n), device="cuda")]
    xs = [x.requires_grad_() for x in xs]
    with torch.no_grad():
        out["Mamba fwd"] = events_ms(torch, lambda: S.mamba_core(*xs, chunk=cfg.ssm.chunk), reps=3)
    with torch.enable_grad():
        y, _ = S.mamba_core(*xs, chunk=cfg.ssm.chunk)
    dy = torch.randn_like(y)
    out["Mamba bwd"] = events_ms(torch, lambda: torch.autograd.grad(y, xs, dy, retain_graph=True), reps=3)
    return out


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dry_run_cell(cfg, kind: str, seq: int, batch: int, mesh=None, tcfg=None):
    """(the argument bytes a rank by name, the report) of
    ``launch.dryrun`` for ``cfg`` at ``batch`` x ``seq`` of ``kind`` on
    ``mesh`` (default one rank, ``MeshShape((1, 1))``)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    shape = ShapeConfig(kind, seq, batch, kind)
    mesh = MeshShape((1, 1), ("data", "model")) if mesh is None else mesh
    tcfg = dryrun.PRODUCTION_TCFG if tcfg is None else tcfg
    return dryrun.arguments(cfg, shape, mesh, tcfg), dryrun.cell_report(cfg, shape, mesh, tcfg=tcfg)


_CARD = []


def card() -> str:
    """The card's name and power limit (nvidia-smi), read once."""
    if not _CARD:
        _CARD.append(nvidia_smi())
    return _CARD[0]


def walk_activation(cfg, kind: str, seq: int, batch: int, mesh, tcfg=None, one_process: bool = False) -> dict:
    """``launch.dryrun``'s ``activation`` entry (counts and assembled
    bytes by kind) of ``cfg`` at ``batch`` x ``seq`` of ``kind`` on
    ``mesh`` (``one_process``: what a SimMesh's one process issues)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    tcfg = dryrun.PRODUCTION_TCFG if tcfg is None else tcfg
    return dryrun.collectives(cfg, ShapeConfig(kind, seq, batch, kind), mesh, tcfg, one_process)["activation"]


def check_counted(label: str, walk: dict, counted: dict) -> None:
    """The activation collectives ``core.mesh.collectives`` counted in a run
    against the walk's prediction for it, counts and bytes of each kind,
    exactly; one line either way."""
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    same = (walk["counts"], walk["bytes"]) == (counted["counts"], counted["bytes"])
    print(f"{label}: activation collectives counted {nz(counted['counts'])} calls, {nz(counted['bytes'])} B "
          f"assembled; the dry run's walk predicted {nz(walk['counts'])} calls, {nz(walk['bytes'])} B -- "
          f"{'equal' if same else 'DIFFERENT'} ({card()})", flush=True)
    check(same, f"{label}: counted {counted} activation collectives, the walk predicts {walk}")


def state_bytes_of(args: dict, prefixes=("params/", "opt/", "step")) -> int:
    """The bytes of the arguments whose names start with ``prefixes``."""
    return sum(v for k, v in args.items() if k.startswith(prefixes))


def dry_run_train_check(cfg, tcfg, counted: int, init_alloc: int, peak_bytes: float, flops: int,
                        label: str) -> None:
    """Phase 20's check 2, the dry run's side: ``launch.dryrun`` for the
    step's cell on one rank predicts the state's bytes exactly (the
    check's own sum of numel x element_size, count and step included),
    within DRYRUN_ALLOC_TOL of what init_train_state allocated; its
    executed half (the step traced on the meta device) predicts the
    step's peak within DRYRUN_PEAK_TOL of ``peak_bytes`` (the steps'
    max_memory_allocated) and the FLOPs ``FlopCounterMode`` counted in one
    real step (``flops``) exactly."""
    args, rep = dry_run_cell(cfg, "train", TRAIN_SEQ, TRAIN_BATCH, tcfg=tcfg)
    predicted = state_bytes_of(args)
    mem, ex = rep["memory"], rep["executed"]
    rel = abs(init_alloc - predicted) / predicted
    prel = (mem["peak_device_bytes"] - peak_bytes) / peak_bytes
    print(f"{label} dry run (launch.dryrun.cell_report, one rank, MeshShape((1, 1))): state {predicted} B predicted, "
          f"{counted} B counted (numel x element_size), {init_alloc} B allocated by init_train_state "
          f"(torch.cuda.memory_allocated delta; rel diff {rel:.2e}, tol {DRYRUN_ALLOC_TOL}); executed half traced "
          f"in {rep['trace_s']:.1f} s ({ex['traces']} traces on the meta device): peak {mem['peak_device_bytes']} B "
          f"({mem['peak_device_bytes'] / 2**30:.2f} GiB = arguments + temporaries {mem['temp_bytes'] / 2**30:.2f} "
          f"GiB + outputs - aliases; floor {mem['floor_bytes'] / 2**30:.2f} GiB) against the measured "
          f"{peak_bytes:.0f} B ({peak_bytes / 2**30:.2f} GiB, max_memory_allocated over the steps; rel diff "
          f"{prel:+.2e}, tol {DRYRUN_PEAK_TOL}); FLOPs {ex['flops']} predicted, {flops} counted by FlopCounterMode "
          f"over one step ({'equal' if ex['flops'] == flops else 'DIFFERENT'}); HBM bytes as moved "
          f"{ex['hbm_bytes'] / 1e12:.3f} TB; roofline bottleneck {rep['roofline']['bottleneck']} ({card()})",
          flush=True)
    check(predicted == counted, f"{label}: the dry run predicts {predicted} B of state, the state holds {counted} B")
    check(rel <= DRYRUN_ALLOC_TOL, f"{label}: init_train_state allocated {init_alloc} B, the dry run predicts "
          f"{predicted} B")
    check(abs(prel) <= DRYRUN_PEAK_TOL, f"{label}: the dry run's peak {mem['peak_device_bytes']} B is "
          f"{prel:+.2%} from the measured {peak_bytes:.0f} B")
    check(ex["flops"] == flops, f"{label}: the dry run predicts {ex['flops']} FLOPs, FlopCounterMode counted {flops}")


def flop_counted_step(torch, step, state, batch) -> int:
    """The FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts in one
    real step (the dry run's rule: its registry's matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    torch.cuda.synchronize()
    return fc.get_total_flops()


def train_full_depth(torch, seed, cm) -> dict:
    """Check 2 of phase 20: Hymba-1.5B whole (32 layers, full width),
    float32 master weights and AdamW state, bf16 compute, remat full,
    TRAIN_STEPS of make_train_step over SyntheticLM at TRAIN_SEQ."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
    from repro_torch.launch.dryrun import train_model_flops
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_train_state, make_train_step

    cfg = ssm_cfg(TRAIN_ARCH)
    label = f"training {TRAIN_ARCH}"
    lm_check_free(torch, f"{label} before the full-depth state", 16 * 1.97e9 + LM_HEADROOM_GIB * 2**30)
    model = Model(cfg)
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 5), total_steps=TRAIN_STEPS,
                       seed=seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    t0 = time.perf_counter()
    alloc0 = torch.cuda.memory_allocated()
    state, _ = init_train_state(model, g, tcfg)
    torch.cuda.synchronize()
    init_alloc = torch.cuda.memory_allocated() - alloc0
    init_s = time.perf_counter() - t0
    flat = leaves(state.params)
    n_all = sum(p.numel() for p in flat)
    state_gb = sum(p.numel() * p.element_size() for p in flat + leaves(state.opt.mu) + leaves(state.opt.nu)) / 1e9
    state_bytes = tensor_bytes(flat + leaves(state.opt.mu) + leaves(state.opt.nu) + [state.opt.count, state.step])
    cast_gb = sum(p.numel() * 2 for p in flat) / 1e9
    ds = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed))
    step = make_train_step(model, tcfg)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, device_ms, host_ms_, wall_ms = [], [], [], [], []
    for s in range(TRAIN_STEPS):
        batch = make_batch_arrays(ds.batch_at(s))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, batch)
        end.record()
        host_ms_.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 2**30
    step_flops = flop_counted_step(torch, step, state, make_batch_arrays(ds.batch_at(TRAIN_STEPS)))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dev, host = statistics.median(device_ms[2:]), statistics.median(host_ms_[2:])
    n_model = n_all - state.params["embed"]["table"].numel()
    flops = train_model_flops(cfg, n_model, tokens, TRAIN_SEQ + cfg.meta_tokens, TRAIN_BATCH)
    share = flops / (dev / 1e3) / cm.PEAK_FLOPS_BF16
    print(f"{label} whole: {cfg.num_layers} layers, full width, {n_all / 1e9:.3f} B params (leaves), float32 master "
          f"weights + AdamW moments {state_gb:.2f} GB + float32 gradients {state_gb / 3:.2f} GB (+ {cast_gb:.2f} GB of "
          f"bf16 weights cast each step), bf16 compute, "
          f"remat {cfg.remat}; SyntheticLM {TRAIN_BATCH} x {TRAIN_SEQ} tokens ({TRAIN_SEQ + cfg.meta_tokens} positions "
          f"with the meta tokens), lr {TRAIN_LR} warmup {tcfg.warmup_steps}; init {init_s:.1f} s", flush=True)
    print(f"{label} losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms {', '.join(f'{x:.3f}' for x in gnorms)}",
          flush=True)
    print(f"{label} step (median of steps 3-{TRAIN_STEPS}): device {dev:.1f} ms (CUDA events), host {host:.1f} ms to "
          f"issue, wall {statistics.median(wall_ms[2:]):.1f} ms; first two steps device "
          f"{', '.join(f'{x:.1f}' for x in device_ms[:2])} ms; {tokens / (dev / 1e3):.0f} tokens/s; model FLOPs "
          f"{flops / 1e12:.2f} T a step (6 N tokens, N {n_model / 1e9:.3f} B without the embedding table, + attention "
          f"products; remat's recompute not counted) = {100 * share:.2f} % of the bf16 dense peak "
          f"({cm.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s); peak memory {peak:.2f} GiB (limit {LM_PEAK_LIMIT_GIB}; weights, "
          f"moments and gradients {4 * state_gb / 3 / 1.073741824:.2f} GiB + cast weights {cast_gb / 1.073741824:.2f} "
          f"GiB)", flush=True)
    check(all(math.isfinite(x) for x in losses + gnorms), f"{label}: a loss or gradient norm is not finite")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    check(last < first, f"{label}: the loss did not fall ({first:.4f} -> {last:.4f} over the first / last three steps)")
    check(peak < LM_PEAK_LIMIT_GIB, f"{label}: peak memory {peak:.2f} GiB >= {LM_PEAK_LIMIT_GIB}")
    dry_run_train_check(cfg, tcfg, state_bytes, init_alloc, peak_bytes, step_flops, label)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    ms = train_layer_ms(torch, g, cfg)
    share = {k: 100 * v * cfg.num_layers / dev for k, v in ms.items()}
    print(f"{label} one layer at the step's shapes, bf16 (CUDA events, median of 3): "
          + ", ".join(f"{k} {v:.2f} ms ({share[k]:.1f} % of the step x {cfg.num_layers} layers)" for k, v in ms.items())
          + f"; under remat each forward runs twice: flash {share['flash fwd'] * 2 + share['flash bwd']:.1f} %, "
          f"Mamba {share['Mamba fwd'] * 2 + share['Mamba bwd']:.1f} % of the step", flush=True)
    return dict(device_ms=dev, host_ms=host, tokens_s=tokens / (dev / 1e3), share=share, peak_gib=peak,
                losses=losses)


def train_launcher(torch) -> None:
    """Check 3 of phase 20: launch/train.py's train(args) in-process on the
    card, reduced, checkpoints every 4 steps, a failure injected at 6."""
    from repro_torch.launch.train import build_argparser, train

    with tempfile.TemporaryDirectory() as tmp:
        args = build_argparser().parse_args(TRAIN_LAUNCH_ARGS + ["--ckpt-dir", tmp])
        t0 = time.perf_counter()
        hist = train(args)
    losses = hist["loss"]
    print(f"training launcher {' '.join(TRAIN_LAUNCH_ARGS)}: restarts {hist['restarts']}, {len(losses)} losses "
          f"({losses[0]:.4f} -> {losses[-1]:.4f}), {time.perf_counter() - t0:.1f} s", flush=True)
    check(hist["restarts"] == 1 and len(losses) >= 12 and all(math.isfinite(x) for x in losses),
          f"training launcher: restarts {hist['restarts']}, losses {losses}")


def leaf_errs(torch, got, exp) -> list:
    """Each leaf's largest error relative to its largest expected entry
    (a leaf whose expected gradient is zero: its largest entry got)."""
    return [((a.float() - e.float()).abs().max() / e.float().abs().max()).item() if e.abs().max() > 0
            else a.abs().max().item() for a, e in zip(got, exp)]


def train_tp_grads(torch, seed, cfg, seq: int, label: str) -> float:
    """Check 4 of phase 20, one model: the gradient of every leaf of
    Model.loss on SimMesh((1, TRAIN_TP_P)) against one rank's on the same
    weights and ``seq`` tokens, float32, each within TRAIN_REL_TOL of the
    leaf's largest one-rank entry."""
    from repro_torch.core import SimMesh
    from repro_torch.models import attention as A
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves, unflatten

    one = Model(cfg)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params, _ = one.init(g)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda", generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = leaves(params)

    def grads(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_grads(torch, lambda *ps: m.loss(unflatten(params, list(ps)), batch)[0], flat)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    grads(one)  # warm: the first call of a phase's shapes pays its setup
    exp, one_s = grads(one)
    split = Model(cfg, SimMesh((1, TRAIN_TP_P), axis_names=("data", "model")))
    got, split_s = grads(split)
    errs = leaf_errs(torch, got, exp)
    err = max(errs)
    tp = split.tp
    print(f"training check 4: {label} full width, {cfg.num_layers} layers, float32, {seq} tokens, on "
          f"SimMesh((1, {TRAIN_TP_P})) (heads split {tp.splits(cfg.num_heads)}, context partition "
          f"{A.use_context_parallel(cfg, tp)}, d_ff split {tp.splits(cfg.d_ff)}, vocabulary {cfg.vocab_size} split "
          f"{tp.splits(cfg.vocab_size)}, sequence parallel {split.seq_parallel(seq + cfg.meta_tokens)}): every leaf's "
          f"gradient ({len(flat)} leaves, {sum(p.numel() for p in flat) / 1e9:.3f} B) vs one rank, worst rel_err "
          f"{err:.3e} (tol {TRAIN_REL_TOL}; median {statistics.median(errs):.3e}); loss + backward {one_s:.2f} s one "
          f"rank, {split_s:.2f} s split", flush=True)
    check(err <= TRAIN_REL_TOL, f"training: {label} split gradients {err:.3e} > {TRAIN_REL_TOL}")
    del params, exp, got, flat
    return err


def train_tp_steps(torch, seed) -> dict:
    """Check 5 of phase 20: TRAIN_TP_STEPS steps of check 1's 4-layer
    Hymba-1.5B (float32 master weights, bf16 compute) on
    SimMesh((1, TRAIN_TP_P)) beside one rank from the same seed and
    batches: each step's device ms (CUDA events), host ms to issue it,
    the peak memory, the losses (finite)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import SimMesh
    from repro_torch.core.mesh import collectives, reset_collectives
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
    from repro_torch.models.model import Model
    from repro_torch.train import init_train_state, make_train_step

    cfg = ssm_cfg(TRAIN_ARCH, TRAIN_F32_LAYERS)
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_TP_STEPS, seed=seed)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_TP_STEP_SEQ, TRAIN_TP_BATCH, seed=seed))
    out = {}
    for label, mesh in (("one rank", None),
                        (f"SimMesh((1, {TRAIN_TP_P}))", SimMesh((1, TRAIN_TP_P), axis_names=("data", "model")))):
        model = Model(cfg, mesh)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        state, _ = init_train_state(model, g, tcfg)
        step = make_train_step(model, tcfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev, host, losses = [], [], []
        for s in range(TRAIN_TP_STEPS):
            batch = make_batch_arrays(ds.batch_at(s))
            torch.cuda.synchronize()
            reset_collectives()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, m = step(state, batch)
            end.record()
            host.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            dev.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
        out[label] = dict(device_ms=dev, host_ms=host, losses=losses,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"training check 5: {TRAIN_ARCH} full width, {cfg.num_layers} layers, bf16 compute, "
              f"{TRAIN_TP_BATCH} x {TRAIN_TP_STEP_SEQ} tokens, {label}: step device ms "
              f"{', '.join(f'{x:.1f}' for x in dev)} (CUDA events), host ms to issue "
              f"{', '.join(f'{x:.1f}' for x in host)}; losses {', '.join(f'{x:.4f}' for x in losses)}; peak memory "
              f"{out[label]['peak_gib']:.2f} GiB", flush=True)
        check(all(math.isfinite(x) for x in losses), f"training: a {label} bf16 loss is not finite")
        if mesh is not None:  # the last step's collectives, one rank's share, against the walk
            check_counted(f"training check 5: {TRAIN_ARCH} {cfg.num_layers} layers {label}, one step",
                          walk_activation(cfg, "train", TRAIN_TP_STEP_SEQ, TRAIN_TP_BATCH, mesh, tcfg, one_process=True),
                          collectives("activation"))
        del state, step, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_state_target(torch, cfg, mesh=None):
    """A ``TrainState`` of ``cfg``'s shapes on the meta device -- cut to
    this process's blocks on ``mesh``, where given -- to restore a
    checkpoint into (no weight is drawn)."""
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState, place_train_state

    shapes, specs = Model(cfg, device="meta").init(torch.Generator())
    zero = torch.zeros((), dtype=torch.int32, device="meta")
    state = TrainState(shapes, adamw.AdamWState(zero, shapes, shapes), zero)
    return state if mesh is None else place_train_state(state, mesh=mesh, specs=specs, cfg=cfg)


def same_state(torch, a, b) -> bool:
    """Whether two ``TrainState``s hold the same bits, leaf for leaf."""
    from repro_torch.optim.adamw import leaves

    x, y = (leaves({"p": st.params, "m": st.opt.mu, "v": st.opt.nu}) for st in (a, b))
    return (len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))
            and int(a.opt.count) == int(b.opt.count) and int(a.step) == int(b.step))


def placed_ckpt_rank(rank: int, world: int, init_method: str, ckpt: str, out_dir: str) -> None:
    """Check 6a's placed checkpoint, one gloo rank on the host's CPU: its
    blocks on a (2, 2) ('data', 'model') grid, restored from the
    launcher's checkpoint of whole leaves (``ckpt``), written with the
    other ranks' as one placed checkpoint (``ckpt``-placed: each rank its
    proc<k>.npz, rank 0's manifest last)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import init_process_mesh
    from repro_torch.models.model import Model

    torch.set_num_threads(2)
    mesh = init_process_mesh(rank, world, init_method, device="cpu", grid=(2, 2), axis_names=("data", "model"),
                             timeout_s=NCCL_TIMEOUT_S)
    try:
        cfg = ssm_cfg(TRAIN_ARCH, TRAIN_PG_LAYERS)
        t0 = time.perf_counter()
        layout = Model(cfg, mesh, device="cpu").state_layout()
        step, state = CheckpointManager(ckpt).restore_latest(train_state_target(torch, cfg, mesh), device="cpu",
                                                             layout=layout)
        t1 = time.perf_counter()
        mgr = CheckpointManager(f"{ckpt}-placed", mesh=mesh)
        mgr.save(step, state, layout=layout)
        mgr.wait()
        rep = dict(rank=rank, step=step, cut=sum(cuts is not None for _, cuts in layout.values()),
                   restore_s=t1 - t0, write_s=time.perf_counter() - t1)
        with open(os.path.join(out_dir, f"placed{rank}.json"), "w") as fh:
            json.dump(rep, fh)
    finally:
        dist.destroy_process_group()


def train_pg_launcher(torch, tmp: str) -> dict:
    """Check 6a of phase 20: launch/train.py's train(args) over a
    torch.distributed world of this one process (as torchrun with one
    rank starts it: a ProcessGroupMesh of (1, 1), which cuts nothing),
    Hymba-1.5B at full width and TRAIN_PG_LAYERS layers, one checkpoint
    at the end; that state rewritten as the placed checkpoint of a (2, 2)
    grid by four gloo ranks on the host's CPU (``placed_ckpt_rank``), and
    restored from its four files onto one rank on the card (the layout of
    SimMesh((2, 2)) too), every leaf bitwise the launcher's. NCCL puts one
    rank on each card, so the FSDP step itself runs in phase 7 on four."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    import repro_torch.launch.train as launch_train
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import SimMesh, init_process_mesh
    from repro_torch.models.model import Model

    cfg = ssm_cfg(TRAIN_ARCH, TRAIN_PG_LAYERS)
    ck = os.path.join(tmp, "ckpt")
    args = launch_train.build_argparser().parse_args([
        "--arch", TRAIN_ARCH, "--steps", str(TRAIN_PG_STEPS), "--batch", str(TRAIN_PG_BATCH), "--seq",
        str(TRAIN_PG_SEQ), "--ckpt-every", str(TRAIN_PG_STEPS), "--lr", str(TRAIN_LR), "--ckpt-dir", ck])
    init_process_mesh(0, 1, f"file://{os.path.join(tmp, 'rendezvous')}", timeout_s=NCCL_TIMEOUT_S)
    get_config, launch_train.get_config = launch_train.get_config, lambda arch, reduced=False: cfg
    t0 = time.perf_counter()
    try:
        hist = launch_train.train(args)
    finally:
        launch_train.get_config = get_config
        dist.destroy_process_group()
    train_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    losses = hist["loss"]
    check(len(losses) == TRAIN_PG_STEPS and all(math.isfinite(x) for x in losses),
          f"training launcher over a process group: losses {losses}")
    t1 = time.perf_counter()  # the four ranks read and rewrite the checkpoint while this process restores it
    ranks = mp.spawn(placed_ckpt_rank, args=(4, f"file://{os.path.join(tmp, 'rendezvous-placed')}", ck, tmp),
                     nprocs=4, join=False)
    try:
        layout = Model(cfg, device="meta").state_layout()
        check(Model(cfg, SimMesh((2, 2), axis_names=("data", "model")), device="cuda").state_layout() == layout,
              "SimMesh((2, 2))'s state is not whole leaves")
        step, whole = CheckpointManager(ck).restore_latest(train_state_target(torch, cfg), device="cuda",
                                                           layout=layout)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(step == TRAIN_PG_STEPS, f"the launcher's checkpoint restored step {step}")
    finally:
        while not ranks.join():
            pass
    spawn_s = time.perf_counter() - t1
    reps = []
    for r in range(4):
        with open(os.path.join(tmp, f"placed{r}.json")) as fh:
            reps.append(json.load(fh))
    step_dir = os.path.join(f"{ck}-placed", f"step_{TRAIN_PG_STEPS:010d}")
    with open(os.path.join(step_dir, "manifest.json")) as fh:
        procs = json.load(fh).get("procs", {})
    check(sorted(os.listdir(step_dir)) == ["manifest.json"] + [f"proc{k}.npz" for k in range(4)]
          and sorted(procs) == [f"proc{k}" for k in range(4)],
          f"the placed checkpoint holds {sorted(os.listdir(step_dir))}, its manifest names {sorted(procs)}")
    check(all(r["step"] == TRAIN_PG_STEPS and r["cut"] > 0 for r in reps), f"the placed checkpoint's ranks: {reps}")
    t1 = time.perf_counter()
    step, placed = CheckpointManager(f"{ck}-placed").restore_latest(train_state_target(torch, cfg), device="cuda",
                                                                     layout=layout)
    torch.cuda.synchronize()
    placed_s = time.perf_counter() - t1
    check(step == TRAIN_PG_STEPS and same_state(torch, placed, whole),
          "the placed checkpoint restored onto one rank differs from the launcher's")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f"proc{k}.npz")) for k in range(4))
    del whole, placed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"training check 6a: launcher over a torch.distributed world of 1 rank ({TRAIN_ARCH} full width, "
          f"{cfg.num_layers} of {ssm_cfg(TRAIN_ARCH).num_layers} layers, {TRAIN_PG_STEPS} steps of {TRAIN_PG_BATCH} x {TRAIN_PG_SEQ}): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, {train_s:.1f} s with init and one checkpoint of whole leaves, "
          f"restored onto one rank in {restore_s:.1f} s; meanwhile four gloo ranks of a (2, 2) grid restored their "
          f"blocks of it ({reps[0]['cut']} of {len(layout)} leaves cut; {max(r['restore_s'] for r in reps):.1f} s) "
          f"and wrote them as a placed checkpoint ({nbytes / 1e9:.2f} GB in proc0-3.npz, {max(r['write_s'] for r in reps):.1f} "
          f"s; spawn {spawn_s:.1f} s in all); the placed checkpoint restored from its four files onto one rank (and "
          f"SimMesh((2, 2))'s layout) in {placed_s:.1f} s, every leaf bitwise equal", flush=True)
    return dict(losses=losses, train_s=train_s, restore_s=restore_s, spawn_s=spawn_s, placed_s=placed_s,
                gb=nbytes / 1e9)


def train_grid_step(torch, seed) -> dict:
    """Check 6b of phase 20: one make_train_step of check 1's Hymba-1.5B
    (full width, TRAIN_F32_LAYERS layers, float32) on SimMesh((2, 2)) --
    TP over model; the data axis holds the whole batch in one process, so
    no rows move between ranks -- with microbatch 2 and labels -1 in the
    first half of the positions of the first half of each microbatch's
    rows, against one rank's from the same seed: the first moments ((1 - b1) times the clipped gradient) within
    TRAIN_REL_TOL of each leaf's largest entry, the weights within
    TRAIN_REL_TOL plus Adam's amplification, loss and grad norm within
    TRAIN_REL_TOL."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import SimMesh
    from repro_torch.core.mesh import collectives, reset_collectives
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_train_state, make_train_step

    cfg = ssm_cfg(TRAIN_ARCH, TRAIN_F32_LAYERS, "float32")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=10, microbatch=2, seed=seed)
    batch = make_batch_arrays(SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_GRID_SEQ, TRAIN_GRID_BATCH, seed=seed))
                              .batch_at(0))
    rows = TRAIN_GRID_BATCH // 2
    for m in range(2):  # each microbatch's first half of its rows
        batch["labels"][m * rows:m * rows + rows // 2, : TRAIN_GRID_SEQ // 2] = -1
    out = {}
    for label, mesh in (("one rank", None), ("SimMesh((2, 2))", SimMesh((2, 2), axis_names=("data", "model")))):
        model = Model(cfg, mesh)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        state, _ = init_train_state(model, g, tcfg)
        torch.cuda.synchronize()
        reset_collectives()
        t0 = time.perf_counter()
        state, m = make_train_step(model, tcfg, mesh)(state, batch)
        torch.cuda.synchronize()
        if mesh is not None:  # one rank's share of the step's collectives against the walk on the same SimMesh
            check_counted(f"training check 6b: {TRAIN_ARCH} {cfg.num_layers} layers SimMesh((2, 2)), one step",
                          walk_activation(cfg, "train", TRAIN_GRID_SEQ, TRAIN_GRID_BATCH, mesh, tcfg, one_process=True),
                          collectives("activation"))
        out[label] = (leaves(state.opt.mu), leaves(state.params), {k: float(v) for k, v in m.items()},
                      (time.perf_counter() - t0) * 1e3)
        del state
    (one_mu, one_p, one_m, one_ms), (mu, p, m, ms) = out["one rank"], out["SimMesh((2, 2))"]
    grad_err = max(leaf_errs(torch, mu, one_mu))
    param_err = -math.inf
    for a, e, ge in zip(p, one_p, one_mu):
        noise = torch.nan_to_num(torch.clamp(TRAIN_REL_TOL * ge.abs().max() / ge.abs(), max=1.0), nan=1.0)
        param_err = max(param_err, ((a - e).abs() - TRAIN_REL_TOL * e.abs().max() - 2 * m["lr"] * noise).max().item())
    metric_err = max(abs(m[k] - one_m[k]) / abs(one_m[k]) for k in ("loss", "grad_norm"))
    print(f"training check 6b: {TRAIN_ARCH} full width, {cfg.num_layers} layers, float32, {TRAIN_GRID_BATCH} x "
          f"{TRAIN_GRID_SEQ} tokens, microbatch 2, labels -1 in part of each microbatch: one step on SimMesh((2, 2)) "
          f"(TP over model; the data axis holds the whole batch in one process) vs one "
          f"rank, first moments worst rel_err {grad_err:.3e} (tol {TRAIN_REL_TOL}), weights past their bound by "
          f"{param_err:.3e}, loss {m['loss']:.6f} / grad norm {m['grad_norm']:.6f} rel_err {metric_err:.3e}; step "
          f"{ms:.1f} ms (host clock) vs {one_ms:.1f} on one rank", flush=True)
    check(grad_err <= TRAIN_REL_TOL, f"training check 6b: first moments {grad_err:.3e} > {TRAIN_REL_TOL}")
    check(param_err <= 0, f"training check 6b: weights {param_err:.3e} past their bound")
    check(metric_err <= TRAIN_REL_TOL, f"training check 6b: loss / grad norm {metric_err:.3e} > {TRAIN_REL_TOL}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return dict(grad_err=grad_err, param_err=param_err, metric_err=metric_err)


def training_phase(torch, seed, fft_stage, cm) -> dict:
    """Phase 20: training on one card; returns its FFT kernel launches (0),
    the single-rank checks' and the split step's (``training_tp``)."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def run():
        t = time.perf_counter()
        train_flash_checks(torch, g)
        train_mamba_check(torch, g)
        train_model_check(torch, seed)
        print(f"training check 1: {time.perf_counter() - t:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out = train_full_depth(torch, seed, cm)
        print(f"training check 2: {time.perf_counter() - t:.1f} s", flush=True)
        train_launcher(torch)
        return out

    def run_tp():
        t = time.perf_counter()
        train_tp_grads(torch, seed, ssm_cfg(TRAIN_ARCH, TRAIN_F32_LAYERS, "float32"), TRAIN_F32_SEQ, "Hymba-1.5B")
        gc.collect()
        torch.cuda.empty_cache()
        train_tp_grads(torch, seed, ssm_cfg(TRAIN_TP_ARCH, TRAIN_TP_LAYERS, "float32"), TRAIN_TP_SEQ, "Qwen2.5-32B")
        gc.collect()
        torch.cuda.empty_cache()
        print(f"training check 4: {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        out = train_tp_steps(torch, seed)
        print(f"training check 5: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    def run_fsdp():
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            train_pg_launcher(torch, tmp)
        train_grid_step(torch, seed)
        print(f"training check 6: {time.perf_counter() - t:.1f} s", flush=True)

    _, launches, _ = counted(torch, fft_stage, "training", run, expect=())
    _, tp_launches, _ = counted(torch, fft_stage, "training TP", run_tp, expect=())
    _, fsdp_launches, _ = counted(torch, fft_stage, "training FSDP", run_fsdp, expect=())
    print(f"training phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"training": launches, "training_tp": tp_launches, "training_fsdp": fsdp_launches}


def nccl_ddp(torch, mesh, fft_stage, seed: int) -> dict:
    """Phase 7's training part, one rank: make_ddp_compressed_step on this
    rank's ProcessGroupMesh over a "data" axis -- Hymba-1.5B at full width,
    DDP_LAYERS layers, float32, each rank its block of DDP_BATCH x DDP_SEQ
    -- DDP_STEPS steps without compression and with the int8 all-gather:
    every rank's parameters equal after every step (a digest each), losses
    finite, the int8 losses within DDP_DRIFT x the first of the plain
    run's; the bytes one step's gradient reduction moves a rank. The
    parameters are compared by a checksum of their bits a leaf (all
    gathered to every rank)."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig
    from repro_torch.core import ProcessGroupMesh
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_ddp_state, make_ddp_compressed_step

    def run():
        dmesh = ProcessGroupMesh("data", device=mesh.device, timeout_s=NCCL_TIMEOUT_S)
        model = Model(ssm_cfg(TRAIN_ARCH, DDP_LAYERS, "float32"), device=mesh.device)
        ds = SyntheticLM(DataConfig(model.cfg.vocab_size, DDP_SEQ, DDP_BATCH, seed=seed))
        out = {}
        for comp in ("none", "int8"):
            tcfg = TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=12, grad_compression=comp)
            g = torch.Generator(device=mesh.device)
            g.manual_seed(seed)
            state = init_ddp_state(model, g, tcfg, dmesh)
            step = make_ddp_compressed_step(model, tcfg, dmesh)
            losses, equal, ms = [], True, []
            for s in range(DDP_STEPS):
                batch = make_batch_arrays(ds.batch_at(s), dmesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                mine = tuple(int(p.view(torch.int32).long().sum()) for p in leaves(state.params))  # the bits, summed
                every = [None] * mesh.p
                dist.all_gather_object(every, mine)
                equal = equal and len(set(every)) == 1
            numel = sum(p.numel() for p in leaves(state.params))
            payload = (numel + 4 * len(leaves(state.params))) if comp == "int8" else 4 * numel
            out[comp] = dict(losses=losses, equal=equal, step_ms=ms, payload_bytes=payload,
                             gathered_bytes=payload * mesh.p if comp == "int8" else None)
            check(equal, f"rank {mesh.rank}: the replicas' parameters differ after a {comp} DDP step")
            check(all(math.isfinite(x) for x in losses), f"rank {mesh.rank}: a {comp} DDP loss is not finite")
            del state, step
        drift = max(abs(a - b) for a, b in zip(out["none"]["losses"], out["int8"]["losses"]))
        out["drift"] = drift
        check(drift < DDP_DRIFT * out["none"]["losses"][0],
              f"rank {mesh.rank}: int8 DDP drifts {drift:.4f} from the uncompressed run")
        return out

    out, launches, _ = counted(torch, fft_stage, "NCCL DDP", run, expect=())
    out["launches"] = launches
    return out


def fsdp_grids(p: int) -> list:
    """The ('data', 'model') grids phase 7's FSDP part runs over P cards."""
    return [(p, 1)] + ([(2, p // 2)] if p >= 4 else [])


def nccl_fsdp_f32(torch, mesh, seed: int, arch: str, layers: int) -> dict:
    """Phase 7's FSDP check of one model, one rank: one make_train_step
    (microbatch FSDP_MICRO, float32) of ``arch`` at full width and
    ``layers`` layers on this card alone, then over each grid of
    ``fsdp_grids`` (each rank its blocks, its rows of every microbatch,
    FSDP x TP) from the same seed and batch: each rank's block of every
    first moment within TRAIN_REL_TOL of the block's largest one-card
    entry, the weights within TRAIN_REL_TOL plus Adam's amplification of
    the gradients' disagreement, the loss and the gradient norm within
    TRAIN_REL_TOL and bitwise equal on every rank."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import ProcessGroupMesh
    from repro_torch.core.mesh import FSDP_BYTES
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
    from repro_torch.models.model import Model, rank_blocks
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_train_state, make_train_step

    cfg = ssm_cfg(arch, layers, "float32")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=10, microbatch=FSDP_MICRO, seed=seed)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, FSDP_SEQ, FSDP_BATCH, seed=seed))
    batch = make_batch_arrays(ds.batch_at(0), mesh)
    grids = fsdp_grids(mesh.p)

    def run(model):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        state, specs = init_train_state(model, gen, tcfg)
        step = make_train_step(model, tcfg, model.mesh)
        FSDP_BYTES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        return state, m, specs, (time.perf_counter() - t0) * 1e3

    one, one_m, specs, one_ms = run(Model(cfg, device=mesh.device))
    kept = {}  # each grid's blocks of the one-card moments and weights, on the host
    for grid in grids:
        gmesh = ProcessGroupMesh(device=mesh.device, grid=grid, axis_names=("data", "model"), timeout_s=NCCL_TIMEOUT_S)
        place = dict(mesh=gmesh, specs=specs, cfg=cfg)
        kept[grid] = (gmesh, [t.cpu() for t in leaves(rank_blocks(one.opt.mu, **place))],
                      [t.cpu() for t in leaves(rank_blocks(one.params, **place))])
    del one
    gc.collect()
    torch.cuda.empty_cache()
    out = {"one_ms": one_ms, "grids": {}}
    for grid, (gmesh, one_mu, one_p) in kept.items():
        torch.cuda.reset_peak_memory_stats()
        state, m, _, ms = run(Model(cfg, gmesh, device=mesh.device))
        moved = dict(FSDP_BYTES)
        label = f"{arch} grid {grid}"
        dry = dry_run_fsdp_check(cfg, tcfg, gmesh, FSDP_SEQ, FSDP_BATCH, state, moved, f"rank {mesh.rank}: {label}")
        grad_err, param_err = 0.0, -math.inf
        lr = float(m["lr"])
        for a, e, p, ep in zip(leaves(state.opt.mu), one_mu, leaves(state.params), one_p):
            e, ep = e.to(mesh.device), ep.to(mesh.device)
            top = e.abs().max()
            grad_err = max(grad_err, ((a - e).abs().max() / top).item() if top > 0 else a.abs().max().item())
            noise = torch.nan_to_num(torch.clamp(TRAIN_REL_TOL * top / e.abs(), max=1.0), nan=1.0)
            param_err = max(param_err, ((p - ep).abs() - TRAIN_REL_TOL * ep.abs().max() - 2 * lr * noise).max().item())
        metric_err = max(abs(float(m[k]) - float(one_m[k])) / abs(float(one_m[k])) for k in ("loss", "grad_norm"))
        check(grad_err <= TRAIN_REL_TOL, f"rank {mesh.rank}: NCCL FSDP {label} gradients {grad_err:.3e} > "
              f"{TRAIN_REL_TOL}")
        check(param_err <= 0, f"rank {mesh.rank}: NCCL FSDP {label} weights {param_err:.3e} past their bound")
        check(metric_err <= TRAIN_REL_TOL, f"rank {mesh.rank}: NCCL FSDP {label} loss / grad norm {metric_err:.3e}")
        same_on_every_rank(mesh, [digest(m["loss"]), digest(m["grad_norm"])], f"{label} loss and grad norm (bitwise)")
        out["grids"][str(grid)] = dict(grad_err=grad_err, param_err=param_err, metric_err=metric_err, step_ms=ms,
                                       loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                       gathered=moved.get("all_gather", 0), scattered=moved.get("reduce_scatter", 0),
                                       reduced=moved.get("all_reduce", 0), dry=dry,
                                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: ``core.mesh.FSDP_BYTES``' names of the dry run's state kinds
FSDP_NAMES = {"all-gather": "all_gather", "reduce-scatter": "reduce_scatter", "all-reduce": "all_reduce"}


def dry_run_fsdp_check(cfg, tcfg, gmesh, seq: int, batch: int, state, moved: dict, label: str,
                       peak: int = None) -> dict:
    """``launch.dryrun``'s train cell of ``cfg`` at ``batch`` x ``seq`` on
    ``gmesh``'s grid beside a step's: the rank's state bytes and the bytes
    each kind of state collective moved (``core.mesh.FSDP_BYTES``),
    exactly; with ``peak`` (the steps' max_memory_allocated on the rank)
    the executed half's peak within DRYRUN_PEAK_TOL. Returns the
    prediction."""
    from repro_torch.optim.adamw import leaves

    args, rep = dry_run_cell(cfg, "train", seq, batch, mesh=gmesh, tcfg=tcfg)
    held = tensor_bytes(leaves(state.params) + leaves(state.opt.mu) + leaves(state.opt.nu)
                        + [state.opt.count, state.step])
    pred = {FSDP_NAMES[k]: v for k, v in rep["collectives"]["state"]["bytes"].items() if v}
    check(state_bytes_of(args) == held, f"{label}: the dry run predicts {state_bytes_of(args)} B of state, the rank "
          f"holds {held} B")
    check(pred == {k: v for k, v in moved.items() if v}, f"{label}: the dry run predicts {pred}, the step moved {moved}")
    if peak is not None:
        mem = rep["memory"]
        prel = (mem["peak_device_bytes"] - peak) / peak
        print(f"{label}: the dry run's executed peak {mem['peak_device_bytes']} B "
              f"({mem['peak_device_bytes'] / 2**30:.2f} GiB; temporaries {mem['temp_bytes'] / 2**30:.2f} GiB, traced "
              f"in {rep['trace_s']:.1f} s) against the measured {peak} B ({peak / 2**30:.2f} GiB, "
              f"max_memory_allocated over the steps; rel diff {prel:+.2e}, tol {DRYRUN_PEAK_TOL}) ({card()})",
              flush=True)
        check(abs(prel) <= DRYRUN_PEAK_TOL, f"{label}: the dry run's peak {mem['peak_device_bytes']} B is "
              f"{prel:+.2%} from the measured {peak} B")
    return dict(state=state_bytes_of(args), moved=pred, bottleneck=rep["roofline"]["bottleneck"])


def nccl_fsdp_big(torch, mesh, seed: int) -> dict:
    """Phase 7's four-card FSDP part, one rank: Qwen2.5-32B at full width
    and FSDP_BIG_LAYERS layers (float32 master weights and AdamW state,
    bf16 compute), FSDP_BIG_STEPS steps on each of (P, 1), (2, P / 2) (FSDP
    x TP) and (1, P) (tensor parallelism alone): each step's device ms
    (CUDA events), host ms to issue it, the bytes FSDP's gathers and
    reduce-scatters assemble on the rank, the peak memory, the losses
    (finite, bitwise equal on every rank)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import ProcessGroupMesh
    from repro_torch.core.mesh import FSDP_BYTES, collectives, reset_collectives
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_train_state, make_train_step

    cfg = ssm_cfg(LM_ARCH, FSDP_BIG_LAYERS)
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=FSDP_BIG_STEPS, seed=seed)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, FSDP_BIG_SEQ, FSDP_BIG_BATCH, seed=seed))
    out = {}
    for grid in fsdp_grids(mesh.p) + [(1, mesh.p)]:
        gmesh = ProcessGroupMesh(device=mesh.device, grid=grid, axis_names=("data", "model"), timeout_s=NCCL_TIMEOUT_S)
        model = Model(cfg, gmesh, device=mesh.device)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        state, _ = init_train_state(model, gen, tcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_gib = sum(t.numel() * t.element_size() for t in leaves(state.params) + leaves(state.opt.mu)
                        + leaves(state.opt.nu)) / 2**30
        _, pred = dry_run_cell(cfg, "train", FSDP_BIG_SEQ, FSDP_BIG_BATCH, mesh=gmesh, tcfg=tcfg)
        act = pred["collectives"]["activation"]
        if mesh.rank == 0:
            b = pred["collectives"]["state"]["bytes"]
            print(f"NCCL rank 0/{mesh.p} FSDP dry run, Qwen2.5-32B {FSDP_BIG_LAYERS} layers, {FSDP_BIG_BATCH} x "
                  f"{FSDP_BIG_SEQ} tokens, grid {grid}, before its steps: state "
                  f"{pred['memory']['alias_bytes'] / 2**30:.2f} GiB a rank, "
                  f"all_gather {b['all-gather'] / 1e9:.3f} GB, reduce_scatter {b['reduce-scatter'] / 1e9:.3f} GB, "
                  f"all_reduce {b['all-reduce']} B a rank a step; activation collectives "
                  f"{sum(act['counts'].values())} calls, {sum(act['bytes'].values()) / 1e9:.3f} GB assembled a rank "
                  f"a step ({card()})", flush=True)
        step = make_train_step(model, tcfg, gmesh)
        torch.cuda.reset_peak_memory_stats()
        dev, host, losses, moved = [], [], [], []
        for s in range(FSDP_BIG_STEPS):
            batch = make_batch_arrays(ds.batch_at(s), gmesh)
            torch.cuda.synchronize()
            reset_collectives()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            state, m = step(state, batch)
            end.record()
            host.append((time.perf_counter() - t1) * 1e3)
            end.synchronize()
            dev.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            moved.append(dict(FSDP_BYTES))
            check_counted(f"rank {mesh.rank}: Qwen2.5-32B {FSDP_BIG_LAYERS} layers on {grid}, step {s}", act,
                          collectives("activation"))
        check(all(math.isfinite(x) for x in losses), f"rank {mesh.rank}: a Qwen2.5-32B FSDP loss on {grid} is not "
              "finite")
        same_on_every_rank(mesh, losses, f"Qwen2.5-32B {FSDP_BIG_LAYERS} layers on {grid}: losses")
        dry_run_fsdp_check(cfg, tcfg, gmesh, FSDP_BIG_SEQ, FSDP_BIG_BATCH, state, moved[-1],
                           f"rank {mesh.rank}: Qwen2.5-32B {FSDP_BIG_LAYERS} layers on {grid}",
                           peak=torch.cuda.max_memory_allocated())
        out[str(grid)] = dict(device_ms=dev, host_ms=host, losses=losses, init_s=init_s, state_gib=state_gib,
                              peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                              gathered=moved[-1].get("all_gather", 0), scattered=moved[-1].get("reduce_scatter", 0))
        del state, step, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dryrun_phase(torch, fft_stage, smi: str) -> dict:
    """Phase 21: the port's dry run, its CLI over every arch x shape x
    production mesh cell in a subprocess (a walk over the placement
    specs, and one rank's step traced on the meta device: no
    card, no process group), within DRYRUN_CLI_S seconds; every cell's
    executed peak, temporaries and whether it fits a card; its FFT kernel
    launches (0)."""

    from repro_torch.launch.dryrun import CARD_BYTES

    card_gb = f"{CARD_BYTES / 1e9:.0f}"

    def run():
        out_dir = tempfile.mkdtemp(prefix="dryrun_")
        try:
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [os.path.join(HERE, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh", "both",
                                   "--out", out_dir], capture_output=True, text=True, env=env, timeout=600)
            secs = time.perf_counter() - t0
            check(proc.returncode == 0, f"dry run: exit {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            files = sorted(f for f in os.listdir(out_dir) if f.endswith("_torch.json"))
            check(len(files) == DRYRUN_CELLS, f"dry run: {len(files)} cells written, not {DRYRUN_CELLS}")
            print(f"dry run: python -m repro_torch.launch.dryrun --all --mesh both, {len(files)} cells in {secs:.1f} s "
                  f"(limit {DRYRUN_CLI_S:.0f} s; a spec walk and one rank's step traced on the meta device, no card, "
                  f"{os.cpu_count()} host cores); the times below are the roofline's, from the H100 "
                  f"SXM data-sheet constants (989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink a direction) on the "
                  f"executed FLOPs and moved bytes, not measured; this card: {smi}", flush=True)
            print("dry run CLI: " + proc.stdout.strip().splitlines()[-1], flush=True)
            check(secs <= DRYRUN_CLI_S, f"dry run: the CLI took {secs:.1f} s > {DRYRUN_CLI_S} s")
            over = []
            for f in files:
                with open(os.path.join(out_dir, f)) as fh:
                    r = json.load(fh)
                roof, coll = r["roofline"], r["collectives"]
                state, act = coll["state"]["shipped"], coll["activation"]["shipped"]
                mem = r["memory"]
                fits = mem["peak_device_bytes"] <= CARD_BYTES
                over += [] if fits else [f"{r['arch']} {r['shape']} {r['mesh']}"]
                check(mem["temp_bytes"] is not None and mem["peak_device_bytes"] == mem["argument_bytes"]
                      + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"], f"dry run {f}: memory {mem}")
                print(f"dry run {r['arch']} {r['shape']} {r['mesh']} ({r['chips']} ranks): "
                      f"{mem['peak_device_bytes'] / 2**30:.2f} GiB a rank (arguments: the traced rank's "
                      f"{r['executed']['args_bytes']} B, the spec's {mem['argument_bytes']} B; temporaries "
                      f"{mem['temp_bytes'] / 2**30:.2f}, floor {mem['floor_bytes'] / 2**30:.2f}; "
                      f"{'fits' if fits else 'EXCEEDS'} {card_gb} GB), traced in {r['trace_s']:.2f} s, "
                      f"{r['executed']['flops']:.4e} FLOPs, {r['executed']['hbm_bytes']:.4e} HBM B, useful "
                      f"{r['useful_flops_frac']:.3f}, bottleneck "
                      f"{roof['bottleneck']}, t_compute {roof['t_compute_s']:.3e} s, t_memory "
                      f"{roof['t_memory_s']:.3e} s, t_collective {roof['t_collective_s']:.3e} s; shipped a rank: "
                      f"state {state:.6e} B, activation {act:.6e} B (data-sheet roofline; {smi})", flush=True)
                total = sum(coll["bytes"].values())
                check(math.isclose(total, state + act, rel_tol=1e-12) and roof["coll_bytes"] == total
                      and sum(coll["counts"].values()) == sum(coll["state"]["counts"].values())
                      + sum(coll["activation"]["counts"].values()),
                      f"dry run {f}: shipped {total} B by kind, {state} + {act} B by scope, roofline "
                      f"{roof['coll_bytes']} B")
            print(f"dry run: {len(over)} of {len(files)} cells exceed {card_gb} GB a rank: {', '.join(over)}",
                  flush=True)
            check(sorted(over) == sorted(DRYRUN_OVER), f"dry run: the cells over {card_gb} GB a rank are {over}, "
                  f"not {DRYRUN_OVER}")
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)

    _, launches, _ = counted(torch, fft_stage, "dry run", run, expect=())
    return launches


def nccl_fsdp(torch, mesh, fft_stage, seed: int) -> dict:
    """Phase 7's FSDP part, one rank: the float32 checks over the grids of
    ``fsdp_grids`` (``nccl_fsdp_f32``), then at P >= 4 the four-card
    Qwen2.5-32B steps (``nccl_fsdp_big``); the FFT kernels' launches (0)."""

    def run():
        out = {"f32": {}}
        for arch, layers in ((TRAIN_ARCH, TRAIN_F32_LAYERS), (LM_ARCH, FSDP_QWEN_LAYERS)):
            out["f32"][arch] = nccl_fsdp_f32(torch, mesh, seed, arch, layers)
            gc.collect()
            torch.cuda.empty_cache()
        out["big"] = nccl_fsdp_big(torch, mesh, seed) if mesh.p >= 4 else None
        return out

    out, launches, _ = counted(torch, fft_stage, "NCCL FSDP", run, expect=())
    out["launches"] = launches
    return out


def print_nccl_fsdp(rep) -> None:
    who, m = f"NCCL rank {rep['rank']}/{rep['P']} FSDP", rep["fsdp"]
    for arch, r in m["f32"].items():
        layers = TRAIN_F32_LAYERS if arch == TRAIN_ARCH else FSDP_QWEN_LAYERS
        for grid, g in r["grids"].items():
            print(f"{who} {arch} full width, {layers} layers, float32, {FSDP_BATCH} x {FSDP_SEQ} tokens, microbatch "
                  f"{FSDP_MICRO}, one make_train_step over grid {grid} ('data', 'model') vs one card on the same seed: "
                  f"each rank's first-moment blocks worst rel_err {g['grad_err']:.3e} (tol {TRAIN_REL_TOL}), weights "
                  f"within their bound (largest distance past it {g['param_err']:.3e}), loss {g['loss']:.6f} / grad "
                  f"norm {g['grad_norm']:.6f} rel_err {g['metric_err']:.3e}, bitwise equal on every rank; step "
                  f"{g['step_ms']:.1f} ms (host clock) vs {r['one_ms']:.1f} on one card; FSDP gathered "
                  f"{g['gathered'] / 1e9:.3f} GB, reduce-scattered {g['scattered'] / 1e9:.3f} GB, all-reduced "
                  f"{g['reduced']} B a rank; peak {g['peak_gib']:.2f} GiB; the dry run predicted state "
                  f"{g['dry']['state']} B and moved {g['dry']['moved']} B a rank, as held and counted", flush=True)
    if m["big"] is None:
        print(f"{who} Qwen2.5-32B at {FSDP_BIG_LAYERS} of 64 layers (5.46 B params, ~87 GB of float32 weights, "
              f"gradients and moments): not run at P = {rep['P']}: the model does not fit on fewer than 4 cards",
              flush=True)
        return
    for grid, r in m["big"].items():
        print(f"{who} Qwen2.5-32B full width, {FSDP_BIG_LAYERS} layers, bf16 compute (float32 weights and AdamW), "
              f"{FSDP_BIG_BATCH} x {FSDP_BIG_SEQ} tokens a step, grid {grid}: step device ms "
              f"{', '.join(f'{x:.1f}' for x in r['device_ms'])} (CUDA events), host ms to issue "
              f"{', '.join(f'{x:.1f}' for x in r['host_ms'])}; losses {', '.join(f'{x:.4f}' for x in r['losses'])} "
              f"(bitwise equal on every rank); state {r['state_gib']:.2f} GiB a rank, peak {r['peak_gib']:.2f} GiB; "
              f"FSDP gathered {r['gathered'] / 1e9:.3f} GB, reduce-scattered {r['scattered'] / 1e9:.3f} GB a rank a "
              f"step (the dry run's prediction, exactly); init {r['init_s']:.1f} s", flush=True)


def print_nccl_ddp(rep) -> None:
    who, m = f"NCCL rank {rep['rank']}/{rep['P']} DDP", rep["ddp"]
    for comp in ("none", "int8"):
        r = m[comp]
        wire = (f"{r['payload_bytes'] / 1e6:.1f} MB of int8 + scales a rank into one all_gather_into_tensor a leaf "
                f"({r['gathered_bytes'] / 1e6:.1f} MB gathered)" if comp == "int8" else
                f"{r['payload_bytes'] / 1e6:.1f} MB of float32 a rank into one all_reduce a leaf")
        if rep["P"] == 1:
            wire += " (P = 1: no message moves)"
        print(f"{who} {TRAIN_ARCH} full width, {DDP_LAYERS} layers, float32, {DDP_BATCH} x {DDP_SEQ} a step, "
              f"grad_compression={comp}: losses {', '.join(f'{x:.4f}' for x in r['losses'])}; step ms (host clock) "
              f"{', '.join(f'{x:.1f}' for x in r['step_ms'])}; gradient reduction {wire}; every rank's parameters "
              f"equal after every step (a checksum of each leaf's bits): {r['equal']}", flush=True)
    print(f"{who} int8 vs none: largest loss drift {m['drift']:.4f} (gate {DDP_DRIFT} x the first loss)", flush=True)


def agreement_probe(torch, mesh) -> dict:
    """Host ms of one agreement over the group's CPU backend
    (mesh.host_max, what the serving engine uses) and over the card's
    (mesh.all_max), each idle (median of 20) and with AGREE_BUSY_MATMULS matmuls
    queued on the stream: an agreement that waits for the stream takes
    the queued work's time."""
    a = torch.randn((AGREE_BUSY_N, AGREE_BUSY_N), device=mesh.device)

    def host_ms_of(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def busy():
        for _ in range(AGREE_BUSY_MATMULS):
            torch.matmul(a, a)

    out = {}
    for name, fn in (("host_max", lambda: mesh.host_max([1.0])), ("all_max", lambda: mesh.all_max([1.0]))):
        torch.cuda.synchronize()
        out[f"{name}_idle_ms"] = statistics.median(host_ms_of(fn) for _ in range(20))
        busy()
        out[f"{name}_busy_ms"] = host_ms_of(fn)
        torch.cuda.synchronize()
    out["queued_ms"] = events_ms(torch, busy, reps=3)
    return out


def same_on_every_rank(mesh, obj, what: str):
    """All-gather ``obj`` from every rank; fail unless all are equal."""
    import torch.distributed as dist

    objs = [None] * mesh.p
    dist.all_gather_object(objs, obj)
    check(all(o == objs[0] for o in objs), f"rank {mesh.rank}: the ranks' {what} differ: {objs}")
    return objs


def nccl_serving(torch, mesh, fft_stage, seed) -> dict:
    """Phase 7's serving part, one rank: phase 11's clean stream through
    SpectralEngine on this ProcessGroupMesh (every rank submits its own
    block of each request), coalescing on and off, each completed block
    held against the same stream through SpectralEngine(SimMesh(P)) on
    this card; every rank must make the same batches. Then a poisoned
    batch with the fault on rank 0 only and a breaker trip (each rank's
    clock offset differently; only the last rank's passes the cool-down),
    whose counters must be the same on every rank; and on P > 1 cards the
    engine's remesh onto the P/2 survivors, equal to SimMesh(P/2)'s
    engine bitwise."""
    import torch.distributed as dist

    from repro_torch.core import SimMesh
    from repro_torch.runtime import CircuitBreaker, FaultPlan, RetryPolicy, elastic_mesh
    from repro_torch.serve import SpectralEngine

    p, tail, buckets = mesh.p, ("model", None), (1, 2, 4, SERVE_BATCH)
    xs, fs = serve_inputs(torch, seed, mesh.device)
    own = lambda a: mesh.split(a, tail)[0]  # noqa: E731
    out = {"agreement": agreement_probe(torch, mesh)}
    for coalesce in (True, False):
        arm = "coalesced" if coalesce else "solo"
        kw = dict(max_batch=SERVE_BATCH, max_wait_s=0.005, coalesce=coalesce, plan_kwargs=SERVE_KW)
        ref = SpectralEngine(SimMesh(p, device=mesh.device), **kw)
        warm_buckets(torch, ref, buckets if coalesce else (1,), ("fft", "poisson"))
        exp = [own(f.result()).clone() for _, _, f in serve_stream(ref, xs, fs)]
        del ref
        eng = SpectralEngine(mesh, **kw)
        warm_buckets(torch, eng, buckets if coalesce else (1,), ("fft", "poisson"))
        eng.reset_stats()
        dist.barrier()
        t0 = time.perf_counter()
        futs, launches, peak = counted(torch, fft_stage, f"NCCL serving ({arm})", lambda: serve_stream(eng, xs, fs, own),
                                       None if p > 1 else ("stage_left", "stage_right"))
        elapsed = time.perf_counter() - t0
        err = max(rel_err(torch, f.result(), e) for (_, _, f), e in zip(futs, exp))
        check(err <= 1e-6, f"rank {mesh.rank}: NCCL serving ({arm}) disagrees with SimMesh({p})'s engine ({err:.3e})")
        s = eng.stats()
        ag = s["agreements"]
        same_on_every_rank(mesh, ([f.batch_size for _, _, f in futs], s["batches"], ag["count"]), f"{arm} batches")
        out[arm] = dict(
            requests=len(futs), elapsed_ms=elapsed * 1e3, tps=len(futs) / elapsed, latency_s=s["latency_s"],
            mean_batch=s["mean_batch"], batches=s["batches"], padded=s["padded"], agreements=ag["count"],
            agreements_per_dispatch=ag["per_dispatch"], agreement_ms=ag["host_s"] / max(ag["count"], 1) * 1e3,
            stages_s=s["stages_s"], launches=launches, peak_gib=peak, rel_err_vs_sim=err)
        del futs, exp, eng
        torch.cuda.empty_cache()

    # poison on rank 0 only: one coalesced batch of 4, two faults, no retries
    eng = SpectralEngine(mesh, max_batch=SERVE_BATCH, max_wait_s=100.0, retry=RetryPolicy(max_retries=0),
                         plan_kwargs=SERVE_KW)
    warm_buckets(torch, eng, (1, 4))
    eng.set_faults(FaultPlan.error(match="Exchange", times=2) if mesh.rank == 0 else FaultPlan())
    futs = [eng.submit("fft", own(x)) for x in xs[:4]]
    eng.drain()
    failed = [i for i, f in enumerate(futs) if f.failed()]
    errs = [rel_err(torch, f.result(), own(torch.fft.fft2(xs[i]).mT)) for i, f in enumerate(futs) if i not in failed]
    m = eng.metrics()
    poison = dict(failed=failed, errors=m["errors"], batch_splits=m["batch_splits"], quarantined=m["quarantined"])
    same_on_every_rank(mesh, poison, "poison counters")
    check(len(failed) == 1 and (m["errors"], m["batch_splits"], m["quarantined"]) == (2, 1, 1)
          and max(errs) <= MAIN_PATH_REL_TOL, f"rank {mesh.rank}: poison on rank 0: {poison}, rel_errs {errs}")
    out["poison"] = dict(poison, max_rel_err=max(errs))
    del futs, eng

    # the breaker: faults on rank 0 only, clocks offset by rank
    clk = FakeClock()
    clk.advance(10.0 * mesh.rank)
    eng = SpectralEngine(mesh, max_batch=1, clock=clk, retry=RetryPolicy(max_retries=0), plan_kwargs=SERVE_KW,
                         breaker=CircuitBreaker(failure_threshold=2, reset_after_s=5.0, clock=clk))
    warm_buckets(torch, eng, (1,))
    eng.set_faults(FaultPlan.error(match="Exchange", times=2) if mesh.rank == 0 else FaultPlan())

    def one(x):
        fut = eng.submit("fft", own(x))
        eng.drain()
        return fut

    check(all(one(x).failed() for x in xs[:2]), f"rank {mesh.rank}: breaker: the faults did not quarantine")
    deg, dl, _ = counted(torch, fft_stage, "NCCL serving degraded", lambda: one(xs[2]), expect=())
    check(deg.degraded and deg.backend == "xla_auto" and not any(dl.values()),
          f"rank {mesh.rank}: breaker: the open key was not degraded to xla_auto without kernels: {dl}")
    err_deg = rel_err(torch, deg.result(), own(torch.fft.fft2(xs[2]).mT))
    clk.advance(6.0 if mesh.rank == p - 1 else 1.0)  # only the last rank's clock passes the cool-down
    probe = one(xs[3])
    b = eng.breaker.stats()
    same_on_every_rank(mesh, (b, eng.metrics()["degraded_dispatches"]), "breaker states")
    check(probe.degraded is False and (b["opened"], b["reclosed"], b["probes"], b["open"]) == (1, 1, 1, 0)
          and err_deg <= MAIN_PATH_REL_TOL, f"rank {mesh.rank}: breaker: {b}, degraded rel_err {err_deg:.3e}")
    out["breaker"] = dict(b, degraded_launches=dl, degraded_rel_err=err_deg)
    del deg, probe, eng

    if p == 1:
        out["remesh"] = "P = 1: one rank cannot shrink"
        return out
    half = p // 2
    eng = SpectralEngine(mesh, max_batch=SERVE_BATCH, max_wait_s=100.0, plan_kwargs=SERVE_KW)
    small = elastic_mesh(("model",), max_devices=half, timeout_s=NCCL_TIMEOUT_S)  # every rank calls it
    if small is not None:
        eng.remesh(small)
        check(eng.mesh is small and all(f"|P={half}|" in k for k in eng.pool.keys()),
              f"rank {mesh.rank}: remesh kept the old mesh's plans: {eng.pool.keys()}")
        warm_buckets(torch, eng, (SERVE_BATCH,))
        futs = [eng.submit("fft", small.split(x, tail)[0]) for x in xs[:SERVE_BATCH]]
        eng.drain()
        ref = SpectralEngine(SimMesh(half, device=mesh.device), max_batch=SERVE_BATCH, max_wait_s=100.0,
                             plan_kwargs=SERVE_KW)
        refs = [ref.submit("fft", x) for x in xs[:SERVE_BATCH]]
        ref.drain()
        bitwise = all(torch.equal(f.result(), small.split(r.result(), tail)[0]) for f, r in zip(futs, refs))
        check(bitwise, f"rank {mesh.rank}: serving after remesh onto {half} ranks differs from SimMesh({half})'s")
        out["remesh"] = dict(survivors=half, requests=len(futs), bitwise_vs_sim=bitwise,
                             batch_sizes=[f.batch_size for f in futs])
        del futs, refs, ref
    else:
        out["remesh"] = "left out"
    dist.barrier()  # the others wait here for the survivors
    return out


def print_nccl_serving(rep) -> None:
    who, sv = f"NCCL rank {rep['rank']}/{rep['P']}", rep["serving"]
    a = sv["agreement"]
    print(f"{who} agreement (one host value): mesh.host_max (gloo) {a['host_max_idle_ms']:.3f} ms idle, "
          f"{a['host_max_busy_ms']:.3f} ms with {a['queued_ms']:.1f} ms of matmuls queued; mesh.all_max (NCCL) "
          f"{a['all_max_idle_ms']:.3f} ms idle, {a['all_max_busy_ms']:.3f} ms with the same queued", flush=True)
    for arm in ("coalesced", "solo"):
        r = sv[arm]
        lat, st = r["latency_s"], r["stages_s"]
        print(f"{who} SPMD serving ({arm}): {r['requests']} requests ({SERVE_FFT} fft {SERVE_N}^2 complex64, "
              f"{SERVE_POISSON} poisson float32, each rank its block) in {r['elapsed_ms']:.1f} ms, "
              f"{r['tps']:.1f} transforms/s, latency p50 {lat['p50'] * 1e3:.2f} ms p99 {lat['p99'] * 1e3:.2f} ms, "
              f"mean batch {r['mean_batch']:.2f} ({r['batches']} batches, padded {r['padded']}); agreements "
              f"{r['agreements']} ({r['agreements_per_dispatch']:.2f} per dispatch, {r['agreement_ms']:.3f} ms each); "
              f"dispatch spans p50/p99 ms: "
              + ", ".join(f"{k} {v['p50'] * 1e3:.3f}/{v['p99'] * 1e3:.3f}" for k, v in st.items())
              + f"; rel_err vs SimMesh({rep['P']})'s engine {r['rel_err_vs_sim']:.3e} (tol 1e-06), launches "
              f"{r['launches']}, peak memory {r['peak_gib']:.2f} GiB", flush=True)
    print(f"{who} SPMD serving poison (FaultPlan.error(times=2) on rank 0 only): {sv['poison']}", flush=True)
    print(f"{who} SPMD serving breaker (faults on rank 0 only, clocks offset by rank): {sv['breaker']}", flush=True)
    print(f"{who} SPMD serving remesh: {sv['remesh']}", flush=True)


def nccl_moe_f32(torch, mesh, seed: int, arch: str) -> dict:
    """Phase 7's MoE check, one rank: ``arch`` at MOE_F32_CUTS' depth in
    float32 with nothing dropped, first on this card alone (Model(cfg)),
    then freed, then Model(cfg, mesh) from the same seed (every expert
    drawn, the rank's kept): the whole sequence's logits (NCCL_MOE_SEQ
    tokens: the ring), a prefill of them + NCCL_MOE_DECODE decode steps
    (the einsum dispatch over the ranks), each within EP_REL_TOL of the
    one-card model's; and a short stream through the SPMD ServeEngine,
    whose greedy tokens must equal the one-card engine's and every
    rank's."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine

    cfg = moe_cfg(arch, no_drop=True, dtype="float32", **MOE_F32_CUTS[arch])
    g = torch.Generator(device=mesh.device)
    g.manual_seed(seed + 5)
    toks = torch.randint(0, cfg.vocab_size, (1, NCCL_MOE_SEQ + NCCL_MOE_DECODE), device=mesh.device, generator=g)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), device=mesh.device, generator=g).int().cpu().numpy()
               for n in NCCL_MOE_PROMPTS]
    scfg = ServeConfig(max_batch=4, max_seq=256)

    def run(model):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        params, _ = model.init(gen)
        init_s = time.perf_counter() - t0
        moe.DISPATCHES.clear()
        whole = model.logits(params, {"tokens": toks[:, :NCCL_MOE_SEQ]})
        state = model.init_decode_state(1, NCCL_MOE_SEQ + NCCL_MOE_DECODE, cache_dtype=torch.float32)
        state, pl = model.prefill(params, {"tokens": toks[:, :NCCL_MOE_SEQ]}, state)
        steps = [pl]
        for t in range(NCCL_MOE_DECODE):
            lg, state = model.decode_step(params, toks[:, NCCL_MOE_SEQ + t:NCCL_MOE_SEQ + t + 1], state)
            steps.append(lg)
        ran = dict(moe.DISPATCHES)
        tokens = ServeEngine(model, params, scfg).run(prompts, max_new=NCCL_MOE_NEW)
        nbytes = sum(t.numel() * t.element_size() for t in lm_leaves(params))
        return whole, steps, tokens, ran, init_s, nbytes

    one_whole, one_steps, one_tokens, _, one_init, one_bytes = run(Model(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    whole, steps, tokens, ran, init_s, nbytes = run(Model(cfg, mesh))
    errs = [lm_rel_err(whole, one_whole)] + [lm_rel_err(a, b) for a, b in zip(steps, one_steps)]
    who = f"rank {mesh.rank}: NCCL EP {arch} float32"
    check(max(errs) <= EP_REL_TOL, f"{who}: logits vs the one-card model {errs} > {EP_REL_TOL}")
    same_on_every_rank(mesh, [digest(t) for t in [whole] + steps], f"{arch} float32 logits (bitwise)")
    check(tokens == one_tokens, f"{who}: the SPMD engine's greedy tokens {tokens} differ from one card's {one_tokens}")
    same_on_every_rank(mesh, tokens, f"{arch} float32 SPMD engine tokens")
    if mesh.p > 1:
        took = {"einsum", cfg.moe.dispatch}  # the ring config's decode steps fall back to the einsum dispatch
        check({d for d, p in ran if p == mesh.p} == took, f"{who}: dispatches that ran {ran}")
    return dict(errs=errs, ran={f"{d} x{p}": n for (d, p), n in ran.items()}, tokens=sum(map(len, tokens.values())),
                init_s=init_s, one_init_s=one_init, gib=nbytes / 2**30, one_gib=one_bytes / 2**30)


def digest(t) -> str:
    """The bytes of a tensor, hashed: ranks compare results bitwise."""
    import hashlib

    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def collectives_per_step(torch, eng) -> dict:
    """The torch.distributed calls one decode step of all slots makes
    (the engine's host agreements are outside it), by name; the step's
    activation collectives (``core.mesh.collectives``) checked against
    ``launch.dryrun``'s decode cell at max_batch x max_seq on the
    engine's mesh, exactly, the prediction printed before the step."""
    import collections

    import torch.distributed as dist

    from repro_torch.core.mesh import collectives, reset_collectives
    from repro_torch.launch.mesh import MeshShape

    mesh, cfg = eng.model.mesh, eng.model.cfg
    walk = walk_activation(cfg, "decode", eng.scfg.max_seq, eng.scfg.max_batch,
                           MeshShape(tuple(mesh.shape.values()), tuple(mesh.shape)))
    print(f"NCCL rank {mesh.rank}/{mesh.p} {cfg.name} {cfg.num_layers} layers: the dry run predicts one decode step "
          f"of {eng.scfg.max_batch} slots to issue {sum(walk['counts'].values())} activation collectives, "
          f"{sum(walk['bytes'].values())} B assembled a rank ({card()})", flush=True)
    reset_collectives()

    counts = collections.Counter()
    names = ("all_reduce", "all_gather_into_tensor", "all_gather", "all_to_all_single", "batch_isend_irecv")
    orig = {n: getattr(dist, n) for n in names}

    def counting(n):
        def call(*a, **k):
            counts[n] += 1
            return orig[n](*a, **k)
        return call

    tokens = torch.zeros((eng.scfg.max_batch, 1), dtype=torch.int32, device=eng.model.device)
    for n in names:
        setattr(dist, n, counting(n))
    try:
        eng._decode(eng.params, tokens, eng.state)
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(dist, n, orig[n])
    check_counted(f"NCCL rank {mesh.rank}/{mesh.p} {cfg.name} one decode step", walk, collectives("activation"))
    return dict(counts)


def nccl_moe_served(torch, mesh, seed: int, arch: str) -> dict:
    """Phase 7's MoE serving, one rank (P > 1): ``arch`` at NCCL_MOE_CUTS'
    depth in bfloat16 (tensor- and expert-parallel), on phase 14's
    stream at the stock capacity factor (``nccl_served``); for MLA
    (DeepSeek-V3) the dispatches' prefill ms."""
    from repro_torch.models import moe

    moe.DISPATCHES.clear()
    cfg = moe_cfg(arch, **NCCL_MOE_CUTS[arch])
    out = nccl_served(torch, mesh, seed, cfg)
    out["ran"] = {f"{d} x{p}": n for (d, p), n in moe.DISPATCHES.items()}
    if cfg.mla is not None:
        out["prefill_ms"] = ep_prefill_ms(torch, mesh, cfg, out.pop("params"), seed)
    out.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def nccl_served(torch, mesh, seed: int, cfg) -> dict:
    """One rank (P > 1): ``cfg`` in bfloat16 built by launch.build_engine
    on the mesh (every rank draws the same weights and keeps its blocks),
    on phase 14's stream: every rank's tokens identical, peak memory
    under LM_PEAK_LIMIT_GIB, the collectives of one decode step. The
    engine's weights come back under "params" for a caller's timing."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch import serve as launch

    scfg = ServeConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = launch.build_engine(cfg, scfg, seed=seed, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in lm_leaves(eng.params))
    stream = lm_stream(torch, eng, launch.prompt_stream(cfg, LM_REQUESTS, LM_PROMPT_LEN), LM_MAX_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    results = stream[0]
    same_on_every_rank(mesh, results, f"{cfg.name} served tokens")
    check(sorted(results) == list(range(LM_REQUESTS)) and all(len(v) == LM_MAX_NEW for v in results.values()),
          f"rank {mesh.rank}: {cfg.name} served {sorted(results)}")
    check(peak <= LM_PEAK_LIMIT_GIB, f"rank {mesh.rank}: {cfg.name} peak memory {peak:.2f} GiB > {LM_PEAK_LIMIT_GIB}")
    out = dict(stream_summary(stream, scfg), layers=cfg.num_layers, gib=nbytes / 2**30, peak_gib=peak,
               init_s=init_s, agreements=eng.agreements, agreement_ms=eng.agreement_s * 1e3,
               collectives=collectives_per_step(torch, eng), params=eng.params)
    eng.state = None
    del eng
    return out


def nccl_moe(torch, mesh, fft_stage, seed: int) -> dict:
    """Phase 7's MoE part, one rank: the float32 check of each MoE arch,
    then (P > 1) the served models; the FFT kernels' launches (0)."""
    def run():
        out = {"f32": {arch: nccl_moe_f32(torch, mesh, seed, arch) for arch in MOE_CUTS}, "served": {}}
        if mesh.p > 1:
            for arch in NCCL_MOE_CUTS:
                out["served"][arch] = nccl_moe_served(torch, mesh, seed, arch)
        return out

    out, launches, _ = counted(torch, fft_stage, "NCCL MoE", run, expect=())
    out["launches"] = launches
    return out


def print_nccl_moe(rep) -> None:
    who, m = f"NCCL rank {rep['rank']}/{rep['P']} EP", rep["moe"]
    for arch, r in m["f32"].items():
        print(f"{who} {arch} full width, 2 layers, float32, no drops: Model(cfg, ProcessGroupMesh) vs one card on the "
              f"same seed: whole-sequence logits ({NCCL_MOE_SEQ} tokens), prefill, {NCCL_MOE_DECODE} decode steps "
              f"rel_err {', '.join(f'{e:.3e}' for e in r['errs'])} (tol {EP_REL_TOL}); SPMD engine tokens equal to one "
              f"card's ({r['tokens']} tokens); weights {r['gib']:.2f} GiB a rank vs {r['one_gib']:.2f} on one card, "
              f"init {r['init_s']:.1f} s vs {r['one_init_s']:.1f}; dispatches {r['ran']}", flush=True)
    for arch, r in m["served"].items():
        print(f"{who} {arch} {r['layers']} layers bf16, stock factor, phase 14's stream: {r['tokens']} tokens in "
              f"{r['wall_s']:.2f} s, {r['tok_s']:.1f} tok/s, time to first token p50 {r['ttft_p50_ms']:.1f} ms p99 "
              f"{r['ttft_p99_ms']:.1f} ms; decode step ({r['steps']} steps, full slots) device {r['decode_device_ms']:.2f} "
              f"ms, host {r['decode_host_ms']:.2f} ms to issue; weights {r['gib']:.2f} GiB a rank, peak "
              f"{r['peak_gib']:.2f} GiB (limit {LM_PEAK_LIMIT_GIB}), init {r['init_s']:.1f} s; {r['agreements']} "
              f"agreements, {r['agreement_ms']:.1f} ms; dispatches {r['ran']}; one decode step's collectives "
              f"{r['collectives']}; tokens identical on every rank", flush=True)
        if "prefill_ms" in r:
            print_prefill_ms(f"{who} {arch}", r["prefill_ms"])


def nccl_tp_f32(torch, mesh, seed: int, arch: str, kw: dict) -> dict:
    """Phase 7's TP check, one rank: ``arch`` at full width,
    TP_F32_LAYERS layers, float32 (``kw`` overrides the config), on this
    card alone (Model(cfg)), then freed, then Model(cfg, mesh) from the
    same seed (each rank keeps its blocks): hidden (LM_SEQ tokens: the
    rings), a prefill and TP_DECODE decode steps within TP_REL_TOL of
    the one-card model's, every rank's results bitwise equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch), **{"num_layers": TP_F32_LAYERS, "dtype": "float32", **kw})
    g = torch.Generator(device=mesh.device)
    g.manual_seed(seed + 6)
    toks = torch.randint(0, cfg.vocab_size, (1, LM_SEQ + TP_DECODE), device=mesh.device, generator=g)
    enc = (torch.randn((1, ENCDEC_FRAMES, cfg.d_model), device=mesh.device, generator=g) if cfg.is_encdec
           else None)
    logits = (arch, kw) in TP_F32_MORE  # the model-level checks of phase 19: logits, not hidden

    def run(model):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        params, _ = model.init(gen)
        nbytes = sum(t.numel() * t.element_size() for t in lm_leaves(params))
        states = []
        out = tp_runs(torch, model, params, toks, LM_SEQ, enc, logits, states)
        return out, nbytes, kv_cache_bytes(states.pop())

    one, one_bytes, one_kv = run(Model(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    got, nbytes, kv = run(Model(cfg, mesh))
    errs = [lm_rel_err(a, b) for a, b in zip(got, one)]
    tol = SSM_F32_REL_TOL if cfg.family in ("ssm", "hybrid") else TP_REL_TOL  # as phase 19's check 3
    check(max(errs) <= tol, f"rank {mesh.rank}: NCCL TP {arch} {kw} float32 vs one card {errs} > {tol}")
    same_on_every_rank(mesh, [digest(t) for t in got], f"{arch} {kw} float32 outputs (bitwise)")
    # the cache a rank holds is its block (decode_state_shardings' cut: KV heads, else the head dim): 1/P
    check(kv * mesh.p == one_kv, f"rank {mesh.rank}: {arch} {kw} holds {kv} B of KV cache, not 1/{mesh.p} of "
          f"the one-card model's {one_kv} B")
    return dict(errs=errs, gib=nbytes / 2**30, one_gib=one_bytes / 2**30, tol=tol, layers=cfg.num_layers,
                kv_bytes=kv, one_kv_bytes=one_kv)


def nccl_tp_train(torch, mesh, seed: int) -> dict:
    """Phase 7's TP training check, one rank: one make_train_step of check
    1's Hymba-1.5B (full width, TRAIN_F32_LAYERS layers, float32) on 1 x
    NCCL_TRAIN_SEQ tokens at lr TRAIN_LR, on this card alone (Model(cfg))
    and then on Model(cfg, mesh) from the same seed (each rank keeps its
    blocks): each rank's block of every leaf's gradient within
    TRAIN_REL_TOL of that block's largest one-card entry, the parameters
    after the step within TRAIN_REL_TOL of the block's largest plus Adam's
    amplification of the gradients' disagreement (2 lr min(1,
    TRAIN_REL_TOL G / |g|), G the block's largest gradient), the loss and
    the gradient norm within TRAIN_REL_TOL; the leaves kept whole (their gradients
    and parameters), the loss and the gradient norm bitwise equal on every
    rank."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models.model import Model, rank_blocks
    from repro_torch.optim.adamw import leaves, unflatten
    from repro_torch.train import init_train_state, make_train_step

    cfg = ssm_cfg(TRAIN_ARCH, TRAIN_F32_LAYERS, "float32")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=10, seed=seed)
    g = torch.Generator(device=mesh.device)
    g.manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab_size, (1, NCCL_TRAIN_SEQ + 1), device=mesh.device, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(model):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        state, specs = init_train_state(model, gen, tcfg)
        flat = leaves(state.params)
        grads = train_grads(torch, lambda *ps: model.loss(unflatten(state.params, list(ps)), batch)[0], flat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = make_train_step(model, tcfg, model.mesh)(state, batch)
        torch.cuda.synchronize()
        return unflatten(state.params, list(grads)), state.params, m, specs, (time.perf_counter() - t0) * 1e3

    one_g, one_p, one_m, specs, one_ms = run(Model(cfg, device=mesh.device))
    place = dict(mesh=mesh, specs=specs, cfg=cfg)
    one_g, one_p = (leaves(rank_blocks(t, **place)) for t in (one_g, one_p))  # this rank's blocks
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, mesh, device=mesh.device)
    got_g, got_p, got_m, _, ms = run(model)
    got_g, got_p = leaves(got_g), leaves(got_p)
    grad_err = max(leaf_errs(torch, got_g, one_g))
    lr = float(got_m["lr"])
    param_err = -math.inf  # the largest distance past its bound
    for a, e, ge in zip(got_p, one_p, one_g):  # the gradient's relative noise, at most 1 (a zero gradient: 1)
        noise = torch.nan_to_num(torch.clamp(TRAIN_REL_TOL * ge.abs().max() / ge.abs(), max=1.0), nan=1.0)
        excess = ((a - e).abs() - TRAIN_REL_TOL * e.abs().max() - 2 * lr * noise).max().item()
        param_err = max(param_err, excess)
    metric_err = max(abs(float(got_m[k]) - float(one_m[k])) / abs(float(one_m[k])) for k in ("loss", "grad_norm"))
    check(grad_err <= TRAIN_REL_TOL, f"rank {mesh.rank}: NCCL TP training gradients {grad_err:.3e} > {TRAIN_REL_TOL}")
    check(param_err <= 0, f"rank {mesh.rank}: NCCL TP training parameters {param_err:.3e} past their bound")
    check(metric_err <= TRAIN_REL_TOL, f"rank {mesh.rank}: NCCL TP training loss / grad norm {metric_err:.3e} > "
          f"{TRAIN_REL_TOL}")
    whole = [not s for s in model.sharded_leaves()]
    same_on_every_rank(mesh, [digest(t) for t, w in zip(got_g + got_p, whole + whole) if w]
                       + [digest(got_m["loss"]), digest(got_m["grad_norm"])],
                       "whole leaves' gradients and parameters, loss and grad norm after a TP train step (bitwise)")
    return dict(grad_err=grad_err, param_err=param_err, metric_err=metric_err, loss=float(got_m["loss"]),
                grad_norm=float(got_m["grad_norm"]), step_ms=ms, one_ms=one_ms, leaves=len(got_g),
                sharded=len(whole) - sum(whole))


def nccl_latent_seq(torch, mesh, seed: int) -> dict:
    """Phase 7's sequence cut over NCCL, one rank of four: DeepSeek-V3 at
    full width, its first NCCL_SEQ_LAYERS (dense) layers, float32, on this
    card alone, freed, then Model(cfg, ProcessGroupMesh over SEQ_GRID)
    from the same seed with ``seq_shard``: the rank holds its block of
    the latent cache over ``data`` (half of one card's), and a
    LM_SEQ-token prefill and TP_DECODE decode steps lie within TP_REL_TOL
    of one card's, bitwise equal on every rank. Dense layers: a float32
    MoE layer's experts, gathered whole over ``data`` by FSDP, took a rank
    past 80 GB in the whole phase 7 (62.5 GiB allocated beside its NCCL
    groups' buffers); the latent cache is the attention's."""
    from repro_torch.core import ProcessGroupMesh
    from repro_torch.models.model import Model

    cfg = moe_cfg("deepseek-v3-671b", dtype="float32", num_layers=NCCL_SEQ_LAYERS, first_k_dense=NCCL_SEQ_LAYERS)
    g = torch.Generator(device=mesh.device)
    g.manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab_size, (1, LM_SEQ + TP_DECODE), device=mesh.device, generator=g)

    def run(model, cut: bool):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        params, _ = model.init(gen)
        out, state = seq_runs(torch, model, params, toks, LM_SEQ, cut)
        return out, latent_bytes(state)

    one, one_bytes = run(Model(cfg), False)
    gc.collect()
    torch.cuda.empty_cache()
    grid = ProcessGroupMesh(grid=SEQ_GRID, axis_names=SEQ_AXES, timeout_s=NCCL_TIMEOUT_S)
    got, nbytes = run(Model(cfg, grid), True)
    errs = [lm_rel_err(a, b) for a, b in zip(got, one)]
    check(max(errs) <= TP_REL_TOL, f"rank {mesh.rank}: NCCL seq_shard {cfg.name} float32 vs one card {errs} > "
          f"{TP_REL_TOL}")
    same_on_every_rank(mesh, [digest(t) for t in got], f"{cfg.name} seq_shard float32 outputs (bitwise)")
    check(nbytes * SEQ_GRID[0] == one_bytes, f"rank {mesh.rank}: {cfg.name} holds {nbytes} B of latent cache, not "
          f"1/{SEQ_GRID[0]} of one card's {one_bytes} B")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(errs=errs, layers=cfg.num_layers, latent_bytes=nbytes, one_latent_bytes=one_bytes,
                coords=[grid.axis_index(a) for a in SEQ_AXES])


def nccl_tp(torch, mesh, fft_stage, seed: int) -> dict:
    """Phase 7's TP part, one rank: the float32 checks of TP_F32, one TP
    train step (``nccl_tp_train``), then (P > 1) Qwen2.5-32B at all 64
    layers served tensor-parallel; the FFT kernels' launches (0)."""
    from repro_torch.configs import get_config

    def run():
        out = {"f32": {f"{arch} {kw or ''}".strip(): nccl_tp_f32(torch, mesh, seed, arch, kw)
                       for arch, kw in TP_F32 + TP_F32_MORE}, "served": {}}
        gc.collect()
        torch.cuda.empty_cache()
        out["train"] = nccl_tp_train(torch, mesh, seed)
        gc.collect()
        torch.cuda.empty_cache()
        if mesh.p == math.prod(SEQ_GRID):
            out["latent_seq"] = nccl_latent_seq(torch, mesh, seed)
        if mesh.p > 1:
            r = nccl_served(torch, mesh, seed, get_config(LM_ARCH))
            r.pop("params")
            gc.collect()
            torch.cuda.empty_cache()
            out["served"][LM_ARCH] = r
        return out

    out, launches, _ = counted(torch, fft_stage, "NCCL TP", run, expect=())
    out["launches"] = launches
    return out


def print_nccl_tp(rep) -> None:
    who, m = f"NCCL rank {rep['rank']}/{rep['P']} TP", rep["tp"]
    for name, r in m["f32"].items():
        print(f"{who} {name} full width, {r['layers']} layers, float32: Model(cfg, ProcessGroupMesh) vs one card on "
              f"the same seed: hidden or logits ({LM_SEQ} tokens), prefill, {TP_DECODE} decode steps rel_err "
              f"{', '.join(f'{e:.3e}' for e in r['errs'])} (tol {r['tol']:.3e}), bitwise equal on every rank; weights "
              f"{r['gib']:.2f} GiB a rank vs {r['one_gib']:.2f} on one card; KV cache {r['kv_bytes']} B a rank vs "
              f"{r['one_kv_bytes']} B on one card (1/{rep['P']})", flush=True)
    if "latent_seq" in m:
        r = m["latent_seq"]
        print(f"{who} deepseek-v3-671b full width, its first {r['layers']} (dense) layers, float32, seq_shard on a {SEQ_GRID} grid "
              f"{SEQ_AXES} (this rank {r['coords']}): a {LM_SEQ}-token prefill and {TP_DECODE} decode steps vs one "
              f"card on the same seed, rel_err {', '.join(f'{e:.3e}' for e in r['errs'])} (tol {TP_REL_TOL}), "
              f"bitwise equal on every rank; latent cache {r['latent_bytes']} B a rank vs {r['one_latent_bytes']} B "
              f"on one card (1/{SEQ_GRID[0]})", flush=True)
    else:
        print(f"{who} the latent cache's sequence cut over NCCL needs {math.prod(SEQ_GRID)} cards; "
              f"{rep['P']} here", flush=True)
    r = m["train"]
    print(f"{who} training: {TRAIN_ARCH} full width, {TRAIN_F32_LAYERS} layers, float32, 1 x {NCCL_TRAIN_SEQ} tokens, "
          f"one make_train_step at lr {TRAIN_LR} on Model(cfg, ProcessGroupMesh) ({r['sharded']} of {r['leaves']} leaves "
          f"placed over the ranks) vs one card on the same seed: each rank's gradient blocks worst rel_err "
          f"{r['grad_err']:.3e} (tol {TRAIN_REL_TOL}), parameters within their bound (largest distance past it "
          f"{r['param_err']:.3e}), loss {r['loss']:.6f} / grad norm {r['grad_norm']:.6f} rel_err {r['metric_err']:.3e} "
          f"(tol {TRAIN_REL_TOL}); whole leaves, loss and grad norm bitwise equal on every rank; step {r['step_ms']:.1f} ms (host "
          f"clock) vs {r['one_ms']:.1f} on one card", flush=True)
    for arch, r in m["served"].items():
        print(f"{who} {arch} {r['layers']} layers bf16, phase 14's stream: {r['tokens']} tokens in {r['wall_s']:.2f} s, "
              f"{r['tok_s']:.1f} tok/s, time to first token p50 {r['ttft_p50_ms']:.1f} ms p99 {r['ttft_p99_ms']:.1f} ms; "
              f"decode step ({r['steps']} steps, full slots) device {r['decode_device_ms']:.2f} ms, host "
              f"{r['decode_host_ms']:.2f} ms to issue; weights {r['gib']:.2f} GiB a rank, peak {r['peak_gib']:.2f} GiB "
              f"(limit {LM_PEAK_LIMIT_GIB}), init {r['init_s']:.1f} s; {r['agreements']} agreements, "
              f"{r['agreement_ms']:.1f} ms; one decode step's collectives {r['collectives']}; tokens identical on "
              f"every rank", flush=True)


def tp_rank(rank: int, world: int, init_method: str, seed: int, out_dir: str) -> None:
    """Phase 7's TP part alone, one rank (see nccl_tp_phase)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import init_process_mesh
    from repro_torch.kernels import fft_stage

    mesh = init_process_mesh(rank, world, init_method, timeout_s=NCCL_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump({"rank": rank, "P": world, "tp": nccl_tp(torch, mesh, fft_stage, seed)}, fh)
    finally:
        dist.destroy_process_group()


def nccl_tp_phase(torch, seed: int) -> dict:
    """Phase 7's tensor-parallel part alone, one rank per visible card:
    the measurement of tensor parallelism on a host with four cards
    (``python3 -c "import sys, torch; sys.path.insert(0, 'src'); import
    chip_smoke as cs; cs.nccl_tp_phase(torch, 0)"``; ``nccl_moe_phase``
    serves the MoE models, tensor- and expert-parallel)."""
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(tp_rank, args=(world, f"file://{os.path.join(tmp, 'rendezvous')}", seed, tmp), nprocs=world,
                 join=True)
        reports = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(world)]
    print(nvidia_smi(), flush=True)
    for rep in reports:
        print_nccl_tp(rep)
    return reports[0]["tp"]


def moe_rank(rank: int, world: int, init_method: str, seed: int, out_dir: str) -> None:
    """Phase 7's MoE part alone, one rank (see nccl_moe_phase)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import init_process_mesh
    from repro_torch.kernels import fft_stage

    mesh = init_process_mesh(rank, world, init_method, timeout_s=NCCL_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump({"rank": rank, "P": world, "moe": nccl_moe(torch, mesh, fft_stage, seed)}, fh)
    finally:
        dist.destroy_process_group()


def nccl_moe_phase(torch, seed: int) -> dict:
    """Phase 7's MoE part alone, one rank per visible card: a measurement
    of expert parallelism on a host with four cards
    (``python3 -c "import sys, torch; sys.path.insert(0, 'src'); import
    chip_smoke as cs; cs.nccl_moe_phase(torch, 0)"``)."""
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(moe_rank, args=(world, f"file://{os.path.join(tmp, 'rendezvous')}", seed, tmp), nprocs=world,
                 join=True)
        reports = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(world)]
    print(nvidia_smi(), flush=True)
    for rep in reports:
        print(f"NCCL rank {rep['rank']}/{rep['P']}: its card's memory outside the rank's allocator before the MoE "
              f"part {rep['outside_gib']:.2f} GiB (its context, NCCL's buffers, any other process)", flush=True)
    for rep in reports:
        print_nccl_moe(rep)
    return reports[0]["moe"]


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
        report["faults"] = nccl_faults(torch, mesh, sim, x, plan_fft, seed, out_dir)
        del x
        torch.cuda.empty_cache()
        report["serving"] = nccl_serving(torch, mesh, fft_stage, seed)
        torch.cuda.empty_cache()
        report["rings"] = ring_cases(torch, mesh, seed)
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        report["outside_gib"] = (total - free - torch.cuda.memory_reserved()) / 2**30
        report["moe"] = nccl_moe(torch, mesh, fft_stage, seed)
        torch.cuda.empty_cache()
        report["tp"] = nccl_tp(torch, mesh, fft_stage, seed)
        torch.cuda.empty_cache()
        report["ddp"] = nccl_ddp(torch, mesh, fft_stage, seed)
        torch.cuda.empty_cache()
        report["fsdp"] = nccl_fsdp(torch, mesh, fft_stage, seed)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    except BaseException:  # said here: destroy_process_group waits on the other ranks, which may wait on this one
        print(f"NCCL rank {rank}/{world} failed:", flush=True)
        traceback.print_exc()
        sys.stderr.flush()
        raise
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


def nccl_faults(torch, mesh, sim, x, plan_fft, seed: int, tmp: str) -> dict:
    """Phase 7's fault part, one rank. Agreement: a FaultPlan that fires
    on rank 0 only (an empty one elsewhere) makes every rank raise at the
    same Exchange, far inside NCCL_TIMEOUT_S; the exhausted plan then
    runs clean and equals SimMesh. Elastic (P > 1): the ranks go from P
    to P/2 over dist.new_group (called on every rank), rank 0
    checkpointing the gathered state; the survivors' result must equal
    an uninterrupted P/2 ProcessGroupMesh run and SimMesh(P/2) bitwise,
    and the others wait at the final barrier."""
    import torch.distributed as dist

    from repro_torch.core import SimMesh
    from repro_torch.runtime import FailureInjector, FaultPlan, InjectedFault

    kw = dict(backend="scatter", local_impl="kernel")
    fp = FaultPlan.error(match="Exchange") if mesh.rank == 0 else FaultPlan()
    plan = plan_fft((N, N), mesh, faults=fp, **kw)
    block = mesh.split(x, ("model", None))[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raised = None
    try:
        plan.execute(block)
    except InjectedFault as e:
        raised = f"{type(e).__name__}: {e}"
    waited = time.perf_counter() - t0
    check(raised is not None and "on rank 0" in raised, f"rank {mesh.rank}: the agreed fault did not raise: {raised}")
    check(waited < NCCL_TIMEOUT_S / 10, f"rank {mesh.rank}: raising took {waited:.1f} s")
    got = mesh.gather([plan.execute(block)], ("model", None))
    err = rel_err(torch, got, plan_fft((N, N), sim, **kw).execute(x))
    check(err <= 1e-6, f"rank {mesh.rank}: the clean run after the fault disagrees with SimMesh")
    out = dict(raised=raised, waited_s=waited, events=len(fp.events), clean_rel_err_vs_sim=err)
    del got, block
    if mesh.p == 1:
        out["elastic"] = "P = 1: one rank cannot shrink (phase 12 shrinks SimMesh(4) to SimMesh(2))"
        return out
    x0, forcing = elastic_inputs(torch, seed, mesh.device)
    inj = FailureInjector(ELASTIC_FAIL_AT)
    half = mesh.p // 2
    got = elastic_run(torch, f"{tmp}/elastic-resume", {"n": mesh.p}, x0, forcing, inj)
    ref = elastic_run(torch, f"{tmp}/elastic-p{half}", {"n": half}, x0, forcing)
    el = dict(survivor="x" in got, fired=inj.fired_steps, restarts=got["restarts"])
    if el["survivor"]:
        sim_half = elastic_run(torch, f"{tmp}/elastic-sim{half}-rank{mesh.rank}", {"n": half}, x0, forcing,
                               make_mesh=lambda k: SimMesh(k, device=mesh.device))
        el.update(resumed_at=list(got["resumed_at"]), bitwise_vs_process_group=torch.equal(got["x"], ref["x"]),
                  bitwise_vs_sim=torch.equal(got["x"], sim_half["x"]))
        check(el["resumed_at"] == [ELASTIC_FAIL_AT, half] and el["bitwise_vs_process_group"] and el["bitwise_vs_sim"],
              f"rank {mesh.rank}: the resumed state differs from the uninterrupted P = {half} runs: {el}")
    else:
        check(got.get("left") and ref.get("left"), f"rank {mesh.rank}: a non-survivor ran the shrunk loop")
    dist.barrier()  # the non-survivors wait here for the survivors
    out["elastic"] = el
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
            if isinstance(r, dict) and key not in ("measured planner", "faults", "serving", "moe", "tp", "ddp", "fsdp"):
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
    for rep in reports:
        f = rep["faults"]
        print(f"NCCL rank {rep['rank']}/{rep['P']} fault agreement: FaultPlan.error on rank 0 only -> {f['raised']} "
              f"after {f['waited_s'] * 1e3:.1f} ms (timeout {NCCL_TIMEOUT_S} s), own events {f['events']}; clean run "
              f"after it rel_err vs SimMesh={f['clean_rel_err_vs_sim']:.3e} (tol 1e-06); elastic: {f['elastic']}",
              flush=True)
    for rep in reports:
        print_nccl_serving(rep)
    for rep in reports:
        print_rings(f"NCCL rank {rep['rank']}/{rep['P']} rings", rep["rings"])
    for rep in reports:
        print(f"NCCL rank {rep['rank']}/{rep['P']}: its card's memory outside the rank's allocator before the MoE "
              f"part {rep['outside_gib']:.2f} GiB (its context, NCCL's buffers, any other process)", flush=True)
    for rep in reports:
        print_nccl_moe(rep)
        print_nccl_tp(rep)
        print_nccl_ddp(rep)
        print_nccl_fsdp(rep)
    check(len({rep["measured planner"]["winner"] for rep in reports}) == 1, "the ranks' measured winners differ")
    for what in ("poison", "breaker"):  # the counters, not each rank's own error against torch.fft
        counters = [{k: v for k, v in rep["serving"][what].items() if not k.endswith("rel_err")} for rep in reports]
        check(all(c == counters[0] for c in counters), f"the ranks' SPMD serving {what} counters differ: {counters}")
    return reports[0]


def fsdp_rank(rank: int, world: int, init_method: str, seed: int, out_dir: str) -> None:
    """``--fsdp``: phase 7's FSDP part alone, one rank a card over NCCL."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import init_process_mesh
    from repro_torch.kernels import fft_stage

    mesh = init_process_mesh(rank, world, init_method, timeout_s=NCCL_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        t = time.perf_counter()
        rep = {"rank": rank, "P": world, "fsdp": nccl_fsdp(torch, mesh, fft_stage, seed)}
        rep["s"] = time.perf_counter() - t
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(rep, fh)
    finally:
        dist.destroy_process_group()


def fsdp_only(torch, seed: int) -> None:
    """``--fsdp``: phase 7's FSDP part over every card (``nccl_fsdp``: on
    four, Qwen2.5-32B at 8 layers too), then phase 20's check 6."""
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(fsdp_rank, args=(world, f"file://{os.path.join(tmp, 'rendezvous')}", seed, tmp), nprocs=world,
                 join=True)
        reports = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                reports.append(json.load(fh))
    for rep in reports:
        print_nccl_fsdp(rep)
        print(f"NCCL rank {rep['rank']}/{rep['P']} FSDP part {rep['s']:.1f} s", flush=True)
    print(f"phase 7's FSDP part with the spawn: {time.perf_counter() - t0:.1f} s", flush=True)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train_pg_launcher(torch, tmp)
    train_grid_step(torch, seed)
    print(f"training check 6: {time.perf_counter() - t:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true",
                    help="run phase 7's FSDP part over every card and phase 20's check 6 alone: nothing is built "
                         "and no result line is printed")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
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
    if args.fsdp:
        fsdp_only(torch, args.seed)
        print(smi, flush=True)
        return 0

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

    nccl = nccl_phase(torch, args.seed)  # phase 7 first: see the module's docstring
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
    by_path["nccl_c2c"] = nccl["c2c main path scatter pipeline=auto"]["launches"]
    by_path["nccl_real_poisson"] = nccl["real Poisson scatter pipeline=auto"]["launches"]
    grid = auto_grid_shape(torch.cuda.device_count())
    by_path["nccl_pencil_c2c"] = nccl[f"pencil c2c grid={grid[0]}x{grid[1]} scatter+scatter pipeline=auto"][
        "launches"]
    for arm in ("coalesced", "solo"):
        by_path[f"nccl_serving_{arm}"] = nccl["serving"][arm]["launches"]
    by_path["nccl_moe"] = nccl["moe"]["launches"]
    by_path["nccl_tp"] = nccl["tp"]["launches"]
    by_path["nccl_ddp"] = nccl["ddp"]["launches"]
    by_path["nccl_fsdp"] = nccl["fsdp"]["launches"]
    by_path["pencil_c2c"], shapes = pencil_c2c_phase(torch, args.seed, fft_stage, plan_fft, SimMesh, slab_ms)
    torch.cuda.empty_cache()
    time_shapes("pencil c2c", shapes)
    by_path["pencil_rfft3"], shapes = pencil_rfft3_phase(torch, args.seed, fft_stage, plan_fft, SimMesh, slab_rfft3_ms)
    torch.cuda.empty_cache()
    time_shapes("pencil rfft3", shapes)
    by_path["measured_race"] = measured_phase(torch, args.seed, fft_stage, plan_fft, SimMesh)
    torch.cuda.empty_cache()
    serving, shapes = serving_phase(torch, args.seed, fft_stage, SimMesh)
    by_path.update(serving)
    torch.cuda.empty_cache()
    time_shapes("serving", shapes)
    by_path["elastic_recovery"] = elastic_phase(torch, args.seed, fft_stage)
    torch.cuda.empty_cache()
    rings_phase(torch, args.seed, SimMesh)
    torch.cuda.empty_cache()
    by_path["lm_serving"] = lm_serving_phase(torch, args.seed, fft_stage, cm)
    by_path.update(moe_serving_phase(torch, args.seed, fft_stage, cm))
    by_path.update(tp_serving_phase(torch, args.seed, fft_stage, cm))
    by_path.update(ssm_serving_phase(torch, args.seed, fft_stage, cm))
    by_path.update(encdec_mesh_phase(torch, args.seed, fft_stage, cm))
    by_path.update(training_phase(torch, args.seed, fft_stage, cm))
    by_path["dryrun"] = dryrun_phase(torch, fft_stage, smi)
    for row in rows:  # the pack's rows count their own mode's launches
        key = f"{PACK} {row['mode']}" if "mode" in row else row["name"]
        row["launches"] = launches[key]
        row["launches_by_path"] = {path: counts[key] for path, counts in by_path.items()}

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
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
