#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failed check:

1. build: every CUDA source under src/repro_torch/kernels/csrc, compiled
   with nvcc for sm_90a, all at once; then the shared memory the C side
   sizes each bfloat16 gather block with (condensed_matmul_smem_bytes)
   must equal condensed_matmul.gather_geometry's at GEOMETRY_D_IN (the
   zoo configs' input widths among them).
2. kernels: the condensed gather kernel (K1) at every shape the serving
   path of full-width qwen3-1.7b gives it (wo, w_gate/w_up, w_down; decode
   B=4 and prefill B*T=128; bfloat16 and float32), then K4 (condensed over
   active rows), K5 (structured) and K6 (structured, gather inside; decode
   only) at the shapes of those stacks with half their neurons ablated.
   Each is held to its plain version within the stated tolerance, with
   the decode launch bitwise equal to the tiled launch, K6 bitwise equal
   to K5 and K4 bitwise equal to K1 on the same rows followed by a
   scatter; K6 also reports its sector bound (the 32-byte sectors of W
   that hold an active column). Then K5's decode launch and K6 with half
   of each stack's neurons ablated at random (random_ablation_phase: K6's
   element path), timed beside the library call and both bounds, with a
   per-layer line. Then K5 and K6 at ragged shapes
   (RAGGED_STRUCT: B 100 and 3, d_in 1000 and 1001, 777 of 1536 columns
   active at random, sentinels up to a_pad 896), bf16 and f32: plain
   version, sentinels dropped and ablated columns 0, the bitwise pairs.
   Then K2 (the condensed gather over int8 / fp8 codes with a
   float32 scale per neuron) at K1's shapes and K2-coa (the same over the
   surviving rows, stored through out_index) at K4's, each with int8 and
   fp8 codes, bf16 and f32 x, B=4 and B*T=128: decode == tiled bitwise
   (and, since K1's redesign, the default tiled launch == the smallest batch
   tile for K1, K4, K2 and K2-coa), K2-coa == K2 on the same rows then a scatter bitwise, and in f32
   K2 == K1(f32(codes)) * scales bitwise. Times are CUDA-event medians over
   replays of a CUDA graph of launches that cycle through enough copies of
   the weights to keep L2 cold. Then K3 (the values gradient) at the
   training shapes of those stacks, full and half of their rows, B*T = 128
   and 512, bf16 and f32, and at ragged shapes with each row's indices
   shuffled (RAGGED_K3): against its plain version, two launches bitwise
   equal, duplicate indices giving equal columns; the first of them again
   in forced pieces (slices of the slots, chunks of d_in) bitwise equal to
   one launch. Then K1, K2 (int8 and fp8 codes) and K4 at ragged shapes
   (RAGGED_GATHER: B 100 and 3, d_in 1000 and 1001, and d_in 40000 and
   40001, past what one bf16 panel holds, k 1 and 195, 777 rows with each
   row's indices shuffled, K4's last 77 of them sentinel rows), bf16 and
   f32: plain version, the bitwise pairs, K4 == K1 rows then a scatter; and
   K1 with duplicate indices (plain version, two launches bitwise). Last
   gather_layer_phase: K1 and K4 per layer at B*T = 512 (the [grad]
   forward), bf16 and f32, beside the library call and the bound. With its
   defaults it takes K1, K2, K4 and K2-coa at B = 4, 128 and 512; it calls
   only wrappers that older trees have too, so it times their kernels the
   same way in one call. Then kernel:zoo: K1 at every (d_in, d_out, k)
   of the ZOO configs' sparse stacks (gemma3-1b, qwen2-vl-7b,
   internlm2-20b, mistral-large-123b; k the realized fan-in of their ERK
   densities at 90%), bf16 and f32, B=4 and B*T=128, against its plain
   version (computed in neuron chunks at these widths), the decode launch
   bitwise the tiled launch, each shape's bf16 geometry printed (splits,
   passes, whether the decode kernel exists: up to d_in 6656), timed beside
   the plain version, torch.matmul on the dense masked weight and the byte
   bound, and one decode and one tiled layer a config. Then kernel:moe: the
   expert-grouped launches K1-moe and K2-moe (one launch for an MoE
   layer's E experts) at granite-moe-1b's (E 32) and kimi-k2's (E 384)
   expert stack shapes, MOE_ROWS rows an expert, bf16 and f32 (K2-moe on
   int8 codes): bitwise equal to E single K1 (K2) launches, within TOL of
   the plain version, timed beside it, torch.bmm over the dense masked
   expert weights and the bound, and one decode layer's experts a config.
3. slice: full-width qwen3-1.7b (28 layers, random weights from a seeded
   torch.Generator), SRigL ERK masks at 90%, condensed export, greedy
   generation at B=4, prompt 32, gen 16 on the condensed and the masked
   path, in bfloat16 and again in float32. The condensed run must launch
   K1 exactly 4 * 28 * (1 + 16) times; the two paths' tokens must agree
   except where the masked path's top-2 logit gap is a tie at that dtype.
   Every generate in phases 3-7 decodes by replaying a captured CUDA graph
   of one decode step (its launches counted once per replay); a
   [walls:<path>] line puts its wall beside the eager decode loop's, whose
   tokens must equal the replays' bitwise.
4. ablation: the same model with half of every stack's neurons ablated:
   condensed_over_active on the ablated masks (K4 4 * 28 * 17 times),
   structured on ablation-only masks (K5 4 * 28 * 17 times) and again with
   prefetch_gather (K6 4 * 28 * 16 times at decode, K5 4 * 28 at prefill),
   each against the masked path on its own masks, bf16 and f32.
5. auto: --path auto on the ablated masks at B=4 (bucket 8); each kernel
   must launch as often as the plan's decisions imply.
6. quant: --values-dtype int8 and fp8 on full-width qwen3-1.7b, bf16 and
   f32: condensed on the 90% masks and condensed_over_active on the ablated
   masks must launch K2 (K2-coa) 4 * 28 * 17 times and nothing else, and
   their tokens agree, except at near-ties, with a twin that serves the
   same codes and scales dequantized into a float export through K1 (K4);
   structured int8 on ablation-only masks (K5 4 * 28 * 17 times) gives its
   dequantized twin's tokens exactly (the twin dequantizes the panel as the
   format does, so this checks the launch counts; phase 8 holds the path to
   the CPU).
7. checkpoint: the int8 condensed serving tree saved with
   repro_torch.train.checkpoint.save and restored into a fresh template on
   the card gives identical arrays and identical tokens.
8. engine: the paged ServingEngine (block_size 16, gen_chunk 16), bf16:
   ENGINE_MIX (eight requests of batch 1-4, so groups at buckets 1 and 8,
   prompts 20-120, 8-40 new tokens) submitted two at a time between
   step(max_chunks=1) calls, then a second wave of the same shapes, on
   condensed (K1) and on auto over the ablated masks (K4), and the first
   four requests on int8 condensed (K2). A chunk replayed from a saved
   state must equal the eager chunk bitwise (tokens and written pages);
   live requests never share a page and every page comes back; the second
   wave captures no graph, runs no new prefill shape, has no cold result
   and launches each kernel as often as the plans' decisions imply; every
   second-wave request's tokens equal a standalone generate's, or part only
   at a logit near-tie (max(TIE_GAP, 2 x the bucket-padded prefill's logit
   noise)). Then the first four requests once more in float32 (K1), where a
   stream may part only below 1e-3. The condensed engine's bucket-8 pool,
   serving leaves and one eager decode step's memory go to [dryrun].
9. rows: whether torch.matmul gives other rows for other row counts M on
   the card (M = 4 vs 8, 8 vs 32, 128 vs 512; bf16 and f32; qwen3-1.7b's
   dense product shapes, the head through the embedding's transpose), and
   RMSNorm, the softmax and decode attention over a longer masked span;
   reported, not gated: it says why two correct paths' streams part.
10. kernel:spec: K1, K2, K4, K2-coa, K5 and K6 at the shapes speculation
   gives them (a bucket-8 draft step, 8 rows; its gamma = 3 verify, 32
   rows; sentinel and subset drafts from plan.derive_draft_leaf), against
   their plain versions, the 8-row launch bitwise the 32-row launch's
   first rows, K6 == K5.
11. profile: HardwareProfile.measure on the card (float32, as the
   reference), its cache round trip, the plan's decisions at buckets 1 to
   512 under the default and the measured profile; a decision that moves
   at bucket 8 is served end to end under both and both walls printed.
12. spec: self-draft speculative decoding in the paged engine, gamma = 3,
   ENGINE_MIX (a warm wave, then a timed one) beside plain graph decode on
   the same path and masks: condensed at draft ablation 0.5 (sentinel
   drafts, K4; verify K1) and 0.0 and in f32, structured on ablation-only
   masks (subset drafts and verify, K5). The draft and verify are replayed
   CUDA graphs, none new in the timed wave; the timed wave launches each
   kernel as the plans and draft kinds imply (gamma x 112 draft and 112
   verify launches a round); pages come back after each wave; the draft
   holds no value bytes of its own; each stream equals plain decode's or
   parts at a tie (f32: below 1e-3); at ablation 0.0 every rejected draft
   is at a tie. Prints acceptance, rounds, dispatches per token, draft and
   verify device ms, both tok/s and the reference's price under both
   profiles.
13. autotune: the launch-configuration search (sparse/autotune.py) at
   full width, bf16, B = 4, 32 and 128 (buckets 8, 32, 128), on the SRigL
   stacks' shapes: every candidate launch of K1, of K4 over half of each
   stack's rows, of K2 on int8 codes (bucket 8) and of K5 over the
   ablation-only masks' surviving columns, each bitwise, row by row, the
   default launch's output, the winner held to its plain version; per key
   the default's and the winner's microseconds and the candidates timed,
   and K5's beside the plan's price with and without the reference's
   one-hot epilogue term. Then ServingEngine.autotune(4) into a cache file
   of its own: a tuned condensed engine serves a B = 4 request with the
   untuned engine's tokens, bitwise, and 4 * 28 * 17 K1 launches; walls and
   a decode step's device ms beside each other. Then a speculative verify
   (gamma 3, 32 rows) with and without autotune(32)'s entries: device ms,
   tokens equal.
14. grad: loss_fn over full-width qwen3-1.7b's condensed serving tree (90%
   masks, a train batch of 8 x 64 tokens) backpropagated into the values,
   float32 and bfloat16, then condensed_over_active on the ablated masks:
   K3 launches exactly 4 * 28 times per backward and K1 (K4) 2 * 4 * 28
   (the forward, and again when each checkpointed block is recomputed), and
   in float32 the values gradient equals the masked loss's dense gradient
   gathered at the condensed indices within GRAD_F32_BOUND. The bf16
   gradients of both paths are reported against the float32 one, and the
   condensed one again with the backward's dx accumulated in float32.
   Then grad:structured: loss_fn over the structured tree on the
   ablation-only masks, float32, backpropagated into the dense weights
   (K5 4 * 28 times per forward, the structured linear's backward): each
   sparse stack's dW and the embedding's gradient within STRUCT_GRAD_BOUND
   of the same loss with every structured linear computed as
   structured_dense under autograd, ablated columns' dW exactly 0, and
   one layer per stack shape (B*T = 512) its dx and dW the same way.
15. train: full-width qwen3-1.7b from a seeded random init: the train CLI
   for 3 steps (8 x 64 tokens), then the Trainer with delta_t=2 for 4 steps
   (two SRigL updates): every loss and grad norm finite, after each update
   every active neuron's fan-in equal to its layer's new k', nnz <= k0 *
   d_out, grown weights 0 and mask_versions moved where the masks did;
   after a plain step AdamW's moments 0 off the mask. A step is timed and
   profiled, and the DST steps timed. Then rigl: the train CLI with
   --method rigl for 3 steps, the Trainer with delta_t=2 for 4 steps (two
   RigL updates: every layer's nnz its target_nnz, neuron_active all True,
   grown weights 0, mask_versions moved; n_ablated per stack) and one more
   step (moments 0 off the mask), the DST step's time beside SRigL's; the
   trained masks condensed at their realized max fan-in (k, mean fan-in,
   padding share and bf16 leaf bytes per stack beside SRigL's plan), served
   on condensed (K1 4 * 28 * 17 times) and masked with the tie rule, the
   condensed wall beside slice's SRigL one; K1 per layer at RigL's shapes
   (decode B=4 and tiled B=128, bf16 and f32, against its plain version,
   decode == tiled bitwise, beside the library call and the bound, one
   [kernel] JSON line each, "masks": "rigl"). Then set: the train CLI with
   --method set for 2 steps, the Trainer for 2 steps (one update): the
   survivors equal prune_survivors' on the weights the update saw, the
   grown positions were inactive and as many as pruned, and the update run
   twice more from the same state, seed and step regrows the same masks.
16. refresh: gen-1 is [train]'s seeded full-width TrainState, gen-2 the
   same after two train steps, one DST update and the reference's _bump
   rewire (the first stack's mask rolled by one input row). The paged
   ServingEngine, bf16, on condensed (K1), int8 condensed (K2),
   condensed_over_active over the half-ablated masks (K4) and masked,
   serves one request (B=4, prompt 32, 16 new tokens, chunks of 8): one
   chunk on gen-1, refresh(gen-2), the rest; a twin does the same with
   refresh(donate=False). Gates: the two engines' tokens equal bitwise;
   export_calls grew by the stacks whose version moved; a leaf whose
   shapes held kept every data_ptr (in place), and no graph was
   recaptured unless a leaf's shape moved; the in-place refresh's peak
   memory grew by less than the plan's weight bytes; a fresh engine from
   gen-2 serves a new request bitwise equal to the refreshed engine. Each
   line gives the refresh's seconds, leaves in place and rebuilt, graphs
   recaptured and max_memory_allocated before and during.
17. sync: a repro_torch.sync Publisher sends gen-1 (a snapshot) over a
   QueueChannel, an engine built with engine_from_snapshot (condensed,
   then int8 condensed) serves one chunk, the publisher sends gen-2 (a
   topology delta) and gen-2 again (a values-only delta), and step()
   drains both at the chunk boundary: no graph recaptured, the leaves
   written in place, tokens bitwise equal to [refresh]'s, the deltas
   smaller than the snapshot and the values-only one than the topology
   one; the record bytes, encode, decode and drain seconds are printed.
18. zoo: each ZOO config at its published width (gemma3-1b and
   qwen2-vl-7b at full depth, internlm2-20b at 16 of 48 layers and
   mistral-large-123b at 4 of 88: see ZOO), random weights and 90% SRigL
   masks from a seeded generator, bf16, served by ServingEngine with
   paged=None: gemma3-1b's grouped local/global layout (prompts of 600
   tokens against its 512-token window, so the ring caches wrap in prefill
   and in decode) and qwen2-vl-7b's M-RoPE on the slab path, the other two
   on the paged pool, each on masked and condensed: the counted request
   launches K1 4 * layers * (1 + GEN) times on condensed and nothing on
   masked, with the warm request's tokens; the paged engine's tokens equal
   standalone generate's (they may part at a near-tie), the eager decode
   loop's (masked: its step-by-step run's) equal the graph replays', and
   condensed is held to masked under the tie rule.
   Prints the layout, the depth, the graph and eager walls and
   max_memory_allocated.
19. moe: granite-moe-1b-a400m at its published width and depth (24
   layers, 32 experts top-8), random weights and 90% SRigL masks from a
   seeded generator, served by the paged ServingEngine with graph decode
   (B=4, prompt 32 + 16) in bf16 on masked, condensed, int8 condensed and
   auto: the counted request launches what its plan implies (condensed:
   K1 24 x 17 times for wo and K1-moe 3 x 24 x 17 for the experts; int8:
   K2 and K2-moe), a repeated request equals the one that took the same
   bucket rows, standalone graph decode equals the eager loop bitwise.
   Each path is held to masked's step-by-step run (int8 codes to their
   dequantized twin's): fed masked's tokens with masked's routing replayed,
   its logits and router logits stay within LOGIT_NOISE_BOUND (only the
   kernels differ); run on its own, its routing may first choose other
   experts only where that token's own router top-k gap is a near-tie, and
   its tokens part only at a logit tie or after such a routing change.
   Then f32 masked and condensed, where neither routing nor tokens part.
   Prints walls, launches, the logit differences and max_memory_allocated.
   Then spec:moe: self-draft speculative decoding on the same model at
   bucket 8 and gamma 3, bf16 condensed at draft ablation 0.5 and f32 at
   0.0, each beside a plain engine (a warm request, then a timed one): the
   draft runs wo on K4 and the experts on K4-moe, the verify routes the
   bucket's 32 rows as one group at capacity 10 (K1, K1-moe), as the
   reference's does. The draft and verify are captured graphs, none new in
   the timed wave, which launches what the plan and draft kinds imply;
   pages come back; the draft holds no value bytes; every round's verify
   (and the first round's drafts) equals its eager rerun on the card
   bitwise, each of its router calls one group at capacity 10; in f32 the
   first round's verify logits lie within LOGIT_NOISE_BOUND of the CPU
   plain-version verify's on the same inputs, the card's routing
   replayed; a stream parts from the plain engine's only at a tie or at
   or after the first token that a verify drop of its own row's (token,
   expert) assignments moved (counted per row and position from the eager
   rerun's router calls), and in f32 at ablation 0.0 a draft is rejected
   only so. Prints
   acceptance, rounds, the share of verify rounds that dropped, draft and
   verify device ms, both tok/s, launches a round and the SpecEstimate.
20. ssm: mamba2-130m at its published width and depth (24 layers, d_model
   768, d_inner 1536, 24 SSD heads of 64, state 128), random weights and
   90% SRigL masks from a seeded generator, served by the slab
   ServingEngine with graph decode (B=4, prompts of 200 tokens: four
   64-token SSD chunks, the last padded; 16 new tokens) in bf16 on masked,
   condensed, int8 condensed and auto, and in f32 on masked and condensed:
   the counted request launches what its plan implies (condensed: K1 3 x
   24 x 17 times, int8: K2) with the warm request's tokens, the engine's
   tokens == the eager decode loop's (masked: its step-by-step run's),
   each path held to masked's
   tokens under the tie rule (int8 to its dequantized twin's). Prints the
   walls and max_memory_allocated. Its kernel phase (kernel:ssm, after
   kernel:moe): K1 and K2 at mamba2's three stack shapes at decode B=4 and
   the prefill's B*T = 800, against the plain version, beside torch.matmul
   and the bound.
21. lead2: refresh and live sync on stacks with two leading axes, at the
   published width and depth: gemma3-1b's g_local (4, 5) on the slab engine
   and granite-moe-1b's expert stack (24, 32) on the paged one, one stack
   rewired and every param scaled by 1.01: the refresh lands after a
   request's first chunk (paged) or between requests (slab), then a sync
   drain of the same generation into an engine built from the stream;
   every leaf written in place, no graph recaptured, tokens equal a fresh
   gen-2 engine's (and the drained engine's the refreshed one's). Then
   autotune:moe: every K1-moe / K2-moe candidate at granite's expert keys,
   buckets 8 and 32, bitwise the default grouped launch, which is bitwise
   E single launches; ServingEngine.autotune at both buckets in bf16 and
   int8, the winners held to the plain version, tuned tokens == untuned
   request by request at B=4 and B=12 (bucket 32, its padding rows routing
   into the real rows' capacity), and which grouped launches of a request
   read an entry.
22. hybrid: zamba2-7b at its published width and depth (81 Mamba2 layers,
   d_model 3584, d_inner 7168; one shared attention + MLP block after
   every 6th layer, 13 applications, whose stacks have no leading axis),
   random weights and 90% SRigL masks drawn on the card, served by the slab
   ServingEngine with graph decode (B=4, prompts of 300 tokens: two
   256-token SSD chunks, the second padded; 16 new tokens) in bf16 on
   masked, condensed, int8 condensed and auto, then in f32 on masked,
   condensed and int8 condensed at a 15-layer cut (two groups and the 3
   m_rem layers): launches as the plan implies (condensed: K1 (3 x 81 + 4
   x 13) x 17 times), the counted request equal to the warm one, the
   engine's tokens == the eager loop's (masked: its step-by-step run's),
   each of the 13 shared KV slabs written,
   each path held to masked's tokens under the tie rule (int8 to its
   dequantized twin's), the bf16 noise bound at this depth
   HYBRID_NOISE_BOUND. Its kernel phase (kernel:hybrid, after kernel:ssm):
   K1 and K2 at zamba2's six stack shapes, decode B=4 and the prefill's
   1200 rows, against the plain version, beside torch.matmul and the
   bound, with a line per decode layer of each kind. Then hybrid_sync:
   lead2's refresh and sync at the 15-layer cut with one shared stack
   (lead ()) and one m_groups stack (lead (2, 6)) rewired.
23. vit: vit-b16 (the paper's own transformer: encoder-only, no RoPE, a
   class head over mean-pooled hidden states, uniform 90% densities) at
   its published width and depth, random weights and SRigL masks drawn on
   the card, its classification forward on frontend_embeds (256, 197,
   768) over plans built at the forward's 50,432 rows: bf16 masked,
   condensed (K1), int8 condensed (K2), condensed_over_active on half-
   ablated masks (K4), structured on their ablation-only projection (K5)
   and auto, then f32 masked / condensed at B=32: 48 launches of the
   path's kernel a forward, class logits held to masked's (int8: its
   dequantized twin's) within the measured bound and top-1 classes under
   the tie rule, repeated forwards bitwise; walls, images/s, peak memory.
   Then vit_train: the Trainer at full width, 32 images a step, 3 AdamW
   steps with one SRigL update (gamma_sal 0.95, ablation on). Its kernel
   phase (kernel:vit, after kernel:hybrid): K1, K2, K4 and K5 at its three
   stack shapes at 256 rows (the paper's batch-256 layer) and 50,432 (the
   first 4096 rows bitwise a 4096-row launch, that launch held to the
   plain version), beside torch.matmul and the bound.
24. audio: musicgen-medium (4 codebooks: embeddings summed, a head each)
   at its published width and depth (48 layers), random weights and 90%
   SRigL ERK masks drawn on the card, B=4 prompts (4, 4, 32) and 16 greedy
   tokens a codebook by prefill_step and 16 decode_steps (no serving loop
   takes audio prompts, as in the reference), bf16 masked, condensed, int8
   condensed and auto, f32 masked and condensed: K1 (K2) 4 x 48 x 17 =
   3264 launches a condensed (int8) request, a repeated request equal, every
   codebook's tokens held to masked's (int8: its twin's) under the tie
   rule. Its kernel phase (kernel:audio, after kernel:vit): K1 and K2 at
   its stack shapes, decode B=4 and the prefill's 128 rows.
25. dryrun (run after grad:structured, while the qwen3 setup lives):
   planning without allocation (launch/dryrun.py), every tensor on the
   meta device. qwen3-1.7b condensed on the [engine] group's
   pool: memory_allocated unchanged across the meta cells, the params' and
   the pool's bytes equal to what the card allocated, the abstract serving
   tree equal to the export in every axis but k (both k printed), and the
   meta decode step's peak beside the measured max_memory_allocated
   increase of one eager step (a finding). A process that sees no card
   (start_dryrun, started with the script) meanwhile runs every config's
   serve_zoo cell at its published width and full depth (kimi-k2-1t and
   mistral-large-123b too) and the train cells of DRYRUN_TRAIN; each
   cell's bytes are printed beside the card's memory.
26. reference: the smoke config on the card against the port's CPU path
   (plain versions), which the CPU tests hold to the JAX reference, on the
   condensed, condensed_over_active and structured paths, each with float,
   int8 and fp8 values: identical tokens, and the path's kernel launched
   (and the MoE and SSM smoke configs on condensed, float and int8);
   the smoke trainer (6 steps, delta_t=3) card vs CPU, a TrainState
   checkpoint round trip on the card, and the condensed loss's values
   gradient (K3) card vs CPU.

Every phase prints a [time] line, then its sub-stamps ([time:<phase>:<part>]:
setup, capture, serve, eager, checks, profile, release and so on, from
_part), and the script its total.

Imports only torch, numpy, the standard library and repro_torch. Prints
the card's name and power limit, a JSON line describing each kernel, and
last a JSON line with the device. Per-shape kernel numbers also go to
build/chip_smoke_kernels.json.
"""
from __future__ import annotations

import atexit
import contextlib
import gc
import json
import math
import os
import re
import shlex
import shutil
import signal
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

_T_START = time.perf_counter()
REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20
ARCH = "qwen3-1.7b"
BATCH, PROMPT, GEN = 4, 32, 16
REPEATS = 3  # timed generate runs per path and dtype (tokens must repeat exactly)
# kernel vs plain version: the k-sum runs in another order (f32 rounding),
# and a bf16 output may then round to the neighbouring value (one ulp)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=1e-5)}
# masked vs condensed tokens may part only at a top-2 logit gap below this
TIE_GAP = {"bfloat16": 0.05, "float32": 1e-3}
# Two correct paths' bf16 logits differ by more than TIE_GAP: per-output
# rounding of every linear compounds over 28 layers (measured at prefill,
# NVIDIA H100: up to 0.078 condensed, 0.14 structured, against masked). The
# ablation paths are therefore held to masked with a tie threshold of
# max(TIE_GAP, 2 * d), where d is the largest |logit difference| the two
# paths show on the same prefill (a top-2 swap needs a gap below 2 * d),
# and d itself must stay below this bound.
LOGIT_NOISE_BOUND = {"bfloat16": 0.25, "float32": 5e-4}
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = (  # key, wrapper (call), CUDA source, the TPU kernel it replaces
    ("K1", "condensed_matmul", CSRC + "condensed_matmul.cu",
     "src/repro/kernels/condensed_matmul.py:235"),
    ("K4", "condensed_over_active_matmul", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:274"),
    ("K5", "structured_matmul", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:217"),
    ("K6", "structured_matmul_prefetch", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:244"),
    ("K2", "condensed_matmul(scales=)", CSRC + "condensed_matmul.cu",
     "src/repro/kernels/condensed_matmul.py:254"),
    ("K2-coa", "condensed_over_active_matmul(scales=)", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:297"),
    ("K3", "condensed_matmul_dw", CSRC + "condensed_dw.cu",
     "src/repro/kernels/condensed_matmul.py:271"),
    # the expert-grouped launches: the reference's jax.vmap of K1's and
    # K2's Pallas kernels over an MoE layer's experts
    ("K1-moe", "condensed_matmul_grouped", CSRC + "condensed_matmul_grouped.cu",
     "src/repro/kernels/condensed_matmul.py:235"),
    ("K2-moe", "condensed_matmul_grouped(scales=)", CSRC + "condensed_matmul_grouped.cu",
     "src/repro/kernels/condensed_matmul.py:254"),
    # the rest of the expert stacks' bodies, grouped the same way
    ("K4-moe", "condensed_over_active_matmul_grouped", CSRC + "condensed_matmul_grouped.cu",
     "src/repro/kernels/structured_matmul.py:274"),
    ("K2-coa-moe", "condensed_over_active_matmul_grouped(scales=)",
     CSRC + "condensed_matmul_grouped.cu", "src/repro/kernels/structured_matmul.py:297"),
    ("K5-moe", "structured_matmul_grouped", CSRC + "structured_matmul_grouped.cu",
     "src/repro/kernels/structured_matmul.py:217"),
    ("K6-moe", "structured_matmul_prefetch_grouped", CSRC + "structured_matmul_grouped.cu",
     "src/repro/kernels/structured_matmul.py:244"),
    ("K3-moe", "condensed_matmul_dw_grouped", CSRC + "condensed_dw.cu",
     "src/repro/kernels/condensed_matmul.py:271"),
)
QUANT = ("int8", "fp8")  # the quantized --values-dtype choices
QUANT_REPEATS = 2  # timed generate runs per quantized path and dtype
ABLATION = 0.5  # fraction of each sparse stack's output neurons ablated
# the port's kernels as the profiler names them: K1, K2, K4 and K2-coa run
# gather_mma in bfloat16 and gather_rows_kernel in float32; K5 and K6 run
# structured_mma in bfloat16 and structured_kernel (decode, K6) or
# structured_f32_tiled in float32; K3 is dw_kernel
PORT_KERNEL_NAMES = ("gather_mma", "gather_rows_kernel", "structured_mma",
                     "structured_kernel", "structured_f32_tiled", "dw_kernel")
# the training phases: qwen3-1.7b at the train CLI's default batch and
# sequence (8 x 64 tokens per step)
TRAIN_BATCH, TRAIN_SEQ = 8, 64
TRAIN_TOKENS = TRAIN_BATCH * TRAIN_SEQ
# the [engine] phase: pages of 16 tokens, 16 decode steps a chunk, and
# eight requests (batch, prompt_len, gen_len): batches 1-4 (groups at
# buckets 1 and 8), prompts 20-120 (prompt buckets 32, 64 and 128), 8-40
# generated tokens
ENGINE_BLOCK, ENGINE_CHUNK = 16, 16
ENGINE_MIX = ((1, 20, 8), (2, 37, 40), (3, 64, 16), (4, 120, 24),
              (1, 90, 33), (2, 50, 12), (3, 100, 8), (4, 25, 20))


# the running phase's sub-stamps: the seconds since the previous mark, summed
# by part (main() resets it as each phase starts and prints it as it ends)
_PARTS: dict = {"t": 0.0, "parts": {}}


def _part(name: str) -> None:
    """Add the seconds since the previous mark to part ``name`` of the
    running phase, printed as a ``[time:<phase>:<part>]`` line after the
    phase's ``[time]`` line. The helpers mark what precedes them as
    "setup" (inits, masks, exports, engine builds: what no other part
    claims) and their own span as capture, serve, eager, checks, profile
    and so on."""
    now = time.perf_counter()
    _PARTS["parts"][name] = _PARTS["parts"].get(name, 0.0) + now - _PARTS["t"]
    _PARTS["t"] = now


def _release() -> None:
    """Collect what the caller dropped, then hand the card's cached free
    blocks back (the graphs and pools of freed engines included), timed as
    the parts release:gc and release:cache."""
    import torch
    _part("setup")
    gc.collect()
    _part("release:gc")
    torch.cuda.empty_cache()
    _part("release:cache")


def _time_ms(fn, arg_sets, reps: int = 5, iters: int = 30) -> float:
    """Device ms per call: ``iters`` calls cycling through ``arg_sets``
    (copies of the operands, so L2 stays cold) are captured in one CUDA
    graph, and the median over ``reps`` replays is timed with CUDA events.
    Replaying the graph keeps the host's per-call overhead out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (library handles, workspaces)
        for a in arg_sets[:3]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _timed_call(fn, *args):
    """(``fn(*args)``, the device ms of that one call by CUDA events): the
    plain version timed on the very call that holds a kernel to it, where
    it takes milliseconds and a graph of repeated calls would only repeat
    it."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _call_ms(fn, args, iters: int = 50) -> float:
    """Host-inclusive ms per eager call (what the serving loop pays)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _copies(nbytes: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def _ptxas_kernels(log: str) -> list[tuple[str, str]]:
    """(kernel, what ptxas -v said it uses) for each entry function in a log,
    names demangled where c++filt is at hand."""
    found, name, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), "0 bytes spill stores, 0 bytes spill loads"
        m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+ registers.*)", line)
        if m and name:
            found.append((name, f"{m.group(1)}; {spills}"))
            name = None
    filt = shutil.which("c++filt")
    if found and filt:
        names = subprocess.run([filt], input="\n".join(n for n, _ in found), text=True,
                               capture_output=True).stdout.splitlines()
        if len(names) == len(found):
            found = [(n.replace("(anonymous namespace)::", ""), u)
                     for n, (_, u) in zip(names, found)]
    return found


def start_build() -> dict:
    """Start nvcc on every CUDA source at once, in a thread, so that the
    compile overlaps the card's first use and the set-up before [build];
    ``build_phase`` waits for it."""
    import threading
    from repro_torch.kernels import _build
    job = {"names": sorted(p.stem for p in _build.CSRC.glob("*.cu")),
           "t0": time.perf_counter()}

    def run():
        try:
            _build.build(*job["names"])
        except Exception as e:  # noqa: BLE001 -- raised again in build_phase
            job["error"] = e

    job["thread"] = threading.Thread(target=run)
    job["thread"].start()
    return job


def build_phase(job: dict | None = None):
    from repro_torch.kernels import _build
    job = job or start_build()
    names = job["names"]
    job["thread"].join()
    if "error" in job:
        raise job["error"]
    print(f"[build] {', '.join(names)} in {time.perf_counter() - job['t0']:.1f}s from the "
          f"start of the compile (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in names:
        found = _ptxas_kernels(_build.build_logs.get(name, ""))
        if found:  # what ptxas said of the source's kernels
            regs = [int(re.match(r"\d+", u).group()) for _, u in found]
            spills = [int(re.search(r"(\d+) bytes spill stores", u).group(1)) for _, u in found]
            smem = [int(m.group(1)) for _, u in found for m in [re.search(r"(\d+) bytes smem", u)]
                    if m] or [0]
            print(f"[build] {name}: {_build.build_seconds[name]:.1f}s, {len(found)} kernels, "
                  f"registers {min(regs)}-{max(regs)}, static smem up to {max(smem)} bytes, "
                  f"spill stores up to {max(spills)} bytes")
            for fn, used in found:
                print(f"[build] {name}: {fn}: {used}")
    gather_geometry_check()


# the d_in at which the C side's shared memory must equal the wrapper's
# geometry: the CPU tests' values (tests/test_torch_condensed_matmul.py),
# then the input widths of the zoo configs' sparse stacks (ZOO: wo, w_gate
# and w_up, w_down), then the MoE expert stacks' (granite-moe-1b's w_gate,
# kimi-k2's)
GEOMETRY_D_IN = (1, 63, 64, 65, 511, 512, 513, 1000, 1001, 2048, 6144, 8192, 14336,
                 40_000, 40_001, 116_224, 1_000_000,
                 1152, 3584, 4096, 6912, 12288, 16384, 18944, 28672, 1024, 7168)


def gather_geometry_check() -> None:
    """The dynamic shared memory the C side sizes each bfloat16 block of
    K1/K2/K4/K2-coa with (``condensed_matmul_smem_bytes``) equals what
    ``gather_geometry`` computes, at every batch tile and GEOMETRY_D_IN, so
    the one Python geometry and the kernels' layout cannot drift apart."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm

    c_bytes = cm._lib().condensed_matmul_smem_bytes
    checked = 0
    for d_in in GEOMETRY_D_IN:
        geo = cm.gather_geometry(d_in, torch.bfloat16)
        for tile in cm.GATHER_ROWS[torch.bfloat16]:
            want = cm.mma_smem_bytes(tile, geo.block_neurons, geo.pass_rows, geo.passes)
            got = c_bytes(0, tile, geo.block_neurons, geo.pass_rows, geo.passes)
            if got != want:
                raise AssertionError(f"gather_mma at d_in={d_in}, {tile} rows: the C side "
                                     f"sizes {got} bytes, gather_geometry {want}")
            checked += 1
        if geo.decode_smem_bytes is not None:
            got = c_bytes(1, 0, 0, geo.split_rows, geo.splits)
            if got != geo.decode_smem_bytes:
                raise AssertionError(f"gather_mma_decode at d_in={d_in}: the C side sizes "
                                     f"{got} bytes, gather_geometry {geo.decode_smem_bytes}")
            checked += 1
    print(f"[build] gather geometry: the C side's shared memory == gather_geometry's in "
          f"{checked} cases ({len(GEOMETRY_D_IN)} d_in from 1 to {max(GEOMETRY_D_IN)}, every "
          f"batch tile)")


def kernel_phase(device):
    """K1 at every main-path shape; returns the per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(1)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    cases = []
    for (d_in, n_out), (name, k) in shapes.items():
        mask = topology.random_constant_fan_in_mask(gen, d_in, n_out, k)
        w = torch.randn((d_in, n_out), generator=gen, device=device) / k ** 0.5
        vals32, idx = topology.dense_to_condensed(w * mask, mask, k)
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            vals = vals32.to(dtype).contiguous()
            dense = topology.condensed_to_dense(vals32, idx, d_in).to(dtype).contiguous()
            isz = vals.element_size()
            weight_sets = [(vals.clone(), idx.clone())
                           for _ in range(_copies(n_out * k * (isz + 4)))]
            dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
            for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                y = cm.condensed_matmul(x, vals, idx)
                y_ref = ref.condensed_matmul_ref(x, vals, idx)
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), y_ref.float(), **TOL[dtype_name])
                err = (y.float() - y_ref.float()).abs().max().item()
                tiled, least = cm.TILED_ROWS[dtype], cm.GATHER_ROWS[dtype][0]
                if launch == "decode":
                    other = cm.condensed_matmul(x, vals, idx, block_b=tiled)  # tiled launch
                    same = torch.equal(cm.condensed_matmul_decode(x, vals, idx), other)
                    pair = f"decode == tiled({tiled})"
                else:
                    same = torch.equal(y, cm.condensed_matmul(x, vals, idx, block_b=least))
                    pair = f"tiled({tiled}) == tiled({least})"
                if not same:
                    raise AssertionError(f"K1 {name} {dtype_name} B={b}: {pair} is not bitwise")
                ms = _time_ms(cm.condensed_matmul, [(x, v, i) for v, i in weight_sets])
                plain_ms = _time_ms(ref.condensed_matmul_ref,
                                    [(x, v, i) for v, i in weight_sets], iters=10)
                library_ms = _time_ms(torch.matmul, [(x, wd) for wd in dense_sets])
                call_ms = _call_ms(cm.condensed_matmul, (x, vals, idx))
                nbytes = n_out * k * (isz + 4) + b * d_in * isz + b * n_out * isz
                ops = 2 * b * n_out * k
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                rec = dict(kernel="K1", stack=name, d_in=d_in, n_out=n_out, k=k,
                           dtype=dtype_name, batch=b, launch=launch, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, eager_call_ms=call_ms,
                           max_abs_err=err, bitwise=pair)
                cases.append(rec)
                print(f"[kernel] K1  {name:6s} {d_in}->{n_out} k={k} {dtype_name:8s} B={b:3d} "
                      f"{launch:6s}: ms {ms:.5f} | plain {plain_ms:.5f} | torch.matmul "
                      f"{library_ms:.5f} | bound {rec['bound_ms']:.5f} ({rec['bound_by']}) | "
                      f"eager call {call_ms:.5f} | max_abs_err {err:.3g} | {pair}: bitwise")
            del weight_sets, dense_sets
    torch.cuda.empty_cache()
    return cases


def _ablated(mask, frac: float):
    """``mask`` with the last ``frac`` of its output columns emptied."""
    import torch
    d_out = mask.shape[-1]
    cut = d_out - max(1, int(d_out * frac))
    return mask & (torch.arange(d_out, device=mask.device) < cut)


def _ablate_masks(reg, masks, frac: float):
    """Constant fan-in masks with SRigL-style neuron ablation on top (the
    reference's benchmarks/serve_paths.py _ablate_masks)."""
    from repro_torch.sparse import registry as REG
    out: dict = {}
    for s in reg:
        REG.set_path(out, s.path, _ablated(REG.get_path(masks, s.path), frac))
    return out


def _ablation_only(reg, masks, frac: float):
    """Masks that are purely neuron ablation: active columns fully dense,
    ablated ones empty (the reference's tests/test_plan.py _ablation_only),
    where the structured representation is exact."""
    import torch
    from repro_torch.sparse import registry as REG
    out: dict = {}
    for s in reg:
        m = REG.get_path(masks, s.path)
        REG.set_path(out, s.path, _ablated(torch.ones_like(m), frac))
    return out


def ablation_kernel_phase(device):
    """K4, K5 and K6 at every main-path shape of the ablated stacks; returns
    the per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(2)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    cases = []

    def record(kernel, name, d_in, d_out, dtype_name, b, launch, fn, arg_sets, plain,
               library, library_sets, nbytes, ops, err, pair):
        ms = _time_ms(fn, arg_sets)
        plain_ms = _time_ms(plain, arg_sets, iters=10)
        library_ms = _time_ms(library, library_sets)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
        rec = dict(kernel=kernel, stack=name, d_in=d_in, d_out=d_out, dtype=dtype_name,
                   batch=b, launch=launch, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, ops=ops, max_abs_err=err, bitwise=pair)
        cases.append(rec)
        print(f"[kernel] {kernel:3s} {name:6s} {d_in}->{d_out} {dtype_name:8s} B={b:3d} "
              f"{launch:6s}: ms {ms:.5f} | plain {plain_ms:.5f} | library {library_ms:.5f} | "
              f"bound {rec['bound_ms']:.5f} ({rec['bound_by']}) | max_abs_err {err:.3g} | "
              f"{pair}: bitwise")

    def check(kernel, got, want, dtype_name, what):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype_name],
                                   msg=lambda m: f"{kernel} {what}: {m}")
        return (got.float() - want.float()).abs().max().item()

    def same(kernel, a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{kernel} {what} is not bitwise")

    for (d_in, d_out), (name, k) in shapes.items():
        mask = _ablated(topology.random_constant_fan_in_mask(gen, d_in, d_out, k), ABLATION)
        w = torch.randn((d_in, d_out), generator=gen, device=device) / k ** 0.5
        only = _ablated(torch.ones_like(mask), ABLATION)
        stats = F.realized_stats(mask)
        a_pad = sm.padded_active_count(stats.max_active, d_out)
        print(f"[kernel] {name} {d_in}->{d_out}: k {stats.k}, a = a_pad = {a_pad}")
        if stats.k != k or a_pad != stats.max_active:
            raise AssertionError(f"{name}: k {stats.k}, a {stats.max_active}, a_pad {a_pad}")
        coa = F.CondensedOverActive.export_from_dense(w, mask, stats)
        ai = F.StructuredFanIn.from_mask(only).active_index
        ai_long = ai.long()
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            isz = torch.empty((), dtype=dtype).element_size()
            vals, idx, oi = coa.values.to(dtype).contiguous(), coa.indices, coa.out_index
            masked = (w * mask).to(dtype).contiguous()
            dense = w.to(dtype).contiguous()
            panel = sm._gather_columns(dense, ai)
            coa_sets = [(vals.clone(), idx.clone(), oi.clone())
                        for _ in range(_copies(vals.numel() * (isz + 4)))]
            masked_sets = [masked.clone() for _ in range(_copies(masked.numel() * isz))]
            panel_sets = [panel.clone() for _ in range(_copies(panel.numel() * isz))]
            dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
            for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                out_bytes = b * d_in * isz + b * d_out * isz

                # K4
                y = sm.condensed_over_active_matmul(x, vals, idx, oi, d_out)
                err = check("K4", y, ref.condensed_over_active_matmul_ref(x, vals, idx, oi, d_out),
                            dtype_name, f"{name} B={b}")
                tiled, least = cm.TILED_ROWS[dtype], cm.GATHER_ROWS[dtype][0]
                other = sm.condensed_over_active_matmul(
                    x, vals, idx, oi, d_out, block_b=tiled if launch == "decode" else least)
                pair = (f"decode == tiled({tiled})" if launch == "decode"
                        else f"tiled({tiled}) == tiled({least})")
                same("K4", y, other, f"{name} {dtype_name} B={b}: {pair}")
                k1 = ref._scatter_columns(cm.condensed_matmul(x, vals, idx), oi, d_out)
                same("K4", y, k1, f"{name} {dtype_name} B={b}: K4 == K1 then scatter")
                k1_rows_ms = _time_ms(lambda x_, v_, i_, o_: cm.condensed_matmul(x_, v_, i_),
                                      [(x, *c) for c in coa_sets])
                record("K4", name, d_in, d_out, dtype_name, b, launch,
                       lambda *a: sm.condensed_over_active_matmul(*a, d_out),
                       [(x, *c) for c in coa_sets],
                       lambda *a: ref.condensed_over_active_matmul_ref(*a, d_out),
                       torch.matmul, [(x, m) for m in masked_sets],
                       vals.numel() * (isz + 4) + oi.numel() * 4 + out_bytes,
                       2 * b * vals.numel(), err, pair + ", K4 == K1 then scatter")
                cases[-1]["k1_same_rows_ms"] = k1_rows_ms
                print(f"[kernel] K1  {name:6s} on K4's {vals.shape[0]} rows, unscattered: "
                      f"ms {k1_rows_ms:.5f}")

                # K5, on the gathered panel
                y = sm.structured_matmul_pregathered(x, panel, ai, d_out)
                want = ref.structured_matmul_ref(x, panel, ai, d_out)
                err = check("K5", y, want, dtype_name, f"{name} B={b}")
                tiled = sm.TILED_ROWS[dtype]
                if launch == "decode":
                    other = sm.structured_matmul_pregathered(x, panel, ai, d_out, block_b=tiled)
                    pair = f"decode == tiled({tiled})"
                else:
                    least = sm.STRUCTURED_ROWS[dtype][0]  # the smallest batch tile
                    other = sm.structured_matmul_pregathered(x, panel, ai, d_out, block_b=least)
                    pair = f"tiled({tiled}) == tiled({least})"
                same("K5", y, other, f"{name} {dtype_name} B={b}: {pair}")
                same("K5", y, sm.structured_matmul(x, dense, ai),
                     f"{name} {dtype_name} B={b}: pregathered == gathered by the wrapper")
                struct_bytes = panel.numel() * isz + ai.numel() * 4 + out_bytes
                struct_ops = 2 * b * panel.numel()
                record("K5", name, d_in, d_out, dtype_name, b, launch,
                       lambda x_, p_: sm.structured_matmul_pregathered(x_, p_, ai, d_out),
                       [(x, p) for p in panel_sets],
                       lambda x_, p_: ref.structured_matmul_ref(x_, p_, ai, d_out),
                       lambda x_, p_: torch.zeros((b, d_out), dtype=dtype, device=device)
                       .index_copy_(1, ai_long, torch.matmul(x_, p_)),
                       [(x, p) for p in panel_sets], struct_bytes, struct_ops, err, pair)

                # K6, decode only: reads the dense weight through active_index
                if launch == "decode":
                    y6 = sm.structured_matmul_prefetch(x, dense, ai)
                    err = check("K6", y6, want, dtype_name, f"{name} B={b}")
                    same("K6", y6, y, f"{name} {dtype_name} B={b}: K6 == K5 decode")
                    record("K6", name, d_in, d_out, dtype_name, b, launch,
                           lambda x_, w_: sm.structured_matmul_prefetch(x_, w_, ai),
                           [(x, d) for d in dense_sets],
                           lambda x_, w_: ref.structured_matmul_ref(
                               x_, sm._gather_columns(w_, ai), ai, d_out),
                           lambda x_, p_: torch.zeros((b, d_out), dtype=dtype, device=device)
                           .index_copy_(1, ai_long, torch.matmul(x_, p_)),
                           [(x, p) for p in panel_sets], struct_bytes, struct_ops, err,
                           "K6 == K5 decode")
                    sectors = _sector_bytes(ai, d_in, d_out, isz)
                    cases[-1]["sector_bytes"] = sectors + struct_bytes - panel.numel() * isz
                    cases[-1]["sector_bound_ms"] = (cases[-1]["sector_bytes"]
                                                    / HBM_BYTES_PER_S * 1e3)
                    print(f"[kernel] K6  {name:6s} sector bound: {sectors} bytes of W in the "
                          f"32-byte sectors that hold an active column, "
                          f"{cases[-1]['sector_bound_ms']:.5f} ms")
            del coa_sets, masked_sets, panel_sets, dense_sets
    torch.cuda.empty_cache()
    return cases


def _sector_bytes(active_index, d_in: int, d_out: int, elem: int) -> int:
    """Bytes of the dense (d_in, d_out) weight in the 32-byte sectors that
    hold an active column (sentinel slots excluded): the least K6 can read
    from HBM, since a sector moves whole."""
    import torch
    cols = active_index[active_index < d_out].long()
    if (d_out * elem) % 32 == 0:  # every row starts a sector
        return d_in * torch.unique(cols * elem // 32).numel() * 32
    rows = torch.arange(d_in, device=cols.device)
    return torch.unique((rows[:, None] * d_out + cols[None, :]) * elem // 32).numel() * 32


def random_ablation_phase(device) -> list:
    """K5's decode launch and K6 at every main-path shape with half of the
    neurons ablated at random (as SRigL ablates them), not in one block as
    the main path's masks do: K6 then takes its element path. bf16 and f32,
    B=4: within TOL of the plain version, ablated columns 0, K6 == K5
    bitwise; times, bound, sector bound and the library call as
    ablation_kernel_phase records them. Uses only wrapper calls that older
    trees of the port have too, so their kernels can be timed by the same
    function. Returns the per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(7)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), s.path[-1])
    per_layer = {"wo": 1, "w_gate": 2, "w_down": 1}
    cases, layer = [], {}
    for (d_in, d_out), name in shapes.items():
        n_active = d_out - max(1, int(d_out * ABLATION))
        act = torch.zeros(d_out, dtype=torch.bool, device=device)
        act[torch.randperm(d_out, generator=gen, device=device)[:n_active]] = True
        ai = F.active_index_from_bools(act, sm.padded_active_count(n_active, d_out))
        ai_long = ai.long()
        w = torch.randn((d_in, d_out), generator=gen, device=device) / d_in ** 0.5
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            isz = torch.empty((), dtype=dtype).element_size()
            dense = w.to(dtype).contiguous()
            panel = sm._gather_columns(dense, ai)
            x = torch.randn((BATCH, d_in), generator=gen, device=device).to(dtype)
            want = ref.structured_matmul_ref(x, panel, ai, d_out)
            y5 = sm.structured_matmul_pregathered(x, panel, ai, d_out)
            y6 = sm.structured_matmul_prefetch(x, dense, ai)
            torch.cuda.synchronize()
            what = f"{name} {d_in}->{d_out} {dtype_name} B={BATCH} random ablation"
            for kernel, y in (("K5", y5), ("K6", y6)):
                torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name],
                                           msg=lambda m: f"{kernel} {what}: {m}")
                if not torch.all(y[:, ~act] == 0):
                    raise AssertionError(f"{kernel} {what}: an ablated column is not 0")
            if not torch.equal(y5, y6):
                raise AssertionError(f"K6 {what}: not bitwise K5 decode")
            err = max((y.float() - want.float()).abs().max().item() for y in (y5, y6))
            panel_sets = [panel.clone() for _ in range(_copies(panel.numel() * isz))]
            dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
            nbytes = panel.numel() * isz + ai.numel() * 4 + BATCH * (d_in + d_out) * isz
            bound = max(nbytes / HBM_BYTES_PER_S,
                        2 * BATCH * panel.numel() / PEAK_OPS_PER_S[dtype_name]) * 1e3
            sector = (_sector_bytes(ai, d_in, d_out, isz) + nbytes
                      - panel.numel() * isz) / HBM_BYTES_PER_S * 1e3
            library_ms = _time_ms(
                lambda x_, p_: torch.zeros((BATCH, d_out), dtype=dtype, device=device)
                .index_copy_(1, ai_long, torch.matmul(x_, p_)), [(x, p) for p in panel_sets])
            times = {
                "K5": _time_ms(lambda x_, p_: sm.structured_matmul_pregathered(x_, p_, ai, d_out),
                               [(x, p) for p in panel_sets]),
                "K6": _time_ms(lambda x_, w_: sm.structured_matmul_prefetch(x_, w_, ai),
                               [(x, d) for d in dense_sets])}
            del panel_sets, dense_sets
            for kernel, ms in times.items():
                cases.append(dict(kernel=kernel, stack=name, d_in=d_in, d_out=d_out,
                                  dtype=dtype_name, batch=BATCH, launch="decode, random ablation",
                                  ms=ms, library_ms=library_ms, bound_ms=bound,
                                  sector_bound_ms=sector, max_abs_err=err))
                acc = layer.setdefault((kernel, dtype_name), [0.0, 0.0, 0.0, 0.0])
                for q, v in enumerate((ms, library_ms, bound, sector)):
                    acc[q] += v * per_layer[name]
            print(f"[kernel] {what}: K5 ms {times['K5']:.5f} | K6 ms {times['K6']:.5f} | "
                  f"library {library_ms:.5f} | bound {bound:.5f} | K6 sector bound {sector:.5f} | "
                  f"max_abs_err {err:.3g} | K6 == K5 decode: bitwise, ablated columns 0")
    for (kernel, dtype_name), (ms, lib, bound, sector) in layer.items():
        print(f"[kernel] {kernel} {dtype_name} one decode layer (wo + w_gate + w_up + w_down), "
              f"B={BATCH}, half the neurons ablated at random: {ms * 1e3:.2f} us | library "
              f"{lib * 1e3:.2f} | bound {bound * 1e3:.2f} | K6 sector bound {sector * 1e3:.2f}")
    torch.cuda.empty_cache()
    return cases


# ragged K5/K6 cases (B, d_in): d_out RAGGED_D_OUT with RAGGED_ACTIVE active
# columns drawn at random, so active_index carries d_out sentinels up to its
# 128-lane padding (a_pad 896); d_in 1000 takes 16-byte copies of x, 1001
# element loads; B 100 the tiled launch, B 3 the decode launch and K6
RAGGED_STRUCT = ((100, 1000), (3, 1000), (100, 1001), (3, 1001))
RAGGED_D_OUT, RAGGED_ACTIVE = 1536, 777


def ragged_structured_phase(device) -> None:
    """K5 and K6 at RAGGED_STRUCT, bf16 and f32: within TOL of the plain
    version; sentinel slots dropped and ablated columns exactly 0; the
    launch equal bitwise to the smallest batch tile (``STRUCTURED_ROWS``,
    1), and where B <= 8 also to the tiled launch and to K6; and K5 on the
    panel cut to the 777 active columns (no padding: the element path)
    bitwise equal to K5 on all 896."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F

    gen = torch.Generator(device=device).manual_seed(5)
    d_out = RAGGED_D_OUT
    act = torch.zeros(d_out, dtype=torch.bool, device=device)
    act[torch.randperm(d_out, generator=gen, device=device)[:RAGGED_ACTIVE]] = True
    ai = F.active_index_from_bools(act, sm.padded_active_count(RAGGED_ACTIVE, d_out))
    sentinels = int((ai == d_out).sum())
    if ai.shape[0] != 896 or sentinels != 896 - RAGGED_ACTIVE:
        raise AssertionError(f"ragged active_index: a_pad {ai.shape[0]}, {sentinels} sentinels")
    ai_active = ai[:RAGGED_ACTIVE].contiguous()

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} is not bitwise")

    for b, d_in in RAGGED_STRUCT:
        # scaled as the main path's weights are, so outputs are O(1)
        w32 = torch.randn((d_in, d_out), generator=gen, device=device) / d_in ** 0.5
        x32 = torch.randn((b, d_in), generator=gen, device=device)
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            w, x = w32.to(dtype).contiguous(), x32.to(dtype).contiguous()
            panel = sm._gather_columns(w, ai)
            what = (f"K5 ragged B={b} d_in={d_in} d_out={d_out} a={RAGGED_ACTIVE} "
                    f"a_pad={ai.shape[0]} {dtype_name}")
            y = sm.structured_matmul_pregathered(x, panel, ai, d_out)
            want = ref.structured_matmul_ref(x, panel, ai, d_out)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name],
                                       msg=lambda m: f"{what}: {m}")
            err = (y.float() - want.float()).abs().max().item()
            if not torch.all(y[:, ~act] == 0):
                raise AssertionError(f"{what}: an ablated column is not 0")
            tiled, least = sm.TILED_ROWS[dtype], sm.STRUCTURED_ROWS[dtype][0]
            pairs = [f"== tiled({least})"]
            same(y, sm.structured_matmul_pregathered(x, panel, ai, d_out, block_b=least),
                 f"{what}: launch == tiled({least})")
            if b <= sm.SMALL_BATCH_MAX:
                same(y, sm.structured_matmul_pregathered(x, panel, ai, d_out, block_b=tiled),
                     f"{what}: decode == tiled({tiled})")
                y6 = sm.structured_matmul_prefetch(x, w, ai)
                same(y6, y, f"{what}: K6 == K5 decode")
                pairs += [f"decode == tiled({tiled})", "K6 == K5 decode"]
            cut = sm.structured_matmul_pregathered(
                x, panel[:, :RAGGED_ACTIVE].contiguous(), ai_active, d_out)
            same(cut, y, f"{what}: K5 on the {RAGGED_ACTIVE}-column panel == on the padded one")
            pairs.append(f"{RAGGED_ACTIVE}-column panel == padded")
            print(f"[kernel] {what}: max_abs_err {err:.3g} | {sentinels} sentinel slots dropped, "
                  f"ablated columns 0 | {', '.join(pairs)}: bitwise")


# ragged K1/K2/K4 cases (B, d_in): no dimension a multiple of a tile, each
# row's indices shuffled; k of 1 and 195; RAGGED_ROWS rows (not a multiple
# of any neuron tile), K4's last RAGGED_PAD of them padding rows stored at
# the sentinel d_out = RAGGED_D_OUT; B 100 the tiled launch, B 3 the decode.
# d_in 40000 and 40001 lie past what one bf16 panel of 16 neurons holds:
# gather_mma builds each split's panel in two passes, and decodes too
RAGGED_GATHER = ((100, 1000), (3, 1000), (100, 1001), (3, 1001), (100, 40_000), (3, 40_001))
RAGGED_K = (1, 195)
RAGGED_ROWS, RAGGED_PAD = 777, 77


def ragged_gather_phase(device) -> None:
    """K1, K2 (int8 and fp8 codes) and K4 at RAGGED_GATHER x RAGGED_K, bf16
    and f32, each row's indices in random order: within TOL of the plain
    version; the launch bitwise equal to the smallest batch tile
    (``GATHER_ROWS[dtype][0]``) and, where B <= 8, to the tiled launch; K4
    bitwise K1's rows then a scatter, its sentinel rows dropped and its other
    columns 0; in f32 K2 bitwise K1(f32(q)) * s. Then K1 with duplicate
    indices (slot 1 := slot 0 in every row), at the first shape, k 195: within
    TOL of the plain version (which adds them), two launches bitwise equal."""
    import torch
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F

    gen = torch.Generator(device=device).manual_seed(6)
    d_out = RAGGED_D_OUT
    live = RAGGED_ROWS - RAGGED_PAD
    cols = torch.sort(torch.randperm(d_out, generator=gen, device=device)[:live]).values
    oi = torch.cat([cols, torch.full((RAGGED_PAD,), d_out, device=device)]).to(torch.int32)
    ablated = torch.ones(d_out, dtype=torch.bool, device=device)
    ablated[cols] = False

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} is not bitwise")

    def close(got, want, dtype_name, what):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype_name],
                                   msg=lambda m: f"{what}: {m}")
        return (got.float() - want.float()).abs().max().item()

    for b, d_in in RAGGED_GATHER:
        x32 = torch.randn((b, d_in), generator=gen, device=device)
        for k in RAGGED_K:
            mask = topology.random_constant_fan_in_mask(gen, d_in, RAGGED_ROWS, k)
            w = torch.randn((d_in, RAGGED_ROWS), generator=gen, device=device) / k ** 0.5
            v32, idx = topology.dense_to_condensed(w * mask, mask, k)
            shuffle = torch.argsort(torch.rand((RAGGED_ROWS, k), generator=gen, device=device), 1)
            idx = torch.gather(idx, 1, shuffle).contiguous()
            v32 = torch.gather(v32, 1, shuffle).contiguous()
            for dtype_name in ("bfloat16", "float32"):
                dtype = getattr(torch, dtype_name)
                x, vals = x32.to(dtype).contiguous(), v32.to(dtype).contiguous()
                tiled, least = cm.TILED_ROWS[dtype], cm.GATHER_ROWS[dtype][0]
                what = (f"ragged B={b} d_in={d_in} rows={RAGGED_ROWS} k={k} shuffled "
                        f"{dtype_name}")

                def pairs_of(fn, y, key):
                    same(y, fn(block_b=least), f"{key} {what}: launch == tiled({least})")
                    done = [f"== tiled({least})"]
                    if b <= cm.SMALL_BATCH_MAX:
                        same(y, fn(block_b=tiled), f"{key} {what}: decode == tiled({tiled})")
                        done.append(f"decode == tiled({tiled})")
                    return done

                y1 = cm.condensed_matmul(x, vals, idx)
                err = close(y1, ref.condensed_matmul_ref(x, vals, idx), dtype_name, f"K1 {what}")
                done = pairs_of(lambda **kw: cm.condensed_matmul(x, vals, idx, **kw), y1, "K1")
                print(f"[kernel] K1  {what}: max_abs_err {err:.3g} | {', '.join(done)}: bitwise")

                y4 = sm.condensed_over_active_matmul(x, vals, idx, oi, d_out)
                err = close(y4, ref.condensed_over_active_matmul_ref(x, vals, idx, oi, d_out),
                            dtype_name, f"K4 {what}")
                if not torch.all(y4[:, ablated] == 0):
                    raise AssertionError(f"K4 {what}: an ablated column is not 0")
                same(y4, ref._scatter_columns(y1, oi, d_out), f"K4 {what}: K1 rows then scatter")
                done = pairs_of(lambda **kw: sm.condensed_over_active_matmul(
                    x, vals, idx, oi, d_out, **kw), y4, "K4")
                print(f"[kernel] K4  {what}, {RAGGED_PAD} sentinel rows to d_out={d_out}: "
                      f"max_abs_err {err:.3g} | ablated columns 0, K4 == K1 rows then scatter, "
                      f"{', '.join(done)}: bitwise")

                for qdt in QUANT:
                    q, sc = F.quantize_values(v32, qdt)
                    y2 = cm.condensed_matmul(x, q, idx, scales=sc)
                    err = close(y2, ref.condensed_matmul_scaled_ref(x, q, idx, sc), dtype_name,
                                f"K2 {qdt} {what}")
                    done = pairs_of(lambda **kw: cm.condensed_matmul(
                        x, q, idx, scales=sc, **kw), y2, f"K2 {qdt}")
                    if dtype_name == "float32":
                        same(y2, cm.condensed_matmul(x, q.float(), idx) * sc,
                             f"K2 {qdt} {what}: K2 == K1(f32(q)) * s")
                        done.append("K2 == K1(f32(q)) * s")
                    print(f"[kernel] K2  {qdt} {what}: max_abs_err {err:.3g} | "
                          f"{', '.join(done)}: bitwise")

    # duplicate indices: slot 1 := slot 0 in every row
    b, d_in = RAGGED_GATHER[0]
    k = RAGGED_K[-1]
    mask = topology.random_constant_fan_in_mask(gen, d_in, RAGGED_ROWS, k)
    w = torch.randn((d_in, RAGGED_ROWS), generator=gen, device=device) / k ** 0.5
    v32, idx = topology.dense_to_condensed(w * mask, mask, k)
    idx = idx.clone()
    idx[:, 1] = idx[:, 0]
    x32 = torch.randn((b, d_in), generator=gen, device=device)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        x, vals = x32.to(dtype).contiguous(), v32.to(dtype).contiguous()
        what = f"K1 duplicate indices B={b} d_in={d_in} rows={RAGGED_ROWS} k={k} {dtype_name}"
        y = cm.condensed_matmul(x, vals, idx)
        err = close(y, ref.condensed_matmul_ref(x, vals, idx), dtype_name, what)
        same(y, cm.condensed_matmul(x, vals, idx), f"{what}: two launches")
        least = cm.GATHER_ROWS[dtype][0]
        same(y, cm.condensed_matmul(x, vals, idx, block_b=least), f"{what}: tiled({least})")
        print(f"[kernel] {what}: max_abs_err {err:.3g} | two launches, == tiled({least}): "
              f"bitwise")


# the batches gather_layer_phase times: decode, prefill (tiled) and the
# [grad] forward over a train batch
LAYER_BATCHES = ((BATCH, "decode"), (BATCH * PROMPT, "tiled"), (TRAIN_TOKENS, "grad"))


GATHER_KEYS = ("K1", "K2 int8", "K2 fp8", "K4", "K2-coa int8")


def gather_layer_phase(device, batches=LAYER_BATCHES, keys=GATHER_KEYS,
                       dtypes=("bfloat16", "float32")) -> list:
    """K1, K2 (int8 and fp8 codes), K4 and K2-coa (int8 codes), or those of
    ``keys``, at every main-path stack of full-width qwen3-1.7b (K4 and
    K2-coa with half the neurons ablated), at ``batches``: B = 4 (decode),
    128 (tiled) and 512 (the [grad] forward), in ``dtypes``: each within TOL
    of its plain version, then timed beside its library call (torch.matmul
    on the dense, masked or dequantized weight) and its bound, with one line
    per layer (wo + w_gate + w_up + w_down). Uses only wrapper calls that
    older trees of the port have too, so their kernels can be timed by the
    same function in the same call. Returns the per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(8)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    per_layer = {"wo": 1, "w_gate": 2, "w_down": 1}
    cases, layer = [], {}
    for (d_in, d_out), (name, k) in shapes.items():
        mask = topology.random_constant_fan_in_mask(gen, d_in, d_out, k)
        w = torch.randn((d_in, d_out), generator=gen, device=device) / k ** 0.5
        ablated = _ablated(mask, ABLATION)
        exports = {  # key: (export, out_index or None)
            "K1": lambda: (F.Condensed.export_from_dense(w, mask), None),
            "K2 int8": lambda: (F.Condensed.export_from_dense(w, mask, quantize_spec="int8"),
                                None),
            "K2 fp8": lambda: (F.Condensed.export_from_dense(w, mask, quantize_spec="fp8"),
                               None),
            "K4": lambda: (F.CondensedOverActive.export_from_dense(w, ablated), True),
            "K2-coa int8": lambda: (F.CondensedOverActive.export_from_dense(
                w, ablated, quantize_spec="int8"), True)}
        exports = {key: make() for key, make in exports.items() if key in keys}
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            isz = torch.empty((), dtype=dtype).element_size()
            for key, (fmt, coa) in exports.items():
                scales = getattr(fmt, "scales", None)
                vals = fmt.values if scales is not None else fmt.values.to(dtype).contiguous()
                idx = fmt.indices
                oi = fmt.out_index if coa else None
                deq = vals.float() if scales is None else F.dequantize_values(vals, scales)
                dense = topology.condensed_to_dense(deq, idx, d_in)
                if coa:
                    dense = ref._scatter_columns(dense, oi, d_out)
                dense = dense.to(dtype).contiguous()
                slot_bytes = vals.numel() * (vals.element_size() + 4) + (
                    0 if scales is None else scales.numel() * 4) + (0 if oi is None else
                                                                    oi.numel() * 4)
                sets = [(vals.clone(), idx.clone(), None if scales is None else scales.clone())
                        for _ in range(_copies(slot_bytes))]
                dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
                if coa:
                    def fn(x_, v_, i_, s_):
                        return sm.condensed_over_active_matmul(x_, v_, i_, oi, d_out, scales=s_)

                    def plain(x_, v_, i_, s_):
                        if s_ is None:
                            return ref.condensed_over_active_matmul_ref(x_, v_, i_, oi, d_out)
                        return ref.condensed_over_active_matmul_scaled_ref(x_, v_, i_, oi, s_,
                                                                           d_out)
                else:
                    def fn(x_, v_, i_, s_):
                        return cm.condensed_matmul(x_, v_, i_, scales=s_)

                    def plain(x_, v_, i_, s_):
                        if s_ is None:
                            return ref.condensed_matmul_ref(x_, v_, i_)
                        return ref.condensed_matmul_scaled_ref(x_, v_, i_, s_)
                for b, launch in batches:
                    x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                    y = fn(x, vals, idx, scales)
                    want = plain(x, vals, idx, scales)
                    torch.cuda.synchronize()
                    what = f"{key} {name} {dtype_name} B={b}"
                    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name],
                                               msg=lambda m: f"{what}: {m}")
                    err = (y.float() - want.float()).abs().max().item()
                    del want
                    ms = _time_ms(fn, [(x, *c) for c in sets])
                    library_ms = _time_ms(torch.matmul, [(x, dd) for dd in dense_sets])
                    nbytes = slot_bytes + b * d_in * isz + b * d_out * isz
                    ops = 2 * b * vals.numel()
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                    rec = dict(kernel=key, stack=name, d_in=d_in, d_out=d_out, k=k,
                               dtype=dtype_name, batch=b, launch=launch, ms=ms,
                               library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations",
                               bytes=nbytes, ops=ops, max_abs_err=err)
                    cases.append(rec)
                    acc = layer.setdefault((key, dtype_name, b), {})
                    acc[name] = rec
                    print(f"[layer] {what}: ms {ms:.5f} | library {library_ms:.5f} | bound "
                          f"{rec['bound_ms']:.5f} ({rec['bound_by']}) | max_abs_err {err:.3g}")
                del sets, dense_sets
    for (key, dtype_name, b), recs in layer.items():
        tot = {t: sum(r[t] * per_layer[n] for n, r in recs.items())
               for t in ("ms", "library_ms", "bound_ms")}
        stacks = ", ".join(f"{n} {r['ms'] * 1e3:.2f}" for n, r in recs.items())
        print(f"[layer] {key} {dtype_name} B={b} one layer (wo + w_gate + w_up + w_down): "
              f"{tot['ms'] * 1e3:.2f} us | library {tot['library_ms'] * 1e3:.2f} | bound "
              f"{tot['bound_ms'] * 1e3:.2f} | per stack (us) {stacks}")
    torch.cuda.empty_cache()
    return cases


def quant_kernel_phase(device):
    """K2 at K1's main-path shapes and K2-coa at K4's (half of each stack's
    neurons ablated), int8 and fp8 codes, bf16 and f32 x; returns the
    per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(3)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    cases = []

    def same(kernel, a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{kernel} {what} is not bitwise")

    for (d_in, d_out), (name, k) in shapes.items():
        mask = topology.random_constant_fan_in_mask(gen, d_in, d_out, k)
        w = torch.randn((d_in, d_out), generator=gen, device=device) / k ** 0.5
        ablated = _ablated(mask, ABLATION)
        for qdt in QUANT:
            full = F.Condensed.export_from_dense(w, mask, quantize_spec=qdt)
            coa = F.CondensedOverActive.export_from_dense(w, ablated, quantize_spec=qdt)
            if full.values.shape[-1] != k or coa.values.shape[0] != d_out // 2:
                raise AssertionError(f"{name} {qdt}: k {full.values.shape[-1]}, a "
                                     f"{coa.values.shape[0]}")
            oi = coa.out_index
            for dtype_name in ("bfloat16", "float32"):
                dtype = getattr(torch, dtype_name)
                isz = torch.empty((), dtype=dtype).element_size()
                kernels = {  # key: (codes, indices, scales, out_index or None)
                    "K2": (full.values, full.indices, full.scales, None),
                    "K2-coa": (coa.values, coa.indices, coa.scales, oi),
                }
                for key, (q, idx, sc, out_index) in kernels.items():
                    rows = q.shape[0]
                    deq = topology.condensed_to_dense(F.dequantize_values(q, sc), idx, d_in)
                    if out_index is not None:  # rows to their dense columns
                        deq = ref._scatter_columns(deq, out_index, d_out)
                    deq = deq.to(dtype).contiguous()
                    meta_bytes = rows * 4 + (rows * 4 if out_index is not None else 0)
                    weight_bytes = q.numel() * 5 + meta_bytes  # codes + int32 indices
                    sets = [(q.clone(), idx.clone(), sc.clone())
                            for _ in range(_copies(weight_bytes))]
                    dense_sets = [deq.clone() for _ in range(_copies(deq.numel() * isz))]
                    if out_index is None:
                        def fn(x_, q_, i_, s_, block_b=None):
                            return cm.condensed_matmul(x_, q_, i_, scales=s_, block_b=block_b)
                        plain = ref.condensed_matmul_scaled_ref
                    else:
                        def fn(x_, q_, i_, s_, block_b=None):
                            return sm.condensed_over_active_matmul(
                                x_, q_, i_, out_index, d_out, scales=s_, block_b=block_b)

                        def plain(x_, q_, i_, s_):
                            return ref.condensed_over_active_matmul_scaled_ref(
                                x_, q_, i_, out_index, s_, d_out)
                    for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                        x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                        what = f"{name} {qdt} {dtype_name} B={b}"
                        y = fn(x, q, idx, sc)
                        want = plain(x, q, idx, sc)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name],
                                                   msg=lambda m: f"{key} {what}: {m}")
                        err = (y.float() - want.float()).abs().max().item()
                        tiled, least = cm.TILED_ROWS[dtype], cm.GATHER_ROWS[dtype][0]
                        pairs = [f"decode == tiled({tiled})" if launch == "decode"
                                 else f"tiled({tiled}) == tiled({least})"]
                        same(key, y, fn(x, q, idx, sc,
                                        block_b=tiled if launch == "decode" else least),
                             f"{what}: {pairs[0]}")
                        if out_index is None and dtype_name == "float32":
                            same(key, y, cm.condensed_matmul(x, q.float(), idx) * sc,
                                 f"{what}: K2 == K1(f32(q)) * s")
                            pairs.append("K2 == K1(f32(q)) * s")
                        if out_index is not None:
                            rows_y = cm.condensed_matmul(x, q, idx, scales=sc)
                            same(key, y, ref._scatter_columns(rows_y, out_index, d_out),
                                 f"{what}: K2-coa == K2 rows then scatter")
                            pairs.append("K2-coa == K2 rows then scatter")
                        ms = _time_ms(fn, [(x, *c) for c in sets])
                        plain_ms = _time_ms(plain, [(x, *c) for c in sets], iters=10)
                        library_ms = _time_ms(torch.matmul, [(x, dd) for dd in dense_sets])
                        nbytes = weight_bytes + b * d_in * isz + b * d_out * isz
                        ops = 2 * b * q.numel() + b * rows  # the FMAs and the scale multiply
                        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                        t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                        rec = dict(kernel=key, stack=name, d_in=d_in, d_out=d_out, rows=rows,
                                   k=k, codes=qdt, dtype=dtype_name, batch=b, launch=launch,
                                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=max(t_bytes, t_ops),
                                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                                   bytes=nbytes, ops=ops, max_abs_err=err,
                                   bitwise=", ".join(pairs))
                        cases.append(rec)
                        print(f"[kernel] {key:6s} {name:6s} {d_in}->{d_out} rows={rows} k={k} "
                              f"{qdt:4s} {dtype_name:8s} B={b:3d} {launch:6s}: ms {ms:.5f} | "
                              f"plain {plain_ms:.5f} | torch.matmul (dequantized) "
                              f"{library_ms:.5f} | bound {rec['bound_ms']:.5f} "
                              f"({rec['bound_by']}) | max_abs_err {err:.3g} | "
                              f"{rec['bitwise']}: bitwise")
                    del sets, dense_sets, deq
    torch.cuda.empty_cache()
    return cases


def _k3_tol(want):
    """K3 vs its plain version: the batch is summed in another order in
    float32 (bf16 products are exact in float32), so rtol 1e-5 and an atol
    of 1e-5 of the largest |dw| (a few float32 ulps of the large sums)."""
    return dict(rtol=1e-5, atol=1e-5 * want.abs().max().item())


def _k3_check(what: str, dy, x, idx) -> tuple[float, float]:
    """K3 against its plain version within _k3_tol, two launches bitwise
    equal, and duplicate indices (slot 1 := slot 0) giving equal columns;
    returns the largest |difference| from the plain version and max |dw|."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    dw = cm.condensed_matmul_dw(dy, x, idx)
    want = ref.condensed_matmul_dw_ref(dy, x, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(dw, want, **_k3_tol(want), msg=lambda m: f"{what}: {m}")
    if not torch.equal(dw, cm.condensed_matmul_dw(dy, x, idx)):
        raise AssertionError(f"{what}: two launches are not bitwise equal")
    dup = idx.clone()
    dup[:, 1] = dup[:, 0]  # duplicate indices: each slot gets its own entry
    dd = cm.condensed_matmul_dw(dy, x, dup)
    if not torch.equal(dd[:, 0], dd[:, 1]):
        raise AssertionError(f"{what}: duplicate indices gave unequal columns")
    return (dw - want).abs().max().item(), want.abs().max().item()


def _k3_plan(x, idx) -> str:
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    p = cm.dw_plan(x.shape[1], idx.shape[0], x.dtype,
                   torch.cuda.get_device_properties(x.device).multi_processor_count)
    return f"{p.route} grid {p.grid[0]}x{p.grid[1]}" + (f", {p.stages} stages" if p.stages else "")


# ragged K3 cases (B, d_in, rows, k, index range): no dimension a multiple
# of a tile or chunk (rows % 8 != 0: element loads of dy); d_in 1000 gives
# 56 tiles (one block per SM, the 4-stage ring), 6102 gives 336 (two per
# SM; d_in % 8 != 0: element loads of x), and indices confined to [0, 256)
# give rows whose slots all lie in two tiles
RAGGED_K3 = ((100, 1000, 777, 97, None), (100, 6102, 777, 97, None), (100, 6102, 777, 97, 256))
# the first case again in pieces of at most 40 slots and 256 inputs
K3_PIECE_LIMITS = (40, 256)


def dw_kernel_phase(device):
    """K3 at every main-path stack of full-width qwen3-1.7b (wo, w_gate/w_up,
    w_down) and at the 50%-ablated row counts the condensed_over_active
    backward sees, B*T = 128 and 512, bf16 and f32, then at RAGGED_K3 with
    each row's indices shuffled: against its plain version, two launches
    bitwise equal, duplicate indices giving equal columns, and the first
    again in forced pieces (K3_PIECE_LIMITS) bitwise equal to one launch;
    returns the per-case records of the main-path shapes."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(4)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    cases = []
    for (d_in, d_out), (name, k) in shapes.items():
        for rows in (d_out, d_out - max(1, int(d_out * ABLATION))):
            mask = topology.random_constant_fan_in_mask(gen, d_in, rows, k)
            _, idx = topology.dense_to_condensed(mask.float(), mask, k)
            for dtype_name in ("bfloat16", "float32"):
                dtype = getattr(torch, dtype_name)
                isz = torch.empty((), dtype=dtype).element_size()
                for b in (BATCH * PROMPT, TRAIN_TOKENS):
                    dy = torch.randn((b, rows), generator=gen, device=device).to(dtype)
                    x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                    what = f"K3 {name} rows={rows} {dtype_name} B*T={b}"
                    err, max_dw = _k3_check(what, dy, x, idx)
                    nbytes = b * (rows + d_in) * isz + 2 * rows * k * 4
                    sets = [(dy.clone(), x.clone(), idx.clone())
                            for _ in range(_copies(nbytes))]
                    ms = _time_ms(cm.condensed_matmul_dw, sets)
                    plain_ms = _time_ms(ref.condensed_matmul_dw_ref, sets, iters=10)
                    idx_t = [(dy_, x_, i_.long().T.contiguous()) for dy_, x_, i_ in sets]

                    def library(dy_, x_, it_):  # the dense weight gradient, then the gather
                        return torch.gather(torch.matmul(x_.T, dy_), 0, it_)
                    library_ms = _time_ms(library, idx_t)
                    ops = 2 * b * rows * k
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                    rec = dict(kernel="K3", stack=name, d_in=d_in, d_out=d_out, rows=rows, k=k,
                               dtype=dtype_name, batch=b, launch="train", ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations",
                               bytes=nbytes, ops=ops, max_abs_err=err,
                               plan=_k3_plan(x, idx),
                               bitwise="two launches, duplicate columns")
                    cases.append(rec)
                    print(f"[kernel] K3  {name:6s} {d_in}->{d_out} rows={rows} k={k} "
                          f"{dtype_name:8s} B*T={b:3d}: ms {ms:.5f} | plain {plain_ms:.5f} | "
                          f"matmul(x.T, dy) + gather {library_ms:.5f} | bound "
                          f"{rec['bound_ms']:.5f} ({rec['bound_by']}) | max_abs_err {err:.3g} "
                          f"(max |dw| {max_dw:.3g}) | {rec['plan']} | two launches, "
                          f"duplicate columns: bitwise")
                    del sets, idx_t
    for b, d_in, rows, k, span in RAGGED_K3:
        if span is None:
            mask = topology.random_constant_fan_in_mask(gen, d_in, rows, k)
            _, idx = topology.dense_to_condensed(mask.float(), mask, k)
        else:
            idx = torch.randint(0, span, (rows, k), generator=gen, device=device,
                                dtype=torch.int32)
        shuffle = torch.argsort(torch.rand((rows, k), generator=gen, device=device), dim=1)
        idx = torch.gather(idx, 1, shuffle).contiguous()
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            dy = torch.randn((b, rows), generator=gen, device=device).to(dtype)
            x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
            what = (f"K3 ragged B={b} d_in={d_in} rows={rows} k={k} indices in "
                    f"[0, {span or d_in}) shuffled {dtype_name}")
            err, max_dw = _k3_check(what, dy, x, idx)
            print(f"[kernel] {what}: max_abs_err {err:.3g} (max |dw| {max_dw:.3g}) | "
                  f"{_k3_plan(x, idx)} | plain version within tolerance, two launches, "
                  f"duplicate columns: bitwise")
            if span is None and d_in == RAGGED_K3[0][1]:
                # the pieces a shape past one launch's limits runs in, forced
                # small: bitwise one launch, and one count per call
                pieces = cm.dw_pieces(d_in, k, K3_PIECE_LIMITS)
                before = cm.condensed_matmul_dw.launches
                dp = cm.condensed_matmul_dw(dy, x, idx, limits=K3_PIECE_LIMITS)
                if cm.condensed_matmul_dw.launches != before + 1:
                    raise AssertionError(f"{what}: pieces counted "
                                         f"{cm.condensed_matmul_dw.launches - before} launches")
                if not torch.equal(dp, cm.condensed_matmul_dw(dy, x, idx)):
                    raise AssertionError(f"{what}: in pieces is not bitwise one launch")
                print(f"[kernel] {what} in {len(pieces.slots)} slot slices x "
                      f"{len(pieces.inputs)} d_in chunks (limits {K3_PIECE_LIMITS}): bitwise "
                      f"one launch, 1 launch counted")
    torch.cuda.empty_cache()
    return cases


def _device_profile(fn, label: str, what: str = f"generate {BATCH}x{PROMPT}+{GEN}") -> None:
    """Device busy share and the kernels that take the device time of one
    call of ``fn`` (``what`` names it), from torch.profiler tracing the
    device activity only (the host-side events were never read; tracing
    them cost seconds a call), wall time from an unprofiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    _part("setup")
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():  # device-side records only: kernels and copies
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    rows = [(name, ms, count) for name, (ms, count) in by_name.items()]
    _part("profile")
    if not rows:
        print(f"[profile:{label}] device time not measured (no CUDA events)")
        return
    device_ms = sum(r[1] for r in rows)
    ours = [r for r in rows if any(k in r[0] for k in PORT_KERNEL_NAMES)]
    ours_ms = sum(r[1] for r in ours)
    print(f"[profile:{label}] {what}: wall {wall_ms:.2f} ms, "
          f"device busy {device_ms:.3f} ms ({device_ms / wall_ms:.1%}), idle "
          f"{1 - device_ms / wall_ms:.1%}; port kernels {ours_ms:.3f} ms in "
          f"{sum(r[2] for r in ours)} launches ({ours_ms / device_ms:.1%} of device time)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile:{label}]   {ms:9.3f} ms {count:6d}x {key[:90]}")


def _rates(tok_s: dict) -> str:
    return "; ".join(f"{p} median {statistics.median(r):.1f} tok/s (min {min(r):.1f}, max "
                     f"{max(r):.1f}, n={len(r)})" for p, r in tok_s.items())


def _first_divergence(a, b):
    """Per stream: index of the first differing token, or None."""
    out = []
    for ra, rb in zip(a.tolist(), b.tolist()):
        out.append(next((j for j, (p, q) in enumerate(zip(ra, rb)) if p != q), None))
    return out


def _masked_gaps(cfg, model, prompts, gen_len: int):
    """The masked path's own greedy run, step by step: its tokens and the
    top-2 logit gap at each generated position."""
    import torch
    from repro_torch.models import model as M
    _part("setup")
    with torch.inference_mode():
        b, t = prompts.shape
        cache = M.init_cache(cfg, b, t + gen_len, device=prompts.device)
        logits, cache = M.prefill_step(cfg, model.compute, model.serving,
                                       {"tokens": prompts}, cache)
        toks, gaps = [], []
        for step in range(gen_len):
            if not torch.isfinite(logits[:, :cfg.vocab_size]).all():
                raise AssertionError("non-finite logits on the masked path")
            top2 = logits.topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks.append(cur[:, 0])
            if step + 1 < gen_len:
                logits, cache = M.decode_step(cfg, model.compute, model.serving,
                                              {"tokens": cur}, cache)
        out = torch.stack(toks, 1), torch.stack(gaps, 1)
    _part("checks")
    return out


def _kernel_counters() -> dict:
    """Each kernel's launch counter: its wrapper function and the attribute
    the wrapper adds to (K2 and K2-coa count on K1's and K4's wrappers, K3
    on condensed_matmul_dw, K1-moe and K2-moe on condensed_matmul_grouped,
    K4-moe and K2-coa-moe on condensed_over_active_matmul_grouped)."""
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import structured_matmul as sm
    return {"K1": (cm.condensed_matmul, "launches"),
            "K4": (sm.condensed_over_active_matmul, "launches"),
            "K5": (sm.structured_matmul, "launches"),
            "K6": (sm.structured_matmul_prefetch, "launches"),
            "K2": (cm.condensed_matmul, "scaled_launches"),
            "K2-coa": (sm.condensed_over_active_matmul, "scaled_launches"),
            "K3": (cm.condensed_matmul_dw, "launches"),
            "K1-moe": (cm.condensed_matmul_grouped, "launches"),
            "K2-moe": (cm.condensed_matmul_grouped, "scaled_launches"),
            "K4-moe": (sm.condensed_over_active_matmul_grouped, "launches"),
            "K2-coa-moe": (sm.condensed_over_active_matmul_grouped, "scaled_launches"),
            "K5-moe": (sm.structured_matmul_grouped, "launches"),
            "K6-moe": (sm.structured_matmul_prefetch_grouped, "launches"),
            "K3-moe": (cm.condensed_matmul_dw_grouped, "launches")}


def _none() -> dict:
    """Every kernel's count at 0 (an expected-launches dict to fill in)."""
    return {name: 0 for name in _kernel_counters()}


def _zero_counts() -> None:
    for fn, attr in _kernel_counters().values():
        setattr(fn, attr, 0)


def _counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _kernel_counters().items()}


def _check_ties(label: str, cfg, out, toks_m, gaps, tie: float | None = None,
                against: str = "masked", prompt: int = PROMPT) -> int:
    """Tokens of a path against the masked path's on the same masks (or
    another path's, named by ``against``): they may part only where that
    path's top-2 logit gap is a tie (below ``tie``, by default TIE_GAP at
    this dtype). ``prompt`` is the prompts' length. Returns the number of
    streams that agree in full."""
    dtype_name = cfg.dtype
    tie = TIE_GAP[dtype_name] if tie is None else tie
    if out.shape != (BATCH, prompt + GEN) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{label}: bad tokens, shape {tuple(out.shape)}")
    div = _first_divergence(out[:, prompt:], toks_m)
    for b, j in enumerate(div):
        if j is None:
            continue
        gap = gaps[b, j].item()
        print(f"[{label}] stream {b}: parts from {against} at generated token {j}, {against} "
              f"top-2 gap {gap:.3g} (tie below {tie:.3g})")
        if gap >= tie:
            raise AssertionError(f"{label}: tokens differ from {against} at a gap of {gap}")
    return sum(j is None for j in div)


def model_setup(device) -> dict:
    """Full-width qwen3-1.7b: random weights and SRigL ERK masks at 90% from
    a seeded generator, and the prompts every path serves."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG

    base = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(0)
    reg = REG.build_registry(base)
    k_fan = REG.k_fan_map(base, reg)
    if k_fan != {"wo": 293, "w_gate": 195, "w_up": 195, "w_down": 585}:
        raise AssertionError(f"unexpected fan-ins {k_fan}")
    t0 = time.perf_counter()
    params = M.init_params(base, gen, k_fan)
    masks = REG.init_sparsity_state(base, gen, reg)["masks"]
    prompts = torch.randint(0, base.vocab_size, (BATCH, PROMPT), generator=gen,
                            device=device, dtype=torch.int32)
    torch.cuda.synchronize()
    print(f"[slice] {ARCH}: {base.n_layers} layers, d_model {base.d_model}, d_ff "
          f"{base.d_ff}, vocab {base.vocab_size}; fan-ins {k_fan}; init "
          f"{time.perf_counter() - t0:.1f}s")
    # what later phases report beside their own numbers: [slice]'s condensed
    # bf16 generate wall and leaf bytes, [train]'s SRigL DST step times
    report = {"srigl_bytes": {}}
    return dict(base=base, reg=reg, k_fan=k_fan, params=params, masks=masks, prompts=prompts,
                report=report)


def slice_phase(setup: dict, card: str):
    """Full-width qwen3-1.7b through both paths; returns K1's launch count."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.launch.engine import ServingModel
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG

    base, reg, k_fan = setup["base"], setup["reg"], setup["k_fan"]
    params, masks, prompts = setup["params"], setup["masks"], setup["prompts"]
    expected = 4 * base.n_layers * (1 + GEN)
    launches = None
    for dtype_name in ("bfloat16", "float32"):
        cfg = base.replace(dtype=dtype_name)
        t0 = time.perf_counter()
        cond = COND.export_condensed(cfg, reg, params, masks)
        for s in reg:
            leaf = REG.get_path(cond, s.path)
            if leaf.values.shape[-1] != k_fan[s.path[-1]]:
                raise AssertionError(f"{s.name}: exported k {leaf.values.shape[-1]}")
            if dtype_name == "bfloat16":
                setup["report"]["srigl_bytes"][s.name] = sum(
                    t.numel() * t.element_size() for t in leaf.arrays().values())
        torch.cuda.synchronize()
        print(f"[slice:{dtype_name}] condensed export {time.perf_counter() - t0:.1f}s")
        cond_model = ServingModel(cfg, params, cond)
        masked_model = ServingModel(cfg, params, masks)
        cond_model.generate(prompts, GEN)  # warm-up outside the counted run
        masked_model.generate(prompts, GEN)
        torch.cuda.synchronize()
        _part("capture")

        _zero_counts()
        out_c, tok_s_c, wall_c = _timed_generate(cond_model, prompts, "condensed")
        n = cm.condensed_matmul.launches
        if _counts() != {**_none(), "K1": expected}:
            raise AssertionError(f"condensed path launched {_counts()}, expected K1 "
                                 f"{expected} and nothing else")
        out_m, tok_s_m, wall_m = _timed_generate(masked_model, prompts, "masked")
        if launches is None:
            launches = n
            _device_profile(lambda: cond_model.generate(prompts, GEN), "condensed")
            _device_profile(lambda: masked_model.generate(prompts, GEN), "masked")
        tok_s = {"condensed": [tok_s_c], "masked": [tok_s_m]}
        walls = {"condensed": [wall_c], "masked": [wall_m]}
        for rep in range(1, REPEATS):  # alternate which path runs first
            for path in (("masked", "condensed") if rep % 2 else ("condensed", "masked")):
                model, first = ((cond_model, out_c) if path == "condensed"
                                else (masked_model, out_m))
                out, rate, wall = _timed_generate(model, prompts, path)
                if not torch.equal(out, first):
                    raise AssertionError(f"{path}: a repeated run gave other tokens")
                tok_s[path].append(rate)
                walls[path].append(wall)
        _part("serve")
        _eager_wall(f"slice:{dtype_name}:condensed", cond_model, prompts, out_c,
                    walls["condensed"], tok_s["condensed"])
        setup["report"][f"condensed_wall:{dtype_name}"] = statistics.median(walls["condensed"])
        # masked's eager loop is its step-by-step run, held to generate here
        toks_m, gaps = _masked_gaps(cfg, masked_model, prompts, GEN)
        if not torch.equal(toks_m, out_m[:, PROMPT:]):
            raise AssertionError("masked step-by-step run differs from generate")
        _check_ties(f"slice:{dtype_name}", cfg, out_m, toks_m, gaps)
        agree = _check_ties(f"slice:{dtype_name}", cfg, out_c, toks_m, gaps)
        print(f"[slice:{dtype_name}] {card}: decode {_rates(tok_s)}; K1 launches {n}; "
              f"streams agreeing in full {agree}/{BATCH}; min masked top-2 gap "
              f"{gaps.min().item():.3g}")
        print(f"[slice:{dtype_name}] condensed first stream: {out_c[0, PROMPT:].tolist()}")
        del cond, cond_model, masked_model
        torch.cuda.empty_cache()
    return launches


def _tie_threshold(label: str, cfg, model, masked_model, prompts,
                   against: str = "masked", bound: dict = LOGIT_NOISE_BOUND) -> float:
    """max(TIE_GAP, 2 * d), d the largest |logit difference| between a path
    and masked (or the path ``against`` names) on the same prefill; d must
    stay below ``bound`` at the dtype (LOGIT_NOISE_BOUND by default)."""
    import torch
    from repro_torch.models import model as M
    _part("setup")
    logits = []
    with torch.inference_mode():
        for m in (model, masked_model):
            cache = M.init_cache(cfg, prompts.shape[0], prompts.shape[1], prompts.device)
            lg, _ = M.prefill_step(cfg, m.compute, m.serving, {"tokens": prompts}, cache)
            logits.append(lg[:, :cfg.vocab_size])
        d = (logits[0] - logits[1]).abs().max().item()
    if not d <= bound[cfg.dtype]:
        raise AssertionError(f"{label}: prefill logits differ from {against} by {d}, above "
                             f"{bound[cfg.dtype]}")
    tie = max(TIE_GAP[cfg.dtype], 2 * d)
    print(f"[{label}] prefill logits differ from {against} by at most {d:.4g}: tie below "
          f"{tie:.4g}")
    _part("checks")
    return tie


@contextlib.contextmanager
def _prefetch_gather(on: bool):
    """REPRO_PREFETCH_GATHER for the structured decode launches inside."""
    old = os.environ.get("REPRO_PREFETCH_GATHER")
    os.environ["REPRO_PREFETCH_GATHER"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_PREFETCH_GATHER"]
        else:
            os.environ["REPRO_PREFETCH_GATHER"] = old


def _serve_counted(label: str, model, prompts, expected: dict, repeats: int = REPEATS,
                   eager: bool = True, walls_out: list | None = None):
    """A warm-up (which captures the decode graph), then one run with the
    launch counts zeroed just before and read just after (they must equal
    ``expected``), then ``repeats`` - 1 more timed runs that must give the
    same tokens; with ``eager``, the eager decode loop's wall beside them
    (``_eager_wall``). Returns (tokens, tok/s list, the counted run's launch
    counts); the runs' walls (s) go to ``walls_out`` if given."""
    import torch
    _part("setup")
    model.generate(prompts, GEN)
    torch.cuda.synchronize()
    _part("capture")
    _zero_counts()
    out, rate, wall = _timed_generate(model, prompts, label)
    counts = _counts()
    if counts != expected:
        raise AssertionError(f"{label}: launched {counts}, expected {expected}")
    rates, walls = [rate], [wall]
    for _ in range(1, repeats):
        again, rate, wall = _timed_generate(model, prompts, label)
        if not torch.equal(again, out):
            raise AssertionError(f"{label}: a repeated run gave other tokens")
        rates.append(rate)
        walls.append(wall)
    _part("serve")
    if eager:
        _eager_wall(label, model, prompts, out, walls, rates)
    if walls_out is not None:
        walls_out.extend(walls)
    return out, rates, counts


def _timed_generate(model, prompts, label: str):
    """One serve_once (graph decode): (tokens, decode tok/s, wall s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, rate = model.serve_once(prompts, GEN, label, quiet=True)
    torch.cuda.synchronize()
    return out, rate, time.perf_counter() - t0


def _eager_wall(label: str, model, prompts, out, walls: list, rates: list) -> None:
    """The same request with its decode steps run eagerly (the engine's
    private ``_serve_eager``): its tokens must equal the graph replays'
    bitwise; prints both walls, the host share the graph removes."""
    import torch
    from repro_torch.launch import engine as E
    torch.cuda.synchronize()
    _part("setup")
    t0 = time.perf_counter()
    got, _, t_dec, _ = E._serve_eager(model.cfg, model.compute, model.serving, prompts, GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.equal(got, out):
        raise AssertionError(f"{label}: the eager decode loop gave other tokens than the "
                             f"graph replays")
    graph_dec = statistics.median([BATCH * GEN / r for r in rates])
    print(f"[walls:{label}] generate {BATCH}x{PROMPT}+{GEN}: graph decode wall "
          f"{statistics.median(walls) * 1e3:.2f} ms (median of {len(walls)}; decode "
          f"{graph_dec * 1e3:.2f} ms), eager decode loop wall {wall * 1e3:.2f} ms (decode "
          f"{t_dec * 1e3:.2f} ms); eager tokens == graph tokens")
    _part("eager")


def ablation_phase(setup: dict, card: str) -> dict:
    """Full-width qwen3-1.7b with half of every sparse stack's neurons
    ablated: condensed_over_active (K4) on the ablated constant fan-in
    masks, structured (K5) and structured with prefetch_gather (K6 at
    decode, K5 at prefill) on ablation-only masks, each held to the masked
    path on its own masks. Returns the bf16 runs' launch counts."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ServingModel

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    per_pass = 4 * base.n_layers  # sparse linears per forward pass
    sets = {"ablated": _ablate_masks(reg, setup["masks"], ABLATION),
            "ablation-only": _ablation_only(reg, setup["masks"], ABLATION)}
    none = _none()
    runs = (  # label, mask set, path, prefetch_gather, expected launches
        ("condensed_over_active", "ablated", "condensed_over_active", False,
         {**none, "K4": per_pass * (1 + GEN)}),
        ("structured", "ablation-only", "structured", False,
         {**none, "K5": per_pass * (1 + GEN)}),
        ("structured+prefetch", "ablation-only", "structured", True,
         {**none, "K5": per_pass, "K6": per_pass * GEN}),
    )
    launches = {}
    for dtype_name in ("bfloat16", "float32"):
        cfg = base.replace(dtype=dtype_name)
        tok_s, masked = {}, {}
        for set_name, m in sets.items():
            # the masked path's eager loop and device profile are [slice]'s:
            # ablating neurons changes its numbers, not its code path
            model = ServingModel(cfg, params, m)
            label = f"masked/{set_name}"
            out, tok_s[label], _ = _serve_counted(label, model, prompts, none, eager=False)
            toks_m, gaps = _masked_gaps(cfg, model, prompts, GEN)
            if not torch.equal(toks_m, out[:, PROMPT:]):
                raise AssertionError(f"{label}: step-by-step run differs from generate")
            masked[set_name] = (model, toks_m, gaps)
        outs = {}
        for label, set_name, path, prefetch, expected in runs:
            with _prefetch_gather(prefetch):
                t0 = time.perf_counter()
                plan = serve.build_plan(cfg, reg, params, sets[set_name], path, batch_size=BATCH)
                torch.cuda.synchronize()
                export_s = time.perf_counter() - t0
                model = ServingModel(cfg, params, plan)
                outs[label], tok_s[label], counts = _serve_counted(label, model, prompts,
                                                                   expected)
                if dtype_name == "bfloat16":
                    # no device profile: K4, K5 and K6 take their [kernel]
                    # times, the rest of the request is [slice]'s profile
                    launches[label] = counts
                masked_model, toks_m, gaps = masked[set_name]
                name = f"ablation:{dtype_name}:{label}"
                tie = _tie_threshold(name, cfg, model, masked_model, prompts)
                del model, plan
            agree = _check_ties(name, cfg, outs[label], toks_m, gaps, tie)
            print(f"[ablation:{dtype_name}] {label} on the {set_name} masks: export "
                  f"{export_s:.1f}s, launches {expected}, streams agreeing with masked in "
                  f"full {agree}/{BATCH}; first stream {outs[label][0, PROMPT:].tolist()}")
        if not torch.equal(outs["structured+prefetch"], outs["structured"]):
            raise AssertionError(f"{dtype_name}: prefetch_gather changed the structured tokens")
        print(f"[ablation:{dtype_name}] {card}: structured+prefetch tokens == structured "
              f"tokens; decode {_rates(tok_s)}")
        del masked
        torch.cuda.empty_cache()
    return launches


def auto_phase(setup: dict) -> None:
    """--path auto on the ablated masks at B=4 (bucket 8), bf16: the launch
    count of each kernel must be what the plan's decisions imply."""
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ServingModel

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    cfg = base.replace(dtype="bfloat16")
    ablated = _ablate_masks(reg, setup["masks"], ABLATION)
    plan = serve.build_plan(cfg, reg, params, ablated, "auto", batch_size=BATCH)
    print(plan.describe(requested_batch=BATCH))
    if plan.batch_size != 8:
        raise AssertionError(f"B={BATCH} planned at bucket {plan.batch_size}, not 8")
    kernel_of = {"condensed": "K1", "condensed_over_active": "K4", "structured": "K5"}
    expected = _none()
    for s in reg:
        rep = plan.representation_of(s.name)
        if rep in kernel_of:
            expected[kernel_of[rep]] += base.n_layers * (1 + GEN)
    model, masked = ServingModel(cfg, params, plan), ServingModel(cfg, params, ablated)
    with _prefetch_gather(False):
        out, rates, _ = _serve_counted("auto", model, prompts, expected)
    tie = _tie_threshold("auto", cfg, model, masked, prompts)
    agree = _check_ties("auto", cfg, out, *_masked_gaps(cfg, masked, prompts, GEN), tie)
    print(f"[auto] launches {expected} as the decisions imply; streams agreeing with "
          f"masked in full {agree}/{BATCH}; decode {_rates({'auto': rates})}")


def _dequantized_twin(plan, dtype) -> dict:
    """The plan's serving tree with every quantized leaf's codes and scales
    dequantized (at ``dtype``) into a float leaf of the same format: the
    float path (K1, K4, K5) over the same numbers."""
    import dataclasses
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG
    out: dict = {}
    for s in plan.registry:
        leaf = REG.get_path(plan.serving_tree, s.path)
        axis = -2 if isinstance(leaf, F.StructuredFanIn) else -1
        REG.set_path(out, s.path, dataclasses.replace(
            leaf, values=F.dequantize_values(leaf.values, leaf.scales, axis=axis, dtype=dtype),
            scales=None, values_dtype=None))
    return out


def quant_phase(setup: dict, card: str) -> dict:
    """--values-dtype int8 / fp8 on full-width qwen3-1.7b: condensed (K2) on
    the 90% masks and condensed_over_active (K2-coa) on the ablated masks,
    bf16 and f32, each held to its dequantized twin (K1 / K4); structured
    int8 on ablation-only masks (K5) once. Returns the bf16 int8 runs'
    launch counts."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ServingModel

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    per_request = 4 * base.n_layers * (1 + GEN)
    sets = {"90%": setup["masks"], "ablated": _ablate_masks(reg, setup["masks"], ABLATION),
            "ablation-only": _ablation_only(reg, setup["masks"], ABLATION)}
    runs = [  # path, mask set, kernel, the twin's kernel, compute dtypes, codes
        ("condensed", "90%", "K2", "K1", ("bfloat16", "float32"), QUANT),
        ("condensed_over_active", "ablated", "K2-coa", "K4", ("bfloat16", "float32"), QUANT),
        ("structured", "ablation-only", "K5", "K5", ("bfloat16",), ("int8",)),
    ]
    launches = {}
    for path, set_name, key, twin_key, dtypes, codes in runs:
        for dtype_name in dtypes:
            cfg = base.replace(dtype=dtype_name)
            for qdt in codes:
                label = f"quant:{dtype_name}:{path}:{qdt}"
                t0 = time.perf_counter()
                plan = serve.build_plan(cfg, reg, params, sets[set_name], path,
                                        batch_size=BATCH, values_dtype=qdt)
                torch.cuda.synchronize()
                export_s = time.perf_counter() - t0
                weight_bytes, masked_ref = plan.weight_bytes()
                model = ServingModel(cfg, params, plan)
                if model.values_dtype != qdt:
                    raise AssertionError(f"{label}: the model keeps values_dtype "
                                         f"{model.values_dtype}")
                with _prefetch_gather(False):
                    # fp8 codes run the int8 path's wrapper and body (another
                    # code type): int8's eager loop holds it to the graph
                    out, rates, counts = _serve_counted(label, model, prompts,
                                                        {**_none(), key: per_request},
                                                        repeats=QUANT_REPEATS,
                                                        eager=qdt != "fp8")
                    if dtype_name == "bfloat16" and qdt == "int8":
                        # no device profile: K2 and K2-coa run K1's and K4's
                        # bodies in the same request ([slice] and [ablation]
                        # profile those); their own time is [kernel]'s
                        launches[key] = counts[key]
                    twin = ServingModel(cfg, params, _dequantized_twin(plan, getattr(torch,
                                                                                     dtype_name)))
                    out_t, _, _ = _serve_counted(f"{label}:twin", twin, prompts,
                                                 {**_none(), twin_key: per_request}, repeats=1,
                                                 eager=False)
                    toks_t, gaps = _masked_gaps(cfg, twin, prompts, GEN)
                    if not torch.equal(toks_t, out_t[:, PROMPT:]):
                        raise AssertionError(f"{label}: the twin's step-by-step run differs")
                    if key == "K5":
                        # the twin dequantizes as StructuredFanIn.apply does and runs
                        # the same K5, so this holds by construction: it checks the
                        # launch counts; [reference] holds this path to the CPU
                        if not torch.equal(out, out_t):
                            raise AssertionError(f"{label}: tokens differ from the twin's")
                        agree = BATCH
                    else:
                        tie = (_tie_threshold(label, cfg, model, twin, prompts, "the twin")
                               if dtype_name == "bfloat16" else TIE_GAP[dtype_name])
                        agree = _check_ties(label, cfg, out, toks_t, gaps, tie, "the twin")
                print(f"[{label}] {card}: export {export_s:.1f}s, serving weight bytes "
                      f"{weight_bytes} ({weight_bytes / masked_ref:.3f}x of masked), launches "
                      f"{key} {counts[key]}, streams agreeing with the dequantized twin "
                      f"({twin_key}) in full {agree}/{BATCH}; decode {_rates({path: rates})}; "
                      f"first stream {out[0, PROMPT:].tolist()}")
                del model, twin, plan
                torch.cuda.empty_cache()
    return launches


def checkpoint_phase(setup: dict) -> None:
    """The int8 condensed serving tree through the port's checkpoint: saved,
    restored into a fresh template of the same shapes on the card, served."""
    import dataclasses
    import tempfile
    import typing
    import torch
    from repro_torch import bridge
    from repro_torch.launch.engine import ServingModel
    from repro_torch.sparse import condensed as COND
    from repro_torch.train import checkpoint as CKPT

    class State(typing.NamedTuple):
        step: torch.Tensor
        serve: dict

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    cfg = base.replace(dtype="bfloat16")
    tree = COND.export_condensed(cfg, reg, params, setup["masks"], quantize_spec="int8")
    # a fresh template: zero codes and indices, unit scales, same dtypes and device
    template = _map_leaves(tree, lambda leaf: dataclasses.replace(
        leaf, values=torch.zeros_like(leaf.values), indices=torch.zeros_like(leaf.indices),
        scales=torch.ones_like(leaf.scales)))
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        t0 = time.perf_counter()
        path = CKPT.save(d, State(step=torch.tensor(7), serve=tree))
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        got = CKPT.restore(d, CKPT.latest_step(d), State(step=torch.tensor(0), serve=template))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    want, have = bridge.flatten(tree), bridge.flatten(got.serve)
    if int(got.step) != 7 or want.keys() != have.keys():
        raise AssertionError(f"restored step {int(got.step)}, keys {sorted(have)[:4]}...")
    for k in want:
        if have[k].device != want[k].device or not torch.equal(have[k], want[k]):
            raise AssertionError(f"checkpoint: {k} differs after the round trip")
    out = ServingModel(cfg, params, tree).generate(prompts, GEN)
    out_r = ServingModel(cfg, params, got.serve).generate(prompts, GEN)
    if not torch.equal(out, out_r):
        raise AssertionError("checkpoint: the restored tree serves other tokens")
    print(f"[checkpoint] int8 condensed tree, {len(want)} arrays, {size} bytes: save "
          f"{save_s:.1f}s, restore onto {got.serve['blocks']['wo'].values.device} "
          f"{restore_s:.1f}s; every array bitwise equal, tokens equal: "
          f"{out_r[0, PROMPT:].tolist()}")


def _engine_pages_check(label: str, eng) -> None:
    """Every runner's live requests hold disjoint pages, never page 0, each
    request's table rows hold exactly its pages, and owned plus free pages
    cover the pool (no page leaks)."""
    for runner in eng._runners.values():
        owned = [p for a in runner.active.values() for p in a.pages]
        if 0 in owned or len(owned) != len(set(owned)):
            raise AssertionError(f"{label}: live requests share pages or hold page 0")
        if len(owned) + runner.alloc.available != runner.num_blocks - 1:
            raise AssertionError(f"{label}: {len(owned)} owned + {runner.alloc.available} "
                                 f"free pages of {runner.num_blocks - 1}: a page leaked")
        for a in runner.active.values():
            held = {int(p) for row in a.rows for p in runner.table[row] if p}
            if held != set(a.pages):
                raise AssertionError(f"{label}: request {a.req.id}'s table rows hold other "
                                     f"pages than it owns")


def _engine_replay_check(label: str, runner) -> None:
    """One decode chunk from the runner's current state, run eagerly and
    then replayed from the same saved state: the live rows' tokens and next
    tokens and every page the live requests own must be bitwise equal. The
    pool is put back afterwards, so serving goes on unchanged."""
    import numpy as np
    import torch
    from repro_torch.launch import engine as E
    st, dec = runner.state, runner.decoder
    chunk = min(runner.eng.gen_chunk, max(a.remaining for a in runner.active.values()))
    rows = sorted(r for a in runner.active.values() for r in a.rows)
    pages = torch.tensor(sorted(p for a in runner.active.values() for p in a.pages),
                         device=st.cur.device)
    lengths = runner.lengths.copy()
    idle = np.ones(runner.bucket, bool)
    idle[rows] = False
    lengths[idle] = 0
    saved = {k: v.clone() for k, v in st.pool.items()}

    def load():
        for k, v in saved.items():
            st.pool[k].copy_(v)
        st.table.copy_(torch.from_numpy(runner.table))
        st.lengths.copy_(torch.from_numpy(lengths))
        st.cur.copy_(torch.from_numpy(runner.cur))

    def result():
        torch.cuda.synchronize()
        return ([st.toks[rows, :chunk].clone(), st.cur[rows].clone()]
                + [v[:, pages].clone() for v in st.pool.values()])

    load()
    E._decode_chunk_eager(dec, chunk)
    eager = result()
    load()
    dec.run(chunk)
    replay = result()
    load()
    for name, a, b in zip(("tokens", "next tokens", "k pages", "v pages"), eager, replay):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: the graph replay's {name} differ from the eager "
                                 f"chunk's from the same state")
    print(f"[{label}] graph replay == eager chunk bitwise from a saved state: {chunk} steps, "
          f"{len(rows)} live rows of {runner.bucket}, their tokens, next tokens and "
          f"{len(pages)} pages of k and v")


def _engine_wave(label: str, eng, mix, seed: int, replay_check: bool = False):
    """One wave of requests (batch, prompt_len, gen_len) from ``seed``,
    submitted two at a time between ``step(max_chunks=1)`` calls, served to
    the end. Checks the pages after every step and the page count after the
    wave; with ``replay_check``, holds a replay to the eager chunk once the
    bucket-8 group has 4 live rows at a chunk boundary (ENGINE_MIX reaches
    that after its third step). Returns ({id: (prompts,
    gen_len, Result)}, wall seconds)."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    queue = [(torch.randint(0, eng.cfg.vocab_size, (b, t), generator=gen, dtype=torch.int32),
              g) for b, t, g in mix]
    reqs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while queue or eng._pending or any(r.active for r in eng._runners.values()):
        for _ in range(2):
            if queue:
                p, g = queue.pop(0)
                reqs[eng.submit(p, g)] = (p, g)
        eng.step(max_chunks=1)
        _engine_pages_check(label, eng)
        runner = eng._runners.get(eng.plan_key(2))
        if replay_check and runner is not None and sum(
                len(a.rows) for a in runner.active.values()) >= 4:
            _engine_replay_check(label, runner)
            replay_check = False
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if replay_check:
        raise AssertionError(f"{label}: the bucket-8 group never had 4 live rows at a chunk "
                             f"boundary, so no replay was held to the eager chunk")
    results = {r.id: r for r in eng.retire()}
    if results.keys() != reqs.keys():
        raise AssertionError(f"{label}: finished {sorted(results)}, submitted {sorted(reqs)}")
    for runner in eng._runners.values():
        if runner.active or runner.alloc.available != runner.num_blocks - 1:
            raise AssertionError(f"{label}: {runner.num_blocks - 1 - runner.alloc.available} "
                                 f"pages still held after the wave")
    return {rid: (p, g, results[rid]) for rid, (p, g) in reqs.items()}, wall


def _engine_noise(cfg, eng, key, tree, prompts) -> float:
    """The largest |logit difference| between a request's standalone prefill
    and the same prompts right-padded into its bucket's paged prefill (the
    engine's): two correct bf16 runs of other shapes, whose top-2 may swap
    only below twice this."""
    import torch
    from repro_torch.launch import engine as E
    from repro_torch.models import model as M
    from repro_torch.models import paged as PG
    dev, bs = eng.device, eng.block_size
    b, t = prompts.shape
    tb = E._pow2_bucket(t)
    nb = PG.pages_for(tb, bs)
    tokens = torch.zeros((key.batch_bucket, tb), dtype=torch.int32, device=dev)
    tokens[:b, :t] = prompts
    table = torch.zeros((key.batch_bucket, nb), dtype=torch.int32, device=dev)
    table[:b] = 1 + torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb)
    lens = torch.zeros((key.batch_bucket,), dtype=torch.int32, device=dev)
    lens[:b] = t
    with torch.no_grad():
        pool = M.init_paged_pool(cfg, 1 + b * nb, bs, dev)
        paged, _ = M.paged_prefill_step(cfg, eng.compute, tree, {"tokens": tokens}, pool,
                                        table, lens)
        cache = M.init_cache(cfg, b, t, dev)
        alone, _ = M.prefill_step(cfg, eng.compute, tree, {"tokens": prompts}, cache)
    v = cfg.vocab_size
    return (paged[:b, :v] - alone[:, :v]).abs().max().item()


def _engine_tokens(label: str, cfg, eng, reqs: dict, graphs: dict) -> tuple[int, int]:
    """Each request's tokens against a standalone ``generate`` of it on the
    same serving tree: equal, or parting only at a logit near-tie of the
    standalone run (its top-2 gap below max(TIE_GAP, 2 * the prefill noise
    of ``_engine_noise``)). The standalone runs of one plan key keep their
    captured decode graphs in ``graphs`` (one per (B, max_len), as a
    ``ServingModel`` keeps them), so a later wave of the same shapes replays
    them. Returns (streams bitwise equal, streams)."""
    import torch
    from types import SimpleNamespace
    from repro_torch.launch import engine as E
    equal = total = 0
    for rid, (p, g, res) in reqs.items():
        b, t = p.shape
        tree = eng.serving_tree_for(res.plan_key)
        prompts = p.to(eng.device)
        ref, _ = E.serve_once(cfg, eng.compute, tree, prompts, g, "generate", quiet=True,
                              decoders=graphs.setdefault(res.plan_key, {}),
                              pool=graphs.setdefault("pool", E._graph_pool(eng.device)))
        got = res.tokens
        if got.shape != (b, t + g) or not torch.equal(got[:, :t], prompts) or not bool(
                ((got >= 0) & (got < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: request {rid} returned bad tokens "
                                 f"{tuple(got.shape)}")
        div = _first_divergence(got[:, t:], ref[:, t:])
        total += b
        equal += sum(j is None for j in div)
        if all(j is None for j in div):
            continue
        model = SimpleNamespace(compute=eng.compute, serving=tree)
        toks_e, gaps = _masked_gaps(cfg, model, prompts, g)
        if not torch.equal(toks_e, ref[:, t:]):
            raise AssertionError(f"{label}: request {rid}'s standalone generate differs from "
                                 f"its eager step-by-step run")
        tie = max(TIE_GAP[cfg.dtype], 2 * _engine_noise(cfg, eng, res.plan_key, tree, prompts))
        for s_i, j in enumerate(div):
            if j is None:
                continue
            gap = gaps[s_i, j].item()
            print(f"[{label}] request {rid} stream {s_i}: parts from standalone generate at "
                  f"generated token {j}, top-2 gap {gap:.3g} (tie below {tie:.3g})")
            if gap >= tie:
                raise AssertionError(f"{label}: request {rid} differs from standalone "
                                     f"generate at a gap of {gap}")
    return equal, total


def _applications(cfg, stack) -> int:
    """How often one forward pass runs ``stack``'s kernel: once per layer
    of its leading dims; an MoE expert stack (L, E) once per layer for all
    its experts; the hybrid's shared block (no leading axis) once per
    group it follows."""
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG
    if REG.is_expert_stack(stack, cfg):
        return stack.lead[0]
    if not stack.lead:
        return M.hybrid_counts(cfg)[0]
    return stack.n_replicas


def _engine_expected(eng, dispatches: dict) -> dict:
    """Kernel launches the plans' decisions imply for ``dispatches``
    ({plan key: prefill dispatches + decode steps}): each stack's kernel
    ``_applications`` times per dispatch (an MoE expert stack: its
    expert-grouped launch)."""
    from repro_torch.sparse import registry as REG
    quant = eng.values_dtype is not None
    kernel_of = {"condensed": "K2" if quant else "K1",
                 "condensed_over_active": "K2-coa" if quant else "K4", "structured": "K5"}
    grouped = {"K1": "K1-moe", "K2": "K2-moe", "K4": "K4-moe", "K2-coa": "K2-coa-moe",
               "K5": "K5-moe"}
    stacks = {s.name: s for s in eng.registry}
    expected = _none()
    for key, n in dispatches.items():
        for name, rep in key.formats:
            runs = _applications(eng.cfg, stacks[name]) * n
            if rep in kernel_of:
                kern = kernel_of[rep]
                expected[grouped[kern] if REG.is_expert_stack(stacks[name], eng.cfg)
                         else kern] += runs
    return expected


def _bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (tensors, dicts and
    format leaves), as the dry run counts them."""
    from repro_torch.launch import dryrun as DR
    return DR.tree_bytes(*trees)


def _gib(n: int) -> str:
    return f"{n / 2**30:.3f} GiB"


def _engine_bytes(eng) -> dict:
    """What [dryrun] holds its qwen3-1.7b cell to, from the engine's
    bucket-8 group after its waves: the pool's pages and table width, the
    pool's bytes, each serving leaf's field shapes and dtypes, the tree's
    and the serving copy's bytes, and the max_memory_allocated increase of
    one eager paged decode step on the group's state, emptied (every row
    on the garbage page, as a capture's warm-up step runs)."""
    import torch
    from repro_torch.sparse import registry as REG
    key = eng.plan_key(SPEC_BUCKET)
    runner = eng._runners[key]
    tree = eng.serving_tree_for(key)
    leaves = {s.name: {f: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                       for f, t in REG.get_path(tree, s.path).arrays().items()}
              for s in eng.registry}
    st = runner.state
    st.table.zero_()
    st.lengths.zero_()
    st.step.zero_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        runner.decoder.step()
    torch.cuda.synchronize()
    return dict(bucket=key.batch_bucket, pages=(runner.num_blocks, runner.nb),
                block_size=runner.bs, pool_bytes=_bytes(st.pool), leaves=leaves,
                tree_bytes=_bytes(tree), compute_bytes=_bytes(eng.compute),
                step_peak=torch.cuda.max_memory_allocated() - base)


def engine_phase(setup: dict, card: str) -> None:
    """The paged ServingEngine at full width, bf16, block_size 16, gen_chunk
    16: ENGINE_MIX (two groups, buckets 1 and 8) submitted two at a time
    between step(max_chunks=1) calls, then a second wave of the same shapes,
    on --path condensed (K1) and on --path auto with half of every stack's
    neurons ablated (K4 at bucket 8); then the first four requests on
    condensed with int8 values (K2), and in float32 (K1), where a stream
    may part from standalone generate only below TIE_GAP's 1e-3. Gates:
    replay == eager bitwise from a saved state; pages disjoint and none
    leaked; the second wave captures
    no graph, runs no new prefill shape, has no cold result and launches
    each kernel as the plans' decisions imply; every second-wave request's
    tokens equal a standalone generate's, except at near-ties. The condensed
    bf16 engine's bucket-8 group leaves its allocations in
    ``setup["report"]["engine"]`` (``_engine_bytes``) for [dryrun]."""
    import torch
    from repro_torch.launch import engine as E

    base, reg, params, masks = setup["base"], setup["reg"], setup["params"], setup["masks"]
    runs = (("condensed", masks, None, ENGINE_MIX, "bfloat16"),
            ("auto", _ablate_masks(reg, masks, ABLATION), None, ENGINE_MIX, "bfloat16"),
            ("condensed", masks, "int8", ENGINE_MIX[:4], "bfloat16"),
            ("condensed", masks, None, ENGINE_MIX[:4], "float32"))
    for path, m, vd, mix, dtype_name in runs:
        cfg = base.replace(dtype=dtype_name)
        label = (f"engine:{path}" + (f":{vd}" if vd else "")
                 + (":f32" if dtype_name == "float32" else ""))
        eng = E.ServingEngine(cfg, params, m, reg, path=path, block_size=ENGINE_BLOCK,
                              gen_chunk=ENGINE_CHUNK, values_dtype=vd)
        _part("setup")
        first, wall1 = _engine_wave(label, eng, mix, seed=1, replay_check=True)
        _part("capture")
        programs = {k: eng.program_count(k) for k in ("prefill", "decode")}
        before = {key: r.prefills + r.steps for key, r in eng._runners.items()}
        _zero_counts()
        second, wall2 = _engine_wave(label, eng, mix, seed=2)
        _part("serve")
        counts = _counts()
        after = {k: eng.program_count(k) for k in ("prefill", "decode")}
        if after != programs:
            raise AssertionError(f"{label}: the second wave ran new signatures: {programs} -> "
                                 f"{after}")
        cold = sorted(rid for rid, (_, _, r) in second.items() if r.cold)
        if cold:
            raise AssertionError(f"{label}: second-wave requests {cold} are cold")
        dispatches = {key: r.prefills + r.steps - before.get(key, 0)
                      for key, r in eng._runners.items()}
        expected = _engine_expected(eng, dispatches)
        if counts != expected:
            raise AssertionError(f"{label}: the second wave launched {counts}, its plans imply "
                                 f"{expected}")
        # the second wave's requests (the first wave's shapes, other
        # prompts) are held to standalone generate; the first wave is their
        # repetition and held only by the replay check
        equal, total = _engine_tokens(label, cfg, eng, second, {})
        _part("checks")
        if label == "engine:condensed":
            setup["report"]["engine"] = _engine_bytes(eng)
            _part("bytes")
        tokens = sum(b * g for b, _, g in mix)
        groups = ", ".join(f"{k.describe()}: {r.prefills} prefills, {r.steps} decode steps"
                           for k, r in eng._runners.items())
        print(f"[{label}] {card}: {len(mix)} requests a wave ({tokens} generated tokens), "
              f"waves {wall1:.3f}s and {wall2:.3f}s ({tokens / wall2:.1f} tok/s); {groups}; "
              f"graphs captured {programs['decode']}, prefill shapes {programs['prefill']}, "
              f"none new in the second wave, no cold result; second-wave launches {counts} "
              f"as the plans imply; second-wave streams bitwise equal to standalone "
              f"generate {equal}/{total}")
        del eng, first, second
        _release()


# ---------------------------------------------------------------------------
# self-draft speculative decoding ([rows], [kernel:spec], [profile:measured],
# [spec])
# ---------------------------------------------------------------------------

SPEC_GAMMA = 3
SPEC_BUCKET = 8  # the engine's bucket for ENGINE_MIX's batches 2-4
# the dense products whose rows the verify computes at bucket x (gamma + 1)
# where plain decode computes them at the bucket: qwen3-1.7b's q, k/v and
# fused QKV projections, the MLP's (masked stacks), and the tied head
ROWS_SHAPES = (("wq", 2048, 2048), ("wk|wv", 2048, 1024), ("qkv", 2048, 4096),
               ("mlp up", 2048, 6144), ("mlp down", 6144, 2048), ("head", 2048, 151_936))
# the row counts compared: a standalone generate's decode (B = 4) against
# the engine's bucket (8), plain decode against a gamma = 3 verify (32), and
# a 4 x 32 prefill against the engine's bucket-padded 8 x 64
ROWS_PAIRS = ((4, 8), (8, 32), (128, 512))
# label, path, masks ("plain" 90% SRigL, or "only": ablation-only), draft
# ablation, compute dtype
SPEC_RUNS = (("spec:condensed", "condensed", "plain", 0.5, "bfloat16"),
             ("spec:condensed:abl0", "condensed", "plain", 0.0, "bfloat16"),
             ("spec:structured", "structured", "only", 0.5, "bfloat16"),
             ("spec:condensed:f32", "condensed", "plain", 0.5, "float32"))
PROFILE_BUCKETS = (1, 8, 32, 128, 512)


def rows_phase(device) -> dict:
    """Whether torch.matmul's rows depend on the row count M on the card,
    at ROWS_PAIRS, bf16 and f32, at qwen3-1.7b's dense product shapes (the
    head as the model runs it, through the embedding's transpose); and
    whether RMSNorm, the softmax and decode attention over a longer span
    of masked slots give other rows. Returns {(dtype, pair): [names whose
    rows differ]}."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    gen = torch.Generator(device=device).manual_seed(11)
    found: dict = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, k, n in ROWS_SHAPES:
            if name == "head":
                w = (torch.randn((n, k), generator=gen, device=device) * 0.02).to(dtype).T
            else:
                w = (torch.randn((k, n), generator=gen, device=device) / k ** 0.5).to(dtype)
            x = torch.randn((512, k), generator=gen, device=device).to(dtype)
            y = {m: torch.matmul(x[:m], w) for m in (4, 8, 32, 128, 512)}
            parts = []
            for a, b in ROWS_PAIRS:
                diff = (y[a].float() - y[b][:a].float()).abs()
                rows = int((diff.amax(dim=1) > 0).sum())
                parts.append(f"M={a} vs M={b}: {rows}/{a} rows differ "
                             f"(max {diff.max().item():.3g})")
                if rows:
                    found.setdefault((dtype_name, f"{a}-{b}"), []).append(name)
            print(f"[rows] torch.matmul {name:8s} {k}->{n} {dtype_name:8s}: " + "; ".join(parts))
            del w, x, y
        # decode attention over 40 tokens held in a span of 48 or of 64
        # slots (a cache or a page table's span; the slots past 40 masked)
        q = torch.randn((8, 1, 16, 128), generator=gen, device=device).to(dtype)
        kv = [torch.randn((8, 64, 8, 128), generator=gen, device=device).to(dtype)
              for _ in range(2)]
        h2kv = tuple(h // 2 for h in range(16))
        out = {s_: A.decode_attention(q, kv[0][:, :s_], kv[1][:, :s_], 40, head_to_kv=h2kv)
               for s_ in (48, 64)}
        rows = int((out[48] != out[64]).reshape(8, -1).any(dim=1).sum())
        if rows:
            found.setdefault((dtype_name, "span 48-64"), []).append("decode attention")
        print(f"[rows] decode attention   {dtype_name:8s}: 40 tokens in a span of 48 vs 64 "
              f"slots: {rows}/8 rows differ (max "
              f"{(out[48].float() - out[64].float()).abs().max().item():.3g})")
        # the row-wise reductions of a decode step: RMSNorm over d_model and
        # over a head (qk-norm), the attention softmax over a table span
        scale = torch.randn((2048,), generator=gen, device=device)
        others = {
            "rms_norm d_model": (lambda t: L.rms_norm(t, scale), (2048,)),
            "rms_norm head": (lambda t: L.rms_norm(t, scale[:128]), (16, 128)),
            "softmax span": (lambda t: torch.softmax(t.float(), dim=-1), (16, 512)),
        }
        for name, (fn, shape) in others.items():
            x = torch.randn((32, *shape), generator=gen, device=device).to(dtype)
            y = {m: fn(x[:m]) for m in (4, 8, 32)}
            parts = []
            for a, b in ((4, 8), (8, 32)):
                rows = int((y[a] != y[b][:a]).reshape(a, -1).any(dim=1).sum())
                parts.append(f"M={a} vs M={b}: {rows}/{a} rows differ")
                if rows:
                    found.setdefault((dtype_name, f"{a}-{b}"), []).append(name)
            print(f"[rows] {name:16s} {dtype_name:8s}: " + "; ".join(parts))
    torch.cuda.empty_cache()
    print(f"[rows] products whose rows depend on M: "
          f"{ {f'{d} {p}': v for (d, p), v in found.items()} or 'none'}")
    return found


def spec_kernel_phase(device) -> list:
    """K1, K4, K2, K2-coa, K5 and K6 at the shapes speculation gives them,
    per stack of full-width qwen3-1.7b: a bucket-8 draft step (8 rows) and
    its gamma = 3 verify (32 rows). K1 and K2 over the target's rows; K4 and
    K2-coa over a sentinel draft (``plan.derive_draft_leaf``: every row,
    the less salient half's out_index the sentinel d_out); K5 over an
    ablation-only target's surviving columns and over its subset draft (a
    quarter of d_out, padded); K6 at the subset draft. Each against its
    plain version, the 8-row launch bitwise equal to the 32-row launch's
    first 8 rows (decode == tiled), K6 == K5 bitwise; bf16, and K1/K4 in
    f32 too. Returns the per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import plan as PLAN
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(21)
    shapes = {}
    for s in REG.build_registry(cfg):
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    rows = (SPEC_BUCKET, SPEC_BUCKET * (SPEC_GAMMA + 1))
    cases = []

    def case(kernel, what, stack, dtype_name, fn, plain, weights, nbytes, x):
        y_big = fn(x, *weights)
        y_small = fn(x[:rows[0]], *weights)
        want = plain(x, *weights)
        torch.cuda.synchronize()
        torch.testing.assert_close(y_big.float(), want.float(), **TOL[dtype_name])
        err = (y_big.float() - want.float()).abs().max().item()
        if not torch.equal(y_small, y_big[:rows[0]]):
            raise AssertionError(f"{kernel} {what} {stack} {dtype_name}: the {rows[0]}-row "
                                 f"launch is not bitwise the {rows[1]}-row launch's rows")
        sets = [tuple(t.clone() for t in weights) for _ in range(_copies(nbytes))]
        ms = {r: _time_ms(fn, [(x[:r], *s) for s in sets]) for r in rows}
        rec = dict(kernel=kernel, what=what, stack=stack, dtype=dtype_name,
                   ms_draft_rows=ms[rows[0]], ms_verify_rows=ms[rows[1]], max_abs_err=err,
                   rows=list(rows))
        cases.append(rec)
        print(f"[kernel:spec] {kernel:6s} {what:16s} {stack:6s} {dtype_name:8s}: "
              f"{rows[0]} rows {ms[rows[0]]:.5f} ms, {rows[1]} rows {ms[rows[1]]:.5f} ms | "
              f"max_abs_err {err:.3g} vs plain | {rows[0]} rows == first {rows[0]} of "
              f"{rows[1]}: bitwise")
        del sets
        return y_small

    for (d_in, d_out), (name, k) in shapes.items():
        mask = topology.random_constant_fan_in_mask(gen, d_in, d_out, k)
        w = torch.randn((d_in, d_out), generator=gen, device=device) / k ** 0.5
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            isz = dtype.itemsize
            x = torch.randn((rows[1], d_in), generator=gen, device=device).to(dtype)
            cond = F.Condensed.export_from_dense(w, mask, dtype=dtype)
            draft, kind = PLAN.derive_draft_leaf(cond, w, mask, 0.5)
            if kind != "sentinel" or draft.values is not cond.values:
                raise AssertionError(f"{name}: a condensed leaf's draft is {kind}, sharing "
                                     f"values: {draft.values is cond.values}")
            case("K1", "target", name, dtype_name, cm.condensed_matmul,
                 ref.condensed_matmul_ref, (cond.values, cond.indices), d_out * k * (isz + 4), x)
            case("K4", "sentinel draft", name, dtype_name,
                 lambda xx, v, i, o: sm.condensed_over_active_matmul(xx, v, i, o, d_out),
                 lambda xx, v, i, o: ref.condensed_over_active_matmul_ref(xx, v, i, o, d_out),
                 (draft.values, draft.indices, draft.out_index), d_out * (k * (isz + 4) + 4), x)
            if dtype_name != "bfloat16":
                continue
            q = F.Condensed.export_from_dense(w, mask, quantize_spec="int8")
            qd, _ = PLAN.derive_draft_leaf(q, w, mask, 0.5)
            case("K2", "int8 target", name, dtype_name,
                 lambda xx, v, i, s: cm.condensed_matmul(xx, v, i, scales=s),
                 ref.condensed_matmul_scaled_ref, (q.values, q.indices, q.scales),
                 d_out * (k * 5 + 4), x)
            case("K2-coa", "int8 sentinel", name, dtype_name,
                 lambda xx, v, i, o, s: sm.condensed_over_active_matmul(xx, v, i, o, d_out,
                                                                       scales=s),
                 lambda xx, v, i, o, s: ref.condensed_over_active_matmul_scaled_ref(
                     xx, v, i, o, s, d_out),
                 (qd.values, qd.indices, qd.out_index, qd.scales), d_out * (k * 5 + 8), x)
            only = _ablated(torch.ones_like(mask), ABLATION)
            tgt = F.StructuredFanIn.export_from_dense(w, only)
            sub, kind = PLAN.derive_draft_leaf(tgt, w, only, 0.5)
            if kind != "subset":
                raise AssertionError(f"{name}: a structured leaf's draft is {kind}")
            wd = w.to(dtype)

            def k5(xx, ww, ai):
                return sm.structured_matmul(xx, ww, ai, prefetch_gather=False)

            def k5_plain(xx, ww, ai):
                return ref.structured_matmul_ref(xx, sm._gather_columns(ww, ai), ai, d_out)

            for what, leaf in (("structured target", tgt), ("subset draft", sub)):
                a_pad = leaf.active_index.shape[0]
                y8 = case("K5", what, name, dtype_name, k5, k5_plain,
                          (wd, leaf.active_index), d_in * a_pad * isz + a_pad * 4, x)
            y6 = sm.structured_matmul_prefetch(x[:rows[0]], wd, sub.active_index)
            if not torch.equal(y6, y8):
                raise AssertionError(f"K6 {name}: the subset draft's prefetch launch is not "
                                     f"bitwise K5's")
            print(f"[kernel:spec] K6     subset draft     {name:6s} bfloat16: {rows[0]} rows "
                  f"== K5's decode launch bitwise ({sub.active_index.shape[0]} of {d_out} "
                  f"columns, {int((sub.active_index < d_out).sum())} live)")
            del q, qd, tgt, sub, wd
        del mask, w
    torch.cuda.empty_cache()
    return cases


def _spec_masks(reg, masks) -> dict:
    return {"plain": masks, "only": _ablation_only(reg, masks, ABLATION)}


def profile_phase(setup: dict, card: str):
    """HardwareProfile.measure on the card (CUDA events over replayed work;
    K1 at the reference's gather points, float32 as the reference
    measures), cached in build/autotune.json and read back; the plan's
    per-stack decisions at PROFILE_BUCKETS under the default and the
    measured profile, on the 90% masks and the half-ablated ones. A
    decision that differs at bucket 8 (B = 4) is served end to end under
    both profiles (--path auto, one B = 4 request, bf16, warm then timed),
    and both walls are printed. Returns the measured profile."""
    import torch
    from repro_torch.launch import engine as E
    from repro_torch.sparse import autotune as AT
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import plan as PLAN

    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(REPO / "build" / "autotune.json")
    AT.reset_cache_state()
    device = setup["params"]["embed"].device
    d = PLAN.DEFAULT_PROFILE
    t0 = time.perf_counter()
    prof = PLAN.HardwareProfile.measure(device=device, use_cache=False)
    took = time.perf_counter() - t0
    if PLAN.HardwareProfile.measure(device=device) != prof:
        raise AssertionError("the measured profile did not round-trip through the cache")
    print(f"[profile:measured] {card}: hbm {prof.hbm_bytes_per_s / 1e12:.4f} TB/s (default "
          f"{d.hbm_bytes_per_s / 1e12:.4f}), float32 matmul (128x2048x1024) "
          f"{prof.mxu_flops_per_s / 1e12:.3f} TFLOP/s (default, the bf16 peak, "
          f"{d.mxu_flops_per_s / 1e12:.1f}), K1 float32 gather "
          f"{prof.gather_flops_per_s / 1e12:.4f} TFLOP/s at B={prof.gather_small_batch} -> "
          f"{prof.gather_flops_per_s_large / 1e12:.4f} at B={prof.gather_large_batch} "
          f"(default {d.gather_flops_per_s / 1e12:.4f}, one point); measured in "
          f"{took * 1e3:.1f} ms, cached in {AT.cache_path()} and read back")
    base, reg = setup["base"], setup["reg"]
    itemsize = getattr(torch, base.param_dtype).itemsize
    differ = {}
    for label, m in (("90%", setup["masks"]), ("ablated", _ablate_masks(reg, setup["masks"],
                                                                          ABLATION))):
        stats = COND.export_stats(reg, m)
        for b in PROFILE_BUCKETS:
            reps = [[PLAN.select_representation(s, batch_size=b, itemsize=itemsize,
                                                stats=stats[s.name], profile=p).representation
                     for s in reg] for p in (d, prof)]
            if reps[0] != reps[1] and b == SPEC_BUCKET:
                differ[label] = m
            print(f"[profile:measured] {label} masks, bucket {b}: default {reps[0]} | measured "
                  f"{reps[1]}" + ("  <- differs" if reps[0] != reps[1] else ""))
    for label, m in differ.items():
        walls, toks = {}, {}
        for name, p in (("default", d), ("measured", prof)):
            eng = E.ServingEngine(base.replace(dtype="bfloat16"), setup["params"], m, reg,
                                  path="auto", profile=p, block_size=ENGINE_BLOCK,
                                  gen_chunk=ENGINE_CHUNK)
            for _ in range(2):  # warm, then timed
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                rid = eng.submit(setup["prompts"], GEN)
                eng.step()
                [res] = eng.retire(rid)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t1
            toks[name] = res.tokens
            del eng
            _release()
        print(f"[profile:measured] {label} masks, bucket {SPEC_BUCKET} served end to end "
              f"(B={BATCH}, prompt {PROMPT}, {GEN} new tokens, bf16, --path auto): default "
              f"wall {walls['default'] * 1e3:.2f} ms, measured wall "
              f"{walls['measured'] * 1e3:.2f} ms; tokens equal: "
              f"{bool(torch.equal(toks['default'], toks['measured']))}")
    if not differ:
        print(f"[profile:measured] no decision differs at bucket {SPEC_BUCKET}: nothing to "
              f"serve under both")
    return prof


def _prefix_gap(cfg, compute, tree, tokens) -> float:
    """The top-2 logit gap of the next token after ``tokens`` (1, n): one
    contiguous-cache prefill of the prefix."""
    import torch
    from repro_torch.models import model as M
    with torch.no_grad():
        cache = M.init_cache(cfg, 1, tokens.shape[1], tokens.device)
        logits, _ = M.prefill_step(cfg, compute, tree, {"tokens": tokens}, cache)
        top2 = logits[0, :cfg.vocab_size].topk(2).values
    return (top2[0] - top2[1]).item()


def _replay_ms(decoder, reps: int = 10) -> float:
    """Device ms of one replay of ``decoder``'s graph (median of ``reps``;
    the step index is reset before each, outside the timed span)."""
    import torch
    times = []
    for _ in range(reps):
        decoder.state.step.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        decoder.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _spec_expected(eng, dispatches: dict) -> dict:
    """Kernel launches the plans and draft kinds imply for ``dispatches``
    ({plan key: (prefills, rounds)}): each stack's target kernel
    ``_applications`` times per prefill and per verify, its draft's kernel
    gamma times as often a round; an MoE expert stack's through its
    expert-grouped launch."""
    from repro_torch.sparse import registry as REG
    quant = eng.values_dtype is not None
    target = {"condensed": "K2" if quant else "K1",
              "condensed_over_active": "K2-coa" if quant else "K4", "structured": "K5"}
    draft = {"sentinel": "K2-coa" if quant else "K4", "subset": "K5"}
    grouped = {"K1": "K1-moe", "K2": "K2-moe", "K4": "K4-moe", "K2-coa": "K2-coa-moe",
               "K5": "K5-moe"}
    stacks = {s.name: s for s in eng.registry}
    gamma = eng.speculative.gamma
    expected = _none()
    for key, (prefills, rounds) in dispatches.items():
        report = eng._draft_reports[key]
        for name, rep in key.formats:
            runs = _applications(eng.cfg, stacks[name])
            expert = REG.is_expert_stack(stacks[name], eng.cfg)
            if rep in target:
                expected[grouped[target[rep]] if expert else target[rep]] += \
                    runs * (prefills + rounds)
            kind = report[name]
            kern = draft.get(kind) if kind != "identity" else target.get(rep)
            if kern:
                expected[grouped[kern] if expert else kern] += runs * gamma * rounds
    return expected


def spec_phase(setup: dict, card: str, measured) -> None:
    """Self-draft speculative decoding in the paged engine at full width,
    gamma = 3, ENGINE_MIX, one warm wave then one timed wave, beside the
    plain engine (graph decode) on the same path, masks and mix in the same
    call: condensed with draft ablation 0.5 (sentinel drafts: K4, verify
    K1), 0.0 (the protocol's ceiling) and in f32, and structured on
    ablation-only masks (subset drafts and verify on K5). Gates: the draft
    and verify are replayed graphs, none captured in the timed wave and no
    result cold; the timed wave launches each kernel as the plans and draft
    kinds imply; pages all back after each wave; no extra draft weight
    bytes; every stream equals the plain engine's or parts at a top-2 gap
    under the tie rule (f32: only below 1e-3); at draft ablation 0.0 every
    rejected draft is at such a tie. Prints acceptance, rounds, full-network
    dispatches per token, draft and verify device ms a round (CUDA events),
    both tok/s, launches a round, and SpecEstimate under the default and the
    measured profile beside the measured step ratios. Configurations that
    share the path, masks and dtype share one plain engine's waves."""
    import torch
    from repro_torch.launch import engine as E
    from repro_torch.launch import speculative as SP
    from repro_torch.sparse import plan as PLAN

    base, reg, params = setup["base"], setup["reg"], setup["params"]
    masks_of = _spec_masks(reg, setup["masks"])
    gamma = SPEC_GAMMA
    tokens_per_wave = sum(b * g for b, _, g in ENGINE_MIX)
    plain_runs: dict = {}       # (path, masks, dtype): the plain engine's timed wave
    for label, path, mk, ablation, dtype_name in SPEC_RUNS:
        t_run = time.perf_counter()
        cfg = base.replace(dtype=dtype_name)
        m = masks_of[mk]
        if (path, mk, dtype_name) not in plain_runs:
            plain_runs.clear()
            gc.collect()
            plain = E.ServingEngine(cfg, params, m, reg, path=path, block_size=ENGINE_BLOCK,
                                    gen_chunk=ENGINE_CHUNK)
            _part("setup")
            _engine_wave(label + ":plain", plain, ENGINE_MIX, seed=1)
            plain_res, plain_wall = _engine_wave(label + ":plain", plain, ENGINE_MIX, seed=2)
            plain_step_ms = _replay_ms(plain._runners[plain.plan_key(SPEC_BUCKET)].decoder)
            _part("plain")
            plain_runs[(path, mk, dtype_name)] = (plain, plain_res, plain_wall, plain_step_ms)
        plain, plain_res, plain_wall, plain_step_ms = plain_runs[(path, mk, dtype_name)]

        eng = E.ServingEngine(cfg, params, m, reg, path=path, block_size=ENGINE_BLOCK,
                              gen_chunk=ENGINE_CHUNK,
                              speculative=SP.SpecConfig(gamma=gamma, draft_ablation=ablation,
                                                        force=True))
        _part("setup")
        _engine_wave(label, eng, ENGINE_MIX, seed=1)
        _part("capture")
        programs = {k: eng.program_count(k) for k in ("prefill", "draft", "verify")}
        if not programs["draft"] or programs["draft"] != programs["verify"] or \
                eng.program_count("decode"):
            raise AssertionError(f"{label}: graphs {programs}, decode "
                                 f"{eng.program_count('decode')}")
        if any(r.draft.graph is None or r.verify.graph is None
               for r in eng._runners.values()):
            raise AssertionError(f"{label}: a draft or verify step is not a captured graph")
        before = {key: (r.prefills, r.rounds, r.draft_s, r.verify_s)
                  for key, r in eng._runners.items()}
        _zero_counts()
        res, wall = _engine_wave(label, eng, ENGINE_MIX, seed=2)
        _part("serve")
        counts = _counts()
        after = {k: eng.program_count(k) for k in ("prefill", "draft", "verify")}
        if after != programs:
            raise AssertionError(f"{label}: the timed wave ran new signatures {programs} -> "
                                 f"{after}")
        cold = sorted(rid for rid, (_, _, r) in res.items() if r.cold)
        if cold:
            raise AssertionError(f"{label}: timed-wave requests {cold} are cold")
        dispatches = {key: (r.prefills - before.get(key, (0,) * 4)[0],
                            r.rounds - before.get(key, (0,) * 4)[1])
                      for key, r in eng._runners.items()}
        expected = _spec_expected(eng, dispatches)
        if counts != expected:
            raise AssertionError(f"{label}: the timed wave launched {counts}, the plans and "
                                 f"draft kinds imply {expected}")
        rounds = sum(r for _, r in dispatches.values())
        in_prefill = _spec_expected(eng, {k: (p, 0) for k, (p, _) in dispatches.items()})
        per_round = {k: round((v - in_prefill[k]) / max(rounds, 1), 2)
                     for k, v in counts.items() if v - in_prefill[k]}
        key8 = eng.plan_key(SPEC_BUCKET)
        target, draft = eng.serving_tree_for(key8), eng.draft_tree_for(key8)
        shared, extra = PLAN.draft_weight_overhead_bytes(reg, target, draft)
        if extra:
            raise AssertionError(f"{label}: the draft holds {extra} value bytes of its own")
        kinds = sorted(set(eng._draft_reports[key8].values()))

        # tokens against the plain engine's (same ids: both engines saw the
        # same two waves)
        tie = TIE_GAP[dtype_name]
        equal = total = 0
        for rid, (p, g, r) in res.items():
            want = plain_res[rid][2].tokens
            t = p.shape[1]
            div = _first_divergence(r.tokens[:, t:], want[:, t:])
            total += len(div)
            equal += sum(j is None for j in div)
            if all(j is None for j in div):
                continue
            if dtype_name != "float32":
                tie = max(TIE_GAP[dtype_name],
                          2 * _engine_noise(cfg, plain, r.plan_key,
                                            plain.serving_tree_for(r.plan_key), p.to(plain.device)))
            for i, j in enumerate(div):
                if j is None:
                    continue
                gap = _prefix_gap(cfg, plain.compute, plain.serving_tree_for(r.plan_key),
                                  want[i:i + 1, :t + j])
                print(f"[{label}] request {rid} stream {i}: parts from plain graph decode at "
                      f"generated token {j}, top-2 gap {gap:.3g} (tie below {tie:.3g})")
                if gap >= tie:
                    raise AssertionError(f"{label}: request {rid} differs from plain decode "
                                         f"at a gap of {gap}")
        _part("checks")
        stats = [r.spec for _, _, r in res.values()]
        drafted = sum(s["drafted"] for s in stats)
        matched = sum(s["matched"] for s in stats)
        acceptance = matched / max(drafted, 1)
        fdpt = statistics.mean(s["full_dispatches_per_token"] for s in stats)
        if ablation == 0.0:
            largest = 0.0
            rejects = {(rid, i, q) for rid, (_, _, r) in res.items()
                       for i, q in r.spec["rejected"]}
            for rid, i, q in sorted(rejects):
                p, _, r = res[rid]
                t = p.shape[1]
                tree = eng.serving_tree_for(r.plan_key)
                gap = _prefix_gap(cfg, eng.compute, tree, r.tokens[i:i + 1, :t + q])
                tie0 = TIE_GAP[dtype_name] if dtype_name == "float32" else max(
                    TIE_GAP[dtype_name],
                    2 * _engine_noise(cfg, eng, r.plan_key, tree, p.to(eng.device)))
                print(f"[{label}] request {rid} stream {i}: draft rejected at generated token "
                      f"{q}, top-2 gap {gap:.3g} (tie below {tie0:.3g})")
                if gap >= tie0:
                    raise AssertionError(f"{label}: a draft rejected at draft ablation 0 at a "
                                         f"top-2 gap of {gap}")
                largest = max(largest, gap)
            print(f"[{label}] draft ablation 0.0: {len(rejects)} rejections in "
                  f"{drafted} drafts, each at a tie (largest gap {largest:.3g}); acceptance "
                  f"{acceptance:.4f}")
        _part("checks")
        runner8 = eng._runners[key8]
        _, rounds0, draft0, verify0 = before.get(key8, (0,) * 4)
        draft_ms = (runner8.draft_s - draft0) / (runner8.rounds - rounds0) * 1e3
        verify_ms = (runner8.verify_s - verify0) / (runner8.rounds - rounds0) * 1e3
        draft_step_ms = _replay_ms(runner8.draft)
        verify_step_ms = _replay_ms(runner8.verify)
        _part("timing")
        ests = {name: PLAN.price_speculation(reg, target, draft, batch_size=SPEC_BUCKET,
                                             gamma=gamma, acceptance=a, profile=p)
                for name, p, a in (("default", PLAN.DEFAULT_PROFILE, 0.7),
                                   ("measured", measured, 0.7),
                                   ("measured at the measured acceptance", measured,
                                    acceptance))}
        est_s = "; ".join(
            f"{n}: draft/target {e.draft_step_s / e.target_step_s:.3f}, verify/target "
            f"{e.verify_s / e.target_step_s:.3f}, {e.spec_s_per_token * 1e6:.2f} vs "
            f"{e.base_s_per_token * 1e6:.2f} us/token at acceptance {e.acceptance:.3f} -> auto "
            f"would {'run' if e.worthwhile else 'decline'}" for n, e in ests.items())
        print(f"[{label}] {card}: {dtype_name}, gamma {gamma}, draft ablation {ablation} "
              f"({'/'.join(kinds)} drafts); timed wave {wall:.3f}s = "
              f"{tokens_per_wave / wall:.1f} tok/s vs plain graph decode {plain_wall:.3f}s = "
              f"{tokens_per_wave / plain_wall:.1f} tok/s ({plain_wall / wall:.3f}x); acceptance "
              f"{acceptance:.4f} ({matched}/{drafted}), {rounds} rounds, full-network "
              f"dispatches/token {fdpt:.4f} (mean over requests); bucket {SPEC_BUCKET} per "
              f"round: draft {draft_ms:.3f} ms + verify {verify_ms:.3f} ms device (events); "
              f"one replay: draft step {draft_step_ms:.3f} ms, verify {verify_step_ms:.3f} ms, "
              f"plain decode step {plain_step_ms:.3f} ms (draft/plain "
              f"{draft_step_ms / plain_step_ms:.3f}, verify/plain "
              f"{verify_step_ms / plain_step_ms:.3f}); graphs: draft {programs['draft']}, "
              f"verify {programs['verify']}, none new in the timed wave, no cold result; "
              f"launches {counts} as the plans imply, per round {per_round}; pages all back "
              f"after each wave; draft weight bytes shared {shared}, extra {extra}; streams "
              f"bitwise equal to plain graph decode {equal}/{total}")
        print(f"[{label}] SpecEstimate at bucket {SPEC_BUCKET}: {est_s}")
        print(f"[time] {label}: {time.perf_counter() - t_run:.1f}s")
        del eng, plain, res, plain_res
        _release()
    plain_runs.clear()
    _release()


# ---------------------------------------------------------------------------
# [autotune]: the launch-configuration search
# ---------------------------------------------------------------------------

# the batches the search runs at: buckets 8, 32 and 128
AUTOTUNE_BATCHES = (BATCH, 32, 128)


def _rows_bitwise(got, want) -> int:
    """The rows of ``got`` whose bits equal ``want``'s (leading dims
    flattened: an (E, M, n) grouped output has E * M rows)."""
    import torch
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    got, want = (t.reshape(-1, t.shape[-1]).contiguous().view(view) for t in (got, want))
    return int((got == want).all(dim=1).sum())


def _autotune_key(label: str, kind: str, cands, operands, plain, search) -> dict:
    """Every candidate launch of one key run once and held bitwise, row by
    row, to the default launch (the first candidate; all outputs kept
    alive, so no candidate's output lands on another's); then the timed
    search on the same seeded operands, and its winner held to the plain
    version at the [kernel] tolerance."""
    import torch
    from repro_torch.sparse import autotune as AT
    outs = [AT.candidate_call(kind, *c)(*operands) for c in cands]
    torch.cuda.synchronize()
    rows = outs[0].shape[0]
    for c, out in zip(cands, outs):
        same = _rows_bitwise(out, outs[0])
        if same != rows:
            raise AssertionError(f"[autotune] {label}: launch {AT._label(*c)} equals the "
                                 f"default launch in {same}/{rows} rows")
    res = search()
    if list(res.table) != [AT._label(*c) for c in cands]:
        raise AssertionError(f"[autotune] {label}: timed {list(res.table)}, listed {cands}")
    if res.us != min(res.table.values()) or res.speedup_vs_default < 1.0:
        raise AssertionError(f"[autotune] {label}: the winner is not its table's argmin")
    won = outs[cands.index((res.block_b, res.block_n))].float()
    want = plain(*operands).float()
    torch.testing.assert_close(won, want, **TOL["bfloat16"])
    err = (won - want).abs().max().item()
    print(f"[autotune] {label}: default {AT._label(*cands[0])} {res.default_us:.2f} us, best "
          f"{res.label} {res.us:.2f} us ({res.speedup_vs_default:.3f}x), {len(res.table)} "
          f"candidates timed, each bitwise the default in all {rows} rows; winner vs plain "
          f"max_abs_err {err:.3g}; key {res.key}")
    return dict(label=label, key=res.key, default=AT._label(*cands[0]),
                default_us=res.default_us, best=res.label, us=res.us,
                candidates=len(res.table), max_abs_err=err, table=res.table)


def _autotune_request(eng, prompts) -> tuple:
    """One B = 4, prompt 32, 16-token request served twice (warm, then
    timed): its tokens, the timed wall and the timed request's launches."""
    import torch
    for _ in range(2):
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        rid = eng.submit(prompts, GEN)
        eng.step()
        [res] = eng.retire(rid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res.tokens, wall, _counts()


@contextlib.contextmanager
def _recorded_launches():
    """Record every launch configuration ``condensed_matmul.launch_args``
    gives while the block runs (graph captures included; a replay makes
    none): a set of (d_in, rows, batch rows, block_rows, block_neurons,
    decode_loads)."""
    from repro_torch.kernels import condensed_matmul as cm
    real, seen = cm.launch_args, set()

    def spy(x, n_rows, block_rows, sm_count, block_n=None):
        out = real(x, n_rows, block_rows, sm_count, block_n)
        seen.add((x.shape[1], n_rows, x.shape[0], out[0], out[4], out[5]))
        return out
    cm.launch_args = spy
    try:
        yield seen
    finally:
        cm.launch_args = real


def _alternate_ms(a, b, rounds: int = 6) -> tuple[float, float]:
    """Device ms of one replay of captured step ``a`` and of ``b`` (medians
    of ``_replay_ms``), replayed in turns: a b, b a, a b, ..."""
    ta, tb = [], []
    for i in range(rounds):
        for step, times in ((a, ta), (b, tb))[::1 if i % 2 == 0 else -1]:
            times.append(_replay_ms(step))
    return statistics.median(ta), statistics.median(tb)


def _check_capture(label: str, reg, stats, device, launched, pairs: dict) -> list:
    """Gate that an engine's decode graph captured the launches it should:
    for each stack, the decode step (at most SMALL_BATCH_MAX rows) made one
    launch configuration in the capture (``launched``, from
    ``_recorded_launches``), and it is the launch of ``pairs[name]``
    ((block_b, block_n); (None, None): the default). Where the pair is the
    cache's entry, ``ops._resolve_blocks`` at the step's rows must return
    it too (the key ops reads is the key autotune wrote). Returns the
    stacks whose launch differs from the default."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ops
    from repro_torch.sparse import autotune as AT
    from repro_torch.sparse import formats as F
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    differ = {}
    for s_ in reg:
        spec = F.spec_for_stack(s_, stats[s_.name], 2)
        entry = AT.lookup_entry(F.Condensed.spec_tuning_key(spec, BATCH))
        pair = pairs[s_.name]
        at = {c for c in launched
              if c[:2] == (s_.d_in, s_.d_out) and c[2] <= cm.SMALL_BATCH_MAX}
        rows = next(iter(at))[2] if len(at) == 1 else None

        def launch(block_b, block_n):
            meta = torch.empty((rows, s_.d_in), dtype=torch.bfloat16, device="meta")
            tile = cm.decode_rows(rows) if block_b is None else block_b
            out = cm.launch_args(meta, s_.d_out, tile, sms, block_n)
            return (s_.d_in, s_.d_out, rows, out[0], out[4], out[5])
        if rows is None or at != {launch(*pair)}:
            raise AssertionError(f"[autotune:engine] {s_.name}: the {label} decode capture "
                                 f"launched {sorted(at)}, expected the launch of {pair}")
        if entry is not None and pair == (entry["block_b"], entry["block_n"]):
            x = torch.empty((rows, s_.d_in), dtype=torch.bfloat16, device=device)
            got = ops._resolve_blocks(x, s_.d_out, spec.k, None, None)
            if got != pair:
                raise AssertionError(f"[autotune:engine] {s_.name}: ops resolves {got} at "
                                     f"{rows} rows, the entry is {entry}")
        if launch(*pair) != launch(None, None):
            differ[s_.name] = (f"{AT._label(*pair)} (default "
                               f"{AT._label(None, launch(None, None)[4])})")
    return [f"{name} {text}" for name, text in differ.items()]


def autotune_phase(setup: dict, card: str, smi: str) -> list:
    """The launch-configuration search at full width, bf16, at B = 4, 32 and
    128 (buckets 8, 32 and 128) on qwen3-1.7b's SRigL stacks (wo 2048 ->
    2048 k 293, w_gate / w_up 2048 -> 6144 k 195, w_down 6144 -> 2048 k
    585): every candidate of K1, of K4 on half of each stack's rows (the
    half-ablated masks), of K2 on int8 codes at bucket 8 and of K5 over the
    ablation-only masks' surviving columns, each held bitwise, row by row,
    to the default launch, the winner to its plain version; per key the
    default's and the winner's µs and the candidates timed, and for K5 the
    plan's price of a layer with and without the reference's one-hot
    epilogue term. Then, with $REPRO_TORCH_AUTOTUNE_CACHE on a file of its
    own: a condensed engine serves a B = 4 request untuned, a second engine
    runs ServingEngine.autotune(4) and serves it tuned; the tokens must be
    equal bitwise and K1 the only kernel, 4 * 28 * 17 launches; each decode
    capture's launches are recorded and held to each stack's entry (the
    untuned one's to the default), and a third engine, with every entry
    set by hand to a decode launch other than the default, must capture
    those, same tokens; the two first engines' decode steps are replayed
    in turns (the untuned one's graph, captured before autotune, keeps its
    launches). Last a speculative
    engine (gamma 3, draft ablation 0.5) serves the request without
    bucket-32 entries, runs autotune(32), and a fresh one serves it with
    them: tokens equal, the two verify graphs' device ms in turns. Returns
    the per-key records."""
    import torch
    from types import SimpleNamespace
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.launch import engine as E
    from repro_torch.launch import speculative as SP
    from repro_torch.sparse import autotune as AT
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import plan as PLAN

    base, reg, params, masks = setup["base"], setup["reg"], setup["params"], setup["masks"]
    device = params["embed"].device
    bf16 = torch.bfloat16
    print(f"[autotune] {smi}: the launch search, bf16, B = {AUTOTUNE_BATCHES} (buckets "
          f"{tuple(PLAN.batch_bucket(b) for b in AUTOTUNE_BATCHES)}), L2 kept cold by copies")
    shapes = {}
    for s_ in reg:  # w_up has w_gate's shape
        shapes.setdefault((s_.d_in, s_.d_out), (s_.path[-1], setup["k_fan"][s_.path[-1]]))
    kw = dict(dtype=bf16, device=device, save=False)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    records = []
    for (d_in, d_out), (name, k) in shapes.items():
        a = d_out - max(1, int(d_out * ABLATION))
        a_pad = sm.padded_active_count(a, d_out)
        for b in AUTOTUNE_BATCHES:
            bucket = PLAN.batch_bucket(b)
            where = f"{name} {d_in}->{d_out} B={b} (bucket {bucket})"

            def gather(rows):
                return cm.gather_candidates(bucket, d_in, rows, bf16, sm_count=sms)
            jobs = [("K1", "condensed", gather(d_out),
                     AT.gather_operands(b, d_in, d_out, k, dtype=bf16, device=device),
                     cm._plain, lambda: AT.autotune_blocks(b, d_in, d_out, k, **kw)),
                    (f"K4 {a} rows", "coa", gather(a),
                     AT.gather_operands(b, d_in, a, k, dtype=bf16, device=device, d_out=d_out),
                     sm._coa_plain, lambda: AT.autotune_coa_blocks(b, d_in, a, k, d_out, **kw)),
                    (f"K5 a_pad {a_pad}", "structured",
                     sm.structured_candidates(bucket, d_in, a_pad, bf16),
                     AT.structured_operands(b, d_in, a_pad, d_out, dtype=bf16, device=device),
                     ref.structured_matmul_ref,
                     lambda: AT.autotune_structured_blocks(b, d_in, a_pad, d_out, **kw))]
            if bucket == PLAN.batch_bucket(BATCH):
                jobs.append(("K2 int8", "condensed", gather(d_out),
                             AT.gather_operands(b, d_in, d_out, k, dtype=bf16, device=device,
                                                values_dtype="int8"),
                             cm._plain, lambda: AT.autotune_blocks(b, d_in, d_out, k,
                                                                   values_dtype="int8", **kw)))
            for kern, kind, cands, operands, plain, search in jobs:
                rec = _autotune_key(f"{kern} k={k if kind != 'structured' else 0} {where}",
                                    kind, cands, operands, plain, search)
                rec.update(kernel=kern.split()[0], stack=name, batch=b, bucket=bucket)
                records.append(rec)
                if kind == "structured":
                    # the plan's price of this layer, as the reference prices it (with
                    # its one-hot epilogue's a_pad * d_out flops a row) and without
                    st = F.ExportStats(k=d_in, max_active=a, active_fraction=a / d_out,
                                       min_fan_in=d_in)
                    spec = F.spec_for_stack(SimpleNamespace(d_in=d_in, d_out=d_out), st, 2)
                    prof = PLAN.DEFAULT_PROFILE
                    with_term = F.StructuredFanIn.estimate_cost(spec, bucket, prof)
                    without = max(F.StructuredFanIn.estimate_weight_bytes(spec)
                                  / prof.hbm_bytes_per_s,
                                  2.0 * bucket * a_pad * d_in / prof.mxu_flops_per_s)
                    rec.update(price_us=with_term * 1e6, price_without_epilogue_us=without * 1e6)
                    print(f"[autotune:epilogue] K5 {where}: measured default "
                          f"{rec['default_us']:.2f} us, tuned {rec['us']:.2f} us; "
                          f"StructuredFanIn.estimate_cost (default profile) "
                          f"{with_term * 1e6:.3f} us with the one-hot epilogue term, "
                          f"{without * 1e6:.3f} us without")
            del jobs
        _release()

    old = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    cache = REPO / "build" / "autotune_phase.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache)
    AT.reset_cache_state()
    try:
        cfg = base.replace(dtype="bfloat16")
        prompts = setup["prompts"]
        untuned = E.ServingEngine(cfg, params, masks, reg, path="condensed",
                                  block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK)
        with _recorded_launches() as launched_u:
            toks_u, wall_u, counts_u = _autotune_request(untuned, prompts)
        eng = E.ServingEngine(cfg, params, masks, reg, path="condensed",
                              block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK)
        t0 = time.perf_counter()
        tuned = eng.autotune(BATCH)
        took = time.perf_counter() - t0
        for name, res in tuned.items():
            print(f"[autotune:engine] autotuned {name}: best {res.label} ({res.us:.2f} us vs "
                  f"default {res.default_us:.2f} us, {len(res.table)} launches timed)")
        stats = eng.stats()
        missing = [s_.name for s_ in reg if AT.lookup_entry(F.Condensed.spec_tuning_key(
            F.spec_for_stack(s_, stats[s_.name], 2), BATCH)) is None]
        if missing or not tuned:
            raise AssertionError(f"[autotune:engine] tuned {sorted(tuned)}; no entry for "
                                 f"{missing}")
        with _recorded_launches() as launched_t:
            toks_t, wall_t, counts_t = _autotune_request(eng, prompts)
        entries = {s_.name: AT.lookup_entry(F.Condensed.spec_tuning_key(
            F.spec_for_stack(s_, stats[s_.name], 2), BATCH)) for s_ in reg}
        _check_capture("untuned", reg, stats, device, launched_u,
                       {n: (None, None) for n in entries})
        differ = _check_capture("tuned", reg, stats, device, launched_t,
                                {n: (e["block_b"], e["block_n"]) for n, e in entries.items()})
        # the same read with a launch that surely differs: each stack's entry
        # set by hand to a decode launch other than the default, and a fresh
        # engine's capture must take it, with the same tokens
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        saved = {k_: dict(v) for k_, v in AT._load()["kernels"].items()}
        forced = {}
        for s_ in reg:
            cands = cm.gather_candidates(PLAN.batch_bucket(BATCH), s_.d_in, s_.d_out, bf16,
                                         sm_count=sms)
            forced[s_.name] = next(c for c in cands[1:] if c[0] is None)
            AT._load()["kernels"][F.Condensed.spec_tuning_key(
                F.spec_for_stack(s_, stats[s_.name], 2), BATCH)] = dict(
                    block_b=forced[s_.name][0], block_n=forced[s_.name][1])
        other = E.ServingEngine(cfg, params, masks, reg, path="condensed",
                                block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK)
        with _recorded_launches() as launched_f:
            toks_f, _, counts_f = _autotune_request(other, prompts)
        forced_differ = _check_capture("forced", reg, stats, device, launched_f, forced)
        AT._load()["kernels"] = saved
        if not torch.equal(toks_f, toks_u) or len(forced_differ) != len(reg):
            raise AssertionError(f"[autotune:engine] the forced entries' engine: tokens equal "
                                 f"{torch.equal(toks_f, toks_u)}, launches that differ "
                                 f"{forced_differ}")
        del other
        print(f"[autotune:engine] decode captures at the step's rows: untuned == the default "
              f"launches, tuned == each stack's entry (ops resolves it), launches that differ "
              f"from the default: {', '.join(differ) or 'none'}; with entries forced by hand "
              f"to {', '.join(forced_differ)} a fresh engine's capture takes them, same tokens")
        want = {**_none(), "K1": 4 * base.n_layers * (1 + GEN)}
        for label, counts in (("untuned", counts_u), ("tuned", counts_t), ("forced", counts_f)):
            if counts != want:
                raise AssertionError(f"[autotune:engine] {label} request launched {counts}, "
                                     f"expected {want}")
        if not torch.equal(toks_u, toks_t):
            raise AssertionError("[autotune:engine] tuned tokens differ from untuned")
        # the untuned engine's decode graph was captured before autotune and
        # keeps its launches; the two steps replayed in turns
        step_u, step_t = _alternate_ms(untuned._runners[untuned.plan_key(BATCH)].decoder,
                                       eng._runners[eng.plan_key(BATCH)].decoder)
        n_tok = BATCH * GEN
        print(f"[autotune:engine] {card}: condensed bf16, B={BATCH} prompt {PROMPT} + {GEN}: "
              f"autotune({BATCH}) {took:.2f}s; tuned tokens == untuned bitwise; K1 "
              f"{counts_t['K1']} launches a request, tuned and untuned; wall {wall_t * 1e3:.2f} "
              f"ms ({n_tok / wall_t:.1f} tok/s) tuned vs {wall_u * 1e3:.2f} ms "
              f"({n_tok / wall_u:.1f} tok/s) untuned; one decode step's replay "
              f"{step_t:.3f} ms device tuned vs {step_u:.3f} ms untuned, in turns (findings, "
              f"not gated)")
        del eng, untuned
        gc.collect()

        spec = SP.SpecConfig(gamma=SPEC_GAMMA, draft_ablation=0.5, force=True)
        untuned = E.ServingEngine(cfg, params, masks, reg, path="condensed",
                                  block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK,
                                  speculative=spec)
        toks_s, _, _ = _autotune_request(untuned, prompts)
        rows = SPEC_BUCKET * (SPEC_GAMMA + 1)
        tuned32 = untuned.autotune(rows)  # its graphs, captured before, keep their launches
        eng = E.ServingEngine(cfg, params, masks, reg, path="condensed",
                              block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK, speculative=spec)
        toks_s2, _, _ = _autotune_request(eng, prompts)
        if not torch.equal(toks_s, toks_s2):
            raise AssertionError("[autotune:verify] tokens differ with the bucket-32 entries")
        verify_u, verify_t = _alternate_ms(
            untuned._runners[untuned.plan_key(SPEC_BUCKET)].verify,
            eng._runners[eng.plan_key(SPEC_BUCKET)].verify)
        best = ", ".join(f"{n} {r.label} {r.us:.2f} us (default {r.default_us:.2f})"
                         for n, r in tuned32.items())
        print(f"[autotune:verify] {card}: one speculative verify (gamma {SPEC_GAMMA}, bucket "
              f"{SPEC_BUCKET}, {rows} rows, bf16) {verify_t:.3f} ms device with the bucket-32 "
              f"entries ({best}) vs {verify_u:.3f} ms without, replayed in turns; tokens "
              f"equal")
        del eng, untuned
        _release()
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = old
        AT.reset_cache_state()
    return records


def _map_leaves(tree: dict, fn) -> dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# [grad]: the values gradient against the masked loss's dense gradient at
# the condensed indices, as max |difference| / max |dense gradient|; in
# float32 the two differ only by summation order (forward and backward)
GRAD_F32_BOUND = 1e-4
# [reference] trainer: card vs CPU losses (float32 sums in other orders,
# over six AdamW steps) and the smoke values gradient card vs CPU
TRAIN_LOSS_TOL = 1e-4
SMOKE_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _train_batch(cfg, device, step: int = 0, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ):
    """Step ``step`` of the train CLI's synthetic stream (seed 0) on ``device``."""
    from repro_torch.data.pipeline import SyntheticLM, to_tensors
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch, seed=0)
    return {k: v.to(device) for k, v in to_tensors(data.batch(step)).items()}


def _sparse_grads(cfg, reg, params, masks, batch):
    """loss_fn over bool masks and its dense gradient at each sparse stack."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG
    leaves = [REG.get_path(params, s.path) for s in reg]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = M.loss_fn(cfg, params, masks, batch)[0]
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), {s.name: g for s, g in zip(reg, grads)}


def _gathered(dense, leaf, d_out: int):
    """The dense gradient (*lead, d_in, d_out) at a condensed leaf's slots:
    [..., r, j] = dense[..., indices[..., r, j], column of row r] (0 for a
    padding row)."""
    import torch
    g_t = dense.transpose(-1, -2)                                 # (*lead, d_out, d_in)
    out_index = getattr(leaf, "out_index", None)
    if out_index is not None:
        rows = out_index.long().clamp(max=d_out - 1)
        g_t = torch.gather(g_t, -2, rows[..., None].expand(*rows.shape, g_t.shape[-1]))
    got = torch.gather(g_t, -1, leaf.indices.long())
    if out_index is not None:
        got = got * (out_index < d_out)[..., None]
    return got


def _values_grad_check(label: str, cfg, reg, params, masks, tree, batch, kernel: str,
                       bound: float | None) -> tuple[dict, dict]:
    """Backpropagate loss_fn over ``tree`` (values requiring grad) with the
    counts zeroed just before and read just after, then hold each stack's
    values gradient to the masked loss's gathered dense gradient. Returns
    the counts and, per stack, (values gradient, gathered dense gradient)
    in float32."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG
    leaves = {s.name: REG.get_path(tree, s.path) for s in reg}
    for leaf in leaves.values():
        leaf.values.requires_grad_(True)
    per_pass = 4 * cfg.n_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _zero_counts()
    loss = M.loss_fn(cfg, params, tree, batch)[0]
    loss.backward()
    torch.cuda.synchronize()
    counts = _counts()
    step_s = time.perf_counter() - t0
    # forward 112, then 112 again when each checkpointed block is recomputed
    expected = {**_none(), kernel: 2 * per_pass, "K3": per_pass}
    if counts != expected:
        raise AssertionError(f"{label}: launched {counts}, expected {expected}")
    mloss, dense = _sparse_grads(cfg, reg, params, masks, batch)
    if not math.isfinite(loss.item()) or (
            bound is not None and abs(loss.item() - mloss.item()) > bound * abs(mloss.item())):
        raise AssertionError(f"{label}: loss {loss.item()} vs masked {mloss.item()}")
    worst = 0.0
    grads = {}
    for s in reg:
        leaf = leaves[s.name]
        got = leaf.values.grad.float()
        want = _gathered(dense[s.name], leaf, s.d_out).float()
        grads[s.name] = (got, want)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label} {s.name}: non-finite values gradient")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        worst = max(worst, rel)
        print(f"[grad:{label}] {s.name}: max |values grad - gathered dense grad| / max |dense "
              f"grad| = {rel:.3g} (max |dense grad| {want.abs().max().item():.3g})")
        if bound is not None and not rel <= bound:
            raise AssertionError(f"{label} {s.name}: {rel} above the bound {bound}")
        leaf.values.grad = None
        leaf.values.requires_grad_(False)
    print(f"[grad:{label}] loss {loss.item():.6f} (masked {mloss.item():.6f}); forward + "
          f"backward {step_s:.2f}s; launches {counts}; worst relative difference {worst:.3g}"
          + (f" (bound {bound:g})" if bound is not None else " (reported, not bounded)"))
    return counts, grads


def _bf16_gap(reg, found: dict) -> None:
    """Where the bf16 values gradient's distance from the masked path's
    comes from: each bf16 gradient against the float32 one (which the two
    paths agree on within GRAD_F32_BOUND), as max |difference| / max |f32
    dense gradient|, and the condensed bf16 gradient again with dx
    accumulated in float32."""
    for s in reg:
        got32, want32 = found["condensed f32"][s.name]
        got16, want16 = found["condensed bf16"][s.name]
        dx32 = found["condensed bf16, dx accumulated in f32"][s.name][0]
        scale = want32.abs().max()

        def rel(a, b):
            return ((a - b).abs().max() / scale).item()
        print(f"[grad:bf16] {s.name}: from the f32 gradient: condensed bf16 "
              f"{rel(got16, got32):.3g}, masked bf16 {rel(want16, want32):.3g}, condensed "
              f"bf16 with dx accumulated in f32 {rel(dx32, got32):.3g}; condensed vs masked "
              f"bf16 {rel(got16, want16):.3g}")


def grad_phase(setup: dict) -> int:
    """loss_fn over the condensed serving tree of full-width qwen3-1.7b (90%
    masks), backpropagated into the values, float32 and bfloat16 (and bf16
    again with the backward's dx scatter-add in float32, to place the bf16
    gap); then condensed_over_active on the ablated masks (K4 forward, K3
    backward). Returns K3's launches per backward."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.sparse import condensed as COND

    base, reg, params = setup["base"], setup["reg"], setup["params"]
    batch = _train_batch(base, params["embed"].device)
    ablated = _ablate_masks(reg, setup["masks"], ABLATION)
    runs = (("condensed f32", "float32", COND.export_condensed, setup["masks"], "K1",
             GRAD_F32_BOUND),
            ("condensed bf16", "bfloat16", COND.export_condensed, setup["masks"], "K1", None),
            ("condensed bf16, dx accumulated in f32", "bfloat16", COND.export_condensed,
             setup["masks"], "K1", None),
            ("condensed_over_active f32", "float32", COND.export_condensed_over_active,
             ablated, "K4", GRAD_F32_BOUND))
    plain_dx = ref.condensed_matmul_dx_ref
    k3, found = None, {}
    for label, dtype_name, export, masks, kernel, bound in runs:
        cfg = base.replace(dtype=dtype_name)
        tree = export(cfg, reg, params, masks)
        if "dx accumulated in f32" in label:
            ref.condensed_matmul_dx_ref = (
                lambda dy, v, i, d_in: plain_dx(dy.float(), v, i, d_in).to(dy.dtype))
        try:
            counts, grads = _values_grad_check(label, cfg, reg, params, masks, tree, batch,
                                               kernel, bound)
        finally:
            ref.condensed_matmul_dx_ref = plain_dx
        if kernel == "K1":
            found[label] = grads
        k3 = counts["K3"] if k3 is None else k3
        del tree, grads
        torch.cuda.empty_cache()
        if len(found) == 3:
            _bf16_gap(reg, found)
            found.clear()
    return k3


def _check_dst(cfg, reg, state, old_masks: dict, old_versions: dict) -> None:
    """The SRigL invariants after a DST update on the full-width state."""
    import torch
    from repro_torch.sparse import registry as REG
    for s in reg:
        spec = s.srigl_spec(cfg)
        new, old = REG.get_path(state.masks, s.path), REG.get_path(old_masks, s.path)
        act = REG.get_path(state.neuron_active, s.path)                  # (*lead, d_out)
        fan = new.sum(dim=-2)                                            # (*lead, d_out)
        k_new = torch.clamp(spec.target_nnz // act.sum(-1).clamp(min=1), 1, s.d_in)
        if not bool(torch.where(act, fan == k_new[..., None], fan == 0).all()):
            raise AssertionError(f"{s.name}: an active neuron's fan-in is not its layer's k'")
        if not bool((new.sum(dim=(-2, -1)) <= spec.k0 * s.d_out).all()):
            raise AssertionError(f"{s.name}: nnz above k0 * d_out")
        grown = new & ~old
        w = REG.get_path(state.params, s.path)
        if bool(w.masked_select(grown).any()):
            raise AssertionError(f"{s.name}: a grown weight is not 0")
        changed = not torch.equal(new, old)
        if int(state.mask_versions[s.name]) != old_versions[s.name] + int(changed):
            raise AssertionError(f"{s.name}: mask_versions did not follow the mask")
        print(f"[train] DST {s.name}: k' {int(k_new.min())}..{int(k_new.max())} (k0 "
              f"{spec.k0}), active neurons {act.float().mean().item():.4f}, grown "
              f"{int(grown.sum())}, pruned {int((old & ~new).sum())}, mask_versions "
              f"{int(state.mask_versions[s.name])}")


def _timed_dst(trainer, times: list, before=None) -> None:
    """Give ``trainer`` its step functions, its DST step timed (device
    synchronized on both sides, seconds appended to ``times``) and preceded
    by ``before(state)`` when given."""
    import torch
    from repro_torch.train.trainer import make_dst_step, make_train_step
    trainer._step_fn = make_train_step(trainer.cfg, trainer.registry, trainer.lr_fn)
    inner = make_dst_step(trainer.cfg, trainer.registry)

    def dst(state, batch):
        if before is not None:
            before(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    trainer._dst_fn = dst


def train_phase(device, card: str) -> list:
    """Full-width qwen3-1.7b training from a seeded random init: the CLI for
    3 steps, then the Trainer with delta_t=2 for 4 steps (two DST updates),
    each step and update checked; one more step timed and profiled. Returns
    the two DST steps' seconds."""
    import dataclasses
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.launch import train as TL
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sparse import registry as REG
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    _zero_counts()
    state = TL.main(["--arch", ARCH, "--steps", "3", "--batch", str(TRAIN_BATCH),
                     "--seq", str(TRAIN_SEQ)])
    torch.cuda.synchronize()
    if int(state.step) != 3 or _counts() != _none():
        raise AssertionError(f"CLI: step {int(state.step)}, launches {_counts()}")
    for name, t in (("params", state.params), ("mu", state.opt_state["mu"])):
        if not all(bool(torch.isfinite(v).all()) for v in _leaf_list(t)):
            raise AssertionError(f"CLI: non-finite {name}")
    print(f"[train] CLI --arch {ARCH} --steps 3 --batch {TRAIN_BATCH} --seq {TRAIN_SEQ}: "
          f"{time.perf_counter() - t0:.1f}s with init; params and moments finite; masked-dense "
          f"path, no port kernel launched")
    del state
    _release()

    torch.cuda.reset_peak_memory_stats()
    base = configs.get_config(ARCH)
    cfg = base.replace(sparsity=dataclasses.replace(base.sparsity, delta_t=2))
    trainer = Trainer(cfg=cfg, lr_fn=warmup_cosine(3e-3, 1, 6), log_every=1)
    reg = trainer.registry
    dst_times: list = []
    _timed_dst(trainer, dst_times)
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                       seed=0)
    batches = Prefetcher(data.iterate(), depth=2, pin=True)
    logs: list = []
    try:
        for i in range(4):
            old_masks, old_versions = state.masks, {k: int(v) for k, v in
                                                    state.mask_versions.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.fit(state, batches, 1, log_fn=logs.append)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            m = trainer.last_metrics
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"step {i}: loss {loss}, grad norm {gnorm}")
            dst = (i + 1) % 2 == 0
            print(f"[train] step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}, lr "
                  f"{float(m['lr']):.3g}, {dt:.3f}s" + (" with the DST update" if dst else ""))
            if dst:
                _check_dst(cfg, reg, state, old_masks, old_versions)
            else:
                for s in reg:  # the optimizer re-masked the moments
                    mask = REG.get_path(state.masks, s.path)
                    for moment in ("mu", "nu"):
                        mom = REG.get_path(state.opt_state[moment], s.path)
                        if bool(mom.masked_fill(mask, 0.0).any()):
                            raise AssertionError(f"step {i} {s.name}: {moment} is not 0 "
                                                 f"off the mask")
            del old_masks
        if _counts() != _none():
            raise AssertionError(f"the masked-dense trainer launched {_counts()}")
        batch = {k: v.to(device) for k, v in next(batches).items()}
    finally:
        batches.close()
    step_fn = trainer._step_fn
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] {card}: init {init_s:.1f}s; train step ({TRAIN_BATCH}x{TRAIN_SEQ} tokens, "
          f"no DST) {min(times) * 1e3:.1f} ms (of {[round(t * 1e3, 1) for t in times]}); "
          f"{TRAIN_TOKENS / min(times):.0f} tokens/s; peak device memory {peak:.1f} GiB; "
          f"every loss and grad norm finite, DST invariants held, moments 0 off the mask")
    print(f"[train] {card}: SRigL DST step (dense gradient recomputed, then the update "
          f"over {len(reg)} stacks) {[round(t * 1e3, 1) for t in dst_times]} ms")
    _device_profile(lambda: step_fn(state, batch), "train",
                    f"train step {TRAIN_BATCH}x{TRAIN_SEQ}")
    del state, trainer, step_fn
    _release()
    return dst_times


def _moments_off_mask(label: str, reg, state) -> None:
    """AdamW's moments are 0 wherever the mask is off."""
    from repro_torch.sparse import registry as REG
    for s in reg:
        mask = REG.get_path(state.masks, s.path)
        for moment in ("mu", "nu"):
            if bool(REG.get_path(state.opt_state[moment], s.path).masked_fill(mask, 0.0).any()):
                raise AssertionError(f"{label} {s.name}: {moment} is not 0 off the mask")


def _unstructured_cli(method: str, steps: int) -> None:
    """The train CLI with ``--method``: params and moments finite, each
    layer's nnz its target, no port kernel launched."""
    import torch
    from repro_torch.launch import train as TL
    from repro_torch.sparse import registry as REG
    t0 = time.perf_counter()
    _zero_counts()
    state = TL.main(["--arch", ARCH, "--method", method, "--steps", str(steps), "--batch",
                     str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
    torch.cuda.synchronize()
    if int(state.step) != steps or _counts() != _none():
        raise AssertionError(f"{method} CLI: step {int(state.step)}, launches {_counts()}")
    for name, t in (("params", state.params), ("mu", state.opt_state["mu"]),
                    ("nu", state.opt_state["nu"])):
        if not all(bool(torch.isfinite(v).all()) for v in _leaf_list(t)):
            raise AssertionError(f"{method} CLI: non-finite {name}")
    for s in REG.build_registry(_method_cfg(method)):
        m = REG.get_path(state.masks, s.path)
        if m.reshape(m.shape[0], -1).sum(-1).tolist() != [s.rigl_spec().target_nnz] * s.lead[0]:
            raise AssertionError(f"{method} CLI {s.name}: nnz is not target_nnz")
    print(f"[{method}] CLI --arch {ARCH} --method {method} --steps {steps} --batch "
          f"{TRAIN_BATCH} --seq {TRAIN_SEQ}: {time.perf_counter() - t0:.1f}s with init; params "
          f"and moments finite, every layer at its target nnz; no port kernel launched")
    del state
    _release()


def _method_cfg(method: str, delta_t: int | None = None):
    """Full-width qwen3-1.7b with ``method`` (and ``delta_t``)."""
    import dataclasses
    from repro_torch import configs
    base = configs.get_config(ARCH)
    sp = dataclasses.replace(base.sparsity, method=method)
    if delta_t is not None:
        sp = dataclasses.replace(sp, delta_t=delta_t)
    return base.replace(sparsity=sp)


def _check_unstructured_dst(label: str, reg, state, old_masks: dict,
                            old_versions: dict) -> dict:
    """The RigL / SET invariants after an update on the full-width state:
    every layer's nnz equal to its target_nnz, neuron_active all True, grown
    weights 0, the mask moved and mask_versions with it. Returns the
    neurons left with no incoming weight per stack (RigL's implicit
    ablation)."""
    import torch
    from repro_torch.core import topology
    from repro_torch.sparse import registry as REG
    ablated = {}
    for s in reg:
        new, old = REG.get_path(state.masks, s.path), REG.get_path(old_masks, s.path)
        target = s.rigl_spec().target_nnz
        if new.reshape(new.shape[0], -1).sum(-1).tolist() != [target] * s.lead[0]:
            raise AssertionError(f"{label} {s.name}: a layer's nnz is not {target}")
        if not bool(REG.get_path(state.neuron_active, s.path).all()):
            raise AssertionError(f"{label} {s.name}: neuron_active changed")
        grown = new & ~old
        if bool(REG.get_path(state.params, s.path).masked_select(grown).any()):
            raise AssertionError(f"{label} {s.name}: a grown weight is not 0")
        if torch.equal(new, old) or int(state.mask_versions[s.name]) != old_versions[s.name] + 1:
            raise AssertionError(f"{label} {s.name}: the mask or mask_versions did not move")
        fan = topology.column_nnz(new)
        ablated[s.name] = int((fan == 0).sum())
        print(f"[{label}] DST {s.name}: nnz {target} per layer, grown {int(grown.sum())}, "
              f"pruned {int((old & ~new).sum())}, fan-in {int(fan.min())}..{int(fan.max())}, "
              f"n_ablated {ablated[s.name]} of {fan.numel()} neurons, mask_versions "
              f"{int(state.mask_versions[s.name])}")
    return ablated


def _unstructured_trainer(method: str, device, steps: int, dst_times: list, before=None):
    """The Trainer with ``method`` and delta_t=2 for ``steps`` steps from a
    seeded full-width init, each update checked; returns (cfg, registry,
    state, the step function, the next batch)."""
    import torch
    from repro_torch.core import topology
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sparse import registry as REG
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import Trainer

    cfg = _method_cfg(method, delta_t=2)
    trainer = Trainer(cfg=cfg, lr_fn=warmup_cosine(3e-3, 1, 6), log_every=1)
    reg = trainer.registry
    _timed_dst(trainer, dst_times, before)
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    for s in reg:
        fan = topology.column_nnz(REG.get_path(state.masks, s.path))
        print(f"[{method}] init {s.name}: fan-in {int(fan.min())}..{int(fan.max())} (SRigL's k "
              f"{REG.k_fan_map(cfg, reg)[s.path[-1]]})")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                       seed=0)
    batches = Prefetcher(data.iterate(), depth=2, pin=True)
    logs: list = []
    try:
        for i in range(steps):
            old_masks, old_versions = state.masks, {k: int(v) for k, v in
                                                    state.mask_versions.items()}
            state = trainer.fit(state, batches, 1, log_fn=logs.append)
            m = trainer.last_metrics
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"{method} step {i}: loss {loss}, grad norm {gnorm}")
            dst = (i + 1) % 2 == 0
            print(f"[{method}] step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}"
                  + (f", DST step {dst_times[-1] * 1e3:.1f} ms" if dst else ""))
            if dst:
                _check_unstructured_dst(method, reg, state, old_masks, old_versions)
            else:
                _moments_off_mask(f"{method} step {i}", reg, state)
        if _counts() != _none():
            raise AssertionError(f"the {method} trainer launched {_counts()}")
        batch = {k: v.to(device) for k, v in next(batches).items()}
    finally:
        batches.close()
    return cfg, reg, state, trainer._step_fn, batch


def rigl_kernel_phase(device, cond32: dict, masks: dict, reg, srigl_cases: list) -> list:
    """K1 at RigL's realized shapes: layer 0 of each stack's condensed
    export (the stack's max fan-in k, the shorter columns padded), decode
    B=4 and tiled B=128, bf16 and f32: within TOL of the plain version,
    decode == tiled bitwise, timed beside torch.matmul on the dense weight
    and the bound (bytes of the padded slots, operations of the real
    non-zeros); one JSON line per case and one line per layer beside
    SRigL's K1 (``srigl_cases``, kernel_phase's records)."""
    import torch
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.sparse import registry as REG

    gen = torch.Generator(device=device).manual_seed(11)
    cases = []
    for s in reg:  # w_up is timed too: its realized k is its own
        name = s.path[-1]
        leaf = REG.get_path(cond32, s.path)
        vals32, idx = leaf.values[0].contiguous(), leaf.indices[0].contiguous()
        n_out, k = vals32.shape
        nnz = int(REG.get_path(masks, s.path)[0].sum())
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            vals = vals32.to(dtype).contiguous()
            dense = topology.condensed_to_dense(vals32, idx, s.d_in).to(dtype).contiguous()
            isz = vals.element_size()
            weight_sets = [(vals.clone(), idx.clone())
                           for _ in range(_copies(n_out * k * (isz + 4)))]
            dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
            for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                x = torch.randn((b, s.d_in), generator=gen, device=device).to(dtype)
                y = cm.condensed_matmul(x, vals, idx)
                y_ref = ref.condensed_matmul_ref(x, vals, idx)
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), y_ref.float(), **TOL[dtype_name])
                err = (y.float() - y_ref.float()).abs().max().item()
                tiled = cm.TILED_ROWS[dtype]
                if launch == "decode":
                    same = torch.equal(cm.condensed_matmul_decode(x, vals, idx),
                                       cm.condensed_matmul(x, vals, idx, block_b=tiled))
                    pair = f"decode == tiled({tiled})"
                else:
                    least = cm.GATHER_ROWS[dtype][0]
                    same = torch.equal(y, cm.condensed_matmul(x, vals, idx, block_b=least))
                    pair = f"tiled({tiled}) == tiled({least})"
                if not same:
                    raise AssertionError(f"K1 rigl {name} {dtype_name} B={b}: {pair} is not "
                                         f"bitwise")
                ms = _time_ms(cm.condensed_matmul, [(x, v, i) for v, i in weight_sets])
                plain_ms = _time_ms(ref.condensed_matmul_ref,
                                    [(x, v, i) for v, i in weight_sets], iters=10)
                library_ms = _time_ms(torch.matmul, [(x, wd) for wd in dense_sets])
                nbytes = n_out * k * (isz + 4) + b * s.d_in * isz + b * n_out * isz
                ops = 2 * b * nnz
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                rec = dict(kernel="K1", masks="rigl", stack=name, d_in=s.d_in, n_out=n_out, k=k,
                           mean_fan_in=nnz / n_out, dtype=dtype_name, batch=b, launch=launch,
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, max_abs_err=err, bitwise=pair)
                cases.append(rec)
                print("[kernel] " + json.dumps(rec))
            del weight_sets, dense_sets
    # one layer: every stack once; kernel_phase timed w_gate for w_up too
    per_layer = {"wo": 1, "w_gate": 2, "w_down": 1}
    for dtype_name in ("bfloat16", "float32"):
        for launch in ("decode", "tiled"):
            def layer(recs):
                return {t: sum(r[t] * (1 if r.get("masks") else per_layer[r["stack"]])
                               for r in recs)
                        for t in ("ms", "plain_ms", "library_ms", "bound_ms")}
            pick = (lambda c: c["kernel"] == "K1" and c["dtype"] == dtype_name
                    and c["launch"] == launch)
            rg = layer([c for c in cases if pick(c)])
            sr = layer([c for c in srigl_cases if pick(c)])
            print(f"[rigl] K1 {dtype_name} {launch} one layer (wo + w_gate + w_up + w_down) at "
                  f"RigL's k: {rg['ms'] * 1e3:.2f} us | plain {rg['plain_ms'] * 1e3:.2f} | "
                  f"library {rg['library_ms'] * 1e3:.2f} | bound {rg['bound_ms'] * 1e3:.2f}; "
                  f"SRigL's k: {sr['ms'] * 1e3:.2f} us | library {sr['library_ms'] * 1e3:.2f} "
                  f"| bound {sr['bound_ms'] * 1e3:.2f}")
    torch.cuda.empty_cache()
    return cases


def rigl_phase(device, card: str, report: dict, srigl_cases: list) -> list:
    """RigL at full width: the train CLI with --method rigl for 3 steps; the
    Trainer with delta_t=2 for 4 steps (two updates, each checked) and one
    more step (moments 0 off the mask); the trained state condensed at its
    realized max fan-in (k, mean fan-in, padding share and bf16 leaf bytes
    per stack beside SRigL's); served B=4, 32+16, graph decode, on condensed
    (K1, 4 * 28 * 17 launches) and masked, held to the tie rule, the
    condensed wall beside [slice]'s SRigL one; then K1 at RigL's shapes
    (rigl_kernel_phase). Returns the kernel records."""
    import torch
    from repro_torch.core import topology
    from repro_torch.launch.engine import ServingModel
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG

    _unstructured_cli("rigl", 3)
    dst_times: list = []
    cfg, reg, state, step_fn, batch = _unstructured_trainer("rigl", device, 4, dst_times)
    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    _moments_off_mask("rigl step 4", reg, state)
    srigl = report["srigl_dst_s"]
    print(f"[rigl] {card}: DST step {[round(t * 1e3, 1) for t in dst_times]} ms (median "
          f"{statistics.median(dst_times) * 1e3:.1f}); SRigL's in [train] "
          f"{[round(t * 1e3, 1) for t in srigl]} ms (median {statistics.median(srigl) * 1e3:.1f})"
          f"; moments 0 off the mask after the next step")
    params, masks = state.params, state.masks
    del state, step_fn, batch
    _release()

    cfg = cfg.replace(dtype="bfloat16")
    cond = COND.export_condensed(cfg, reg, params, masks)
    for s in reg:
        leaf = REG.get_path(cond, s.path)
        fan = topology.column_nnz(REG.get_path(masks, s.path))
        k, mean = leaf.values.shape[-1], fan.float().mean().item()
        if k != int(fan.max()):
            raise AssertionError(f"rigl {s.name}: exported k {k}, max fan-in {int(fan.max())}")
        nbytes = sum(t.numel() * t.element_size() for t in leaf.arrays().values())
        sb = report["srigl_bytes"][s.name]
        print(f"[rigl] {s.name}: realized max k {k} (SRigL's k "
              f"{REG.k_fan_map(cfg, reg)[s.path[-1]]}), mean fan-in {mean:.2f}, padding share "
              f"{1 - mean / k:.4f}; condensed bf16 leaf {nbytes} bytes, SRigL's plan {sb} bytes "
              f"({nbytes / sb:.3f}x)")
    gen = torch.Generator(device=device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    cond_model = ServingModel(cfg, params, cond)
    masked_model = ServingModel(cfg, params, masks)
    expected = {**_none(), "K1": 4 * cfg.n_layers * (1 + GEN)}
    walls: list = []
    out_c, rates_c, _ = _serve_counted("rigl:condensed", cond_model, prompts, expected,
                                       walls_out=walls)
    out_m, rates_m, _ = _serve_counted("rigl:masked", masked_model, prompts, _none())
    toks_m, gaps = _masked_gaps(cfg, masked_model, prompts, GEN)
    if not torch.equal(toks_m, out_m[:, PROMPT:]):
        raise AssertionError("rigl masked: step-by-step run differs from generate")
    agree = _check_ties("rigl", cfg, out_c, toks_m, gaps)
    sw = report["condensed_wall:bfloat16"]
    print(f"[rigl] {card}: condensed (K1 {expected['K1']} launches) generate "
          f"{BATCH}x{PROMPT}+{GEN} wall {statistics.median(walls) * 1e3:.2f} ms (median of "
          f"{len(walls)}), SRigL's in [slice] {sw * 1e3:.2f} ms; decode "
          f"{_rates({'condensed': rates_c, 'masked': rates_m})}; streams agreeing with masked "
          f"in full {agree}/{BATCH}")
    del cond, cond_model, masked_model
    torch.cuda.empty_cache()
    cond32 = COND.export_condensed(cfg.replace(dtype="float32"), reg, params, masks)
    cases = rigl_kernel_phase(device, cond32, masks, reg, srigl_cases)
    del cond32, params, masks
    _release()
    return cases


def set_phase(device, card: str) -> None:
    """SET at full width: the train CLI with --method set for 2 steps; the
    Trainer with delta_t=2 for 2 steps (one update): the survivors equal
    prune_survivors' on the weights and mask the update saw, the grown
    positions were all inactive and as many as were pruned, and the update
    run again from the same state, seed and step regrows the same masks."""
    import torch
    from repro_torch.core import saliency
    from repro_torch.core.rigl import n_to_prune
    from repro_torch.sparse import registry as REG
    from repro_torch.train.trainer import _dst_schedule, set_generator

    _unstructured_cli("set", 2)
    seen: dict = {}

    def before(state):  # what the update sees (it zeroes grown weights in place)
        seen.update(state=state, masks=state.masks,
                    params=_map_leaves(state.params, torch.clone))
    dst_times: list = []
    cfg, reg, state, _, _ = _unstructured_trainer("set", device, 2, dst_times, before)
    pre = seen["state"]._replace(params=seen["params"])
    drop = _dst_schedule(cfg).drop_fraction(int(pre.step))
    for s in reg:
        w = REG.get_path(pre.params, s.path)
        old, new = REG.get_path(seen["masks"], s.path), REG.get_path(state.masks, s.path)
        for layer in range(s.lead[0]):
            m = old[layer]
            n_prune = n_to_prune(m, drop)
            survive = saliency.prune_survivors(w[layer].float(), m, n_prune)
            if not torch.equal(new[layer] & m, survive):
                raise AssertionError(f"set {s.name} layer {layer}: survivors differ from "
                                     f"prune_survivors'")
            grown = int((new[layer] & ~m).sum())
            if grown != int(n_prune) or int((m & ~new[layer]).sum()) != grown:
                raise AssertionError(f"set {s.name} layer {layer}: grown {grown}, n_prune "
                                     f"{int(n_prune)}")
    sp = {"masks": pre.masks, "neuron_active": pre.neuron_active}
    again = [REG.dst_update(cfg, reg, pre.params, {}, sp, drop, set_generator(pre))[0]
             for _ in range(2)]
    for s in reg:
        want = REG.get_path(state.masks, s.path)
        if not all(torch.equal(REG.get_path(a["masks"], s.path), want) for a in again):
            raise AssertionError(f"set {s.name}: the same seed and step regrew other masks")
    print(f"[set] {card}: DST step {[round(t * 1e3, 1) for t in dst_times]} ms; survivors == "
          f"prune_survivors' in every layer; grown positions all inactive before, as many as "
          f"pruned; the same seed and step regrew the same masks twice")
    del state, pre, seen, again
    _release()


# [grad:structured]: dx and dW through K5 and the structured backward
# against autograd through structured_dense, float32, as max |difference|
# / max |reference|
STRUCT_GRAD_BOUND = 1e-4


def _plain_structured(x, w, active_index):
    """The structured linear as ``structured_dense`` (autograd through
    plain torch), its neuron_active read back from ``active_index``."""
    import torch
    from repro_torch.kernels import ref
    act = torch.zeros(w.shape[-1] + 1, dtype=torch.bool, device=w.device)
    act[active_index.long()] = True
    return ref.structured_dense(x, w.to(x.dtype), act[:-1])


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def structured_grad_phase(setup: dict) -> None:
    """loss_fn over the structured serving tree (K5 forward, the structured
    backward) of full-width qwen3-1.7b on the ablation-only masks [ablation]
    builds, float32, a train batch of 8 x 64: K5 launches 4 * 28 per
    forward; every sparse stack's dW and the embedding's gradient (dx
    carried through every layer) against the same loss with each structured
    linear computed as structured_dense under autograd, within
    STRUCT_GRAD_BOUND of the max; ablated columns' dW exactly 0. Then one
    layer per stack shape at B*T = 512: dx and dW against structured_dense's."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG

    base, reg, params = setup["base"], setup["reg"], setup["params"]
    cfg = base.replace(dtype="float32")
    masks = _ablation_only(reg, setup["masks"], ABLATION)
    tree = COND.export_structured(cfg, reg, masks)
    batch = _train_batch(cfg, params["embed"].device)
    paths = [("embed",)] + [s.path for s in reg]
    per_pass = 4 * cfg.n_layers
    found = []
    for plain in (False, True):
        leaves = [REG.get_path(params, p) for p in paths]
        for t in leaves:
            t.requires_grad_(True)
        saved = ops.structured_linear_nd
        if plain:
            ops.structured_linear_nd = _plain_structured
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _zero_counts()
            loss = M.loss_fn(cfg, params, tree, batch)[0]
            fwd = _counts()
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            total = _counts()
            dt = time.perf_counter() - t0
        finally:
            ops.structured_linear_nd = saved
            for t in leaves:
                t.requires_grad_(False)
        if not plain:
            # K5 at every forward linear, again when each checkpointed block
            # is recomputed for the backward
            if fwd != {**_none(), "K5": per_pass} or total != {**_none(), "K5": 2 * per_pass}:
                raise AssertionError(f"structured loss: forward launched {fwd}, forward and "
                                     f"backward {total}")
            print(f"[grad:structured] loss {loss.item():.6f}; forward + backward {dt:.2f}s; K5 "
                  f"launches per forward {fwd['K5']}, with the backward's recompute "
                  f"{total['K5']}")
        elif total != _none():
            raise AssertionError(f"the plain structured loss launched {total}")
        found.append((loss.detach(), dict(zip(paths, grads))))
    (loss_k, got), (loss_p, want) = found
    if not abs(loss_k.item() - loss_p.item()) <= STRUCT_GRAD_BOUND * abs(loss_p.item()):
        raise AssertionError(f"structured loss {loss_k.item()} vs plain {loss_p.item()}")
    for p in paths:
        rel = _rel(got[p], want[p])
        extra = ""
        if p != ("embed",):
            active = REG.get_path(masks, p).any(dim=-2)                 # (L, d_out)
            dead = got[p].masked_select(~active[:, None, :].expand_as(got[p]))
            if bool(dead.any()):
                raise AssertionError(f"{'/'.join(p)}: an ablated column's dW is not 0")
            extra = f"; ablated columns' dW exactly 0 ({dead.numel()} entries)"
        print(f"[grad:structured] {'/'.join(p)}: max |grad - structured_dense grad| / max = "
              f"{rel:.3g} (bound {STRUCT_GRAD_BOUND:g}){extra}")
        if not rel <= STRUCT_GRAD_BOUND:
            raise AssertionError(f"{'/'.join(p)}: {rel} above {STRUCT_GRAD_BOUND}")
    del found, got, want, tree
    gen = torch.Generator(device=params["embed"].device).manual_seed(12)
    shapes = {}
    for s in reg:
        shapes.setdefault((s.d_in, s.d_out), s)
    for (d_in, d_out), s in shapes.items():
        w = REG.get_path(params, s.path)[0].clone()
        leaf = F.StructuredFanIn.from_mask(REG.get_path(masks, s.path)[:1])
        ai = leaf.active_index[0]
        x = torch.randn((TRAIN_TOKENS, d_in), generator=gen, device=w.device)
        dy = torch.randn((TRAIN_TOKENS, d_out), generator=gen, device=w.device)
        out = []
        for fn in (ops.structured_linear, _plain_structured):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            fn(xr, wr, ai).backward(dy)
            out.append((xr.grad, wr.grad))
        (dx, dw), (dx_p, dw_p) = out
        rx, rw = _rel(dx, dx_p), _rel(dw, dw_p)
        if not (rx <= STRUCT_GRAD_BOUND and rw <= STRUCT_GRAD_BOUND):
            raise AssertionError(f"{s.path[-1]} layer: dx {rx}, dW {rw}")
        print(f"[grad:structured] {s.path[-1]} layer {d_in}->{d_out}, {int((ai < d_out).sum())} "
              f"columns active, B*T={TRAIN_TOKENS}: dx {rx:.3g}, dW {rw:.3g} from "
              f"structured_dense's (bound {STRUCT_GRAD_BOUND:g})")
    torch.cuda.empty_cache()


# the [refresh] and [sync] phases: one request of B=4, prompt 32, 16 new
# tokens, decoded in chunks of 8: the first chunk on gen-1, the second after
# the refresh (or the sync drain) to gen-2
REFRESH_CHUNK = 8
# (label, path, values dtype, masks ablated): K1, K2, K4 and masked
REFRESH_RUNS = (("condensed", "condensed", None, False),
                ("condensed:int8", "condensed", "int8", False),
                ("condensed_over_active", "condensed_over_active", None, True),
                ("masked", "masked", None, False))


def _generations(device) -> dict:
    """gen-1 and gen-2 of the seeded full-width TrainState [train] builds
    (``init_train_state`` at seed 0): gen-1 a clone of it, gen-2 after two
    train steps, one DST update and the reference's ``_bump`` rewire
    (tests/test_sync.py: the first stack's mask rolled by one input row, so
    its fan-in is unchanged, and its version bumped). The optimizer state
    and the gradients are freed before any engine is built."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sparse import registry as REG
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import make_dst_step, make_train_step

    base = configs.get_config(ARCH)
    cfg = base.replace(sparsity=dataclasses.replace(base.sparsity, delta_t=2))
    reg = REG.build_registry(cfg)
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    gen1 = (_map_leaves(state.params, torch.clone), _map_leaves(state.masks, torch.clone),
            {k: int(v) for k, v in state.mask_versions.items()})
    step = make_train_step(cfg, reg, warmup_cosine(3e-3, 1, 6))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                       seed=0)
    for i in range(2):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
        state, _ = step(state, batch)
    state = make_dst_step(cfg, reg)(state, batch)
    masks2 = _map_leaves(state.masks, lambda m: m)
    s0 = reg[0]
    REG.set_path(masks2, s0.path, torch.roll(REG.get_path(masks2, s0.path), 1, dims=-2))
    versions2 = {k: int(v) for k, v in state.mask_versions.items()}
    versions2[s0.name] += 1
    gen2 = (state.params, masks2, versions2)
    del state, step, batch
    _release()
    moved = sorted(k for k in versions2 if versions2[k] != gen1[2][k])
    print(f"[refresh] gen-2: 2 train steps, one DST update and {s0.name} rolled by one input "
          f"row; mask versions moved for {len(moved)}/{len(reg)} stacks {moved}")
    return dict(cfg=base.replace(dtype="bfloat16"), reg=reg, gen1=gen1, gen2=gen2,
                moved=moved, device=device)


def _gen_masks(gens: dict, gen: str, ablated: bool) -> dict:
    masks = gens[gen][1]
    return _ablate_masks(gens["reg"], masks, ABLATION) if ablated else masks


def _leaf_storage(eng) -> dict:
    """stack name -> {field: (data_ptr, shape)} of every plan's leaves."""
    from repro_torch.sparse import registry as REG
    out = {}
    for key, plan in eng._plans.items():
        for s in eng.registry:
            leaf = REG.get_path(plan.serving_tree, s.path)
            out[(key, s.name)] = {f: (t.data_ptr(), tuple(t.shape))
                                  for f, t in leaf.arrays().items()}
    return out


def _leaf_bytes(eng) -> int:
    from repro_torch.sparse import registry as REG
    return sum(t.numel() * t.element_size() for plan in eng._plans.values()
               for s in eng.registry
               for t in REG.get_path(plan.serving_tree, s.path).arrays().values())


def _serve_chunks(eng, prompts, chunks: int | None):
    rid = eng.submit(prompts, GEN)
    eng.step(max_chunks=chunks)
    return rid


def _launched(label: str, counts: dict) -> None:
    """The engine's decode ran through the kernel of its path, and no other."""
    want = {"condensed": "K1", "condensed:int8": "K2", "condensed_over_active": "K4"}.get(label)
    bad = {k: n for k, n in counts.items() if n and k != want}
    if bad or (want is not None and not counts[want]):
        raise AssertionError(f"[refresh:{label}] launches {counts}, expected {want} only")


def refresh_phase(gens: dict, card: str) -> dict:
    """ServingEngine.refresh at full width, bf16, mid-generation, on K1
    (condensed), K2 (int8 condensed), K4 (condensed_over_active on the
    half-ablated masks) and masked: one chunk on gen-1, refresh(gen-2), the
    rest of the request. Gates: the in-place tokens equal a twin refreshed
    with donate=False bitwise; export_calls grew by the stacks whose version
    moved; every leaf whose shapes held kept its data_ptr, no graph was
    recaptured unless a leaf's shape moved (then one per runner, its
    signature new), and the refresh's peak memory stayed below the plan's
    weight bytes; a fresh engine built from gen-2 serves a new request
    bitwise equal to the refreshed engine. Returns the in-place tokens."""
    import torch
    from repro_torch.launch import engine as E

    cfg, reg, device = gens["cfg"], gens["reg"], gens["device"]
    gen = torch.Generator(device=device).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    prompts2 = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                             dtype=torch.int32)
    tokens: dict = {}
    for label, path, vd, ablated in REFRESH_RUNS:
        def engine(g: str):
            params, _, versions = gens[g]
            return E.ServingEngine(cfg, params, _gen_masks(gens, g, ablated), reg, path=path,
                                   values_dtype=vd, block_size=ENGINE_BLOCK,
                                   gen_chunk=REFRESH_CHUNK, mask_versions=versions)

        out, second = {}, None
        for donate in (True, False):
            eng = engine("gen1")
            _zero_counts()
            rid = _serve_chunks(eng, prompts, 1)
            before = _leaf_storage(eng)
            calls = {k: p.export_calls for k, p in eng._plans.items()}
            captures, programs = eng.captures, eng.program_count("decode")
            plan_bytes = _leaf_bytes(eng)
            masks2 = _gen_masks(gens, "gen2", ablated)
            torch.cuda.synchronize()
            _part("setup")
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            changed = eng.refresh(gens["gen2"][0], masks2, gens["gen2"][2], donate=donate)
            torch.cuda.synchronize()
            refresh_s = time.perf_counter() - t0
            _part("refresh")
            peak = torch.cuda.max_memory_allocated()
            eng.step()
            [res] = eng.retire(rid)
            _part("serve")
            _launched(label, _counts())
            out[donate] = res.tokens.cpu()
            after = _leaf_storage(eng)
            for key, p in eng._plans.items():
                if sorted(changed[key]) != gens["moved"] or \
                        p.export_calls != calls[key] + len(gens["moved"]):
                    raise AssertionError(f"[refresh:{label}] re-exported {changed[key]}, "
                                         f"versions moved for {gens['moved']}")
            same_shape = {k: {f: v[1] for f, v in a.items()} == {f: v[1] for f, v in
                                                                  before[k].items()}
                          for k, a in after.items()}
            kept = {k: all(v[0] == before[k].get(f, (None,))[0] for f, v in a.items())
                    for k, a in after.items()}
            in_place = sum(kept.values())
            if any(kept[k] != (donate and same_shape[k]) for k in after):
                raise AssertionError(f"[refresh:{label}] donate={donate}: storage kept "
                                     f"{kept}, shapes held {same_shape}")
            reshaped = not all(same_shape.values())
            recaptured = eng.captures - captures
            want = int(bool(after) and (reshaped or not donate))
            if recaptured != want or eng.program_count("decode") != programs + int(reshaped):
                raise AssertionError(f"[refresh:{label}] donate={donate}: recaptured "
                                     f"{recaptured} (expected {want}), decode programs "
                                     f"{programs} -> {eng.program_count('decode')}")
            # a same-shape refresh must not double the plan's weight bytes
            # (the masked path has no plan: its copies allocate nothing)
            grew = peak - mem0
            if donate and not reshaped and grew >= (plan_bytes or 64 * 2**20):
                raise AssertionError(f"[refresh:{label}] the refresh allocated {grew} bytes, "
                                     f"the plan holds {plan_bytes}")
            print(f"[refresh:{label}] {card}: donate={donate}: refresh {refresh_s:.3f}s "
                  f"(host clock, synchronised); leaves copied in place {in_place}, rebuilt "
                  f"{len(after) - in_place}; graphs recaptured {recaptured}; "
                  f"max_memory_allocated {mem0 / 2**30:.2f} GiB before, "
                  f"{peak / 2**30:.2f} GiB during (+{grew / 2**20:.1f} MiB; plan weight bytes "
                  f"{plan_bytes / 2**20:.1f} MiB); stacks re-exported per plan "
                  f"{[len(v) for v in changed.values()]}")
            if donate:
                second = _serve_chunks(eng, prompts2, None)
                [res2] = eng.retire(second)
                second = res2.tokens.cpu()
            del eng, res, masks2
            _release()
        if not torch.equal(out[True], out[False]):
            raise AssertionError(f"[refresh:{label}] in-place and donate=False tokens differ")
        _part("setup")
        fresh = engine("gen2")
        rid = _serve_chunks(fresh, prompts2, None)
        [res] = fresh.retire(rid)
        _part("fresh")
        if not torch.equal(res.tokens.cpu(), second):
            raise AssertionError(f"[refresh:{label}] a fresh gen-2 engine serves other tokens "
                                 "than the refreshed one")
        del fresh, res
        _release()
        tokens[label] = out[True]
        print(f"[refresh:{label}] in-place tokens == donate=False tokens bitwise; a fresh gen-2 "
              f"engine == the refreshed engine bitwise at bucket 8")
    return tokens


def sync_phase(gens: dict, refreshed: dict, card: str) -> None:
    """The same update streamed: a port Publisher sends gen-1 (a snapshot)
    over a QueueChannel, an engine built from it with engine_from_snapshot
    (condensed, then int8 condensed) serves one chunk, the publisher sends
    gen-2 (a topology delta) and gen-2 again (a values-only delta), and the
    next step() drains both at the chunk boundary. Gates: no graph
    recaptured, every leaf that kept its shapes kept its data_ptr, tokens
    bitwise equal to the [refresh] engine's, the deltas smaller than the
    snapshot and the values-only one smaller than the topology one."""
    import torch
    from repro_torch.sync import QueueChannel, Publisher, Subscriber, engine_from_snapshot

    cfg, reg, device = gens["cfg"], gens["reg"], gens["device"]
    gen = torch.Generator(device=device).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    for label, vd in (("condensed", None), ("condensed:int8", "int8")):
        _part("setup")
        ch = QueueChannel()
        pub = Publisher(cfg, reg, ch, path="condensed", values_dtype=vd, batch_size=BATCH,
                        arch=ARCH)
        snap = pub.publish(params=gens["gen1"][0], masks=gens["gen1"][1],
                           mask_versions=gens["gen1"][2])
        _part("publish")
        sub = Subscriber(ch.subscribe("replica"), name="replica")
        t0 = time.perf_counter()
        sub.poll()
        snap_decode = time.perf_counter() - t0
        _part("poll")
        eng = engine_from_snapshot(cfg, sub, registry=reg, device=device,
                                   block_size=ENGINE_BLOCK, gen_chunk=REFRESH_CHUNK)
        _part("setup")
        _zero_counts()
        rid = _serve_chunks(eng, prompts, 1)
        _part("serve")
        before = _leaf_storage(eng)
        captures, programs = eng.captures, eng.program_count("decode")
        topo = pub.publish(params=gens["gen2"][0], masks=gens["gen2"][1],
                           mask_versions=gens["gen2"][2])
        vals = pub.publish(params=gens["gen2"][0], masks=gens["gen2"][1],
                           mask_versions=gens["gen2"][2])
        _part("publish")
        eng.step()
        [res] = eng.retire(rid)
        _part("drain+serve")
        _launched(label, _counts())
        after = _leaf_storage(eng)
        if eng._sync_generation != 3:
            raise AssertionError(f"[sync:{label}] drained to gen {eng._sync_generation}")
        if (eng.captures, eng.program_count("decode")) != (captures, programs):
            raise AssertionError(f"[sync:{label}] a graph was recaptured")
        for k, a in after.items():
            if {f: v[1] for f, v in a.items()} == {f: v[1] for f, v in before[k].items()} \
                    and a != before[k]:
                raise AssertionError(f"[sync:{label}] {k} kept its shapes but not its storage")
        if not torch.equal(res.tokens.cpu(), refreshed[label]):
            raise AssertionError(f"[sync:{label}] drained tokens differ from [refresh]'s")
        if not (vals["bytes"] < topo["bytes"] < snap["bytes"]):
            raise AssertionError(f"[sync:{label}] record bytes: snapshot {snap['bytes']}, "
                                 f"topology delta {topo['bytes']}, values-only {vals['bytes']}")
        in_place = sum(a == before[k] for k, a in after.items())
        print(f"[sync:{label}] {card}: snapshot {snap['bytes']} B (encode "
              f"{snap['encode_s']:.3f}s, decode {snap_decode:.3f}s); topology delta "
              f"{topo['bytes']} B ({len(topo['topology'])} stacks; encode "
              f"{topo['encode_s']:.3f}s); values-only delta {vals['bytes']} B (encode "
              f"{vals['encode_s']:.3f}s); drain of both at the chunk boundary "
              f"{eng.last_drain_s:.3f}s (decoding them included); leaves written in place "
              f"{in_place}/{len(after)}; no graph recaptured; tokens == [refresh]'s bitwise")
        del eng, pub, sub, ch, res
        _release()


def _leaf_list(tree) -> list:
    return [x for v in tree.values() for x in (_leaf_list(v) if isinstance(v, dict) else [v])]


def train_reference_phase(device) -> None:
    """The smoke config (float32) on the card against the port's CPU path:
    the trainer for 6 steps with delta_t=3 from the same state (losses within
    TRAIN_LOSS_TOL, masks and neuron_active equal after each DST update), a
    TrainState checkpoint round trip on the card, and the condensed loss's
    values gradient (K3 on the card) against the CPU's."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch import bridge, configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.state import init_train_state, state_to
    from repro_torch.train.trainer import Trainer

    base = configs.get_smoke_config(ARCH)
    cfg = base.replace(sparsity=dataclasses.replace(base.sparsity, delta_t=3))
    cpu = init_train_state(cfg, torch.Generator().manual_seed(0))
    gpu = state_to(cpu, device)
    runs = {}
    for name, st in (("card", gpu), ("cpu", cpu)):
        trainer = Trainer(cfg=cfg, lr_fn=warmup_cosine(3e-3, 1, 6), log_every=100)
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4, seed=0)
        it = data.iterate()
        losses, masks = [], []
        for i in range(6):
            st = trainer.fit(st, it, 1, log_fn=lambda line: None)
            losses.append(float(trainer.last_metrics["loss"]))
            if (i + 1) % 3 == 0:
                masks.append(bridge.flatten({"m": st.masks, "a": st.neuron_active}))
        runs[name] = (st, losses, masks)
    (gpu, g_loss, g_masks), (cpu, c_loss, c_masks) = runs["card"], runs["cpu"]
    diff = max(abs(a - b) for a, b in zip(g_loss, c_loss))
    if not diff <= TRAIN_LOSS_TOL:
        raise AssertionError(f"trainer: card losses {g_loss} vs cpu {c_loss}")
    for n, (gm, cm_) in enumerate(zip(g_masks, c_masks)):
        for k in gm:
            if not torch.equal(gm[k].cpu(), cm_[k]):
                raise AssertionError(f"trainer: {k} differs after DST update {n + 1}")
    print(f"[reference] smoke trainer, 6 steps, delta_t=3: card == CPU plain path, losses "
          f"within {diff:.3g} (tolerance {TRAIN_LOSS_TOL:g}), masks and neuron_active equal "
          f"after both DST updates; losses {[round(x, 5) for x in g_loss]}")

    template = state_to(init_train_state(cfg, torch.Generator().manual_seed(1)), device)
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        CKPT.save(d, gpu)
        got = CKPT.restore(d, CKPT.latest_step(d), template)
    want_np = bridge.flatten(bridge.train_state_to_jax_numpy(gpu))
    got_np = bridge.flatten(bridge.train_state_to_jax_numpy(got))
    if want_np.keys() != got_np.keys() or got.params["embed"].device != gpu.params["embed"].device:
        raise AssertionError("TrainState checkpoint: keys or device differ")
    for k in want_np:
        if want_np[k].dtype != got_np[k].dtype or not np.array_equal(want_np[k], got_np[k]):
            raise AssertionError(f"TrainState checkpoint: {k} differs after the round trip")
    print(f"[reference] TrainState checkpoint on the card: {len(want_np)} arrays (params, "
          f"AdamW mu/nu/count, masks, neuron_active, mask_versions, rng) bitwise equal after "
          f"save and restore")

    # the condensed loss's values gradient: K3 (and K1) on the card vs the CPU
    params = cpu.params
    reg = REG.build_registry(cfg)
    batch = _train_batch(cfg, "cpu", batch=2, seq=12)
    grads = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        p = {k: (v.to(dev) if not isinstance(v, dict) else {kk: vv.to(dev) for kk, vv
                                                           in v.items()})
             for k, v in params.items()}
        tree = COND.export_condensed(cfg, reg, p, {"blocks": {k: v.to(dev) for k, v in
                                                             cpu.masks["blocks"].items()}})
        for s in reg:
            REG.get_path(tree, s.path).values.requires_grad_(True)
        _zero_counts()
        M.loss_fn(cfg, p, tree, {k: v.to(dev) for k, v in batch.items()})[0].backward()
        grads[name] = ({s.name: REG.get_path(tree, s.path).values.grad.cpu() for s in reg},
                       _counts()["K3"])
    for s in reg:
        torch.testing.assert_close(grads["card"][0][s.name], grads["cpu"][0][s.name],
                                   **SMOKE_GRAD_TOL)
    if grads["card"][1] != 4 * cfg.n_layers or grads["cpu"][1] != 0:
        raise AssertionError(f"smoke values gradient: K3 launches {grads['card'][1]} on the "
                             f"card, {grads['cpu'][1]} on the CPU")
    print(f"[reference] smoke condensed loss, values gradient on the card (K3 x "
          f"{grads['card'][1]}) == CPU plain path within {SMOKE_GRAD_TOL}")


def reference_phase(device):
    """The smoke config on the card against the port's CPU path (which the
    CPU tests hold to the JAX package), float and int8/fp8 trees alike; each
    card run must launch the kernel its path names. Then the MoE smoke
    configs on condensed, float and int8 (K1-moe / K2-moe once a dispatch
    for each of the 3 expert stacks of each layer)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import engine as E
    from repro_torch.models import model as M
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG

    cfg = configs.get_smoke_config(ARCH)
    gen = torch.Generator(device="cpu").manual_seed(0)
    reg = REG.build_registry(cfg)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, dtype=torch.int32)
    ablated = _ablate_masks(reg, masks, ABLATION)
    only = _ablation_only(reg, masks, ABLATION)
    trees = {  # label: (each path on masks where it is exact, the kernel it runs)
        "condensed": (COND.export_condensed(cfg, reg, params, masks), "K1"),
        "condensed_over_active": (COND.export_condensed_over_active(cfg, reg, params, ablated),
                                  "K4"),
        "structured": (COND.export_structured(cfg, reg, only), "K5"),
    }
    for qdt in QUANT:
        trees[f"condensed {qdt}"] = (COND.export_condensed(
            cfg, reg, params, masks, quantize_spec=qdt), "K2")
        trees[f"condensed_over_active {qdt}"] = (COND.export_condensed_over_active(
            cfg, reg, params, ablated, quantize_spec=qdt), "K2-coa")
        trees[f"structured {qdt}"] = (COND.export_structured(
            cfg, reg, only, params=params, quantize_spec=qdt), "K5")

    def to_dev(tree):  # tensors and format leaves alike
        return {k: to_dev(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}
    for path, (tree, key) in trees.items():
        cpu = E.generate(cfg, params, tree, prompts, 10)
        _zero_counts()
        gpu = E.generate(cfg, to_dev(params), to_dev(tree), prompts.to(device), 10)
        launched = _counts()[key]
        if not launched:
            raise AssertionError(f"smoke {path}: no {key} launch on the card")
        if not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f"smoke {path} tokens differ: card {gpu.tolist()} "
                                 f"cpu {cpu.tolist()}")
        print(f"[reference] smoke {ARCH} {path} on the card ({key} x {launched}) == CPU "
              f"plain path: {cpu[0, 8:].tolist()}")
    # the MoE smoke configs: the condensed experts through K1-moe / K2-moe
    for arch in MOE_ROWS:
        mcfg = configs.get_smoke_config(arch)
        mreg = REG.build_registry(mcfg)
        mparams = M.init_params(mcfg, gen, REG.k_fan_map(mcfg, mreg))
        mmasks = REG.init_sparsity_state(mcfg, gen, mreg)["masks"]
        for qdt, key in ((None, "K1-moe"), ("int8", "K2-moe")):
            tree = COND.export_condensed(mcfg, mreg, mparams, mmasks, quantize_spec=qdt)
            cpu = E.generate(mcfg, mparams, tree, prompts, 10)
            _zero_counts()
            gpu = E.generate(mcfg, to_dev(mparams), to_dev(tree), prompts.to(device), 10)
            launched = _counts()[key]
            if not launched or launched % (3 * mcfg.n_layers):
                raise AssertionError(f"smoke {arch} {qdt}: {key} launched {launched} times, "
                                     f"not a positive multiple of 3 expert stacks x "
                                     f"{mcfg.n_layers} layers")
            if not torch.equal(gpu.cpu(), cpu):
                raise AssertionError(f"smoke {arch} {qdt} tokens differ: card {gpu.tolist()} "
                                     f"cpu {cpu.tolist()}")
            print(f"[reference] smoke {arch} condensed{' ' + qdt if qdt else ''} on the card "
                  f"({key} x {launched}) == CPU plain path: {cpu[0, 8:].tolist()}")
    # the SSM smoke config: its three stacks through K1 / K2, its SSD scan,
    # conv and gated norm in plain torch on both sides
    scfg = configs.get_smoke_config(SSM_ARCH)
    sreg = REG.build_registry(scfg)
    sparams = M.init_params(scfg, gen, REG.k_fan_map(scfg, sreg))
    smasks = REG.init_sparsity_state(scfg, gen, sreg)["masks"]
    sprompts = torch.randint(0, scfg.vocab_size, (2, 21), generator=gen, dtype=torch.int32)
    for qdt, key in ((None, "K1"), ("int8", "K2")):
        tree = COND.export_condensed(scfg, sreg, sparams, smasks, quantize_spec=qdt)
        cpu = E.generate(scfg, sparams, tree, sprompts, 10)
        _zero_counts()
        gpu = E.generate(scfg, to_dev(sparams), to_dev(tree), sprompts.to(device), 10)
        launched = _counts()[key]
        if not launched or launched % (len(sreg) * scfg.n_layers):
            raise AssertionError(f"smoke {SSM_ARCH} {qdt}: {key} launched {launched} times, "
                                 f"not a positive multiple of 3 stacks x {scfg.n_layers} "
                                 f"layers")
        if not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f"smoke {SSM_ARCH} {qdt} tokens differ: card {gpu.tolist()} "
                                 f"cpu {cpu.tolist()}")
        print(f"[reference] smoke {SSM_ARCH} condensed{' ' + qdt if qdt else ''} on the card "
              f"({key} x {launched}) == CPU plain path (prompts 2 x 21: two 16-token SSD "
              f"chunks, the last padded): {cpu[0, 21:].tolist()}")


# ---------------------------------------------------------------------------
# the config zoo beyond qwen3-1.7b ([kernel:zoo], [zoo:<arch>])
# ---------------------------------------------------------------------------

# (arch, layers served: None for the published depth, prompt length). gemma3's
# prompt is longer than its 512-token window, so its local layers' ring
# caches wrap in prefill and again in decode. internlm2-20b and
# mistral-large-123b run at their published widths but a cut depth: the
# phase holds the bf16 weights and masks twice (the caller's and an engine's
# own copy), about 2.8 GB a layer for internlm2-20b and 11 GB for
# mistral-large-123b, which at 48 and 88 layers do not fit one card
ZOO = (("gemma3-1b", None, 600), ("qwen2-vl-7b", None, PROMPT),
       ("internlm2-20b", 16, PROMPT), ("mistral-large-123b", 4, PROMPT))
# the gathered (B, neurons, k) float32 block the chunked plain version holds
PLAIN_CHUNK_BYTES = 1 << 30


def _plain_gather(x, vals, idx, scales=None):
    """K1's (K2's, with ``scales``) plain version (``condensed_matmul._plain``)
    over neuron chunks whose gathered float32 block stays within
    PLAIN_CHUNK_BYTES: the same function, output by output, at widths where
    one gather of the whole (B, n_out, k) block would not fit the card."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    n_out, k = vals.shape
    step = max(1, PLAIN_CHUNK_BYTES // (4 * x.shape[0] * k))
    return torch.cat([cm._plain(x, vals[i:i + step], idx[i:i + step],
                                None if scales is None else scales[i:i + step])
                      for i in range(0, n_out, step)], dim=1)


def _zoo_shapes() -> dict:
    """{(d_in, d_out, k): (arch, stack)}: each distinct K1 shape of ZOO's
    sparse stacks, k the realized fan-in of the registry's ERK densities at
    90% (gemma3's g_local, g_global and g_rem stacks share theirs)."""
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.sparse import registry as REG
    shapes = {}
    for arch, _, _ in ZOO:
        for s in REG.build_registry(configs.get_config(arch)):
            k = D.fan_in_from_density(s.d_in, s.density)
            shapes.setdefault((s.d_in, s.d_out, k), (arch, s.path[-1]))
    return shapes


def zoo_kernel_phase(device) -> list:
    """K1 at every (d_in, d_out, k) of ZOO's sparse stacks, bf16 and f32, at
    decode B=4 and tiled B*T=128: held to its plain version within TOL, the
    decode launch bitwise the tiled launch's first rows, timed beside the
    plain version, torch.matmul on the dense masked weight and the byte
    bound. Prints each shape's bfloat16 geometry (whether the decode kernel
    exists there: up to d_in 6656; past it B <= 8 runs gather_mma at a
    small batch tile) and a line per config: one decode layer (wo + w_gate
    + w_up + w_down) in bf16. Returns the per-case records."""
    import torch
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm

    gen = torch.Generator(device=device).manual_seed(3)
    cases = []
    for (d_in, n_out, k), (arch, name) in _zoo_shapes().items():
        geo = cm.gather_geometry(d_in, torch.bfloat16)
        decode = geo.decode_loads is not None
        print(f"[kernel:zoo] {arch} {name} {d_in}->{n_out} k={k}: bf16 geometry "
              f"{geo.splits} splits of {geo.split_rows} inputs, {geo.passes} pass(es) of "
              f"{geo.pass_rows}, gather_mma {geo.block_neurons} neurons a block "
              f"({geo.smem_bytes} bytes), decode kernel "
              + (f"yes ({geo.decode_smem_bytes} bytes, {geo.decode_loads} loads a thread)"
                 if decode else "no (B <= 8 runs gather_mma at the batch's tile)"))
        mask = topology.random_constant_fan_in_mask(gen, d_in, n_out, k)
        w = torch.randn((d_in, n_out), generator=gen, device=device) / k ** 0.5
        vals32, idx = topology.dense_to_condensed(w * mask, mask, k)
        del mask, w
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            vals = vals32.to(dtype).contiguous()
            dense = topology.condensed_to_dense(vals32, idx, d_in).to(dtype).contiguous()
            isz = vals.element_size()
            weight_sets = [(vals.clone(), idx.clone())
                           for _ in range(_copies(n_out * k * (isz + 4)))]
            dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
            del dense
            for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                y = cm.condensed_matmul(x, vals, idx)
                y_ref, plain_ms = _timed_call(_plain_gather, x, vals, idx)
                torch.testing.assert_close(y.float(), y_ref.float(), **TOL[dtype_name])
                err = (y.float() - y_ref.float()).abs().max().item()
                del y_ref
                tiled = cm.TILED_ROWS[dtype]
                if launch == "decode":
                    same = torch.equal(cm.condensed_matmul_decode(x, vals, idx),
                                       cm.condensed_matmul(x, vals, idx, block_b=tiled))
                    pair = f"decode == tiled({tiled})"
                else:
                    same = torch.equal(cm.condensed_matmul_decode(x[:BATCH], vals, idx),
                                       y[:BATCH])
                    pair = f"decode(first {BATCH} rows) == tiled({tiled})"
                if not same:
                    raise AssertionError(f"K1 {arch} {name} {dtype_name} B={b}: {pair} is not "
                                         f"bitwise")
                ms = _time_ms(cm.condensed_matmul, [(x, v, i) for v, i in weight_sets])
                library_ms = _time_ms(torch.matmul, [(x, wd) for wd in dense_sets])
                nbytes = n_out * k * (isz + 4) + b * d_in * isz + b * n_out * isz
                ops = 2 * b * n_out * k
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                rec = dict(kernel="K1", arch=arch, stack=name, d_in=d_in, n_out=n_out, k=k,
                           dtype=dtype_name, batch=b, launch=launch, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, max_abs_err=err, bitwise=pair,
                           decode_kernel=decode, splits=geo.splits, split_rows=geo.split_rows,
                           passes=geo.passes)
                cases.append(rec)
                print(f"[kernel:zoo] K1 {arch} {name:6s} {d_in}->{n_out} k={k} "
                      f"{dtype_name:8s} B={b:3d} {launch:6s}: ms {ms:.5f} | plain "
                      f"{plain_ms:.5f} | torch.matmul {library_ms:.5f} | bound "
                      f"{rec['bound_ms']:.5f} ({rec['bound_by']}) | max_abs_err {err:.3g} | "
                      f"{pair}: bitwise")
            del weight_sets, dense_sets
        del vals32, idx
        torch.cuda.empty_cache()
    per_layer = {"wo": 1, "w_gate": 2, "w_down": 1}  # w_up shares w_gate's shape
    for arch, _, _ in ZOO:
        for launch in ("decode", "tiled"):
            layer = [c for c in cases if c["arch"] == arch and c["launch"] == launch
                     and c["dtype"] == "bfloat16"]
            tot = {t: sum(c[t] * per_layer[c["stack"]] for c in layer)
                   for t in ("ms", "plain_ms", "library_ms", "bound_ms")}
            print(f"[kernel:zoo] {arch} one {launch} layer (wo + w_gate + w_up + w_down, "
                  f"bf16, B={layer[0]['batch']}): K1 {tot['ms'] * 1e3:.2f} us | bound "
                  f"{tot['bound_ms'] * 1e3:.2f} us | plain {tot['plain_ms'] * 1e3:.2f} us | "
                  f"torch.matmul {tot['library_ms'] * 1e3:.2f} us")
    return cases


def _zoo_request(eng, prompts):
    """One request of ``prompts`` for GEN tokens, served to the end: (its
    Result, the wall seconds from submit to retire)."""
    import torch
    torch.cuda.synchronize()
    _part("setup")
    t0 = time.perf_counter()
    rid = eng.submit(prompts, GEN)
    eng.step()
    [res] = eng.retire(rid)
    torch.cuda.synchronize()
    _part("serve")
    return res, time.perf_counter() - t0


def _zoo_serve(device, card: str, arch: str, depth: int | None, prompt: int) -> int:
    """One ZOO config at its published width: random weights and SRigL ERK
    masks at 90% from a seeded generator, served by ServingEngine (bf16,
    paged=None: the paged pool where model.supports_paged, else the slab
    path) on masked, then condensed (K1). Each engine serves a warm request
    (which captures its decode graph), then one with the counts zeroed just
    before and read just after (condensed: K1 four times a layer a dispatch,
    4 * layers * (1 + GEN) on the slab path; masked: nothing), with the
    warm one's tokens. The eager decode loop (masked: the step-by-step run
    it is held to) gives the engine's tokens bitwise (paged: standalone
    generate's, which the engine's equal but at a near-tie,
    ``_engine_tokens``). Condensed is held to masked under the tie rule
    (``_check_ties`` at ``_tie_threshold``). Prints the layout, the depth,
    both walls and the peak memory. Returns the counted request's K1
    launches."""
    import torch
    from types import SimpleNamespace
    from repro_torch import configs
    from repro_torch.launch import engine as E
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG

    full = configs.get_config(arch)
    cfg = full if depth is None else full.replace(n_layers=depth)
    label = f"zoo:{arch}"
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    reg = REG.build_registry(cfg)
    k_fan = REG.k_fan_map(cfg, reg)
    if k_fan != REG.k_fan_map(full, REG.build_registry(full)):
        raise AssertionError(f"{label}: the cut depth moved the fan-ins to {k_fan}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, k_fan)
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, prompt), generator=gen,
                            device=device, dtype=torch.int32)
    # the serving copy at the compute dtype (the params themselves where they
    # are stored at it): the engines copy what they are given, so they are
    # given this, and the float32 params go
    compute = M.serving_params(cfg, params)
    del params
    torch.cuda.synchronize()
    layout = ", ".join(f"{key} {lead}" for key, lead in M.block_stacks(cfg))
    print(f"[{label}] {cfg.n_layers} layers"
          + ("" if depth is None else f" of the published {full.n_layers} (depth cut; "
             f"widths as published)")
          + f" ({layout}); d_model {cfg.d_model}, {cfg.n_heads} q heads (padded to "
          f"{cfg.n_heads_padded}) / {cfg.n_kv_heads} kv of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {'tied' if cfg.tie_embeddings else 'untied'} head, "
          f"window {cfg.sliding_window} (local:global {cfg.local_global_ratio}:1), "
          f"mrope {cfg.mrope}, params {cfg.param_dtype} served {cfg.dtype}; fan-ins {k_fan}; "
          f"prompts {BATCH}x{prompt} + {GEN}; init {time.perf_counter() - t0:.1f}s")
    if cfg.local_global_ratio:
        w = cfg.sliding_window
        print(f"[{label}] local layers' ring caches of {min(w, prompt + GEN)} slots: prefill "
              f"writes positions 0-{prompt - 1} (wrapped {prompt // w} time(s)), decode "
              f"{prompt}-{prompt + GEN - 1} into slots {prompt % w}-{(prompt + GEN - 1) % w}")
    outs, launches, cond_tree = {}, 0, None
    for path in ("masked", "condensed"):
        name = f"{label}:{path}"
        eng = E.ServingEngine(cfg, compute, masks, reg, path=path, block_size=ENGINE_BLOCK,
                              gen_chunk=ENGINE_CHUNK)
        if eng.paged != M.supports_paged(cfg):
            raise AssertionError(f"{name}: paged={eng.paged}, supports_paged "
                                 f"{M.supports_paged(cfg)}")
        first, _ = _zoo_request(eng, prompts)
        before = {key: r.prefills + r.steps for key, r in eng._runners.items()}
        _zero_counts()
        res, wall = _zoo_request(eng, prompts)
        counts = _counts()
        if eng.paged:
            dispatches = {key: r.prefills + r.steps - before.get(key, 0)
                          for key, r in eng._runners.items()}
            expected = _engine_expected(eng, dispatches)
        else:
            dispatches = {res.plan_key: 1 + GEN}
            expected = {**_none(), "K1": (4 * cfg.n_layers * (1 + GEN)
                                          if path == "condensed" else 0)}
        if counts != expected:
            raise AssertionError(f"{name}: launched {counts}, expected {expected}")
        if not torch.equal(first.tokens, res.tokens):
            raise AssertionError(f"{name}: the warm request gave other tokens")
        tree = eng.serving_tree_for(res.plan_key)
        # a paged engine's tokens are held to standalone generate's
        # (``_engine_tokens``), a slab one's are the engine's own
        standalone = (E.generate(cfg, eng.compute, tree, prompts, GEN) if eng.paged
                      else res.tokens)
        torch.cuda.synchronize()
        eager_s = "the step-by-step run below"
        checked = ["the counted request == the warm one"]
        if path != "masked":  # masked's step-by-step run (_masked_gaps) is its eager loop
            t1 = time.perf_counter()
            eager, _, t_dec, _ = E._serve_eager(cfg, eng.compute, tree, prompts, GEN)
            torch.cuda.synchronize()
            eager_s = (f"wall {(time.perf_counter() - t1) * 1e3:.2f} ms (decode "
                       f"{t_dec * 1e3:.2f} ms)")
            if not torch.equal(eager, standalone):
                raise AssertionError(f"{name}: the eager decode loop gave other tokens than "
                                     f"the graph replays")
            checked.append("the eager loop == " + ("standalone generate" if eng.paged
                                                   else "the engine's tokens"))
        if eng.paged:
            equal, total = _engine_tokens(name, cfg, eng, {res.id: (prompts.cpu(), GEN, res)},
                                          {})
            checked.append(f"engine streams bitwise equal to standalone generate "
                           f"{equal}/{total}")
        print(f"[{name}] {card}: {'paged' if eng.paged else 'slab'} engine, request "
              f"{BATCH}x{prompt}+{GEN}: graph wall {wall * 1e3:.2f} ms (the counted request; "
              f"prefill {res.prefill_s * 1e3:.2f} ms, decode {res.decode_s * 1e3:.2f} ms), eager "
              f"decode loop {eager_s}; dispatches {sum(dispatches.values())}, launches "
              f"{counts}; {'; '.join(checked)}")
        outs[path] = standalone
        if path == "condensed":
            launches, cond_tree = counts["K1"], tree
        del eng, tree
        _release()
    masked = SimpleNamespace(compute=compute, serving=masks)
    toks_m, gaps = _masked_gaps(cfg, masked, prompts, GEN)
    if not torch.equal(toks_m, outs["masked"][:, prompt:]):
        raise AssertionError(f"{label}: masked step-by-step run differs from the engine "
                             f"(paged: standalone generate)")
    tie = _tie_threshold(label, cfg, SimpleNamespace(compute=compute, serving=cond_tree),
                         masked, prompts)
    agree = _check_ties(label, cfg, outs["condensed"], toks_m, gaps, tie, prompt=prompt)
    print(f"[{label}] {card}: condensed against masked: streams agreeing in full "
          f"{agree}/{BATCH}, min masked top-2 gap {gaps.min().item():.3g}; K1 launches "
          f"{launches}; peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
          f"(max_memory_allocated); condensed first stream "
          f"{outs['condensed'][0, prompt:].tolist()}")
    return launches


def zoo_phase(device, card: str) -> int:
    """Every ZOO config served on masked and condensed (``_zoo_serve``);
    returns K1's launches over their counted requests."""
    import torch
    total = 0
    for arch, depth, prompt in ZOO:
        t0 = time.perf_counter()
        total += _zoo_serve(device, card, arch, depth, prompt)
        _release()
        print(f"[time] zoo:{arch}: {time.perf_counter() - t0:.1f}s")
    return total


# ---------------------------------------------------------------------------
# the MoE family ([kernel:moe], [moe])
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
# rows an expert takes in one grouped launch: a decode group of B = 4 (the
# capacity equals the group), the paged engine's bucket of 8, and
# granite's prefill capacity at 4 x 32 tokens (one group of 128, capacity
# 40) and at the engine's 8 x 32 (256 tokens, capacity 80); kimi-k2 at the
# decode capacity and granite's prefill capacity only (its operands are
# 3.4 GB a stack)
MOE_ROWS = {"granite-moe-1b-a400m": (4, 8, 40, 80), "kimi-k2-1t-a32b": (4, 40)}
# (kernel, x dtype, int8 codes) of each case: both kernels in both dtypes;
# kimi-k2's K2-moe with bf16 x only
MOE_VARIANTS = {"granite-moe-1b-a400m": (("K1-moe", "bfloat16", False),
                                         ("K1-moe", "float32", False),
                                         ("K2-moe", "bfloat16", True),
                                         ("K2-moe", "float32", True)),
                "kimi-k2-1t-a32b": (("K1-moe", "bfloat16", False),
                                    ("K1-moe", "float32", False),
                                    ("K2-moe", "bfloat16", True))}
# the [moe] phase's serving paths: (path, values dtype)
MOE_PATHS = (("masked", None), ("condensed", None), ("condensed", "int8"), ("auto", None))


def _moe_expert_shapes() -> list:
    """(arch, stack, E, d_in, d_out, k) of each distinct expert stack of the
    MoE configs at their published widths, k the realized fan-in of the
    registry's ERK densities at 90%."""
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.sparse import registry as REG
    out, seen = [], set()
    for arch in MOE_ROWS:
        cfg = configs.get_config(arch)
        for s in REG.build_registry(cfg):
            k = D.fan_in_from_density(s.d_in, s.density)
            if REG.is_expert_stack(s, cfg) and (arch, s.d_in, s.d_out) not in seen:
                seen.add((arch, s.d_in, s.d_out))
                out.append((arch, s.path[-1], cfg.n_experts, s.d_in, s.d_out, k))
    return out


def _moe_operands(gen, e: int, d_in: int, n_out: int, k: int, device):
    """Random float32 values (std 1/sqrt(k)) and int32 indices (E, n_out, k),
    each row's k distinct inputs in ascending order, as an export stores
    them; drawn an expert at a time."""
    import torch
    idx = torch.empty((e, n_out, k), dtype=torch.int32, device=device)
    for i in range(e):
        scores = torch.rand((n_out, d_in), generator=gen, device=device)
        idx[i] = scores.topk(k, dim=1).indices.sort(dim=1).values.to(torch.int32)
        del scores
    vals = torch.randn((e, n_out, k), generator=gen, device=device) / k ** 0.5
    return vals, idx


def _moe_dense_t(vals, idx, d_in: int):
    """(E, n_out, d_in) dense masked expert weights at vals' dtype, built an
    expert at a time: the transposed operand torch.bmm reads."""
    import torch
    e, n_out, _ = vals.shape
    dense = torch.zeros((e, n_out, d_in), dtype=vals.dtype, device=vals.device)
    for i in range(e):
        dense[i].scatter_(1, idx[i].long(), vals[i])
    return dense


def moe_kernel_phase(device) -> list:
    """K1-moe and K2-moe (``condensed_matmul_grouped``) at each MoE expert
    stack's shape (granite-moe-1b E 32: 1024->512 k 103 and 512->1024 k 52;
    kimi-k2 E 384: 7168->2048 k 718 and 2048->7168 k 205), at MOE_ROWS rows
    an expert, MOE_VARIANTS' dtypes (bf16 and f32 values, int8 codes). Each
    case: bitwise equal to E separate K1 (K2) launches, expert by expert;
    within TOL of the plain version (``ref.condensed_matmul_grouped_ref``);
    timed beside the plain version, torch.bmm over the dense masked expert
    weights (the library call) and the bound (values, indices, scales, x and
    y over HBM_BYTES_PER_S, or the products over the peak); operands of more
    than 4 x L2_BYTES are timed over 3 calls a replay, the plain version
    there over one. Operands are
    built at those shapes directly, one stack at a time (kimi's w_gate: 1.13
    GB of bf16 values and 2.26 GB of indices). Prints each bf16 geometry
    and granite's decode layer (w_gate + w_up + w_down at 8 rows).
    Returns the per-case records."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.sparse import formats as F

    gen = torch.Generator(device=device).manual_seed(11)
    cases = []
    for arch, name, e, d_in, n_out, k in _moe_expert_shapes():
        geo = cm.gather_geometry(d_in, torch.bfloat16)
        print(f"[kernel:moe] {arch} {name} E={e} {d_in}->{n_out} k={k}: bf16 geometry "
              f"{geo.splits} splits of {geo.split_rows} inputs, decode kernel "
              + ("yes" if geo.decode_loads else "no (M <= 8 runs gather_mma at M's tile)"))
        vals32, idx = _moe_operands(gen, e, d_in, n_out, k, device)
        codes, scales = F.quantize_values(vals32, "int8")
        for label, dtype_name, quant in MOE_VARIANTS[arch]:
            dtype = getattr(torch, dtype_name)
            vals = codes if quant else vals32.to(dtype).contiguous()
            sc = scales if quant else None
            # the library's operand: the dense masked weights the codes stand for
            wq = F.dequantize_values(codes, scales, dtype=torch.float32) if quant else vals32
            dense_t = _moe_dense_t(wq.to(dtype), idx, d_in)
            del wq
            wbytes = vals.numel() * vals.element_size() + idx.numel() * 4 + (
                sc.numel() * 4 if quant else 0)
            big = wbytes > 4 * L2_BYTES
            weight_sets = [(vals, idx, sc)] + [(vals.clone(), idx.clone(), sc)
                                               for _ in range(0 if big else _copies(wbytes) - 1)]
            dbytes = dense_t.numel() * dense_t.element_size()
            dense_sets = [dense_t] + [dense_t.clone() for _ in range(
                0 if dbytes > 4 * L2_BYTES else _copies(dbytes) - 1)]
            timing = dict(reps=3, iters=3) if big else {}
            for m in MOE_ROWS[arch]:
                x = torch.randn((e, m, d_in), generator=gen, device=device).to(dtype)
                y = cm.condensed_matmul_grouped(x, vals, idx, scales=sc)
                per = torch.stack([cm.condensed_matmul(x[i], vals[i], idx[i],
                                                       scales=None if sc is None else sc[i])
                                   for i in range(e)])
                if not torch.equal(y, per):
                    raise AssertionError(f"{label} {arch} {name} {dtype_name} M={m}: the "
                                         f"grouped launch differs from {e} single launches")
                want, plain_ms = _timed_call(ref.condensed_matmul_grouped_ref, x, vals, idx, sc)
                torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name])
                err = (y.float() - want.float()).abs().max().item()
                del per, want

                def grouped(x_, v_, i_, s_):
                    return cm.condensed_matmul_grouped(x_, v_, i_, scales=s_)
                ms = _time_ms(grouped, [(x, v, i, s_) for v, i, s_ in weight_sets], **timing)
                library_ms = _time_ms(lambda x_, w_: torch.bmm(x_, w_.transpose(1, 2)),
                                      [(x, w) for w in dense_sets], **timing)
                isz = x.element_size()
                nbytes = wbytes + e * m * (d_in + n_out) * isz
                ops = 2 * e * m * n_out * k
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                launch = "decode" if m <= cm.SMALL_BATCH_MAX else "tiled"
                rec = dict(kernel=label, arch=arch, stack=name, experts=e, d_in=d_in,
                           n_out=n_out, k=k, dtype=dtype_name,
                           codes="int8" if quant else None, rows=m, launch=launch, ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, max_abs_err=err,
                           bitwise=f"== {e} {label[:2]} launches")
                cases.append(rec)
                print(f"[kernel:moe] {label} {arch} {name:6s} E={e} {d_in}->{n_out} k={k} "
                      f"{dtype_name:8s}{' int8' if quant else ''} M={m:2d} {launch}: ms "
                      f"{ms:.5f} | plain {plain_ms:.5f} | torch.bmm {library_ms:.5f} | bound "
                      f"{rec['bound_ms']:.5f} ({rec['bound_by']}) | max_abs_err {err:.3g} | "
                      f"== {e} single {label[:2]} launches bitwise")
                del x, y
            del weight_sets, dense_sets, dense_t, vals
            torch.cuda.empty_cache()
        del vals32, idx, codes, scales
        _release()
    per_layer = {"w_gate": 2, "w_down": 1}  # w_up shares w_gate's shape
    for arch, rows in MOE_ROWS.items():
        for label, codes in (("K1-moe", None), ("K2-moe", "int8")):
            m = 8 if 8 in rows else rows[0]  # the engine's bucket, else the decode group
            layer = [c for c in cases if c["arch"] == arch and c["kernel"] == label
                     and c["dtype"] == "bfloat16" and c["rows"] == m]
            tot = {t: sum(c[t] * per_layer[c["stack"]] for c in layer)
                   for t in ("ms", "plain_ms", "library_ms", "bound_ms")}
            print(f"[kernel:moe] {arch} one decode layer's experts (w_gate + w_up + w_down, "
                  f"bf16 x{', int8 codes' if codes else ''}, {m} rows an expert): {label} "
                  f"{tot['ms'] * 1e3:.2f} us | bound {tot['bound_ms'] * 1e3:.2f} us | plain "
                  f"{tot['plain_ms'] * 1e3:.2f} us | torch.bmm {tot['library_ms'] * 1e3:.2f} us")
    return cases


# rows an expert takes in the ablated phases' grouped launches: MOE_ROWS's
# granite rows (decode group, the engine's bucket, the prefill capacities)
# and the training capacity, 8 x 64 tokens in one group of 512 (capacity
# 160), where K3-moe runs
MOE_TRAIN_ROWS = 160


def _moe_ablated_operands(gen, e: int, d_in: int, d_out: int, k: int, device) -> dict:
    """One granite expert stack's operands with about half of each expert's
    neurons ablated at seeded random positions: expert i ablates d_out / 2 +
    i % 3 of them, so the experts are ragged and an expert with fewer
    surviving rows than the largest has sentinel rows. Returns the condensed
    slots (``vals``, ``idx``: (E, d_out, k)), K4's surviving rows (``va``,
    ``ia``: (E, a_max, k), padding rows value 0; ``out_index`` (E, a_max),
    the sentinel d_out on padding rows), the dense weights on ablation-only
    masks (``wd``: (E, d_in, d_out), ablated columns 0) with K5's
    ``active_index`` (E, a_pad), ``live`` (the surviving rows an expert
    holds, summed) and ``a_max``."""
    import torch
    from repro_torch.kernels import structured_matmul as sm
    vals, idx = _moe_operands(gen, e, d_in, d_out, k, device)
    active = torch.ones((e, d_out), dtype=torch.bool, device=device)
    for i in range(e):
        active[i, torch.randperm(d_out, generator=gen, device=device)[:d_out // 2 + i % 3]] = False
    counts = active.sum(-1)
    a_max = int(counts.max())
    # each expert's surviving rows first, in ascending order
    rows = torch.sort((~active).to(torch.int8), dim=-1, stable=True).indices[:, :a_max]
    real = torch.arange(a_max, device=device)[None] < counts[:, None]
    out_index = torch.where(real, rows, d_out).to(torch.int32).contiguous()
    va = (torch.gather(vals, 1, rows[..., None].expand(-1, -1, k)) * real[..., None]).contiguous()
    ia = torch.gather(idx, 1, rows[..., None].expand(-1, -1, k)).contiguous()
    wd = (torch.randn((e, d_in, d_out), generator=gen, device=device) / d_in ** 0.5
          * active[:, None, :]).contiguous()
    ai = torch.full((e, sm.padded_active_count(a_max, d_out)), d_out, dtype=torch.int32,
                    device=device)
    ai[:, :a_max] = out_index
    return dict(vals=vals, idx=idx, va=va, ia=ia, out_index=out_index, wd=wd, ai=ai,
                live=int(counts.sum()), a_max=a_max)


def _coa_dense_t(va, ia, out_index, d_in: int, d_out: int):
    """(E, d_out, d_in) dense masked weights K4-moe's rows stand for, at
    va's dtype (padding rows dropped): the operand torch.bmm reads
    transposed."""
    import torch
    e, a, k = va.shape
    dense = torch.zeros((e, d_out + 1, d_in), dtype=va.dtype, device=va.device)
    for i in range(e):
        dense[i].index_put_((out_index[i].long()[:, None].expand(a, k), ia[i].long()), va[i])
    return dense[:, :d_out].contiguous()


def _moe_ablation_record(label: str, name: str, e: int, d_in: int, d_out: int, k: int,
                         dtype_name: str, rows: int, ms: float, plain_ms: float,
                         library_ms: float, nbytes: int, ops: int, err: float, what: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    rec = dict(kernel=label, arch=MOE_ARCH, stack=name, experts=e, d_in=d_in, d_out=d_out, k=k,
               dtype=dtype_name, rows=rows, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes, ops=ops,
               max_abs_err=err, bitwise=f"== {e} single launches")
    print(f"[kernel:moe_ablation] {label:10s} {name:6s} E={e} {d_in}->{d_out} k={k} "
          f"{dtype_name:8s} M={rows:3d}: kernel {ms * 1e3:.2f} us | bound "
          f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}) | plain {plain_ms * 1e3:.2f} us | "
          f"{what} {library_ms * 1e3:.2f} us | max_abs_err {err:.3g} | == {e} single "
          f"launches bitwise")
    return rec


def moe_ablation_kernel_phase(device) -> list:
    """The expert-grouped launches of the ablated expert stacks at granite's
    full width (32 experts; w_gate / w_up 1024 -> 512 k 103, w_down 512 ->
    1024 k 52), about half of each expert's neurons ablated at seeded random
    positions (``_moe_ablated_operands``: ragged experts, sentinel rows):
    K4-moe, K2-coa-moe (int8 codes), K5-moe (structured on ablation-only
    masks) and, at decode rows, K6-moe at MOE_ROWS' granite rows an
    expert, and K3-moe at MOE_TRAIN_ROWS over the condensed rows and the
    surviving rows; each in bfloat16 and float32. Each case is bitwise
    equal to E single launches of its one-expert kernel (K6-moe also to
    K5-moe), within TOL of its plain version (K3-moe within _k3_tol), and
    timed beside the plain version, torch.bmm on the dense masked experts
    (K3-moe: the dense weight gradient by torch.bmm, then the gather) and
    the bound (the bytes and operations of the surviving rows and
    columns). Returns the per-case records."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F

    gen = torch.Generator(device=device).manual_seed(12)
    cases = []
    rows_list = MOE_ROWS[MOE_ARCH]
    for arch, name, e, d_in, d_out, k in _moe_expert_shapes():
        if arch != MOE_ARCH:
            continue
        op = _moe_ablated_operands(gen, e, d_in, d_out, k, device)
        a_max, live, a_pad = op["a_max"], op["live"], op["ai"].shape[1]
        print(f"[kernel:moe_ablation] {name} E={e} {d_in}->{d_out} k={k}: surviving rows "
              f"{live / e:.1f} an expert on average, a_max {a_max}, a_pad {a_pad}")
        codes, scales = F.quantize_values(op["va"], "int8")
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            isz = torch.empty((), dtype=dtype).element_size()
            va, wd = op["va"].to(dtype).contiguous(), op["wd"].to(dtype).contiguous()
            ia, oi, ai = op["ia"], op["out_index"], op["ai"]
            panel = sm._gather_columns_grouped(wd, ai)
            coa_dense = _coa_dense_t(va, ia, oi, d_in, d_out)
            qdense = _coa_dense_t(F.dequantize_values(codes, scales, dtype=dtype), ia, oi, d_in,
                                  d_out)
            wd_t = wd.transpose(1, 2).contiguous()
            for m in rows_list:
                x = torch.randn((e, m, d_in), generator=gen, device=device).to(dtype)
                xy = e * m * (d_in + d_out) * isz
                # K4-moe and K2-coa-moe
                for label, v, sc, dense in (("K4-moe", va, None, coa_dense),
                                            ("K2-coa-moe", codes, scales, qdense)):
                    y = sm.condensed_over_active_matmul_grouped(x, v, ia, oi, d_out, scales=sc)
                    per = torch.stack([sm.condensed_over_active_matmul(
                        x[i], v[i], ia[i], oi[i], d_out, scales=None if sc is None else sc[i])
                        for i in range(e)])
                    if not torch.equal(y, per):
                        raise AssertionError(f"{label} {name} {dtype_name} M={m}: the grouped "
                                             f"launch differs from {e} single launches")
                    want, plain_ms = _timed_call(ref.condensed_over_active_matmul_grouped_ref,
                                                 x, v, ia, oi, d_out, sc)
                    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name])
                    err = (y.float() - want.float()).abs().max().item()
                    wbytes = live * k * (v.element_size() + 4) + e * a_max * 4 + (
                        live * 4 if sc is not None else 0)
                    sets = [(v, ia, oi, sc)] + [(v.clone(), ia.clone(), oi.clone(), sc)
                                                for _ in range(_copies(wbytes) - 1)]
                    ms = _time_ms(
                        lambda x_, v_, i_, o_, s_: sm.condensed_over_active_matmul_grouped(
                            x_, v_, i_, o_, d_out, scales=s_), [(x, *a) for a in sets])
                    dsets = [dense] + [dense.clone() for _ in range(
                        _copies(dense.numel() * dense.element_size()) - 1)]
                    lib_ms = _time_ms(lambda x_, w_: torch.bmm(x_, w_.transpose(1, 2)),
                                      [(x, w_) for w_ in dsets])
                    cases.append(_moe_ablation_record(
                        label, name, e, d_in, d_out, k, dtype_name, m, ms, plain_ms, lib_ms,
                        wbytes + xy, 2 * m * live * k, err, "torch.bmm"))
                    del per, want, sets, dsets
                # K5-moe, and K6-moe at decode rows
                y = sm.structured_matmul_grouped(x, wd, ai, prefetch_gather=False)
                per = torch.stack([sm.structured_matmul(x[i], wd[i], ai[i],
                                                        prefetch_gather=False)
                                   for i in range(e)])
                if not torch.equal(y, per):
                    raise AssertionError(f"K5-moe {name} {dtype_name} M={m}: the grouped launch "
                                         f"differs from {e} single launches")
                want, plain_ms = _timed_call(ref.structured_matmul_grouped_ref, x, panel, ai,
                                             d_out)
                torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name])
                err = (y.float() - want.float()).abs().max().item()
                wbytes = d_in * live * isz + e * a_pad * 4
                psets = [panel] + [panel.clone() for _ in range(_copies(wbytes) - 1)]
                ms = _time_ms(lambda x_, p_: sm.structured_matmul_grouped_pregathered(
                    x_, p_, ai, d_out), [(x, p_) for p_ in psets])
                dsets = [wd_t] + [wd_t.clone() for _ in range(_copies(wd_t.numel() * isz) - 1)]
                lib_ms = _time_ms(lambda x_, w_: torch.bmm(x_, w_.transpose(1, 2)),
                                  [(x, w_) for w_ in dsets])
                cases.append(_moe_ablation_record(
                    "K5-moe", name, e, d_in, d_out, k, dtype_name, m, ms, plain_ms, lib_ms,
                    wbytes + xy, 2 * m * live * d_in, err, "torch.bmm"))
                del psets
                if m <= cm.SMALL_BATCH_MAX:
                    y6 = sm.structured_matmul_prefetch_grouped(x, wd, ai)
                    per6 = torch.stack([sm.structured_matmul_prefetch(x[i], wd[i], ai[i])
                                        for i in range(e)])
                    if not (torch.equal(y6, per6) and torch.equal(y6, y)):
                        raise AssertionError(f"K6-moe {name} {dtype_name} M={m}: not bitwise "
                                             f"{e} single K6 launches and K5-moe")
                    wsets = [wd] + [wd.clone() for _ in range(_copies(wd.numel() * isz) - 1)]
                    ms6 = _time_ms(lambda x_, w_: sm.structured_matmul_prefetch_grouped(
                        x_, w_, ai), [(x, w_) for w_ in wsets])
                    cases.append(_moe_ablation_record(
                        "K6-moe", name, e, d_in, d_out, k, dtype_name, m, ms6, plain_ms,
                        lib_ms, wbytes + xy, 2 * m * live * d_in, err, "torch.bmm"))
                    del wsets, per6, y6
                del dsets, per, want, x, y
            # K3-moe over the condensed rows and the surviving rows
            for label, idx, n in (("condensed", op["idx"], d_out), ("surviving", ia, a_max)):
                b = MOE_TRAIN_ROWS
                dy = torch.randn((e, b, n), generator=gen, device=device).to(dtype)
                x = torch.randn((e, b, d_in), generator=gen, device=device).to(dtype)
                dw = cm.condensed_matmul_dw_grouped(dy, x, idx)
                per = torch.stack([cm.condensed_matmul_dw(dy[i], x[i], idx[i]) for i in range(e)])
                if not torch.equal(dw, per):
                    raise AssertionError(f"K3-moe {name} {label} {dtype_name}: the grouped "
                                         f"launch differs from {e} single K3 launches")
                want, plain_ms = _timed_call(ref.condensed_matmul_dw_grouped_ref, dy, x, idx)
                torch.testing.assert_close(dw, want, **_k3_tol(want))
                err = (dw - want).abs().max().item()
                nbytes = e * (b * (n + d_in) * isz + 2 * n * k * 4)
                sets = [(dy, x, idx)] + [(dy.clone(), x.clone(), idx.clone())
                                         for _ in range(_copies(nbytes) - 1)]
                ms = _time_ms(cm.condensed_matmul_dw_grouped, sets)
                it = [(dy_, x_, i_.long().transpose(1, 2).contiguous()) for dy_, x_, i_ in sets]
                lib_ms = _time_ms(lambda dy_, x_, it_: torch.gather(
                    torch.bmm(x_.transpose(1, 2), dy_), 1, it_), it)
                rec = _moe_ablation_record("K3-moe", name, e, d_in, d_out, k, dtype_name, b, ms,
                                           plain_ms, lib_ms, nbytes, 2 * e * b * n * k, err,
                                           f"{label} rows {n}: bmm(x^T, dy) + gather")
                rec["n_rows"] = n
                cases.append(rec)
                del sets, it, dy, x, dw, per, want
            del va, wd, panel, coa_dense, qdense, wd_t
            torch.cuda.empty_cache()
        del op, codes, scales
        _release()
    per_layer = {"w_gate": 2, "w_down": 1}  # w_up shares w_gate's shape
    for label in ("K4-moe", "K2-coa-moe", "K5-moe", "K6-moe"):
        for m in (8, 80):
            layer = [c for c in cases if c["kernel"] == label and c["dtype"] == "bfloat16"
                     and c["rows"] == m]
            if not layer:
                continue
            tot = {t: sum(c[t] * per_layer[c["stack"]] for c in layer)
                   for t in ("ms", "plain_ms", "library_ms", "bound_ms")}
            print(f"[kernel:moe_ablation] {MOE_ARCH} one layer's experts (w_gate + w_up + "
                  f"w_down, bf16, {m} rows an expert): {label} {tot['ms'] * 1e3:.2f} us | bound "
                  f"{tot['bound_ms'] * 1e3:.2f} us | plain {tot['plain_ms'] * 1e3:.2f} us | "
                  f"torch.bmm {tot['library_ms'] * 1e3:.2f} us")
    return cases


def _moe_run(cfg, compute, tree, prompts, gen_len: int, force=None, replay=None) -> dict:
    """One path's greedy run, step by step and eager, reading every router
    call. ``force`` (B, gen_len) feeds those tokens instead of the run's own;
    ``replay`` (another run's ``routes``) makes each router call return that
    run's (dispatch, combine, aux), so that two runs on the same tokens then
    differ only in their linears' kernels. Returns tokens (B, gen_len), the
    logits of each forward pass (gen_len of (B, V) float32; pass 0 the
    prefill, pass j the decode step that produced generated token j), their
    top-2 gaps (B, gen_len), ``routes`` (every router call's output, in
    order) and ``passes``: per pass, per layer, the router logits (G, S, E)
    float32, each token's top-k choice as a sorted set (G, S, k), the
    experts that kept it within their capacity (G, S, E) and its own gap
    between the k-th and (k+1)-th router logit (G, S)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    _part("setup")
    k = cfg.top_k_experts
    route = MOE.route_topk
    layers, routes = [], []
    replayed = iter(replay) if replay is not None else None

    def recording(logits, top_k, capacity):
        lg = logits.float()
        top = torch.sort(lg, dim=-1, descending=True).values
        choice = MOE.top_k(torch.softmax(lg, dim=-1), k)[1].sort(dim=-1).values
        out = route(logits, top_k, capacity) if replayed is None else next(replayed)
        routes.append(out)
        layers.append(dict(router=lg, choices=choice, kept=out[0].any(-1),
                           gaps=top[..., k - 1] - top[..., k]))
        return out

    passes, logits_seen = [], []

    def passed(logits) -> None:
        logits = logits[:, :cfg.vocab_size].float()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        logits_seen.append(logits)
        passes.append(list(layers))
        layers.clear()
    MOE.route_topk = recording
    try:
        with torch.inference_mode():
            b, t = prompts.shape
            cache = M.init_cache(cfg, b, t + gen_len, device=prompts.device)
            logits, cache = M.prefill_step(cfg, compute, tree, {"tokens": prompts}, cache)
            passed(logits)
            toks = []
            for step in range(gen_len):
                cur = torch.argmax(logits_seen[-1], dim=-1).to(torch.int32)
                toks.append(cur)
                fed = cur if force is None else force[:, step].to(torch.int32)
                if step + 1 < gen_len:
                    logits, cache = M.decode_step(cfg, compute, tree, {"tokens": fed[:, None]},
                                                  cache)
                    passed(logits)
    finally:
        MOE.route_topk = route
    top2 = torch.stack([lg.topk(2, dim=-1).values for lg in logits_seen], 1)  # (B, gen, 2)
    out = dict(tokens=torch.stack(toks, 1), logits=logits_seen,
               gaps=top2[..., 0] - top2[..., 1], routes=routes, passes=passes)
    _part("checks")
    return out


def _routing_parts(label: str, ref: dict, run: dict, tie: float, against: str) -> tuple:
    """Where ``run``'s routing parts from ``ref``'s on the same inputs. A
    token that chooses other experts while its stream's routing still
    agrees must have had a router near-tie there (its own gap in ``ref``
    between the k-th and (k+1)-th router logit below ``tie``), else this
    raises. A stream's routing parts where one of its tokens is kept by
    other experts: from its own choice, or, in the prefill, where another
    token's choice moved it past an expert's capacity (the prefill's group
    holds every stream). A decode group of B rows drops nothing, so there a
    stream parts only by its own choice, looked for while its tokens still
    agree. Returns (per stream the pass at which its routing parted, or
    None; a description of each)."""
    import torch
    b, gen = ref["tokens"].shape
    parted, seen = [None] * b, []

    def near_tie(p: int, layer: int, gaps, flip, row: int) -> float:
        gap = gaps[flip].max().item()
        if not gap < tie:
            raise AssertionError(f"{label}: stream {row} pass {p} layer {layer}: "
                                 f"{int(flip.sum())} token(s) choose other experts than on "
                                 f"{against} at a router top-k gap up to {gap:.4g}, not a "
                                 f"near-tie (below {tie:.4g})")
        return gap

    for layer, (r, q) in enumerate(zip(ref["passes"][0], run["passes"][0])):
        flip = (r["choices"] != q["choices"]).any(-1).reshape(b, -1)     # (B, T)
        moved = (r["kept"] != q["kept"]).any(-1).reshape(b, -1)
        gaps = r["gaps"].reshape(b, -1)
        for row in range(b):
            if parted[row] is not None:
                continue
            gap = near_tie(0, layer, gaps[row], flip[row], row) if flip[row].any() else None
            if moved[row].any():
                parted[row] = 0
                seen.append(f"stream {row} prefill layer {layer}: {int(moved[row].sum())} "
                            f"token(s) kept by other experts, {int(flip[row].sum())} by their "
                            f"own choice" + (f" (own router gaps up to {gap:.3g})"
                                             if gap is not None else ""))
    for p in range(1, gen):
        for row in range(b):
            if parted[row] is not None or not torch.equal(run["tokens"][row, :p],
                                                          ref["tokens"][row, :p]):
                continue
            for layer, (r, q) in enumerate(zip(ref["passes"][p], run["passes"][p])):
                flip = (r["choices"] != q["choices"]).any(-1).reshape(-1)[row:row + 1]
                if flip.any():
                    gap = near_tie(p, layer, r["gaps"].reshape(-1)[row:row + 1], flip, row)
                    parted[row] = p
                    seen.append(f"stream {row} decode pass {p} layer {layer}: own router gap "
                                f"{gap:.3g}")
                    break
    return parted, seen


def _moe_hold(label: str, cfg, compute, tree, prompts, standalone, ref: dict, against: str,
              card: str) -> dict:
    """A path held to ``ref`` (masked's run, or the dequantized twin's for
    int8 codes), in two runs of its own, step by step:

    * on ref's tokens with ref's routing replayed, where only the linears'
      kernels differ: every pass's logits and every router call's logits
      within LOGIT_NOISE_BOUND of ref's (d and d_router, the largest
      differences, are printed);
    * on its own (its tokens equal to standalone graph generate's): its
      routing may first part from ref's only at a router near-tie
      (``_routing_parts``, below max(TIE_GAP, 2 d_router)), and a stream's
      tokens may part only where ref's top-2 gap is below max(TIE_GAP, 2 d)
      or after its routing parted. In float32 neither may part at all.

    Returns the counts printed."""
    import torch
    bound = LOGIT_NOISE_BOUND[cfg.dtype]
    rep = _moe_run(cfg, compute, tree, prompts, GEN, force=ref["tokens"], replay=ref["routes"])
    d = max((a - r).abs().max().item() for a, r in zip(rep["logits"], ref["logits"]))
    d_router = max((q["router"] - r["router"]).abs().max().item()
                   for qp, rp in zip(rep["passes"], ref["passes"]) for q, r in zip(qp, rp))
    del rep
    if not (d <= bound and d_router <= bound):
        raise AssertionError(f"{label}: on {against}'s tokens and routing the logits differ by "
                             f"{d} and the router logits by {d_router}, above {bound}")
    own = _moe_run(cfg, compute, tree, prompts, GEN)
    if not torch.equal(own["tokens"], standalone[:, PROMPT:]):
        raise AssertionError(f"{label}: the step-by-step run differs from graph generate")
    tie, tie_router = max(TIE_GAP[cfg.dtype], 2 * d), max(TIE_GAP[cfg.dtype], 2 * d_router)
    parted, seen = _routing_parts(label, ref, own, tie_router, against)
    div = _first_divergence(own["tokens"], ref["tokens"])
    at_tie = after_router = 0
    for row, j in enumerate(div):
        if j is None:
            continue
        gap = ref["gaps"][row, j].item()
        if gap < tie:
            at_tie += 1
        elif parted[row] is not None and parted[row] <= j:
            after_router += 1
        else:
            raise AssertionError(f"{label}: stream {row} parts from {against} at generated token "
                                 f"{j}, a top-2 gap of {gap:.4g} (tie below {tie:.4g}), with "
                                 f"its routing equal to {against}'s up to there")
        print(f"[{label}] stream {row}: parts from {against} at generated token {j}, top-2 gap "
              f"{gap:.3g} (tie below {tie:.3g}); its routing parted at pass {parted[row]}")
    agree = sum(j is None for j in div)
    if cfg.dtype == "float32" and (agree != len(div) or seen):
        raise AssertionError(f"{label}: in float32 the tokens (first divergence {div}) or the "
                             f"routing ({seen}) part from {against}'s")
    print(f"[{label}] {card}: against {against}: on its tokens and routing, logits within "
          f"{d:.4g} over the prefill and {GEN - 1} decode steps, router logits within "
          f"{d_router:.4g} (bound {bound}); own run: streams agreeing in full "
          f"{agree}/{len(div)}, parted at a logit tie {at_tie}, parted after a router near-tie "
          f"{after_router}; routing parted at {seen or 'no pass'} (near-tie below "
          f"{tie_router:.3g})")
    return dict(agree=agree, at_tie=at_tie, after_router=after_router, d=d, d_router=d_router)


def _moe_engine(cfg, params, masks, reg, path, values_dtype, prompts, label, card,
                prefetch: bool = False, repeats: bool = True):
    """One paged engine on ``path``: a warm request, a counted one, with
    ``repeats`` one more on the warm one's rows and held to its tokens (the
    median wall of the counted and the repeated), and the standalone generate of its
    serving tree (graph decode), which the caller holds to a step-by-step
    eager run (``_moe_run``, in ``_moe_hold`` for a held path): the eager
    decode loop's check, at no extra run. ``prefetch``: the caller set
    REPRO_PREFETCH_GATHER=1, so the structured decode launches are K6 /
    K6-moe. Returns (engine result's tokens, standalone tokens, launch
    counts, (compute params, serving tree)); the engine itself is freed."""
    import torch
    from repro_torch.launch import engine as E
    eng = E.ServingEngine(cfg, params, masks, reg, path=path, values_dtype=values_dtype,
                          block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK)
    if not eng.paged:
        raise AssertionError(f"{label}: the MoE engine is not paged")
    first, _ = _zoo_request(eng, prompts)
    before = {key: (r.prefills, r.steps) for key, r in eng._runners.items()}
    _zero_counts()
    res, wall = _zoo_request(eng, prompts)
    counts = _counts()
    steps = {key: r.steps - before.get(key, (0, 0))[1] for key, r in eng._runners.items()}
    dispatches = {key: r.prefills - before.get(key, (0, 0))[0] + steps[key]
                  for key, r in eng._runners.items()}
    expected = _engine_expected(eng, dispatches)
    if prefetch:
        expected = _prefetched(expected, eng, steps)
    if counts != expected or sum(dispatches.values()) != 1 + GEN:
        raise AssertionError(f"{label}: launched {counts} over {dispatches}, expected "
                             f"{expected}")
    # the bucket's free rows rotate: requests 1 and 3 take rows 0-3, 2 and 4
    # rows 4-7, and a row's place in the prefill's routing group moves which
    # tokens overflow an expert's capacity, so a request is held to the one
    # that took the same rows
    walls, tokens = [wall], [first.tokens, res.tokens]
    if repeats:
        again, wall = _zoo_request(eng, prompts)
        walls.append(wall)
        if not torch.equal(tokens[0], again.tokens):
            raise AssertionError(f"{label}: request 3 gave other tokens than request 1 on "
                                 f"the same rows")
    placed = "equal" if torch.equal(tokens[0], tokens[1]) else "part"
    tree = eng.serving_tree_for(res.plan_key)
    standalone = E.generate(cfg, eng.compute, tree, prompts, GEN)
    torch.cuda.synchronize()
    _part("standalone")
    reps = sorted({r for _, r in res.plan_key.formats})
    print(f"[{label}] {card}: paged engine ({', '.join(reps)}), request {BATCH}x{PROMPT}+{GEN} "
          f"(bucket {res.plan_key.batch_bucket}): graph wall "
          f"{statistics.median(walls) * 1e3:.2f} ms (median of {len(walls)}; prefill "
          f"{res.prefill_s * 1e3:.2f} ms, decode {res.decode_s * 1e3:.2f} ms); on rows 0-3 and "
          f"rows 4-7 the engine's tokens {placed}; "
          f"dispatches {sum(dispatches.values())}, launches "
          f"{ {n: c for n, c in counts.items() if c} }; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (max_memory_allocated)")
    if path == "auto":  # what the cost model weighed for each stack at this bucket
        plan = eng.plan_for(res.plan_key)
        for name, dec in plan.decisions.items():
            est = ", ".join(f"{rep} {sec * 1e6:.2f} us" for rep, sec in dec.est_s.items())
            print(f"[{label}] plan at bucket {res.plan_key.batch_bucket}, profile "
                  f"{plan.profile.name}: {name} -> {dec.representation} (est {est} a step)")
        del plan
    out = res.tokens, standalone, counts, (eng.compute, tree)
    del eng, tree
    _release()
    return out


def moe_phase(device, card: str) -> dict:
    """granite-moe-1b-a400m at its published width and depth (24 layers,
    d_model 1024, 32 experts top-8, d_ff 512 an expert), random weights and
    90% SRigL ERK masks from a seeded generator, served by the paged
    ServingEngine with graph decode at B = 4, prompt 32 + GEN new tokens:
    bf16 on MOE_PATHS (masked, condensed, int8 condensed, auto), then f32 on
    masked and condensed. Each engine (``_moe_engine``): a counted request
    launching what its plan implies (condensed: K1 24 x 17 times for wo and
    K1-moe 3 x 24 x 17 for the experts; int8: K2 and K2-moe), repeated
    requests with the same tokens, standalone graph decode == each path's
    step-by-step eager run bitwise. Each path is held to masked's
    step-by-step run (int8 to its dequantized twin's) by ``_moe_hold``:
    logits within
    LOGIT_NOISE_BOUND on the same tokens and routing, and its own routing
    and tokens parting only at a router near-tie or a logit tie; in f32
    nothing parts. Returns the condensed request's K1 and K1-moe launches
    and the int8 one's K2 and K2-moe launches."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    reg = REG.build_registry(cfg)
    k_fan = REG.k_fan_map(cfg, reg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, k_fan)
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    torch.cuda.synchronize()
    print(f"[moe] {MOE_ARCH}: {cfg.n_layers} layers (published depth), d_model {cfg.d_model}, "
          f"{cfg.n_heads} q heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, {cfg.n_experts} "
          f"experts top-{cfg.top_k_experts} of d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, group "
          f"{cfg.moe_group_size}, capacity factor {cfg.capacity_factor}; stacks "
          f"{[(s.path[-1], s.lead) for s in reg]}, fan-ins {k_fan}; params {cfg.param_dtype} "
          f"served {cfg.dtype}; prompts {BATCH}x{PROMPT} + {GEN}; init "
          f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    launches = {}
    for dtype_name, paths in (("bfloat16", MOE_PATHS), ("float32", MOE_PATHS[:2])):
        run_cfg = cfg.replace(dtype=dtype_name)
        tag = "" if dtype_name == "bfloat16" else ":f32"
        for path, vd in paths:
            label = f"moe:{path}" + (f":{vd}" if vd else "") + tag
            tokens, standalone, counts, (compute, tree) = _moe_engine(
                run_cfg, params, masks, reg, path, vd, prompts, label, card)
            if path == "condensed" and not tag:  # wo once a layer a dispatch, the 3 expert stacks too
                dense, grouped = ("K2", "K2-moe") if vd else ("K1", "K1-moe")
                want = {dense: cfg.n_layers * (1 + GEN), grouped: 3 * cfg.n_layers * (1 + GEN)}
                if {n: counts[n] for n in want} != want:
                    raise AssertionError(f"{label}: launched {counts}, expected {want}")
                launches.update(want)
            if path == "masked":
                # masked's own run, which every other path of this dtype is held to
                masked = _moe_run(run_cfg, compute, tree, prompts, GEN)
                if not torch.equal(masked["tokens"], standalone[:, PROMPT:]):
                    raise AssertionError(f"{label}: the step-by-step run differs from generate")
                masked_engine = tokens
                print(f"[{label}] {card}: first stream {masked['tokens'][0].tolist()}, "
                      f"{len(set(masked['tokens'].reshape(-1).tolist()))} distinct tokens over "
                      f"the {BATCH} streams")
            else:
                ref, against = masked, "masked"
                if vd:  # codes are held to their dequantized twin (K1-moe), as in [quant]
                    twin = _dequantized_twin(types.SimpleNamespace(registry=reg,
                                                                   serving_tree=tree),
                                             getattr(torch, dtype_name))
                    ref, against = _moe_run(run_cfg, compute, twin, prompts, GEN), "the twin"
                    del twin
                _moe_hold(label, run_cfg, compute, tree, prompts, standalone, ref, against, card)
                engine_agree = sum(j is None for j in _first_divergence(
                    tokens[:, PROMPT:], masked_engine[:, PROMPT:]))
                print(f"[{label}] {card}: engine streams equal to the masked engine's "
                      f"{engine_agree}/{BATCH}")
                del ref
            del compute, tree
            _release()
        del masked
    print(f"[moe] {card}: peak memory over the phase "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB (max_memory_allocated)")
    del params, masks
    _release()
    return launches


# the [moe:ablated] phase's serving runs, (dtype, path, values dtype, masks,
# REPRO_PREFETCH_GATHER): "ablated" are the SRigL masks with the last half
# of every stack's neurons emptied (condensed_over_active is exact on any
# mask), "ablation-only" those neurons' columns empty and every other
# column dense (where structured is exact); each group's masked run comes
# first and is the one the paths after it are held to
MOE_ABLATED_RUNS = (("bfloat16", "masked", None, "ablated", False),
                    ("bfloat16", "condensed_over_active", None, "ablated", False),
                    ("bfloat16", "condensed_over_active", "int8", "ablated", False),
                    ("bfloat16", "auto", None, "ablated", False),
                    ("bfloat16", "masked", None, "ablation-only", False),
                    ("bfloat16", "structured", None, "ablation-only", False),
                    ("bfloat16", "structured", None, "ablation-only", True),
                    ("float32", "masked", None, "ablated", False),
                    ("float32", "condensed_over_active", None, "ablated", False))


def _prefetched(expected: dict, eng, steps: dict) -> dict:
    """``expected`` with each structured stack's decode launches (``steps``:
    {plan key: decode steps}) moved from K5 / K5-moe to K6 / K6-moe, as
    REPRO_PREFETCH_GATHER=1 runs them (a decode step's rows: the bucket,
    and an expert's capacity at that group, both at most 8)."""
    from repro_torch.sparse import registry as REG
    stacks = {s.name: s for s in eng.registry}
    out = dict(expected)
    for key, n in steps.items():
        for name, rep in key.formats:
            if rep == "structured":
                grouped = "-moe" if REG.is_expert_stack(stacks[name], eng.cfg) else ""
                runs = _applications(eng.cfg, stacks[name]) * n
                out["K5" + grouped] -= runs
                out["K6" + grouped] += runs
    return out


def moe_ablated_phase(device, card: str) -> dict:
    """granite-moe-1b-a400m at its published width and depth (24 layers,
    d_model 1024, 32 experts top-8, d_ff 512), random weights and 90% SRigL
    ERK masks from a seeded generator, with half of every stack's neurons
    (each expert's and wo's) ablated, served by the paged ServingEngine
    with graph decode at B = 4 x 32 + GEN (``_moe_engine``) on
    MOE_ABLATED_RUNS: bf16 condensed_over_active (K4 24 x 17 and K4-moe 3 x
    24 x 17 a request), the same on int8 codes (K2-coa, K2-coa-moe),
    auto (its decision per stack printed), structured (K5, K5-moe) and
    structured with REPRO_PREFETCH_GATHER=1 (K6, K6-moe at decode) on
    ablation-only masks, and f32 condensed_over_active. Every run launches
    what its plan implies; standalone graph decode == its step-by-step
    eager run bitwise; each path is held by ``_moe_hold`` to its masks'
    masked run (int8 to its dequantized twin's), step by step on the serving params
    with no engine ([moe] serves masked on the engine); a run whose kernels
    are bitwise those of a path already held (auto where its plan is
    condensed_over_active on every stack, structured with prefetch: K6 ==
    K5 at decode) is held to that path's standalone tokens bitwise instead.
    Each engine serves a warm and a counted request, no repeats ([moe]
    repeats its own). Returns the launches of the bf16 runs, by kernel."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats(device)
    reg = REG.build_registry(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    mask_sets = {"ablated": _ablate_masks(reg, masks, ABLATION),
                 "ablation-only": _ablation_only(reg, masks, ABLATION)}
    del masks
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    print(f"[moe:ablated] {MOE_ARCH}: {cfg.n_layers} layers, {cfg.n_experts} experts top-"
          f"{cfg.top_k_experts}, d_model {cfg.d_model}, d_ff {cfg.d_ff}; the last "
          f"{ABLATION:.0%} of every stack's neurons ablated (every expert's and wo's); "
          f"prompts {BATCH}x{PROMPT} + {GEN}")
    launches, masked, held = {}, None, {}
    for dtype_name, path, vd, which, prefetch in MOE_ABLATED_RUNS:
        run_cfg = cfg.replace(dtype=dtype_name)
        label = (f"moe:ablated:{path}" + ("+prefetch" if prefetch else "")
                 + (f":{vd}" if vd else "") + ("" if dtype_name == "bfloat16" else ":f32"))
        if path == "masked":  # the reference the paths after it are held to
            masked = _moe_run(run_cfg, M.serving_params(run_cfg, params), mask_sets[which],
                              prompts, GEN)
            print(f"[{label}] {card}: first stream {masked['tokens'][0].tolist()}")
            continue
        with _prefetch_gather(prefetch):
            tokens, standalone, counts, (compute, tree) = _moe_engine(
                run_cfg, params, mask_sets[which], reg, path, vd, prompts, label, card,
                prefetch=prefetch, repeats=False)
            if dtype_name == "bfloat16":
                for key, n in counts.items():
                    launches[key] = launches.get(key, 0) + n
            if path == "condensed_over_active" and not vd and dtype_name == "bfloat16":
                want = {"K4": cfg.n_layers * (1 + GEN), "K4-moe": 3 * cfg.n_layers * (1 + GEN)}
                if {n: counts[n] for n in want} != want:
                    raise AssertionError(f"{label}: launched {counts}, expected {want}")
            reps = {type(REG.get_path(tree, s.path)).format_name for s in reg}
            same = (path, dtype_name, vd) if path != "auto" else (*reps, dtype_name, vd)
            if same in held and (prefetch or path == "auto"):
                if not torch.equal(standalone, held[same]):
                    raise AssertionError(f"{label}: other tokens than the {same[0]} run, whose "
                                         f"kernels it runs bitwise")
                print(f"[{label}] {card}: its plan {sorted(reps)}; standalone tokens == the "
                      f"{same[0]} run's bitwise (held there to masked)")
            else:
                ref, against = masked, f"masked ({which} masks)"
                if vd:  # codes are held to their dequantized twin, as in [quant]
                    twin = _dequantized_twin(types.SimpleNamespace(registry=reg,
                                                                   serving_tree=tree),
                                             getattr(torch, dtype_name))
                    ref, against = _moe_run(run_cfg, compute, twin, prompts, GEN), "the twin"
                    del twin
                _moe_hold(label, run_cfg, compute, tree, prompts, standalone, ref, against,
                          card)
                held[(path, dtype_name, vd)] = standalone
                del ref
        del compute, tree, tokens, standalone
        _release()
    print(f"[moe:ablated] {card}: peak memory over the phase "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB (max_memory_allocated)")
    del params, mask_sets, masked
    _release()
    return launches


def moe_grad_phase(device) -> int:
    """The loss of full-width granite-moe-1b (float32, 24 layers, half of
    every stack's neurons ablated) over 8 x 64 SyntheticLM tokens (one
    routing group of 512, 160 rows an expert), differentiated through its
    condensed and its condensed_over_active trees into the values: the
    forward launches K1 / K4 for wo and K1-moe / K4-moe for the experts
    (twice with the blocks recomputed), the backward K3 for wo and K3-moe
    for the experts. The masked loss's expert choices (each router call's
    top-k indices) are recorded and replayed in each run, the gates still
    computed from the run's own router logits, so that the two differ only
    in their linears' kernels and the gradient still flows through the
    routers; each stack's values gradient is then within GRAD_F32_BOUND of
    the masked straight-through gradient gathered at its slots, as [grad]
    holds qwen3's. Returns K3-moe's launches per backward."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(MOE_ARCH).replace(dtype="float32")
    reg = REG.build_registry(cfg)
    gen = torch.Generator(device=device).manual_seed(3)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = _ablate_masks(reg, REG.init_sparsity_state(cfg, gen, reg)["masks"], ABLATION)
    batch = _train_batch(cfg, device)
    top_k = MOE.top_k
    choices: list = []

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        choices.append(idx)
        return vals, idx
    MOE.top_k = recording
    try:
        mloss, dense = _sparse_grads(cfg, reg, params, masks, batch)
    finally:
        MOE.top_k = top_k
    passes = 2 if cfg.remat == "block" else 1
    layers = cfg.n_layers
    k3 = None
    for label, export, kern in (("condensed", COND.export_condensed, "K1"),
                                ("condensed_over_active", COND.export_condensed_over_active,
                                 "K4")):
        tree = export(cfg, reg, params, masks)
        leaves = {s.name: REG.get_path(tree, s.path) for s in reg}
        for leaf in leaves.values():
            leaf.values.requires_grad_(True)
        replay = iter(choices)

        def replaying(probs, k):
            idx = next(replay)
            return torch.gather(probs, -1, idx), idx
        MOE.top_k = replaying
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _zero_counts()
            loss = M.loss_fn(cfg, params, tree, batch)[0]
            loss.backward()
            torch.cuda.synchronize()
            counts = _counts()
            step_s = time.perf_counter() - t0
        finally:
            MOE.top_k = top_k
        if next(replay, None) is not None:
            raise AssertionError(f"[grad:moe] {label}: fewer router calls than the masked run")
        expected = {**_none(), kern: passes * layers, kern + "-moe": 3 * passes * layers,
                    "K3": layers, "K3-moe": 3 * layers}
        if counts != expected:
            raise AssertionError(f"[grad:moe] {label}: launched {counts}, expected {expected}")
        if abs(loss.item() - mloss.item()) > GRAD_F32_BOUND * abs(mloss.item()):
            raise AssertionError(f"[grad:moe] {label}: loss {loss.item()} vs masked "
                                 f"{mloss.item()}")
        for s in reg:
            leaf = leaves[s.name]
            got = leaf.values.grad.float()
            want = _gathered(dense[s.name], leaf, s.d_out).float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            if not (bool(torch.isfinite(got).all()) and rel <= GRAD_F32_BOUND):
                raise AssertionError(f"[grad:moe] {label} {s.name}: relative difference {rel} "
                                     f"(bound {GRAD_F32_BOUND})")
            print(f"[grad:moe] {label} {s.name} (lead {tuple(s.lead)}): max |values grad - "
                  f"gathered dense grad| / max |dense grad| = {rel:.3g} (max |dense grad| "
                  f"{want.abs().max().item():.3g})")
        print(f"[grad:moe] {label}: loss {loss.item():.6f} (masked {mloss.item():.6f}, the "
              f"masked run's expert choices replayed); forward + backward {step_s:.2f}s; launches "
              f"{ {n: c for n, c in counts.items() if c} } (bound {GRAD_F32_BOUND:g})")
        k3 = counts["K3-moe"]
        del tree, leaves, loss
        torch.cuda.empty_cache()
    del params, masks, dense, choices
    _release()
    return k3


MOE_TRAIN_STEPS = 3  # AdamW steps; the last one with the SRigL update (delta_t 3)


def moe_train_phase(device, card: str) -> None:
    """granite-moe-1b-a400m trained at its published width and depth on the
    card from a seeded init: the Trainer for MOE_TRAIN_STEPS AdamW steps on
    SyntheticLM 8 x 64 batches (masked-dense, the routers' aux loss in the
    loss), the last one with the SRigL update over every stack (the expert
    stacks' (L, E) vmapped update): losses and grad norms finite, the SRigL
    invariants held, moments 0 off the mask. Prints the step ms, the DST
    step s, max_memory_allocated and each stack's ablated neurons. Then the
    trained state is exported and one B = 4 request served through
    ``--path auto`` on the paged engine, launching what its plan implies."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.launch import engine as E
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sparse import registry as REG
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import Trainer

    torch.cuda.reset_peak_memory_stats(device)
    base = configs.get_config(MOE_ARCH)
    cfg = base.replace(sparsity=dataclasses.replace(base.sparsity, delta_t=MOE_TRAIN_STEPS))
    trainer = Trainer(cfg=cfg, lr_fn=warmup_cosine(3e-3, 1, 2 * MOE_TRAIN_STEPS), log_every=1)
    reg = trainer.registry
    dst_times: list = []
    _timed_dst(trainer, dst_times)
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                       seed=0)
    batches = Prefetcher(data.iterate(), depth=2, pin=True)
    step_ms = []
    _zero_counts()
    try:
        for i in range(MOE_TRAIN_STEPS):
            old_masks = state.masks
            old_versions = {k: int(v) for k, v in state.mask_versions.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.fit(state, batches, 1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            m = trainer.last_metrics
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"[moe:train] step {i}: loss {loss}, grad norm {gnorm}")
            dst = (i + 1) % MOE_TRAIN_STEPS == 0
            print(f"[moe:train] step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
                  f"{step_ms[-1]:.1f} ms" + (" with the SRigL update" if dst else ""))
            if dst:
                _check_dst(cfg, reg, state, old_masks, old_versions)
            else:
                _moments_off_mask(f"[moe:train] step {i}", reg, state)
            del old_masks
    finally:
        batches.close()
    if _counts() != _none():
        raise AssertionError(f"[moe:train] the masked-dense trainer launched {_counts()}")
    ablated = {s.name: int((~REG.get_path(state.neuron_active, s.path)).sum()) for s in reg}
    neurons = {s.name: s.n_replicas * s.d_out for s in reg}
    print(f"[moe:train] {card}: {MOE_TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens at "
          f"{[round(t, 1) for t in step_ms]} ms (the last with the SRigL update); SRigL DST "
          f"step {[round(t, 3) for t in dst_times]} s; peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB (max_memory_allocated); "
          f"ablated neurons per stack {ablated} (of {neurons})")
    params, masks = state.params, state.masks
    del state, trainer
    _release()
    eng = E.ServingEngine(cfg, params, masks, reg, path="auto", block_size=ENGINE_BLOCK,
                          gen_chunk=ENGINE_CHUNK)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator(device=device).manual_seed(1),
                            device=device, dtype=torch.int32)
    _zoo_request(eng, prompts)  # warm: graphs captured
    before = {key: r.prefills + r.steps for key, r in eng._runners.items()}
    _zero_counts()
    res, wall = _zoo_request(eng, prompts)
    counts = _counts()
    dispatches = {key: r.prefills + r.steps - before.get(key, 0)
                  for key, r in eng._runners.items()}
    expected = _engine_expected(eng, dispatches)
    if counts != expected or res.tokens.shape != (BATCH, PROMPT + GEN):
        raise AssertionError(f"[moe:train] auto: launched {counts}, expected {expected}; "
                             f"tokens {tuple(res.tokens.shape)}")
    plan = eng.plan_for(res.plan_key)
    reps = {n: d.representation for n, d in plan.decisions.items()}
    print(f"[moe:train] {card}: the trained state exported and served on --path auto, request "
          f"{BATCH}x{PROMPT}+{GEN} (bucket {res.plan_key.batch_bucket}): wall "
          f"{wall * 1e3:.2f} ms, plan {reps}, launches { {n: c for n, c in counts.items() if c} }")
    del eng, plan, params, masks
    _release()


# ---------------------------------------------------------------------------
# speculative decoding on the MoE family ([spec:moe])
# ---------------------------------------------------------------------------

# (label, compute dtype, draft ablation): bf16 sentinel drafts at half the
# neurons, and f32 at draft ablation 0.0, the protocol's ceiling, where a
# draft is the target's weights and a rejection needs a tie or a verify drop
SPEC_MOE_RUNS = (("spec:moe", "bfloat16", 0.5), ("spec:moe:f32", "float32", 0.0))


@contextlib.contextmanager
def _recorded_rounds(rounds: list, prefill_gaps: list):
    """Record every speculative round the paged runners dispatch while the
    block runs (``engine._spec_dispatch``): the device pool, the host
    tables, lengths and next tokens it starts from, its live rows, and the
    feed and verify argmax the graphs gave; and each prefill dispatch's
    top-2 logit gap per bucket row (``prefill_gaps``; the last is the
    admission's, after any warm-up of a new prompt bucket), which chose the
    first generated token. Nothing of a dispatch changes."""
    from repro_torch.launch import engine as E
    dispatch, prefill = E._spec_dispatch, E._paged_prefill_dispatch

    def recording(runner):
        start = dict(runner=runner, pool={k: v.clone() for k, v in runner.state.pool.items()},
                     table=runner.table.copy(), lengths=runner.lengths.copy(),
                     cur=runner.cur.copy(),
                     rows={a.req.id: list(a.rows) for a in runner.active.values()})
        out = dispatch(runner)
        rounds.append(dict(start, feed=out[0].copy(), targ=out[1].copy()))
        return out

    def recording_prefill(cfg, *args, **kw):
        out = prefill(cfg, *args, **kw)
        top2 = out[0][..., :cfg.vocab_size].float().topk(2, dim=-1).values
        prefill_gaps.append((top2[..., 0] - top2[..., 1]).reshape(-1).cpu().numpy())
        return out

    E._spec_dispatch, E._paged_prefill_dispatch = recording, recording_prefill
    try:
        yield rounds
    finally:
        E._spec_dispatch, E._paged_prefill_dispatch = dispatch, prefill


def _spec_rounds_eager(label: str, cfg, eng, rounds: list, on_cpu: bool) -> dict:
    """Each recorded round run again eagerly on the card from its saved
    state, through the graphs' own step functions (the same kernels): the
    first round's draft steps and every round's verify, which decides every
    committed token. A later round's verify reads the graph's drafts (the
    recorded feed; it overwrites every pool slot the drafts wrote before
    any position attends it, ``models.model`` ``_serve_block``). The feed
    and the verify's argmax must equal the graphs' bitwise on every live
    row. Every router call of a verify must route the bucket's rows as one
    group (B * (gamma + 1) rows) at the capacity the reference's
    ``moe_block`` gives it, min(gs, max(ceil(gs * k * cf / E), k)), worked
    out here from the config. Adds to each round the verify's top-2 gaps
    (bucket, gamma + 1) and, per live row and verify position, the (token,
    expert) assignments its verify dropped: a token's top-k expert that
    kept no slot for it, from the router calls of the eager verify
    (``moe.route_topk``). With ``on_cpu``, the first round's verify is also
    held to ``_spec_verify_on_cpu``. Returns what that check found (or
    an empty dict)."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    gamma = eng.speculative.gamma
    route, verify = MOE.route_topk, M.paged_verify_step
    calls, seen, found = [], {}, {}

    def recording(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        calls.append((logits, out))
        return out

    def kept_logits(*args, **kw):
        out = verify(*args, **kw)
        seen["logits"] = out[0]
        return out

    MOE.route_topk, M.paged_verify_step = recording, kept_logits
    try:
        with torch.no_grad():
            for r in rounds:
                runner, st = r["runner"], r["runner"].state
                for k, v in r["pool"].items():
                    st.pool[k].copy_(v)
                st.table.copy_(torch.from_numpy(r["table"]))
                st.step.zero_()
                if r is rounds[0]:
                    st.lengths.copy_(torch.from_numpy(r["lengths"]))
                    st.cur.copy_(torch.from_numpy(r["cur"]))
                    for _ in range(gamma):
                        runner.draft.step()
                else:  # the state the draft graph left: its tokens, lengths + gamma
                    st.lengths.copy_(torch.from_numpy(r["lengths"] + gamma))
                    st.toks[:, :gamma].copy_(torch.from_numpy(r["feed"][:, :gamma]))
                    st.cur.copy_(torch.from_numpy(r["feed"][:, gamma:]))
                calls.clear()
                runner.verify.step()
                live = sorted(row for rows in r["rows"].values() for row in rows)
                feed = st.toks[:, :gamma + 1].cpu().numpy()
                targ = runner.targ.cpu().numpy()
                if not (np.array_equal(feed[live], r["feed"][live])
                        and np.array_equal(targ[live], r["targ"][live])):
                    raise AssertionError(f"{label}: a round's eager draft and verify give other "
                                         f"tokens than its graph replays")
                lg = seen["logits"][..., :cfg.vocab_size].float()
                top2 = lg.topk(2, dim=-1).values
                r["gaps"] = (top2[..., 0] - top2[..., 1]).cpu().numpy()
                b, t = lg.shape[:2]
                gs = min(cfg.moe_group_size, b * t)
                cap = min(gs, max(math.ceil(gs * cfg.top_k_experts * cfg.capacity_factor
                                            / cfg.n_experts), cfg.top_k_experts))
                drops = torch.zeros((b, t), dtype=torch.int64, device=lg.device)
                for logits, (dispatch, _, _) in calls:  # one router call a layer
                    if tuple(logits.shape[:2]) != (b * t // gs, gs) or dispatch.shape[-1] != cap:
                        raise AssertionError(f"{label}: a verify router call routed groups "
                                             f"{tuple(logits.shape[:2])} at capacity "
                                             f"{dispatch.shape[-1]}, the reference's "
                                             f"{(b * t // gs, gs)} at {cap}")
                    chosen = MOE.top_k(torch.softmax(logits.float(), dim=-1),
                                       cfg.top_k_experts)[1]
                    held = dispatch.any(-1).gather(-1, chosen)          # (G, S, k)
                    drops += (~held).reshape(b, t, -1).sum(-1)
                r["drops"] = {row: drops[row].tolist() for row in live}
                r["capacity"] = cap
                if on_cpu and r is rounds[0]:
                    found = _spec_verify_on_cpu(label, cfg, eng, r, feed, calls,
                                                seen["logits"], live, route)
                del r["pool"]
    finally:
        MOE.route_topk, M.paged_verify_step = route, verify
    return found


def _spec_verify_on_cpu(label: str, cfg, eng, r: dict, feed, calls: list, logits,
                        live: list, route) -> dict:
    """The round ``r``'s verify run again on the CPU through the plain
    versions of the kernels, on copies of the same params, serving tree,
    pool, table, lengths and feed (the path the CPU tests hold to the
    reference's ``paged_verify_step``). The routing: each layer's dispatch
    on the card must equal ``route`` (``moe.route_topk``) run here on the card's router
    logits at the group's capacity, bitwise; the CPU verify then replays the
    card's routing (a float32 near-tie of two experts' scores may rank them
    otherwise here), and its logits on the live rows must lie within
    LOGIT_NOISE_BOUND of the card's. Returns the largest difference and
    the rows and positions compared."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    cpu = torch.device("cpu")

    def to_cpu(tree):  # tensors and format leaves alike
        return {k: to_cpu(v) if isinstance(v, dict) else v.to(cpu) for k, v in tree.items()}

    cap = r["capacity"]
    replay = []
    for router_logits, (dispatch, combine, aux) in calls:
        replay.append((dispatch.cpu(), combine.cpu(), aux.cpu()))
        want = route(router_logits.cpu(), cfg.top_k_experts, cap)[0]
        if not torch.equal(want, replay[-1][0]):
            raise AssertionError(f"{label}: a verify layer's dispatch on the card differs from "
                                 f"route_topk on its router logits at capacity {cap}")
    params, tree = to_cpu(eng.compute), to_cpu(eng.serving_tree_for(r["runner"].key))
    pool = {k: v.cpu() for k, v in r["pool"].items()}
    it, kept = iter(replay), MOE.route_topk
    MOE.route_topk = lambda *a, **kw: next(it)
    try:
        got, _ = M.paged_verify_step(cfg, params, tree, {"tokens": torch.from_numpy(feed)},
                                     pool, torch.from_numpy(r["table"]),
                                     torch.from_numpy(r["lengths"]))
    finally:
        MOE.route_topk = kept
    if next(it, None) is not None:
        raise AssertionError(f"{label}: the CPU verify made fewer router calls than the card's")
    v = cfg.vocab_size
    diff = (logits[live, :, :v].float().cpu() - got[live, :, :v].float()).abs().max().item()
    bound = LOGIT_NOISE_BOUND[cfg.dtype]
    if not diff <= bound:
        raise AssertionError(f"{label}: the first round's verify logits on the card part from "
                             f"the CPU plain-version verify by {diff:.3g} (bound {bound:.3g})")
    del params, tree, pool
    return {"max_abs": diff, "bound": bound, "rows": len(live), "positions": logits.shape[1],
            "layers": len(calls)}


def _round_at(rounds: list, row: int, t: int, j: int):
    """The recorded round whose verify chose generated token ``j`` of the
    stream on bucket row ``row`` (prompt ``t``): the last round of that row
    whose first predicted position, L0 - t + 1, is at or before ``j``."""
    found = None
    for r in rounds:
        if any(row in rows for rows in r["rows"].values()) and \
                int(r["lengths"][row]) - t + 1 <= j:
            found = r
    return found


def spec_moe_phase(device, card: str, measured) -> dict:
    """[spec:moe]: self-draft speculative decoding on granite-moe-1b-a400m
    at its published width and depth, random weights and 90% SRigL ERK masks
    from [moe]'s seed, on the paged engine (condensed, bucket 8, gamma 3,
    one B = 4 x 32 + GEN request a wave, a warm wave then a timed one),
    each run (SPEC_MOE_RUNS) beside a plain engine of the same path, dtype
    and waves. The draft is sentinel condensed-over-active (wo on K4 and the
    experts on K4-moe, 24 and 72 launches a draft step); the verify routes
    the bucket's 32 rows as one group at capacity 10 (K1 at 32 rows, K1-moe
    at up to 10 an expert), where a decode step's 8-row groups hold 8 and
    never drop. Gates: the draft and verify are captured graphs, replayed in
    the timed wave with no new signature and no cold result; the timed wave
    launches each kernel as the plan and the draft kinds imply; all pages
    back after each wave; the draft holds no value bytes of its own; every
    round's verify (and the first round's drafts) equals its eager rerun on
    the card bitwise, and every verify routes its rows as one group at the
    reference's capacity (``_spec_rounds_eager``); in f32, the first round's
    verify logits lie within LOGIT_NOISE_BOUND of the CPU plain-version
    verify's on the same inputs (``_spec_verify_on_cpu``); a stream parts
    from the plain engine's only at a tie (the verify's top-2 gap at the
    parting token below max(TIE_GAP, 2 LOGIT_NOISE_BOUND), the largest
    difference [moe] lets two paths' logits show) or at or after the first
    token that a verify drop of its own row's assignments moved (a drop at
    verify position q moves the logits of q and after); in f32 at draft
    ablation 0.0 every rejected draft (position m) is at a tie (TIE_GAP) or
    its row's verify dropped an assignment at positions 0-m. Returns the
    bf16 run's timed-wave launches."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import engine as E
    from repro_torch.launch import speculative as SP
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.sparse import plan as PLAN
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(MOE_ARCH)
    reg = REG.build_registry(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    gamma, rows = SPEC_GAMMA, SPEC_BUCKET * (SPEC_GAMMA + 1)
    print(f"[spec:moe] {MOE_ARCH}: {cfg.n_layers} layers, {cfg.n_experts} experts top-"
          f"{cfg.top_k_experts}; gamma {gamma} at bucket {SPEC_BUCKET}: a draft step routes "
          f"{SPEC_BUCKET} rows at capacity {MOE.capacity_for(cfg, SPEC_BUCKET)}, the verify "
          f"{rows} rows as one group (group size {cfg.moe_group_size}) at capacity "
          f"{MOE.capacity_for(cfg, min(cfg.moe_group_size, rows))}; request "
          f"{BATCH}x{PROMPT}+{GEN} a wave")
    launches = {}
    for label, dtype_name, ablation in SPEC_MOE_RUNS:
        t_run = time.perf_counter()
        run_cfg = cfg.replace(dtype=dtype_name)
        plain = E.ServingEngine(run_cfg, params, masks, reg, path="condensed",
                                block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK)
        _part("setup")
        _zoo_request(plain, prompts)
        plain_res, plain_wall = _zoo_request(plain, prompts)
        key = plain_res.plan_key
        plain_step_ms = _replay_ms(plain._runners[key].decoder)
        _part("plain")
        eng = E.ServingEngine(run_cfg, params, masks, reg, path="condensed",
                              block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK,
                              speculative=SP.SpecConfig(gamma=gamma, draft_ablation=ablation,
                                                        force=True))
        _part("setup")
        _zoo_request(eng, prompts)
        _part("capture")
        runner = eng._runners[key]

        def pages_back(wave: str) -> None:
            for e in (plain, eng):
                for rn in e._runners.values():
                    if rn.active or rn.alloc.available != rn.num_blocks - 1:
                        raise AssertionError(f"{label}: pages still held after the {wave} wave")

        pages_back("warm")
        programs = {k: eng.program_count(k) for k in ("prefill", "draft", "verify")}
        if not programs["draft"] or eng.program_count("decode") or \
                runner.draft.graph is None or runner.verify.graph is None:
            raise AssertionError(f"{label}: graphs {programs}, decode "
                                 f"{eng.program_count('decode')}: the draft or verify is not a "
                                 f"captured graph")
        before = (runner.prefills, runner.rounds, runner.draft_s, runner.verify_s)
        rounds, prefill_gaps = [], []
        _zero_counts()
        with _recorded_rounds(rounds, prefill_gaps):
            res, wall = _zoo_request(eng, prompts)
        counts = _counts()
        pages_back("timed")
        after = {k: eng.program_count(k) for k in ("prefill", "draft", "verify")}
        if after != programs or res.cold:
            raise AssertionError(f"{label}: the timed wave ran new signatures {programs} -> "
                                 f"{after}, cold {res.cold}")
        n_rounds = runner.rounds - before[1]
        expected = _spec_expected(eng, {key: (runner.prefills - before[0], n_rounds)})
        if counts != expected or len(rounds) != n_rounds:
            raise AssertionError(f"{label}: the timed wave launched {counts} in {len(rounds)} "
                                 f"rounds, the plan and draft kinds imply {expected}")
        target, draft = eng.serving_tree_for(key), eng.draft_tree_for(key)
        shared, extra = PLAN.draft_weight_overhead_bytes(reg, target, draft)
        if extra:
            raise AssertionError(f"{label}: the draft holds {extra} value bytes of its own")
        kinds = sorted(set(eng._draft_reports[key].values()))
        in_prefill = _spec_expected(eng, {key: (1, 0)})
        per_round = {k: (v - in_prefill[k]) / n_rounds for k, v in counts.items()
                     if v - in_prefill[k]}
        _part("serve")
        on_cpu = _spec_rounds_eager(label, run_cfg, eng, rounds, dtype_name == "float32")
        _part("eager")

        # the timed request against the plain engine's (both on rows 4-7)
        t = PROMPT
        [req_rows] = {tuple(rs) for r in rounds for rs in r["rows"].values()}
        tie = max(TIE_GAP[dtype_name], 2 * LOGIT_NOISE_BOUND[dtype_name])
        dropped = [r for r in rounds if any(any(d) for d in r["drops"].values())]
        # a verify drop at position q of a row first moves the logits that
        # choose its generated token L0 - t + 1 + q: each stream's first
        first_drop = [min((int(r["lengths"][row]) - t + 1 + q for r in rounds
                           if row in r["drops"] for q, d in enumerate(r["drops"][row]) if d),
                          default=None) for row in req_rows]
        div = _first_divergence(res.tokens[:, t:], plain_res.tokens[:, t:])
        at_tie = after_drop = 0
        for i, j in enumerate(div):
            if j is None:
                continue
            r = _round_at(rounds, req_rows[i], t, j)
            gap = (r["gaps"][req_rows[i], j - (int(r["lengths"][req_rows[i]]) - t) - 1]
                   if r is not None else prefill_gaps[-1][req_rows[i]])
            if gap < tie:
                at_tie += 1
            elif first_drop[i] is not None and first_drop[i] <= j:
                after_drop += 1
            else:
                raise AssertionError(f"{label}: stream {i} parts from the plain engine at "
                                     f"generated token {j}, the verify's top-2 gap {gap:.4g} "
                                     f"(tie below {tie:.4g}), no drop of its own row's "
                                     f"assignments at or before it (first at {first_drop[i]})")
            print(f"[{label}] stream {i}: parts from the plain engine at generated token {j}, "
                  f"the verify's top-2 gap {gap:.3g} (tie below {tie:.3g}); its row's first "
                  f"verify drop moves generated token {first_drop[i]}")
        # the rejected drafts, round by round: row's accepted prefix m < gamma
        rejected, rejects_tie = 0, TIE_GAP[dtype_name]
        for r in rounds:
            for i, row in enumerate(req_rows):
                m = 0
                while m < gamma and r["feed"][row, m + 1] == r["targ"][row, m]:
                    m += 1
                held = int(np.count_nonzero(r["table"][row]))
                room = held * ENGINE_BLOCK - int(r["lengths"][row])
                pick = int(r["lengths"][row]) - t + m + 1
                if not (m < gamma and m < room and pick < GEN):
                    continue
                rejected += 1
                gap = r["gaps"][row, m]
                if ablation == 0.0 and not (gap < rejects_tie or any(r["drops"][row][:m + 1])):
                    raise AssertionError(f"{label}: at draft ablation 0 stream {i}'s draft was "
                                         f"rejected at generated token {pick}, a top-2 gap of "
                                         f"{gap:.4g}, and the verify dropped none of its row's "
                                         f"assignments at positions 0-{m}")
        if rejected != len(res.spec["rejected"]):
            raise AssertionError(f"{label}: {rejected} rejections in the rounds, the engine "
                                 f"counted {len(res.spec['rejected'])}")
        _part("checks")
        draft_ms = (runner.draft_s - before[2]) / n_rounds * 1e3
        verify_ms = (runner.verify_s - before[3]) / n_rounds * 1e3
        draft_step_ms, verify_step_ms = _replay_ms(runner.draft), _replay_ms(runner.verify)
        _part("timing")
        s = res.spec
        est = {name: PLAN.price_speculation(reg, target, draft, batch_size=SPEC_BUCKET,
                                            gamma=gamma, acceptance=a, profile=p)
               for name, p, a in (("default", PLAN.DEFAULT_PROFILE, 0.7),
                                  ("measured at the measured acceptance", measured,
                                   s["acceptance_rate"]))}
        est_s = "; ".join(
            f"{n}: draft/target {e.draft_step_s / e.target_step_s:.3f}, verify/target "
            f"{e.verify_s / e.target_step_s:.3f}, {e.spec_s_per_token * 1e6:.2f} vs "
            f"{e.base_s_per_token * 1e6:.2f} us/token at acceptance {e.acceptance:.3f} -> auto "
            f"would {'run' if e.worthwhile else 'decline'}" for n, e in est.items())
        tokens = BATCH * GEN
        drops = sum(sum(map(sum, r["drops"].values())) for r in rounds)
        excused = sum(bool(any(r["drops"][row][:m + 1])) for r in rounds for row in req_rows
                      for m in range(gamma + 1))
        cpu_s = ("; round 1's verify == the CPU plain-version verify on the same inputs "
                 f"(the card's routing replayed, each layer's dispatch == route_topk at "
                 f"capacity {rounds[0]['capacity']}): max |logit diff| {on_cpu['max_abs']:.3g} "
                 f"(bound {on_cpu['bound']:.3g}) on {on_cpu['rows']} rows x "
                 f"{on_cpu['positions']} positions" if on_cpu else "")
        equal = sum(j is None for j in div)
        print(f"[{label}] {card}: {dtype_name}, gamma {gamma}, draft ablation {ablation} "
              f"({'/'.join(kinds)} drafts); timed wave {wall * 1e3:.2f} ms = "
              f"{tokens / wall:.1f} tok/s vs the plain engine's {plain_wall * 1e3:.2f} ms = "
              f"{tokens / plain_wall:.1f} tok/s ({plain_wall / wall:.3f}x); acceptance "
              f"{s['acceptance_rate']:.4f} ({s['matched']}/{s['drafted']}), {s['rounds']} "
              f"rounds, full-network dispatches/token {s['full_dispatches_per_token']:.4f}; "
              f"verify rounds that dropped a live row's assignment {len(dropped)}/{n_rounds} "
              f"({len(dropped) / n_rounds:.1%}; {drops} assignments in all; live (row, "
              f"position) pairs whose row dropped at or before it "
              f"{excused}/{len(rounds) * len(req_rows) * (gamma + 1)}){cpu_s}; bucket "
              f"{SPEC_BUCKET} per round: draft {draft_ms:.3f} ms + verify {verify_ms:.3f} ms "
              f"device (events); one replay: draft step {draft_step_ms:.3f} ms, verify "
              f"{verify_step_ms:.3f} ms, plain decode step {plain_step_ms:.3f} ms; graphs: draft "
              f"{programs['draft']}, verify {programs['verify']}, none new in the timed wave, "
              f"no cold result; launches {counts} as the plan implies, per round "
              f"{ {k: round(v, 2) for k, v in per_round.items()} }; pages all back after each "
              f"wave; draft weight bytes shared {shared}, extra {extra}; every round's verify "
              f"(and round 1's drafts) == its eager rerun bitwise; streams equal to the plain "
              f"engine's {equal}/{BATCH} "
              f"(parted at a tie {at_tie}, after a verify drop {after_drop}); rejected drafts "
              f"{rejected}")
        print(f"[{label}] SpecEstimate at bucket {SPEC_BUCKET}: {est_s}")
        print(f"[time] {label}: {time.perf_counter() - t_run:.1f}s")
        if dtype_name == "bfloat16":
            launches = counts
        del eng, plain, runner, rounds, target, draft
        _release()
    del params, masks
    _release()
    return launches


# ---------------------------------------------------------------------------
# the SSM family ([kernel:ssm], [ssm:*])
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-130m"
# prompts of 200 tokens: four 64-token SSD chunks, the last one padded
SSM_PROMPT = 200
# (dtype, path, values dtype) served by [ssm:*]
SSM_PATHS = (("bfloat16", "masked", None, None), ("bfloat16", "condensed", None, None),
             ("bfloat16", "condensed", "int8", None), ("bfloat16", "auto", None, None),
             ("float32", "masked", None, None), ("float32", "condensed", None, None))
# a Mamba2 decode layer's sparse stacks
MAMBA2_LAYER = ("in_z", "in_x", "out_proj")


def _arch_shapes(arch: str) -> dict:
    """{(d_in, d_out, k): [stack names]}: ``arch``'s sparse stacks at the
    fan-ins their 90% ERK densities realize (stacks of one shape and fan-in
    share an entry: in_z and in_x; m_groups and m_rem)."""
    from repro_torch import configs
    from repro_torch.sparse import registry as REG
    cfg = configs.get_config(arch)
    reg = REG.build_registry(cfg)
    k_fan = REG.k_fan_map(cfg, reg)
    shapes: dict = {}
    for s in reg:
        names = shapes.setdefault((s.d_in, s.d_out, k_fan[s.path[-1]]), [])
        if s.path[-1] not in names:
            names.append(s.path[-1])
    return shapes


def _family_kernel_phase(device, tag: str, arch: str, prompt: int, layers: dict,
                         seed: int) -> list:
    """K1 and K2 (int8 codes) at each distinct stack shape of ``arch``, bf16,
    at the decode's B=4 and the prefill's B*T = 4 x ``prompt`` rows: held to
    the plain version within TOL, the decode launch bitwise the tiled
    launch's rows, timed beside the plain version, torch.matmul on the
    dense masked weight and the bound; whether the decode kernel exists at
    the shape's d_in (past 6656, B <= 8 runs gather_mma at the batch's
    tile). Then one decode and one prefill layer of each kind in ``layers``
    ({kind: its stacks}). Prints [kernel:<tag>] lines; returns the records."""
    import torch
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.sparse import formats as F

    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16
    cases = []
    for (d_in, n_out, k), names in _arch_shapes(arch).items():
        decode = cm.gather_geometry(d_in, bf16).decode_loads is not None
        mask = topology.random_constant_fan_in_mask(gen, d_in, n_out, k)
        w = torch.randn((d_in, n_out), generator=gen, device=device) / k ** 0.5
        vals32, idx = topology.dense_to_condensed(w * mask, mask, k)
        del mask, w
        dense = topology.condensed_to_dense(vals32, idx, d_in).to(bf16).contiguous()
        dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * 2))]
        del dense
        for kern in ("K1", "K2"):
            if kern == "K1":
                vals, scales = vals32.to(bf16).contiguous(), None
            else:
                vals, scales = F.quantize_values(vals32, "int8")
                vals, scales = vals.contiguous(), scales.contiguous()
            wbytes = n_out * k * (vals.element_size() + 4) + (0 if scales is None else 4 * n_out)
            weight_sets = [(vals.clone(), idx.clone(), None if scales is None else scales.clone())
                           for _ in range(_copies(wbytes))]
            for b, launch in ((BATCH, "decode"), (BATCH * prompt, "tiled")):
                x = torch.randn((b, d_in), generator=gen, device=device).to(bf16)
                y = cm.condensed_matmul(x, vals, idx, scales=scales)
                y_ref, plain_ms = _timed_call(_plain_gather, x, vals, idx, scales)
                torch.testing.assert_close(y.float(), y_ref.float(), **TOL["bfloat16"])
                err = (y.float() - y_ref.float()).abs().max().item()
                del y_ref
                tiled = cm.TILED_ROWS[bf16]
                if launch == "decode":
                    same = torch.equal(cm.condensed_matmul_decode(x, vals, idx, scales=scales),
                                       cm.condensed_matmul(x, vals, idx, scales=scales,
                                                           block_b=tiled))
                    pair = f"decode == tiled({tiled})"
                else:
                    same = torch.equal(cm.condensed_matmul_decode(x[:BATCH], vals, idx,
                                                                  scales=scales), y[:BATCH])
                    pair = f"decode(first {BATCH} rows) == tiled({tiled})"
                if not same:
                    raise AssertionError(f"[kernel:{tag}] {kern} {d_in}->{n_out} B={b}: "
                                         f"{pair} is not bitwise")

                def call(x_, v_, i_, s_):
                    return cm.condensed_matmul(x_, v_, i_, scales=s_)
                ms = _time_ms(call, [(x, v, i, s_) for v, i, s_ in weight_sets])
                library_ms = _time_ms(torch.matmul, [(x, wd) for wd in dense_sets])
                nbytes = wbytes + b * d_in * 2 + b * n_out * 2
                ops = 2 * b * n_out * k
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
                rec = dict(kernel=kern, arch=arch, stack="/".join(names), d_in=d_in,
                           n_out=n_out, k=k, dtype="bfloat16", batch=b, launch=launch, ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, max_abs_err=err, bitwise=pair,
                           layers=len(names), names=list(names), decode_kernel=decode)
                cases.append(rec)
                print(f"[kernel:{tag}] {kern} {'/'.join(names):12s} {d_in}->{n_out} k={k} "
                      f"bf16 B={b:4d} {launch:6s}: us {ms * 1e3:.2f} | plain "
                      f"{plain_ms * 1e3:.2f} | torch.matmul {library_ms * 1e3:.2f} | bound "
                      f"{rec['bound_ms'] * 1e3:.2f} ({rec['bound_by']}) | max_abs_err "
                      f"{err:.3g} | {pair}: bitwise | decode kernel "
                      f"{'yes' if decode else 'no (gather_mma at the batch tile)'}")
            del weight_sets
        del vals32, idx, dense_sets
        torch.cuda.empty_cache()
    for kern in ("K1", "K2"):
        for launch in ("decode", "tiled"):
            for kind, stacks in layers.items():
                # each case once for every stack of the layer that has its shape
                layer = [(c, len(set(c["names"]) & set(stacks))) for c in cases
                         if c["kernel"] == kern and c["launch"] == launch]
                tot = {t: sum(c[t] * n for c, n in layer)
                       for t in ("ms", "plain_ms", "library_ms", "bound_ms")}
                print(f"[kernel:{tag}] {arch} one {launch} {kind} layer ({' + '.join(stacks)}, "
                      f"bf16{', int8 codes' if kern == 'K2' else ''}, B={layer[0][0]['batch']}): "
                      f"{kern} {tot['ms'] * 1e3:.2f} us | bound {tot['bound_ms'] * 1e3:.2f} us "
                      f"| plain {tot['plain_ms'] * 1e3:.2f} us | torch.matmul "
                      f"{tot['library_ms'] * 1e3:.2f} us")
    return cases


def ssm_kernel_phase(device) -> list:
    """[kernel:ssm]: ``_family_kernel_phase`` at mamba2-130m's three stack
    shapes (in_z and in_x 768 -> 1536 k 77, out_proj 1536 -> 768 k 154),
    the prefill's 4 x 200 rows."""
    return _family_kernel_phase(device, "ssm", SSM_ARCH, SSM_PROMPT,
                                {"Mamba2": MAMBA2_LAYER}, seed=5)


def _family_model(device, arch: str, depth: int | None, dtype_name: str,
                  prompt: int) -> tuple:
    """``arch`` at its published width (``depth`` layers, or its own):
    seeded random weights and 90% SRigL ERK masks drawn on the card, then
    B=4 prompts of ``prompt`` tokens from the same generator, the params
    cast to ``dtype_name`` for serving (the float32 draw freed). Returns
    (cfg, reg, k_fan, compute params, masks, prompts)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG
    cfg = configs.get_config(arch)
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    cfg = cfg.replace(dtype=dtype_name)
    reg = REG.build_registry(cfg)
    k_fan = REG.k_fan_map(cfg, reg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, k_fan)
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, prompt), generator=gen, device=device,
                            dtype=torch.int32)
    compute = M.serving_params(cfg, params)
    del params
    _release()
    return cfg, reg, k_fan, compute, masks, prompts


def _shared_caches_written(label: str, eng, key, positions: int) -> int:
    """Every application of the hybrid's shared block wrote its own KV slab
    at each of the request's ``positions``: the slab engine's cache after
    a request. Returns the slab count."""
    decs = eng._legacy_decoders[key]
    if len(decs) != 1:
        raise AssertionError(f"{label}: {len(decs)} decode signatures, expected 1")
    cache = next(iter(decs.values())).state.cache
    n = int(cache["len"])
    k = cache["shared_attn"]["k"]
    written = k[:, :, :n].abs().amax(dim=(-1, -2)) > 0          # (g, B, n)
    if n != positions or not bool(written.all()) or bool(k[:, :, n:].any()):
        raise AssertionError(f"{label}: the shared block's KV slabs are not each written at "
                             f"the request's {positions} positions (len {n})")
    return k.shape[0]


def _family_phase(device, card: str, tag: str, arch: str, prompt: int, paths: tuple,
                  bound: dict) -> dict:
    """``arch`` (the SSM or hybrid family) at its published width, random
    weights and 90% SRigL masks (``_family_model``, one per (dtype, depth)
    of ``paths``: (dtype, path, values dtype, depth or None)), served by the
    slab ServingEngine (paged=None: SSM state has no paged form) with graph
    decode, B=4, prompts of ``prompt`` tokens + GEN new ones. Gates: the counted request
    launches what its plan implies (condensed: each stack's K1 once per
    application a pass, 1 + GEN passes; int8: K2 as often), the counted
    request repeats the warm one's tokens (each prefill zeroes the decode
    state the graph reads), the engine's tokens equal the eager decode
    loop's (masked, and an auto plan
    of masked on every stack: masked's step-by-step run's, bitwise),
    the hybrid's shared KV slabs are each written, and each path is held to
    masked's tokens of its dtype and depth under the tie rule, its prefill
    logits within ``bound`` (int8 codes to their dequantized twin's). Prints
    the counted request's graph wall with its prefill and decode parts, the
    eager loop's wall, the launches and max_memory_allocated; each path's
    engine is freed before the next.
    Returns the bf16 condensed request's K1 launches and the int8 one's K2
    launches."""
    import torch
    from types import SimpleNamespace
    from repro_torch import configs
    from repro_torch.launch import engine as E
    from repro_torch.models import model as M

    passes = 1 + GEN
    launches = {"K1": 0, "K2": 0}
    refs: dict = {}
    model_of: tuple | None = None
    for dtype_name, path, vd, depth in paths:
        if model_of is None or model_of[0] != (dtype_name, depth):
            model_of = compute = masks = None
            refs.clear()
            _release()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            cfg, reg, k_fan, compute, masks, prompts = _family_model(device, arch, depth,
                                                                     dtype_name, prompt)
            torch.cuda.synchronize()
            _part("init")
            model_of = ((dtype_name, depth), cfg, reg, compute, masks, prompts)
            full = ("published depth" if depth is None else
                    f"of the published {configs.get_config(arch).n_layers}; depth cut")
            shared = ""
            if cfg.family == "hybrid":
                g, r, rem = M.hybrid_counts(cfg)
                full += "" if depth is None else f": {g} groups + {rem} m_rem"
                shared = (f"; shared block ({cfg.n_heads} heads of {cfg.head_dim}, d_ff "
                          f"{cfg.d_ff}) after every {r} layers, {g} applications")
            print(f"[{tag}] {arch}: {cfg.n_layers} Mamba2 layers ({full}), d_model "
                  f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_n_heads} SSD heads of "
                  f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv width "
                  f"{cfg.ssm_conv_width}, ssd_chunk {cfg.ssd_chunk}{shared}; vocab "
                  f"{cfg.vocab_size} (padded {cfg.vocab_padded}); stacks "
                  f"{[(s.name, s.lead) for s in reg]}, fan-ins {k_fan}; served {dtype_name}; "
                  f"prompts {BATCH}x{prompt} + {GEN} ({-(-prompt // cfg.ssd_chunk)} chunks, "
                  f"the last padded); init "
                  f"{time.perf_counter() - t0:.1f}s, "
                  f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
        _, cfg, reg, compute, masks, prompts = model_of
        label = (f"{tag}:{path}" + (f":{vd}" if vd else "")
                 + ("" if dtype_name == "bfloat16" else ":f32"))
        per_pass = sum(_applications(cfg, s) for s in reg)
        torch.cuda.reset_peak_memory_stats(device)
        eng = E.ServingEngine(cfg, compute, masks, reg, path=path, values_dtype=vd,
                              block_size=ENGINE_BLOCK, gen_chunk=ENGINE_CHUNK)
        if eng.paged:
            raise AssertionError(f"{label}: the {cfg.family} engine is paged")
        first, _ = _zoo_request(eng, prompts)
        _zero_counts()
        res, wall = _zoo_request(eng, prompts)
        counts = _counts()
        want = _engine_expected(eng, {res.plan_key: passes})
        if counts != want:
            raise AssertionError(f"{label}: launched {counts}, expected {want}")
        if path == "condensed":
            key = "K2" if vd else "K1"
            if counts[key] != per_pass * passes:
                raise AssertionError(f"{label}: {key} x {counts[key]}, expected {per_pass} "
                                     f"a pass x {passes}")
            if dtype_name == "bfloat16":
                launches[key] += counts[key]
        slabs = ""
        if cfg.family == "hybrid":
            g = M.hybrid_counts(cfg)[0]
            n = _shared_caches_written(label, eng, res.plan_key, prompt + GEN)
            slabs = f"; shared KV slabs written {n}/{g}"
        if not torch.equal(first.tokens, res.tokens):
            raise AssertionError(f"{label}: the warm request gave other tokens")
        tree = eng.serving_tree_for(res.plan_key)
        tokens = res.tokens
        eager_s, checked = "the step-by-step run below", "the counted request == the warm one"
        # an auto plan of masked on every stack runs masked's computation: it
        # is held bitwise to masked's step-by-step run, which is its eager loop
        as_masked = path == "auto" and {rp for _, rp in res.plan_key.formats} == {"masked"}
        if path != "masked" and not as_masked:  # masked's step-by-step run is its eager loop
            t1 = time.perf_counter()
            eager, _, t_dec, _ = E._serve_eager(cfg, compute, tree, prompts, GEN)
            torch.cuda.synchronize()
            eager_s = (f"wall {(time.perf_counter() - t1) * 1e3:.2f} ms (decode "
                       f"{t_dec * 1e3:.2f} ms)")
            _part("eager")
            if not torch.equal(eager, tokens):
                raise AssertionError(f"{label}: graph decode and the eager loop disagree")
            checked += "; the eager loop == the engine's tokens"
        peak = torch.cuda.max_memory_allocated(device)
        model = SimpleNamespace(compute=compute, serving=tree)
        if path == "masked":
            toks_m, gaps = _masked_gaps(cfg, model, prompts, GEN)
            if not torch.equal(toks_m, tokens[:, prompt:]):
                raise AssertionError(f"{label}: the step-by-step run differs from the engine's "
                                     f"tokens")
            refs["masked"] = (model, toks_m, gaps)
            held = (f"the step-by-step run == the engine's tokens; first stream "
                    f"{toks_m[0].tolist()}, "
                    f"{len(set(toks_m.reshape(-1).tolist()))} distinct tokens")
        elif as_masked:
            if not torch.equal(tokens[:, prompt:], refs["masked"][1]):
                raise AssertionError(f"{label}: masked on every stack, but other tokens than "
                                     f"masked's step-by-step run")
            held = "masked on every stack: tokens == masked's step-by-step run bitwise"
        else:
            ref_model, toks_r, gaps_r = refs["masked"]
            against = "masked"
            if vd:  # codes are held to their dequantized twin (K1), as in [quant]
                twin = _dequantized_twin(SimpleNamespace(registry=reg, serving_tree=tree),
                                         getattr(torch, dtype_name))
                ref_model = SimpleNamespace(compute=compute, serving=twin)
                toks_r, gaps_r = _masked_gaps(cfg, ref_model, prompts, GEN)
                against = "the twin"
            tie = _tie_threshold(label, cfg, model, ref_model, prompts, against, bound)
            agree = _check_ties(label, cfg, tokens, toks_r, gaps_r, tie,
                                against=against, prompt=prompt)
            held = (f"streams agreeing in full with {against} {agree}/{BATCH} (tie below "
                    f"{tie:.3g}, min top-2 gap {gaps_r.min().item():.3g})")
        reps = sorted({rp for _, rp in res.plan_key.formats})
        cut = "" if depth is None else f", {cfg.n_layers}-layer cut"
        print(f"[{label}] {card}: slab engine ({', '.join(reps)}){cut}, request "
              f"{BATCH}x{prompt}+{GEN}: graph wall {wall * 1e3:.2f} ms (the counted request; "
              f"prefill {res.prefill_s * 1e3:.2f} ms, decode {res.decode_s * 1e3:.2f} ms), eager "
              f"decode loop {eager_s}; launches "
              f"{ {n: c for n, c in counts.items() if c} } ({per_pass} sparse linears a pass x "
              f"{passes} passes where condensed){slabs}; {checked}; {held}; peak memory {peak / 2**30:.3f} GiB (max_memory_allocated)")
        del eng, tree, model, tokens
        _release()
    del model_of, refs
    _release()
    return launches


def ssm_phase(device, card: str) -> dict:
    """[ssm:*]: ``_family_phase`` on mamba2-130m at its published width and
    depth (24 layers, d_model 768, d_inner 1536, 24 SSD heads of 64, state
    128, vocab 50 280, tied), prompts of SSM_PROMPT tokens, on SSM_PATHS:
    condensed launches K1 3 x 24 x (1 + GEN) times, int8 K2 as often."""
    return _family_phase(device, card, "ssm", SSM_ARCH, SSM_PROMPT, SSM_PATHS,
                         LOGIT_NOISE_BOUND)


# ---------------------------------------------------------------------------
# refresh, sync and the launch search on stacks with two leading axes
# ([refresh:lead2], [sync:lead2], [autotune:moe])
# ---------------------------------------------------------------------------

# (arch, the two-axis stack rewired): gemma3's g_local (g, r) = (4, 5) on the
# slab engine, granite's expert stack (L, E) = (24, 32) on the paged one
LEAD2 = (("gemma3-1b", ("g_local/w_down",)), (MOE_ARCH, ("blocks/w_gate",)))
# [autotune:moe]: the requests' batches (buckets 8 and 32). B=12 leaves 20
# padding rows in bucket 32, whose decode groups of 32 tokens have a
# capacity of 10 an expert: the padding rows, reading the garbage page they
# all write, route into the real rows' capacity, so their tokens repeat
# only if page 0's contents are fixed (``attention.last_writer``)
MOE_TUNE_BATCHES = (BATCH, 12)


def _lead2_generations(device, cfg, names: tuple) -> tuple:
    """``cfg`` at its width, seeded random weights and 90% SRigL masks
    (gen-1), and gen-2: the masks of the stacks ``names`` rolled by one
    input row over all their leading axes (a rewire at an unchanged
    fan-in), every float param times 1.01, those stacks' versions bumped.
    Returns (reg, gen-1, gen-2), each (params, masks, versions)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG
    reg = REG.build_registry(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    masks2 = _map_leaves(masks, lambda m: m)
    for s in reg:
        if s.name in names:
            REG.set_path(masks2, s.path, torch.roll(REG.get_path(masks, s.path), 1, dims=-2))
    params2 = _map_leaves(params, lambda t: t * 1.01)
    versions = {x.name: 0 for x in reg}
    return reg, (params, masks, versions), (params2, masks2,
                                            dict(versions, **{n: 1 for n in names}))


def _decoder_ids(eng) -> dict:
    """The slab engine's captured decode steps, by plan key and signature."""
    return {(key, sig): id(dec) for key, decs in eng._legacy_decoders.items()
            for sig, dec in decs.items()}


def _lead2_first(eng, prompts):
    """Request A: one chunk on the paged engine (the rest is served after
    the refresh or the drain), the whole request on the slab engine, which
    serves a request in one dispatch. Returns (request id, its Result or
    None while it runs)."""
    rid = eng.submit(prompts, GEN)
    eng.step(max_chunks=1)
    return (rid, None) if eng.paged else (rid, eng.retire(rid)[0])


def _lead2_finish(eng, rid, res_a, prompts2):
    """Request A's rest (paged), then request B to the end: both Results."""
    if res_a is None:
        eng.step()
        [res_a] = eng.retire(rid)
    rid_b = eng.submit(prompts2, GEN)
    eng.step()
    [res_b] = eng.retire(rid_b)
    return res_a, res_b


def _lead2_kernels(cfg, counts: dict) -> None:
    want = {"K1", "K1-moe"} if cfg.family == "moe" else {"K1"}
    if {k for k, n in counts.items() if n} != want:
        raise AssertionError(f"{cfg.name}: launched {counts}, expected {sorted(want)}")


def lead2_refresh_sync(device, card: str, arch: str, names: tuple, *,
                       depth: int | None = None, tag: str = "lead2") -> None:
    """[refresh:<tag>] and [sync:<tag>] on one config (LEAD2, or the
    hybrid's at a ``depth`` cut), the stacks ``names`` rewired, condensed,
    bf16. Refresh: request A (B=4, prompt 32, 16 new tokens; chunks of 8 on
    the paged engine, one dispatch on the slab one) starts on gen-1,
    refresh(gen-2) lands after its first chunk (paged) or after it
    (slab), then A's rest and request B. Gates: exactly the rewired stacks
    re-exported; every leaf kept its shapes and data_ptr; no decode graph
    recaptured (paged: captures; slab: the captured steps kept) and B not
    cold; B's tokens equal those of a fresh engine built from gen-2 (on the
    paged engine after a request on the same rows, which the bucket's rows
    rotate through). Sync: a Publisher sends gen-1 (a snapshot) and gen-2
    (a topology delta) over a QueueChannel to an engine_from_snapshot
    serving the same requests, drained at A's chunk boundary (paged) or at
    the top of B's step (slab): the same gates, and A's and B's tokens
    equal the refreshed engine's bitwise. Prints the refresh and drain
    seconds and the record bytes."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import engine as E
    from repro_torch.sync import Publisher, QueueChannel, Subscriber, engine_from_snapshot

    t0 = time.perf_counter()
    _part("setup")
    cfg = configs.get_config(arch)
    full = cfg.n_layers
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    reg, g1, g2 = _lead2_generations(device, cfg, names)
    cfg = cfg.replace(dtype="bfloat16")
    names = sorted(names)
    gen = torch.Generator(device=device).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                            dtype=torch.int32)
    prompts2 = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                             dtype=torch.int32)
    leads = {s.name: s.lead for s in reg if s.name in names}
    torch.cuda.synchronize()
    depth_s = ("" if depth is None else f" of the published {full} (depth cut)")
    print(f"[refresh:{tag}] {arch}: {cfg.n_layers} layers{depth_s} at the published width, "
          f"stacks {[(s.name, s.lead) for s in reg]}; gen-2 rewires {names} (leads {leads}) "
          f"and scales every param by 1.01; init {time.perf_counter() - t0:.1f}s")

    def engine(g):
        return E.ServingEngine(cfg, g[0], g[1], reg, path="condensed", block_size=ENGINE_BLOCK,
                               gen_chunk=REFRESH_CHUNK, mask_versions=g[2])

    def gates(label, eng, before, captures, decoders, res_b):
        after = _leaf_storage(eng)
        if after != before:
            moved = [k for k in after if after[k] != before.get(k)]
            raise AssertionError(f"[{label}] leaves moved or were rebuilt: {moved}")
        if eng.captures != captures or _decoder_ids(eng) != decoders or res_b.cold:
            raise AssertionError(f"[{label}] a decode graph was recaptured (captures "
                                 f"{captures} -> {eng.captures}, cold {res_b.cold})")
        return len(after)

    # refresh
    _part("init")
    eng = engine(g1)
    _zero_counts()
    rid, res_a = _lead2_first(eng, prompts)
    _part("serve")
    before, captures = _leaf_storage(eng), eng.captures
    decoders = _decoder_ids(eng)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    changed = eng.refresh(g2[0], g2[1], g2[2])
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t1
    if [sorted(v) for v in changed.values()] != [names]:
        raise AssertionError(f"[refresh:{tag}:{arch}] re-exported {changed}")
    _part("refresh")
    res_a, res_b = _lead2_finish(eng, rid, res_a, prompts2)
    _part("serve")
    _lead2_kernels(cfg, _counts())
    n_leaves = gates(f"refresh:{tag}:{arch}", eng, before, captures, decoders, res_b)
    paged = eng.paged
    refreshed = (res_a.tokens, res_b.tokens)
    del eng
    _release()
    _part("setup")
    fresh = engine(g2)
    if paged:  # B took the bucket's rows 4-7: the fresh engine's request on them
        rid = fresh.submit(prompts, GEN)
        fresh.step()
        fresh.retire(rid)
    rid = fresh.submit(prompts2, GEN)
    fresh.step()
    [res_f] = fresh.retire(rid)
    _part("fresh")
    if not torch.equal(res_f.tokens, refreshed[1]):
        raise AssertionError(f"[refresh:{tag}:{arch}] a fresh gen-2 engine serves other tokens "
                             f"than the refreshed one")
    del fresh
    _release()
    where = "after request A's first chunk" if paged else "between requests A and B"
    print(f"[refresh:{tag}:{arch}] {card}: {'paged' if paged else 'slab'} engine, condensed "
          f"bf16: refresh {refresh_s:.3f}s (host clock, synchronised) {where}; re-exported "
          f"{names} only; leaves copied in place {n_leaves}/{n_leaves}; graphs recaptured 0; "
          f"B == a fresh gen-2 engine's tokens bitwise")

    # sync
    _part("setup")
    ch = QueueChannel()
    pub = Publisher(cfg, reg, ch, path="condensed", batch_size=BATCH, arch=arch)
    snap = pub.publish(params=g1[0], masks=g1[1], mask_versions=g1[2])
    _part("publish")
    sub = Subscriber(ch.subscribe("replica"), name="replica")
    eng = engine_from_snapshot(cfg, sub, registry=reg, device=device, block_size=ENGINE_BLOCK,
                               gen_chunk=REFRESH_CHUNK)
    _part("sync_setup")
    _zero_counts()
    rid, res_a = _lead2_first(eng, prompts)
    _part("serve")
    before, captures = _leaf_storage(eng), eng.captures
    decoders = _decoder_ids(eng)
    topo = pub.publish(params=g2[0], masks=g2[1], mask_versions=g2[2])
    _part("publish")
    if sorted(topo["topology"]) != names:
        raise AssertionError(f"[sync:{tag}:{arch}] topology delta for {topo['topology']}")
    res_a, res_b = _lead2_finish(eng, rid, res_a, prompts2)
    _part("drain+serve")
    _lead2_kernels(cfg, _counts())
    if eng._sync_generation != 2:
        raise AssertionError(f"[sync:{tag}:{arch}] drained to gen {eng._sync_generation}")
    gates(f"sync:{tag}:{arch}", eng, before, captures, decoders, res_b)
    if not (torch.equal(res_a.tokens, refreshed[0]) and torch.equal(res_b.tokens, refreshed[1])):
        raise AssertionError(f"[sync:{tag}:{arch}] drained tokens differ from "
                             f"[refresh:{tag}]'s")
    where = "at request A's chunk boundary" if paged else "at the top of B's step"
    print(f"[sync:{tag}:{arch}] {card}: snapshot {snap['bytes']} B (encode "
          f"{snap['encode_s']:.3f}s), topology delta {topo['bytes']} B ({topo['topology']}; "
          f"encode {topo['encode_s']:.3f}s); drain {eng.last_drain_s:.3f}s {where}; leaves "
          f"written in place {n_leaves}/{n_leaves}; no graph recaptured; A and B == "
          f"[refresh:{tag}]'s tokens bitwise")
    del eng, pub, sub, ch, g1, g2
    _release()


@contextlib.contextmanager
def _recorded_resolutions():
    """Record every launch resolution the kernel wrappers make while the
    block runs (``ops._resolve_blocks``; graph captures included, a replay
    makes none): a list of (rows, d_in, n_out, k, block_b, block_n). An
    expert-grouped launch resolves at one expert's rows (x's middle dims)."""
    from repro_torch.kernels import ops
    real, seen = ops._resolve_blocks, []

    def spy(x, n_out, k, block_b, block_n, **kw):
        out = real(x, n_out, k, block_b, block_n, **kw)
        seen.append((x.shape[0], x.shape[-1], n_out, k, *out))
        return out
    ops._resolve_blocks = spy
    try:
        yield seen
    finally:
        ops._resolve_blocks = real


def _moe_requests(eng, prompt_sets) -> list:
    """Each prompt set served to the end twice on a fresh engine: the
    tokens of every request, in order. A bucket's free rows rotate (a
    retired request's rows go to the back), so the second request of a set
    may sit on other rows, and in other places of its routing groups, than
    the first: two engines are compared request by request."""
    out = []
    for prompts in prompt_sets:
        for _ in range(2):
            rid = eng.submit(prompts, GEN)
            eng.step()
            [res] = eng.retire(rid)
            out.append(res.tokens)
    return out


def autotune_moe_phase(device, card: str) -> list:
    """The launch search on granite's expert stacks (E 32; w_gate / w_up
    1024 -> 512 k 103, w_down 512 -> 1024 k 52), bf16, at buckets 8 and 32,
    on K1-moe and on K2-moe (int8 codes): every candidate of one expert's
    key (``gather_candidates`` over E * n_out rows) launched as one grouped
    launch, each bitwise, row by row, the default grouped launch, and the
    default bitwise E single K1 (K2) launches. Then, with
    $REPRO_TORCH_AUTOTUNE_CACHE on a file of its own, per values dtype:
    an untuned condensed engine serves requests of B=4 (bucket 8) and B=12
    (bucket 32, 20 padding rows routing into the real rows' capacity) twice
    each, a second engine runs ServingEngine.autotune(4) and autotune(12)
    (each expert key timed on the grouped launch) and serves them the same
    way: every request's tokens equal the untuned engine's bitwise (every
    launch of a key is bitwise the default, so this is also the gate that
    two engines serving B=12 at bucket 32 agree); each key's winner, run
    on the seeded operands, is held to the plain version; every grouped
    decode launch captured reads its key's entry (rows an expert: the
    bucket's 8 at bucket 8, capacity 10 at bucket 32), and the lines list
    which of a request's grouped launches read an entry (the prefill's
    capacity rows, 80 and 320 an expert, bucket past the tuned ones, do
    not). Returns the per-key records."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.launch import engine as E
    from repro_torch.models import model as M
    from repro_torch.sparse import autotune as AT
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import plan as PLAN
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(MOE_ARCH).replace(dtype="bfloat16")
    e = cfg.n_experts
    reg = REG.build_registry(cfg)
    k_fan = REG.k_fan_map(cfg, reg)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = {}
    for s in reg:
        if REG.is_expert_stack(s, cfg):
            shapes.setdefault((s.d_in, s.d_out, k_fan[s.path[-1]]), s.path[-1])
    buckets = tuple(PLAN.batch_bucket(b) for b in MOE_TUNE_BATCHES)
    keys = {}
    for vd in (None, "int8"):
        kern = "K2-moe" if vd else "K1-moe"
        for bucket in buckets:
            for (d_in, n_out, k), stack in shapes.items():
                cands = cm.gather_candidates(bucket, d_in, e * n_out, bf16, sm_count=sms)
                ops_ = AT.grouped_operands(e, bucket, d_in, n_out, k, dtype=bf16,
                                           device=device, values_dtype=vd)
                outs = [AT.candidate_call("grouped", *c)(*ops_) for c in cands]
                singles = torch.stack([cm.condensed_matmul(
                    ops_[0][i], ops_[1][i], ops_[2][i],
                    scales=None if ops_[3] is None else ops_[3][i]) for i in range(e)])
                torch.cuda.synchronize()
                rows = e * bucket
                for c, out in zip(cands, outs):
                    same = _rows_bitwise(out, outs[0])
                    if same != rows:
                        raise AssertionError(f"[autotune:moe] {kern} {stack} bucket {bucket}: "
                                             f"launch {AT._label(*c)} equals the default in "
                                             f"{same}/{rows} rows")
                if _rows_bitwise(singles, outs[0]) != rows:
                    raise AssertionError(f"[autotune:moe] {kern} {stack} bucket {bucket}: the "
                                         f"default grouped launch differs from {e} single "
                                         f"launches")
                key = F.shape_tuning_key(d_in, n_out, k, bucket, backend=AT.device_key(device),
                                         itemsize=2, values_dtype=vd, compute_dtype=bf16)
                keys[key] = dict(kernel=kern, stack=stack, bucket=bucket, cands=cands,
                                 operands=ops_, outs=outs, d_in=d_in, n_out=n_out, k=k)
                print(f"[autotune:moe] {kern} {stack} {d_in}->{n_out} k={k} x {e} experts, "
                      f"bucket {bucket}: {len(cands)} candidates, each bitwise the default "
                      f"grouped launch in all {rows} rows; the default == {e} single launches "
                      f"bitwise")
    old = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    cache = REPO / "build" / "autotune_moe.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache)
    AT.reset_cache_state()
    records = []
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        params = M.serving_params(cfg, M.init_params(cfg, gen, k_fan))
        masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
        prompt_sets = [torch.randint(0, cfg.vocab_size, (b, PROMPT), generator=gen,
                                     device=device, dtype=torch.int32)
                       for b in MOE_TUNE_BATCHES]
        for vd in (None, "int8"):
            kern = "K2-moe" if vd else "K1-moe"

            def engine():
                return E.ServingEngine(cfg, params, masks, reg, path="condensed",
                                       values_dtype=vd, block_size=ENGINE_BLOCK,
                                       gen_chunk=ENGINE_CHUNK)
            untuned = engine()
            toks_u = _moe_requests(untuned, prompt_sets)
            del untuned
            gc.collect()
            eng = engine()
            t0 = time.perf_counter()
            tuned = {}
            for b in MOE_TUNE_BATCHES:
                tuned.update({(PLAN.batch_bucket(b), n): r
                              for n, r in eng.autotune(b).items()})
            took = time.perf_counter() - t0
            for (bucket, stack), res in tuned.items():
                rec = dict(kernel=kern if stack != "blocks/wo" else ("K2" if vd else "K1"),
                           stack=stack, bucket=bucket, key=res.key, default_us=res.default_us,
                           us=res.us, best=res.label, candidates=len(res.table))
                info = keys.get(res.key)
                if info is not None:
                    if list(res.table) != [AT._label(*c) for c in info["cands"]]:
                        raise AssertionError(f"[autotune:moe] {res.key}: timed "
                                             f"{list(res.table)}, listed {info['cands']}")
                    won = info["outs"][info["cands"].index((res.block_b, res.block_n))].float()
                    want = ref.condensed_matmul_grouped_ref(*info["operands"]).float()
                    torch.testing.assert_close(won, want, **TOL["bfloat16"])
                    rec["max_abs_err"] = (won - want).abs().max().item()
                records.append(rec)
                print(f"[autotune:moe] {card}: {rec['kernel']} {stack} bucket {bucket}: "
                      f"default {res.default_us:.2f} us, best {res.label} {res.us:.2f} us "
                      f"({res.speedup_vs_default:.3f}x), {len(res.table)} candidates timed"
                      + (f"; winner vs plain max_abs_err {rec['max_abs_err']:.3g}"
                         if "max_abs_err" in rec else "") + f"; key {res.key}")
            with _recorded_resolutions() as seen:
                toks_t = _moe_requests(eng, prompt_sets)
            for i, (tu, tt) in enumerate(zip(toks_u, toks_t)):
                if not torch.equal(tu, tt):
                    same = sum(torch.equal(a, b) for a, b in zip(tu, tt))
                    raise AssertionError(f"[autotune:moe] {kern} B={tu.shape[0]}, request "
                                         f"{i % 2 + 1}: tuned tokens differ from untuned in "
                                         f"{tu.shape[0] - same}/{tu.shape[0]} streams")
            reads = {}
            experts = {(d_in, n_out) for d_in, n_out, _ in shapes}
            for rows, d_in, n_out, k, bb, bn in seen:
                if (d_in, n_out) not in experts:
                    continue
                key = F.shape_tuning_key(d_in, n_out, k, rows, backend=AT.device_key(device),
                                         itemsize=2, values_dtype=vd, compute_dtype=bf16)
                entry = AT.lookup_entry(key)
                if entry is not None and (bb, bn) != (entry["block_b"], entry["block_n"]):
                    raise AssertionError(f"[autotune:moe] {kern} {rows} rows an expert, "
                                         f"{d_in}->{n_out}: launched {(bb, bn)}, the entry "
                                         f"is {entry}")
                if entry is None and (bb, bn) != (None, None):
                    raise AssertionError(f"[autotune:moe] {kern}: blocks {(bb, bn)} without "
                                         f"an entry at {key}")
                reads[(rows, d_in, n_out)] = (
                    f"entry b{PLAN.batch_bucket(rows)} {AT._label(bb, bn)}" if entry
                    else f"no entry (b{PLAN.batch_bucket(rows)}), default")
            decode_rows = {r for r, *_ in seen if r <= 16}
            if not all(v.startswith("entry") for (r, _, _), v in reads.items()
                       if r in decode_rows):
                raise AssertionError(f"[autotune:moe] {kern}: a decode launch read no entry: "
                                     f"{reads}")
            batches = ", ".join(map(str, MOE_TUNE_BATCHES))
            print(f"[autotune:moe] {card}: {kern} engine: autotune({batches}) "
                  f"{took:.2f}s; tuned tokens == untuned bitwise at B = "
                  f"{MOE_TUNE_BATCHES}; grouped launches of a request (rows an expert, "
                  f"d_in->n_out): "
                  + "; ".join(f"{r} rows {d}->{n}: {v}"
                              for (r, d, n), v in sorted(reads.items())))
            del eng
            _release()
        del params, masks
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = old
        AT.reset_cache_state()
    del keys
    _release()
    return records


def lead2_phase(device, card: str) -> list:
    """[refresh:lead2] and [sync:lead2] on gemma3-1b and granite-moe-1b
    (``lead2_refresh_sync``), then [autotune:moe]. Returns the latter's
    records."""
    for arch, names in LEAD2:
        t0 = time.perf_counter()
        lead2_refresh_sync(device, card, arch, names)
        print(f"[time] lead2:{arch}: {time.perf_counter() - t0:.1f}s")
    return autotune_moe_phase(device, card)


# ---------------------------------------------------------------------------
# the hybrid family ([kernel:hybrid], [hybrid:*], [refresh:hybrid],
# [sync:hybrid])
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-7b"
# prompts of 300 tokens: two 256-token SSD chunks, the second padded
HYBRID_PROMPT = 300
# the depth of the f32 pair and of [refresh:hybrid] / [sync:hybrid]: two
# groups of 6 Mamba2 layers, each followed by the shared block, then the 3
# m_rem layers, so every stack kind is present
HYBRID_CUT = 15
# (dtype, path, values dtype, depth) served by [hybrid:*]
HYBRID_PATHS = (("bfloat16", "masked", None, None), ("bfloat16", "condensed", None, None),
                ("bfloat16", "condensed", "int8", None), ("bfloat16", "auto", None, None),
                ("float32", "masked", None, HYBRID_CUT),
                ("float32", "condensed", None, HYBRID_CUT),
                ("float32", "condensed", "int8", HYBRID_CUT))
# the largest |prefill logit difference| two correct paths may show at the
# hybrid's depth (LOGIT_NOISE_BOUND's role): bf16 rounding, amplified
# through 81 Mamba2 layers and 13 shared-block applications (94 blocks, the
# 28 of qwen3-1.7b's LOGIT_NOISE_BOUND), reached 0.21 (condensed against
# masked) and 0.33 (int8 codes against their dequantized twin) on the card;
# a wrong kernel moves the logits by their own scale. f32 as everywhere.
HYBRID_NOISE_BOUND = {"bfloat16": 0.5, "float32": LOGIT_NOISE_BOUND["float32"]}
# [refresh:hybrid] / [sync:hybrid]: one stack of the shared block (no
# leading axis) and one Mamba2 group stack (lead (g, r)) rewired together
HYBRID_REWIRED = ("shared_attn/w_down", "m_groups/in_x")
# zamba2's decode layers: a Mamba2 layer's stacks and the shared block's
HYBRID_LAYERS = {"Mamba2": MAMBA2_LAYER, "shared-block": ("wo", "w_gate", "w_up", "w_down")}


def hybrid_kernel_phase(device) -> list:
    """[kernel:hybrid]: ``_family_kernel_phase`` at zamba2-7b's six stack
    shapes (in_z and in_x 3584 -> 7168 k 360, out_proj 7168 -> 3584 k 719,
    wo 3584 -> 3584 k 479, w_gate and w_up 3584 -> 14336 k 300, w_down
    14336 -> 3584 k 1199; out_proj and w_down past d_in 6656, where no
    decode kernel exists), the prefill's 4 x HYBRID_PROMPT rows, one
    Mamba2 and one shared-block decode layer."""
    return _family_kernel_phase(device, "hybrid", HYBRID_ARCH, HYBRID_PROMPT, HYBRID_LAYERS,
                                seed=6)


def hybrid_phase(device, card: str) -> dict:
    """[hybrid:*]: ``_family_phase`` on zamba2-7b at its published width
    and depth (81 Mamba2 layers, d_model 3584, d_inner 7168, 112 SSD heads
    of 64, state 64; one shared attention + MLP block, 32 heads of 112 and
    d_ff 14336, after every 6th layer, 13 times), prompts of HYBRID_PROMPT
    tokens, on HYBRID_PATHS (f32 at the HYBRID_CUT depth), held at
    HYBRID_NOISE_BOUND: condensed launches K1 (3 x 81 + 4 x 13) x (1 + GEN)
    times, int8 K2 as often, and each of the 13 shared KV slabs is written."""
    return _family_phase(device, card, "hybrid", HYBRID_ARCH, HYBRID_PROMPT, HYBRID_PATHS,
                         HYBRID_NOISE_BOUND)


def hybrid_refresh_sync_phase(device, card: str) -> None:
    """[refresh:hybrid] and [sync:hybrid]: ``lead2_refresh_sync`` on
    zamba2-7b at HYBRID_CUT layers of its published width, condensed, bf16,
    one stack of the shared block (no leading axis) and one Mamba2 group
    stack (lead (g, r)) rewired (HYBRID_REWIRED)."""
    lead2_refresh_sync(device, card, HYBRID_ARCH, HYBRID_REWIRED, depth=HYBRID_CUT,
                       tag="hybrid")


# ---------------------------------------------------------------------------
# the encoder-only ViT (vit-b16, the paper's own transformer) and the audio
# family (musicgen-medium's codebooks): [kernel:vit], [kernel:audio],
# [vit:*], [vit:train], [audio:*]
# ---------------------------------------------------------------------------

VIT_ARCH = "vit-b16"
AUDIO_ARCH = "musicgen-medium"
# a B=256 forward: 256 images of 196 patches + the CLS slot, every linear at
# 256 x 197 = 50,432 rows; the paper's GPU figure is one 90% sparse linear
# at batch 256 (1.7x over dense, 13.0x over CSR)
VIT_BATCH, VIT_TOKENS = 256, 197
VIT_ROWS = (VIT_BATCH, VIT_BATCH * VIT_TOKENS)
# the rows of a full launch held bitwise against a launch of their own,
# which is held to the plain version (whose gather of (rows, n, k) at the
# full rows would take ~24 GB for w_gate)
VIT_HELD_ROWS = 4096
# the f32 masked / condensed pair runs a smaller batch
VIT_F32_BATCH = 32
# [vit:train]: 32 images a step, 3 AdamW steps, the SRigL update after the
# second (delta_t 2; gamma_sal 0.95, the paper's ViT recipe)
VIT_TRAIN_BATCH = 32
VIT_LAYER = ("wo", "w_gate", "w_up", "w_down")
# [audio:*]: B=4 prompts of (4 codebooks, 32 tokens) + GEN greedy tokens a
# codebook, by prefill_step and GEN decode_steps (no serving loop takes
# (B, K, T) prompts, as in the reference)
AUDIO_PATHS = (("bfloat16", "masked", None), ("bfloat16", "condensed", None),
               ("bfloat16", "condensed", "int8"), ("bfloat16", "auto", None),
               ("float32", "masked", None), ("float32", "condensed", None))


def _vit_operands(gen, d_in: int, d_out: int, k: int, device) -> dict:
    """One ViT stack shape's operands, bf16: K1's values and indices, K2's
    int8 codes and scales, K4's export of the mask with half its neurons
    ablated, K5's panel of the ablation-only mask; and the weight each is
    timed against with torch.matmul (the dense masked weight; K5's panel,
    whose product ``index_copy_`` places). Returns them by kernel, and K4's
    surviving rows and K5's padded column count."""
    import torch
    from repro_torch.core import topology
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    bf16 = torch.bfloat16
    mask = topology.random_constant_fan_in_mask(gen, d_in, d_out, k)
    w = torch.randn((d_in, d_out), generator=gen, device=device) / k ** 0.5
    vals32, idx = topology.dense_to_condensed(w * mask, mask, k)
    codes, scales = F.quantize_values(vals32, "int8")
    ablated = _ablated(mask, ABLATION)
    stats = F.realized_stats(ablated)
    coa = F.CondensedOverActive.export_from_dense(w, ablated, stats)
    ai = F.StructuredFanIn.from_mask(_ablated(torch.ones_like(mask), ABLATION)).active_index
    masked = (w * mask).to(bf16).contiguous()
    out = dict(
        K1=dict(args=(vals32.to(bf16).contiguous(), idx), kw={}, library=masked),
        K2=dict(args=(codes.contiguous(), idx), kw=dict(scales=scales.contiguous()),
                library=masked),
        K4=dict(args=(coa.values.to(bf16).contiguous(), coa.indices, coa.out_index), kw={},
                library=(w * ablated).to(bf16).contiguous()))
    panel = sm._gather_columns(w.to(bf16), ai)
    out["K5"] = dict(args=(panel, ai), kw={}, library=panel)  # then index_copy_
    return out, (int(stats.max_active), int(ai.numel()))


def _vit_call(kern: str, d_out: int):
    """The wrapper of ``kern`` as f(x, *operands)."""
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import structured_matmul as sm
    if kern in ("K1", "K2"):
        return lambda x, v, i, s=None: cm.condensed_matmul(x, v, i, scales=s)
    if kern == "K4":
        return lambda x, v, i, o: sm.condensed_over_active_matmul(x, v, i, o, d_out)
    return lambda x, p, a: sm.structured_matmul_pregathered(x, p, a, d_out)


def _vit_plain(kern: str, d_out: int):
    """The plain version of ``kern`` as f(x, *operands)."""
    from repro_torch.kernels import ref
    if kern in ("K1", "K2"):
        return lambda x, v, i, s=None: _plain_gather(x, v, i, s)
    if kern == "K4":
        return lambda x, v, i, o: ref.condensed_over_active_matmul_ref(x, v, i, o, d_out)
    return lambda x, p, a: ref.structured_matmul_ref(x, p, a, d_out)


def vit_kernel_phase(device) -> list:
    """[kernel:vit]: K1, K2 (int8 codes), K4 and K5 (half the neurons
    ablated, ablation-only for K5) at each of vit-b16's stack shapes (wo
    1024 -> 768 k 102 with 4 of its 16 heads padding, w_gate / w_up 768 ->
    3072 k 77, w_down 3072 -> 768 k 307: the uniform 90% densities), bf16,
    at the paper's batch-256 layer (256 rows) and a B=256 forward's 50,432
    rows. At 256 rows each launch is held to its plain version within TOL
    (K1 and K2 also decode(first 4 rows) == tiled bitwise); at 50,432 the
    first VIT_HELD_ROWS rows are held bitwise against a launch of those
    rows, itself held to the plain version. Each is timed beside
    torch.matmul on the dense weight it computes (K5: on its panel, then
    index_copy_) and the bound; then a layer (wo + w_gate + w_up + w_down)
    a kernel and row count. Prints [kernel:vit] lines; returns the
    records."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(11)
    cases = []
    for (d_in, d_out, k), names in _arch_shapes(VIT_ARCH).items():
        ops_of, (a, a_pad) = _vit_operands(gen, d_in, d_out, k, device)
        print(f"[kernel:vit] {'/'.join(names)} {d_in}->{d_out}: k {k}; half the neurons "
              f"ablated: a {a}, a_pad {a_pad}")
        for kern, o in ops_of.items():
            args = o["args"] + tuple(o["kw"].values())
            wbytes = sum(t.numel() * t.element_size() for t in args)
            weight_sets = [tuple(t.clone() for t in args) for _ in range(_copies(wbytes))]
            lib_w = o["library"]
            lib_sets = [lib_w.clone() for _ in range(_copies(lib_w.numel() * 2))]
            call, plain = _vit_call(kern, d_out), _vit_plain(kern, d_out)
            if kern == "K5":
                ai_long = args[1].long()

                def library(x_, p_):  # a sentinel column lands in the spare one
                    return torch.zeros((x_.shape[0], d_out + 1), dtype=bf16, device=device
                                       ).index_copy_(1, ai_long, torch.matmul(x_, p_))[:, :d_out]
            else:
                library = torch.matmul
            # the work this call's data needs: the k-sums of its stored
            # rows (K4: the surviving rows; K5: the panel's columns)
            macs_row = args[0].numel()
            for rows in VIT_ROWS:
                x = torch.randn((rows, d_in), generator=gen, device=device).to(bf16)
                y = call(x, *args)
                held = min(rows, VIT_HELD_ROWS)
                if rows > held:
                    part = call(x[:held], *args)
                    if not torch.equal(y[:held], part):
                        raise AssertionError(f"[kernel:vit] {kern} {d_in}->{d_out}: the "
                                             f"first {held} of {rows} rows are not bitwise "
                                             f"a {held}-row launch")
                    pair = f"first {held} of {rows} rows == a {held}-row launch"
                else:
                    part = y
                    pair = ""
                want, plain_ms = _timed_call(plain, x[:held], *args)
                torch.testing.assert_close(part.float(), want.float(), **TOL["bfloat16"])
                err = (part.float() - want.float()).abs().max().item()
                del want
                if kern in ("K1", "K2") and rows == VIT_BATCH:
                    if not torch.equal(cm.condensed_matmul_decode(x[:BATCH], *o["args"],
                                                                  **o["kw"]), y[:BATCH]):
                        raise AssertionError(f"[kernel:vit] {kern} {d_in}->{d_out}: "
                                             f"decode(first {BATCH} rows) != tiled")
                    pair = f"decode(first {BATCH} rows) == tiled"
                big = rows > VIT_HELD_ROWS
                ms = _time_ms(call, [(x, *w_) for w_ in weight_sets],
                              reps=3 if big else 5, iters=6 if big else 30)
                library_ms = _time_ms(library, [(x, w_) for w_ in lib_sets],
                                      reps=3 if big else 5, iters=6 if big else 30)
                nbytes = wbytes + rows * d_in * 2 + rows * d_out * 2
                ops = 2 * rows * macs_row
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
                rec = dict(kernel=kern, arch=VIT_ARCH, stack="/".join(names),
                           names=list(names), d_in=d_in, n_out=d_out, k=k, dtype="bfloat16",
                           batch=rows, launch="tiled", ms=ms,
                           plain_ms=plain_ms if not big else None,
                           plain_rows=held, plain_held_ms=plain_ms, library_ms=library_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, max_abs_err=err, bitwise=pair)
                cases.append(rec)
                print(f"[kernel:vit] {kern} {'/'.join(names):12s} {d_in}->{d_out} k={k} bf16 "
                      f"rows={rows:5d}: us {ms * 1e3:.2f} | plain {plain_ms * 1e3:.2f}"
                      f"{'' if not big else f' (its first {held} rows)'} | torch.matmul "
                      f"{library_ms * 1e3:.2f} | bound {rec['bound_ms'] * 1e3:.2f} "
                      f"({rec['bound_by']}) | max_abs_err {err:.3g}"
                      + (f" | {pair}: bitwise" if pair else ""))
                del x, y, part
            del weight_sets, lib_sets
        del ops_of
        torch.cuda.empty_cache()
    for kern in ("K1", "K2", "K4", "K5"):
        for rows in VIT_ROWS:
            layer = [(c, len(c["names"])) for c in cases
                     if c["kernel"] == kern and c["batch"] == rows]
            tot = {t: sum(c[t] * n for c, n in layer)
                   for t in ("ms", "plain_held_ms", "library_ms", "bound_ms")}
            print(f"[kernel:vit] {VIT_ARCH} one layer ({' + '.join(VIT_LAYER)}, bf16"
                  f"{', int8 codes' if kern == 'K2' else ''}"
                  f"{', half the neurons ablated' if kern in ('K4', 'K5') else ''}, "
                  f"rows={rows}): {kern} {tot['ms'] * 1e3:.2f} us | bound "
                  f"{tot['bound_ms'] * 1e3:.2f} us | plain {tot['plain_held_ms'] * 1e3:.2f} us"
                  f"{'' if rows <= VIT_HELD_ROWS else f' (at {VIT_HELD_ROWS} rows)'} | "
                  f"torch.matmul {tot['library_ms'] * 1e3:.2f} us | kernel / torch.matmul "
                  f"{tot['ms'] / tot['library_ms']:.2f}")
    return cases


def audio_kernel_phase(device) -> list:
    """[kernel:audio]: ``_family_kernel_phase`` at musicgen-medium's stack
    shapes (wo 2048 -> 1536 k 276 with 8 of its 32 heads padding, w_gate /
    w_up 1536 -> 6144 k 148, w_down 6144 -> 1536 k 591: every d_in within
    K1's decode kernel), decode B=4 and the prefill's 4 x 32 rows."""
    return _family_kernel_phase(device, "audio", AUDIO_ARCH, PROMPT,
                                {"attn+MLP": VIT_LAYER}, seed=13)


def _plan_expected(cfg, plan, passes: int) -> dict:
    """Kernel launches ``passes`` forward passes over ``plan``'s tree imply:
    each stack's kernel once a layer a pass (quantized values: K2 /
    K2-coa)."""
    quant = plan.values_dtype is not None
    kernel_of = {"condensed": "K2" if quant else "K1",
                 "condensed_over_active": "K2-coa" if quant else "K4", "structured": "K5"}
    expected = _none()
    for s in plan.registry:
        rep = plan.representation_of(s.name)
        if rep in kernel_of:
            expected[kernel_of[rep]] += _applications(cfg, s) * passes
    return expected


def _vit_forward(cfg, compute, tree, x):
    """vit-b16's classification forward: ``frontend_embeds`` x (B, T, d)
    through the backbone over serving tree ``tree``, then the class head
    (``class_logits``): (B, n_classes) float32."""
    import torch
    from repro_torch.models import model as M
    with torch.inference_mode():
        h, pos = M.embed_inputs(cfg, compute, {"frontend_embeds": x})
        hidden, _ = M.backbone(cfg, compute, tree, h, positions=pos)
        return M.class_logits(cfg, compute, hidden)


def _class_ties(label: str, logits, ref_logits, tie: float, against: str) -> int:
    """Top-1 classes against ``against``'s: they may part only where its
    top-2 gap is below ``tie``. Returns the images that agree."""
    import torch
    top2 = ref_logits.topk(2, dim=-1).values
    gaps = top2[:, 0] - top2[:, 1]
    differ = logits.argmax(-1) != ref_logits.argmax(-1)
    if bool((differ & (gaps >= tie)).any()):
        worst = gaps[differ].max().item()
        raise AssertionError(f"{label}: a top-1 class differs from {against} at a top-2 gap "
                             f"of {worst:.4g} (tie below {tie:.4g})")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite class logits")
    return int((~differ).sum())


def vit_phase(device, card: str) -> dict:
    """[vit:*]: vit-b16 at its published width and depth (12 layers, d_model
    768, 12 heads of 64 padded to 16, d_ff 3072, 1000 classes), seeded
    random weights and 90% uniform SRigL masks drawn on the card, the
    classification forward on frontend_embeds (256, 197, 768) over plans
    built at its 50,432 rows: bf16 masked, condensed (K1), int8 condensed
    (K2), condensed_over_active on the masks with half the neurons ablated
    (K4), structured on their ablation-only projection (K5), auto (on the
    ablated masks; its choices printed); then f32 masked / condensed at
    B=32. Gates: a path's forward launches its kernel 12 x 4 = 48 times
    (auto: as its plan implies); its class logits within the measured
    difference from masked's on the same masks (int8: its dequantized
    twin's), below LOGIT_NOISE_BOUND (f32: 1e-3), and its top-1 classes
    masked's but at a top-2 gap below max(TIE_GAP, 2 x that difference);
    repeated forwards bitwise. Prints the forward's wall (median of 3),
    images/s and max_memory_allocated. Returns the bf16 K1, K2, K4 and K5
    launches of one forward each."""
    import torch
    from types import SimpleNamespace
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sparse import plan as PLAN
    from repro_torch.sparse import registry as REG

    launches = {"K1": 0, "K2": 0, "K4": 0, "K5": 0}
    rows = VIT_BATCH * VIT_TOKENS
    for dtype_name in ("bfloat16", "float32"):
        cfg = configs.get_config(VIT_ARCH).replace(dtype=dtype_name)
        reg = REG.build_registry(cfg)
        k_fan = REG.k_fan_map(cfg, reg)
        if k_fan != {"wo": 102, "w_gate": 77, "w_up": 77, "w_down": 307}:
            raise AssertionError(f"vit-b16 fan-ins {k_fan}")
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(0)
        params = M.init_params(cfg, gen, k_fan)
        masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
        b = VIT_BATCH if dtype_name == "bfloat16" else VIT_F32_BATCH
        x = torch.randn((b, VIT_TOKENS, cfg.d_model), generator=gen, device=device)
        compute = M.serving_params(cfg, params)
        torch.cuda.synchronize()
        _part("init")
        print(f"[vit] {VIT_ARCH}: {cfg.n_layers} layers (published depth), d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} padded to "
              f"{cfg.n_heads_padded}, d_ff {cfg.d_ff}, {cfg.n_classes} classes, causal "
              f"{cfg.causal} (no RoPE); {cfg.sparsity.distribution} densities at "
              f"{cfg.sparsity.sparsity}, fan-ins {k_fan}; frontend_embeds {b}x{VIT_TOKENS}x"
              f"{cfg.d_model} ({b * VIT_TOKENS} rows a linear); {dtype_name}; init "
              f"{time.perf_counter() - t0:.1f}s")
        ablated = _ablate_masks(reg, masks, ABLATION)
        only = _ablation_only(reg, masks, ABLATION)
        if dtype_name == "bfloat16":
            runs = (("masked", masks, "masked", None, None),
                    ("condensed", masks, "condensed", None, "masked"),
                    ("condensed:int8", masks, "condensed", "int8", "twin"),
                    ("masked:ablated", ablated, "masked", None, None),
                    ("condensed_over_active", ablated, "condensed_over_active", None,
                     "masked:ablated"),
                    ("auto", ablated, "auto", None, "masked:ablated"),
                    ("masked:ablation-only", only, "masked", None, None),
                    ("structured", only, "structured", None, "masked:ablation-only"))
        else:
            runs = (("masked", masks, "masked", None, None),
                    ("condensed", masks, "condensed", None, "masked"))
        refs: dict = {}
        for name, m, path, vd, against in runs:
            label = f"vit:{name}" + ("" if dtype_name == "bfloat16" else ":f32")
            t0 = time.perf_counter()
            if path == "masked":
                plan, tree = None, m
            else:
                plan = PLAN.build_plan(cfg, reg, params, m, batch_size=b * VIT_TOKENS,
                                       path=path, values_dtype=vd)
                tree = plan.serving_tree
            torch.cuda.synchronize()
            export_s = time.perf_counter() - t0
            _part("export")
            torch.cuda.reset_peak_memory_stats(device)
            _vit_forward(cfg, compute, tree, x)  # warm
            torch.cuda.synchronize()
            _zero_counts()
            logits = _vit_forward(cfg, compute, tree, x)
            torch.cuda.synchronize()
            counts = _counts()
            want = _none() if plan is None else _plan_expected(cfg, plan, 1)
            if counts != want:
                raise AssertionError(f"{label}: launched {counts}, expected {want}")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                again = _vit_forward(cfg, compute, tree, x)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
                if not torch.equal(again, logits):
                    raise AssertionError(f"{label}: a repeated forward gave other logits")
            peak = torch.cuda.max_memory_allocated(device)
            _part("forward")
            if path == "masked":
                refs[name] = logits
                held = (f"{len(set(logits.argmax(-1).tolist()))} distinct top-1 classes of "
                        f"{b}")
            else:
                ref = refs[against] if against != "twin" else _vit_forward(
                    cfg, compute, _dequantized_twin(plan, getattr(torch, dtype_name)), x)
                who = "the dequantized twin (K1)" if against == "twin" else against
                d = (logits - ref).abs().max().item()
                bound = LOGIT_NOISE_BOUND["bfloat16"] if dtype_name == "bfloat16" else 1e-3
                if not d <= bound:
                    raise AssertionError(f"{label}: class logits differ from {who} by {d}, "
                                         f"above {bound}")
                tie = max(TIE_GAP[dtype_name], 2 * d)
                agree = _class_ties(label, logits, ref, tie, who)
                held = (f"class logits within {d:.4g} of {who} (bound {bound}); top-1 "
                        f"equal in {agree}/{b} (the rest at a top-2 gap below {tie:.4g})")
                _part("checks")
            if plan is not None and dtype_name == "bfloat16" and path != "auto":
                for key, n in counts.items():
                    if key in launches:
                        launches[key] += n
            chose = ""
            if path == "auto":
                chose = "; chose " + ", ".join(f"{s.name} {plan.representation_of(s.name)}"
                                              for s in reg)
            wall = statistics.median(walls)
            print(f"[{label}] {card}: forward {b}x{VIT_TOKENS} wall {wall * 1e3:.2f} ms "
                  f"(median of {len(walls)}), {b / wall:.1f} images/s; export "
                  f"{export_s:.2f}s; launches { {n: c for n, c in counts.items() if c} }"
                  f"{chose}; {held}; peak memory {peak / 2**30:.3f} GiB "
                  f"(max_memory_allocated)")
            del plan, tree, logits, again
        del params, masks, compute, x, refs, ablated, only
        _release()
    return launches


def vit_train_phase(device, card: str) -> None:
    """[vit:train]: ``launch/train.py``'s Trainer on vit-b16 at its
    published width and depth from a seeded init, bf16 compute,
    VIT_TRAIN_BATCH images of 197 patch embeddings a step (SyntheticLM's vit
    branch, as the train CLI builds it), 3 AdamW steps with the SRigL
    update (gamma_sal 0.95, ablation on) after the second: every loss
    finite, the update's invariants (an active neuron's fan-in its layer's
    k', an ablated neuron's column empty, grown weights 0). Prints each
    step's seconds, the DST step's and n_ablated per stack. It launches no
    port kernel (masked-dense training)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sparse import registry as REG
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import Trainer

    base = configs.get_config(VIT_ARCH)
    cfg = base.replace(sparsity=dataclasses.replace(base.sparsity, delta_t=2))
    trainer = Trainer(cfg=cfg, lr_fn=warmup_cosine(3e-3, 1, 3), log_every=1)
    reg = trainer.registry
    dst_times: list = []
    _timed_dst(trainer, dst_times)
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    data = SyntheticLM(vocab_size=max(cfg.vocab_size, 2), seq_len=VIT_TOKENS,
                       batch_size=VIT_TRAIN_BATCH, seed=0, family=cfg.family,
                       n_codebooks=cfg.n_codebooks, d_model=cfg.d_model)
    batches = Prefetcher(data.iterate(), depth=2, pin=True)
    _zero_counts()
    _part("setup")
    logs: list = []
    try:
        for i in range(3):
            old_masks = state.masks
            old_versions = {k: int(v) for k, v in state.mask_versions.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.fit(state, batches, 1, log_fn=logs.append)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            loss = float(trainer.last_metrics["loss"])
            if not math.isfinite(loss):
                raise AssertionError(f"[vit:train] step {i}: loss {loss}")
            dst = i == 1
            print(f"[vit:train] step {i}: loss {loss:.4f}, {dt * 1e3:.1f} ms"
                  + (" with the SRigL update" if dst else ""))
            if dst:
                _check_dst(cfg, reg, state, old_masks, old_versions)
                ablated = {s.name: int((~REG.get_path(state.neuron_active, s.path)).sum())
                           for s in reg}
            del old_masks
    finally:
        batches.close()
    if _counts() != _none():
        raise AssertionError(f"[vit:train] the masked-dense trainer launched {_counts()}")
    _part("train")
    print(f"[vit:train] {card}: {VIT_TRAIN_BATCH}x{VIT_TOKENS} rows a step, bf16; SRigL DST "
          f"step {[round(t * 1e3, 1) for t in dst_times]} ms; n_ablated {ablated} (of "
          f"{cfg.n_layers} x d_out neurons a stack); every loss finite, fan-in constant, "
          f"ablated columns empty")
    del state, trainer
    _release()


def _audio_run(cfg, compute, tree, prompts, gen_len: int):
    """musicgen's serving loop: ``prefill_step`` on prompts (B, K, T), then
    ``gen_len`` ``decode_step``s, each feeding the tokens just chosen (each
    codebook's argmax) into the cache, as a serving loop's decode does.
    Returns (tokens (B, K, gen_len), the top-2 gaps they were chosen at,
    the prefill's logits (B, K, V), prefill s, decode s)."""
    import torch
    from repro_torch.models import model as M
    b, _, t = prompts.shape
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = M.init_cache(cfg, b, t + gen_len, prompts.device)
        logits, cache = M.prefill_step(cfg, compute, tree, {"tokens": prompts}, cache)
        first = logits[..., :cfg.vocab_size]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, gaps = [], []
        for step in range(gen_len):
            lg = logits[..., :cfg.vocab_size]
            top2 = lg.topk(2, dim=-1).values
            gaps.append(top2[..., 0] - top2[..., 1])
            cur = lg.argmax(-1).to(torch.int32)                        # (B, K)
            toks.append(cur)
            logits, cache = M.decode_step(cfg, compute, tree, {"tokens": cur[..., None]},
                                          cache)
        out = torch.stack(toks, -1), torch.stack(gaps, -1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (*out, first, t1 - t0, t2 - t1)


def audio_phase(device, card: str) -> dict:
    """[audio:*]: musicgen-medium at its published width and depth (48
    layers, d_model 1536, 24 heads of 64 padded to 32, d_ff 6144, 4
    codebooks of 2048), seeded random weights and 90% SRigL ERK masks drawn
    on the card, B=4 prompts (4, 4, 32) + GEN greedy tokens a codebook
    (``_audio_run``), in bf16 on masked, condensed (K1), int8 condensed (K2)
    and auto, then f32 masked and condensed, each path's plan built at the
    request's bucket. Gates: a condensed request launches K1 4 x 48 x (1 +
    GEN) = 3264 times (int8: K2), auto as its plan implies; a repeated
    request gives the same tokens (an auto plan of masked on every stack
    serves one request, held bitwise to masked's); every codebook's tokens equal masked's
    (int8: its dequantized twin's) up to a stream's first differing
    position, where each codebook that differs has a top-2 gap below
    max(TIE_GAP, 2 d), d the prefill logits' difference, itself below
    LOGIT_NOISE_BOUND (a stream's codebooks share its next input). Prints
    the wall (the faster of 2) with its prefill and decode parts, ms a
    decode step and max_memory_allocated; each dtype's model is freed before the
    next. Returns the bf16 K1 and K2 launches of one request each."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sparse import plan as PLAN
    from repro_torch.sparse import registry as REG

    passes = 1 + GEN  # the prefill and GEN decode steps
    launches = {"K1": 0, "K2": 0}
    model_of = None
    for dtype_name, path, vd in AUDIO_PATHS:
        if model_of is None or model_of[0] != dtype_name:
            model_of = params = compute = masks = None
            _release()
            t0 = time.perf_counter()
            cfg = configs.get_config(AUDIO_ARCH).replace(dtype=dtype_name)
            reg = REG.build_registry(cfg)
            k_fan = REG.k_fan_map(cfg, reg)
            if k_fan != {"wo": 276, "w_gate": 148, "w_up": 148, "w_down": 591}:
                raise AssertionError(f"musicgen-medium fan-ins {k_fan}")
            gen = torch.Generator(device=device).manual_seed(0)
            params = M.init_params(cfg, gen, k_fan)
            masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
            prompts = torch.randint(0, cfg.vocab_size, (BATCH, cfg.n_codebooks, PROMPT),
                                    generator=gen, device=device, dtype=torch.int32)
            compute = M.serving_params(cfg, params)
            torch.cuda.synchronize()
            _part("init")
            n_par = sum(v.numel() for v in _leaf_list(params))
            print(f"[audio] {AUDIO_ARCH}: {cfg.n_layers} layers (published depth), d_model "
                  f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} padded to "
                  f"{cfg.n_heads_padded}, d_ff {cfg.d_ff}, {cfg.n_codebooks} codebooks of "
                  f"{cfg.vocab_size} (embed {tuple(params['embed'].shape)}, lm_head "
                  f"{tuple(params['lm_head'].shape)}); {n_par / 1e9:.3f} B params; fan-ins "
                  f"{k_fan}; served {dtype_name}; prompts {tuple(prompts.shape)} + {GEN}; "
                  f"init {time.perf_counter() - t0:.1f}s, "
                  f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
            model_of = (dtype_name,)
            refs: dict = {}
        label = (f"audio:{path}" + (f":{vd}" if vd else "")
                 + ("" if dtype_name == "bfloat16" else ":f32"))
        t0 = time.perf_counter()
        if path == "masked":
            plan, tree = None, masks
        else:
            plan = PLAN.build_plan(cfg, reg, params, masks,
                                   batch_size=PLAN.batch_bucket(BATCH), path=path,
                                   values_dtype=vd)
            tree = plan.serving_tree
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        _part("export")
        torch.cuda.reset_peak_memory_stats(device)
        # an auto plan of masked on every stack runs masked's computation: one
        # counted request, held bitwise to masked's tokens
        as_masked = path == "auto" and {plan.representation_of(s.name) for s in reg} == {"masked"}
        first = None if as_masked else _audio_run(cfg, compute, tree, prompts, GEN)
        _zero_counts()
        run = _audio_run(cfg, compute, tree, prompts, GEN)
        counts = _counts()
        want = _none() if plan is None else _plan_expected(cfg, plan, passes)
        if counts != want:
            raise AssertionError(f"{label}: launched {counts}, expected {want}")
        if path == "condensed":
            key = "K2" if vd else "K1"
            if counts[key] != len(reg) * cfg.n_layers * passes:
                raise AssertionError(f"{label}: {key} x {counts[key]}, expected "
                                     f"{len(reg)} x {cfg.n_layers} x {passes}")
            if dtype_name == "bfloat16":
                launches[key] += counts[key]
        runs = [r for r in (first, run) if r is not None]
        if first is not None and not torch.equal(first[0], run[0]):
            raise AssertionError(f"{label}: a repeated request gave other tokens")
        peak = torch.cuda.max_memory_allocated(device)
        _part("serve")
        toks, gaps, logits0 = run[0], run[1], run[2]
        if not (toks.shape == (BATCH, cfg.n_codebooks, GEN)
                and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
            raise AssertionError(f"{label}: bad tokens {tuple(toks.shape)}")
        if path == "masked":
            refs["masked"] = (toks, gaps, logits0)
            held = (f"codebook 0 of stream 0 {toks[0, 0].tolist()}, "
                    f"{len(set(toks.reshape(-1).tolist()))} distinct tokens")
        elif as_masked:
            if not torch.equal(toks, refs["masked"][0]):
                raise AssertionError(f"{label}: masked on every stack, but other tokens than "
                                     f"masked's")
            held = "masked on every stack: tokens == masked's bitwise"
        else:
            against = "masked"
            r_toks, r_gaps, r_logits = refs["masked"]
            if vd:  # codes held to their dequantized twin (K1), as in [quant]
                r_toks, r_gaps, r_logits = _audio_run(
                    cfg, compute, _dequantized_twin(plan, getattr(torch, dtype_name)),
                    prompts, GEN)[:3]
                against = "the twin"
            d = (logits0 - r_logits).abs().max().item()
            if not d <= LOGIT_NOISE_BOUND[dtype_name]:
                raise AssertionError(f"{label}: prefill logits differ from {against} by {d}, "
                                     f"above {LOGIT_NOISE_BOUND[dtype_name]}")
            tie = max(TIE_GAP[dtype_name], 2 * d)
            # a stream's codebooks share its next input (their embeddings
            # are summed), so a stream may part at its first differing
            # position only where every codebook that differs there is a
            # tie; after it the whole stream is free
            agree = 0
            for bi in range(BATCH):
                differ = toks[bi] != r_toks[bi]                          # (K, GEN)
                if not bool(differ.any()):
                    agree += 1
                    continue
                j = int(differ.any(0).nonzero()[0])
                for ki in differ[:, j].nonzero()[:, 0].tolist():
                    gap = r_gaps[bi, ki, j].item()
                    print(f"[{label}] stream {bi}: codebook {ki} parts from {against} at "
                          f"generated token {j}, top-2 gap {gap:.3g} (tie below {tie:.3g})")
                    if gap >= tie:
                        raise AssertionError(f"{label}: tokens differ from {against} at a "
                                             f"gap of {gap}")
            held = (f"prefill logits within {d:.4g} of {against}; streams agreeing in "
                    f"full, every codebook, {agree}/{BATCH} (tie below {tie:.3g})")
            _part("checks")
        chose = ""
        if path == "auto":
            chose = "; chose " + ", ".join(f"{s.name} {plan.representation_of(s.name)}"
                                          for s in reg)
        mid = min(runs, key=lambda r: r[3] + r[4])
        print(f"[{label}] {card}: prefill_step + {GEN} decode_steps, {BATCH}x"
              f"{cfg.n_codebooks}x{PROMPT} + {GEN}: wall {(mid[3] + mid[4]) * 1e3:.2f} ms "
              f"(the faster of {len(runs)}; prefill {mid[3] * 1e3:.2f} ms, decode "
              f"{mid[4] * 1e3:.2f} ms, "
              f"{mid[4] / GEN * 1e3:.2f} ms a decode step, eager); export "
              f"{export_s:.2f}s; launches { {n: c for n, c in counts.items() if c} }{chose}; "
              f"{held}; peak memory {peak / 2**30:.3f} GiB (max_memory_allocated)")
        del plan, tree, runs, first, run
        _release()
    del params, compute, masks, refs
    _release()
    return launches


# ---------------------------------------------------------------------------
# planning without allocation ([dryrun])
# ---------------------------------------------------------------------------

# the configs whose training state [dryrun] sizes (one meta trainer step at
# train_4k): the first slice's, the two ROADMAP does not train on the card for
# their memory (zamba2-7b, musicgen-medium), and the paper's own ViT
DRYRUN_TRAIN = ("qwen3-1.7b", "zamba2-7b", "musicgen-medium", "vit-b16")


def start_dryrun():
    """Start the [dryrun] cells that need no card with the dry run's own
    CLI, in a session of their own that sees no card (CUDA_VISIBLE_DEVICES
    empty) and runs beside the phases: ``--program serve_zoo --arch all``
    (every config at its published width and full depth), then ``--program
    train`` for each of DRYRUN_TRAIN, one after another, each writing its
    cells as JSON lines under build/dryrun/. Returns (the process, that
    directory)."""
    out = REPO / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cli = f"{shlex.quote(sys.executable)} -m repro_torch.launch.dryrun"
    steps = [f"{cli} --program serve_zoo --arch all --out {shlex.quote(str(out / 'zoo.jsonl'))}"]
    steps += [f"{cli} --program train --shapes train_4k --arch {arch} "
              f"--out {shlex.quote(str(out / f'train_{arch}.jsonl'))}" for arch in DRYRUN_TRAIN]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO / "src"))
    with open(out / "log", "w") as f:
        proc = subprocess.Popen(["sh", "-c", " && ".join(steps)], stdout=f,
                                stderr=subprocess.STDOUT, env=env, cwd=REPO,
                                start_new_session=True)
    return proc, out


def _stop(proc) -> None:
    """End ``proc``'s session (the shell and the CLI it runs) if it runs."""
    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def dryrun_phase(setup: dict, card: str, cells_proc) -> None:
    """[dryrun]: planning without allocation (``launch/dryrun.py``). First
    qwen3-1.7b condensed at the [engine] phase's bucket 8, on that engine's
    pool pages and table width, in this process. Gates: memory_allocated
    is unchanged across these meta cells; the cell's params bytes equal the
    real params' (``model_setup``), its pool bytes the engine's pool, and
    its abstract serving tree equals the engine's concrete export in every
    axis but k (both k and both byte totals printed). Prints the cell's
    peak above its arguments beside the measured max_memory_allocated
    increase of the same decode step (a finding, not a gate). Then the
    cells of ``start_dryrun``'s process, which sees no card: every
    config's ``serve_zoo`` cell at its published width and full depth
    (kimi-k2-1t and mistral-large-123b included: the engine's plan key at
    the decode shape, the abstract serving tree and one meta decode step)
    and the DRYRUN_TRAIN configs' train cells (one meta trainer step at
    train_4k), each one's bytes beside the card's memory; the process must
    end with every cell."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun as DR
    from repro_torch.sparse import plan as PLAN
    from repro_torch.sparse import registry as REG

    total = torch.cuda.get_device_properties(0).total_memory
    cfg, reg = setup["base"], setup["reg"]
    eng = setup["report"]["engine"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cell = DR.run_zoo_cell(ARCH, quiet=True, batch=eng["bucket"], path="condensed",
                           pages=eng["pages"], block_size=eng["block_size"])
    served = DR.run_zoo_cell(ARCH, quiet=True, batch=eng["bucket"], path="condensed",
                             pages=eng["pages"], block_size=eng["block_size"],
                             serving_copy=True)
    tree = PLAN.abstract_serving_tree(cfg, reg, {s.name: "condensed" for s in reg})
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"[dryrun] memory_allocated moved across the meta cells: "
                             f"{before} -> {after}")
    real_params = _bytes(setup["params"])
    if cell["params_bytes"] != real_params or cell["pool_bytes"] != eng["pool_bytes"]:
        raise AssertionError(f"[dryrun] {ARCH}: params {cell['params_bytes']} vs "
                             f"{real_params} allocated, pool {cell['pool_bytes']} vs "
                             f"{eng['pool_bytes']}")
    ks = []
    for s in reg:
        leaf, real = REG.get_path(tree, s.path), eng["leaves"][s.name]
        for f, t in leaf.arrays().items():
            if tuple(t.shape[:-1]) != real[f][0][:-1]:
                raise AssertionError(f"[dryrun] {s.name}.{f}: abstract {tuple(t.shape)}, "
                                     f"exported {real[f][0]}")
        ks.append(f"{s.name} k {leaf.values.shape[-1]} (target) vs {real['values'][0][-1]} "
                  f"(realized), values {str(leaf.values.dtype).removeprefix('torch.')} vs "
                  f"{real['values'][1]}")
    step = served["peak_bytes"] - served["argument_bytes"]
    print(f"[dryrun:{ARCH}] condensed at bucket {eng['bucket']} on the [engine] pool "
          f"({eng['pages'][0]} pages of {eng['block_size']}, table width {eng['pages'][1]}): "
          f"params {cell['params_bytes']} B == allocated {real_params} B; pool "
          f"{cell['pool_bytes']} B == the engine's {eng['pool_bytes']} B; abstract tree == the "
          f"export in every axis but k: {'; '.join(ks)}; tree bytes {cell['tree_bytes']} "
          f"(abstract, param dtype) vs {eng['tree_bytes']} (export); memory_allocated "
          f"unchanged across the meta cells ({before} B)")
    print(f"[dryrun:{ARCH}] one paged decode step on the serving copy "
          f"({_gib(served['params_bytes'])} meta vs {_gib(eng['compute_bytes'])} allocated): "
          f"meta peak above the arguments {step} B vs the card's measured "
          f"max_memory_allocated increase {eng['step_peak']} B "
          f"({step / max(eng['step_peak'], 1):.3f}x)")
    _part("qwen3")

    proc, out = cells_proc
    try:
        proc.wait(timeout=600)
    finally:
        _stop(proc)
    log = (out / "log").read_text()
    files = [out / "zoo.jsonl"] + [out / f"train_{arch}.jsonl" for arch in DRYRUN_TRAIN]
    cells = [json.loads(line) for f in files if f.exists() for line in f.read_text().splitlines()]
    want = [(a, "serve_zoo") for a in configs.ALL_ARCHS] + [(a, "train") for a in DRYRUN_TRAIN]
    if proc.returncode != 0 or [(c["arch"], c["program"]) for c in cells] != want:
        raise AssertionError(f"[dryrun] the cells' process ended {proc.returncode} with "
                             f"{[(c['arch'], c['program']) for c in cells]}:\n{log[-4000:]}")
    _part("wait")
    for c in cells:
        tag = f"[dryrun:{c['arch']}] {c['program']}"
        if "peak_bytes" not in c:
            print(f"{tag}: encoder-only: plan key {c['plan_key']}, {c['abstract_leaves']} "
                  f"abstract leaves, no decode program")
            continue
        fits = f"{'fits' if c['peak_bytes'] <= total else 'does not fit'} ({c['step_s']:.2f}s)"
        if c["program"] == "serve_zoo":
            print(f"{tag} at {c['decode_shape']} (B {c['batch']} x {c['seq_len']}), group "
                  f"{c['plan_key']} ({'paged' if c['supports_paged'] else 'slab'}): params "
                  f"{_gib(c['params_bytes'])}, tree {_gib(c['tree_bytes'])}, cache "
                  f"{_gib(c['cache_bytes'])}; arguments {_gib(c['argument_bytes'])}, outputs "
                  f"{_gib(c['output_bytes'])}, peak {_gib(c['peak_bytes'])} against the "
                  f"card's {_gib(total)}: {fits}")
            continue
        state = sum(c[f"{k}_bytes"] for k in ("params", "opt_state", "masks",
                                              "neuron_active", "grad_accum"))
        print(f"{tag} at train_4k (B {c['batch']} x {c['seq_len']}), one meta trainer step: "
              f"params {_gib(c['params_bytes'])}, optimizer state "
              f"{_gib(c['opt_state_bytes'])}, the state in all {_gib(state)} "
              f"({'fits' if state <= total else 'does not fit'}), batch "
              f"{_gib(c['batch_bytes'])}; peak {_gib(c['peak_bytes'])} against the card's "
              f"{_gib(total)}: {fits}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    build_job = start_build()

    # full float32 products and reductions in every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    # the launch cache the kernel wrappers read is this run's own, fresh:
    # every phase serves the default launches but [autotune], whose engines
    # use a file of their own
    from repro_torch.sparse import autotune as AT
    cache = REPO / "build" / "autotune.json"
    cache.parent.mkdir(exist_ok=True)
    cache.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache)
    AT.reset_cache_state()
    print(f"[env] launch cache {AT.cache_path()} (fresh, no entries); the [autotune] "
          f"phase's engines use build/autotune_phase.json")
    # [dryrun]'s cells that need no card run in a process of their own,
    # beside the phases, and are read (and the process ended) in [dryrun]
    cells_proc = start_dryrun()
    atexit.register(_stop, cells_proc[0])

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        _PARTS.update(t=t0, parts={})
        out = fn(*args)
        _part("setup")
        print(f"[time] {name}: {time.perf_counter() - t0:.1f}s")
        for part, sec in sorted(_PARTS["parts"].items(), key=lambda kv: -kv[1]):
            if sec >= 0.05:
                print(f"[time:{name}:{part}] {sec:.1f}s")
        return out

    print(f"[time] start: {time.perf_counter() - _T_START:.1f}s (imports, nvidia-smi, "
          f"the card's first use)")
    timed("build", build_phase, build_job)
    cases = timed("kernel", kernel_phase, device)
    cases += timed("ablation_kernel", ablation_kernel_phase, device)
    cases += timed("random_ablation", random_ablation_phase, device)
    timed("ragged_structured", ragged_structured_phase, device)
    cases += timed("quant_kernel", quant_kernel_phase, device)
    cases += timed("dw_kernel", dw_kernel_phase, device)
    timed("ragged_gather", ragged_gather_phase, device)
    # B = 4 and 128 are kernel_phase's, ablation_kernel_phase's and
    # quant_kernel_phase's; here the [grad] forward's K1 and K4 at B*T = 512
    layer_cases = timed("gather_layer", gather_layer_phase, device,
                        ((TRAIN_TOKENS, "grad"),), ("K1", "K4"))
    zoo_cases = timed("kernel_zoo", zoo_kernel_phase, device)
    moe_cases = timed("kernel_moe", moe_kernel_phase, device)
    moe_ablation_cases = timed("kernel_moe_ablation", moe_ablation_kernel_phase, device)
    ssm_cases = timed("kernel_ssm", ssm_kernel_phase, device)
    hybrid_cases = timed("kernel_hybrid", hybrid_kernel_phase, device)
    vit_cases = timed("kernel_vit", vit_kernel_phase, device)
    audio_cases = timed("kernel_audio", audio_kernel_phase, device)
    setup = timed("model_setup", model_setup, device)
    launches = {"K1": timed("slice", slice_phase, setup, card)}
    ablation = timed("ablation", ablation_phase, setup, card)
    launches.update(K4=ablation["condensed_over_active"]["K4"],
                    K5=ablation["structured"]["K5"],
                    K6=ablation["structured+prefetch"]["K6"])
    timed("auto", auto_phase, setup)
    quant = timed("quant", quant_phase, setup, card)
    launches.update({"K2": quant["K2"], "K2-coa": quant["K2-coa"]})
    timed("checkpoint", checkpoint_phase, setup)
    timed("engine", engine_phase, setup, card)
    timed("rows", rows_phase, device)
    spec_cases = timed("kernel_spec", spec_kernel_phase, device)
    measured = timed("profile", profile_phase, setup, card)
    timed("spec", spec_phase, setup, card, measured)
    autotune_cases = timed("autotune", autotune_phase, setup, card, smi)
    if AT.cache_path() != str(cache) or AT.has_kernel_entries():
        raise AssertionError(f"after [autotune] the wrappers read {AT.cache_path()}, which "
                             f"must be {cache} with no launch entries")
    launches["K3"] = timed("grad", grad_phase, setup)
    timed("grad_structured", structured_grad_phase, setup)
    timed("dryrun", dryrun_phase, setup, card, cells_proc)
    report = setup["report"]
    del setup
    _release()
    report["srigl_dst_s"] = timed("train", train_phase, device, card)
    rigl_cases = timed("rigl", rigl_phase, device, card, report,
                       [c for c in cases if c["kernel"] == "K1"])
    timed("set", set_phase, device, card)
    gens = timed("generations", _generations, device)
    refreshed = timed("refresh", refresh_phase, gens, card)
    timed("sync", sync_phase, gens, refreshed, card)
    del gens
    _release()
    launches["K1"] += timed("zoo", zoo_phase, device, card)
    moe = timed("moe", moe_phase, device, card)
    launches["K1"] += moe["K1"]
    launches["K2"] += moe["K2"]
    launches.update({"K1-moe": moe["K1-moe"], "K2-moe": moe["K2-moe"]})
    for key, n in timed("spec_moe", spec_moe_phase, device, card, measured).items():
        launches[key] = launches.get(key, 0) + n
    for key, n in timed("moe_ablated", moe_ablated_phase, device, card).items():
        launches[key] = launches.get(key, 0) + n
    launches["K3-moe"] = timed("grad_moe", moe_grad_phase, device)
    timed("moe_train", moe_train_phase, device, card)
    ssm = timed("ssm", ssm_phase, device, card)
    launches["K1"] += ssm["K1"]
    launches["K2"] += ssm["K2"]
    autotune_moe_cases = timed("lead2", lead2_phase, device, card)
    if AT.cache_path() != str(cache) or AT.has_kernel_entries():
        raise AssertionError(f"after [autotune:moe] the wrappers read {AT.cache_path()}, "
                             f"which must be {cache} with no launch entries")
    hybrid = timed("hybrid", hybrid_phase, device, card)
    launches["K1"] += hybrid["K1"]
    launches["K2"] += hybrid["K2"]
    timed("hybrid_sync", hybrid_refresh_sync_phase, device, card)
    vit = timed("vit", vit_phase, device, card)
    for key in ("K1", "K2", "K4", "K5"):
        launches[key] += vit[key]
    timed("vit_train", vit_train_phase, device, card)
    audio = timed("audio", audio_phase, device, card)
    launches["K1"] += audio["K1"]
    launches["K2"] += audio["K2"]
    timed("reference", reference_phase, device)
    timed("train_reference", train_reference_phase, device)

    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_kernels.json").write_text(
        json.dumps({"card": smi, "cases": cases, "layer_cases": layer_cases,
                    "rigl_cases": rigl_cases, "spec_cases": spec_cases,
                    "autotune_cases": autotune_cases, "zoo_cases": zoo_cases,
                    "moe_cases": moe_cases, "moe_ablation_cases": moe_ablation_cases,
                    "ssm_cases": ssm_cases,
                    "autotune_moe_cases": autotune_moe_cases,
                    "hybrid_cases": hybrid_cases, "vit_cases": vit_cases,
                    "audio_cases": audio_cases}, indent=1))
    per_layer = {"wo": 1, "w_gate": 2, "w_down": 1}  # w_up shares w_gate's shape
    kernels = []
    for key, name, source, replaces in KERNELS:
        if key in ("K1-moe", "K2-moe"):  # an MoE decode layer's expert stacks
            layer = [c for c in moe_cases if c["kernel"] == key and c["arch"] == MOE_ARCH
                     and c["dtype"] == "bfloat16" and c["rows"] == 8]
            shape = (f"one decode layer's experts of {MOE_ARCH}: w_gate + w_up + w_down, "
                     f"32 experts of 8 rows (the paged engine's bucket at B=4), bfloat16 x"
                     + (", int8 codes" if key == "K2-moe" else ""))
        elif key == "K3-moe":  # an MoE training layer's experts, their condensed rows
            layer = [c for c in moe_ablation_cases if c["kernel"] == key
                     and c["dtype"] == "bfloat16" and c["n_rows"] == c["d_out"]]
            shape = (f"one training layer's experts of {MOE_ARCH}: w_gate + w_up + w_down, 32 "
                     f"experts of {MOE_TRAIN_ROWS} rows (8 x 64 tokens), bfloat16 dy and x")
        elif key.endswith("-moe"):  # an ablated MoE decode layer's expert stacks
            layer = [c for c in moe_ablation_cases if c["kernel"] == key
                     and c["dtype"] == "bfloat16" and c["rows"] == 8]
            shape = (f"one decode layer's experts of {MOE_ARCH}: w_gate + w_up + w_down, 32 "
                     f"experts of 8 rows, bfloat16 x, about half of each expert's neurons "
                     f"ablated" + (", int8 codes" if key == "K2-coa-moe" else ""))
        elif key == "K3":  # the training layer: every stack's full row count
            layer = [c for c in cases if c["kernel"] == key and c["dtype"] == "bfloat16"
                     and c["batch"] == TRAIN_TOKENS and c["rows"] == c["d_out"]]
            shape = (f"one training layer: wo + w_gate + w_up + w_down, B*T={TRAIN_TOKENS}, "
                     f"bfloat16 dy and x")
        else:
            layer = [c for c in cases if c["kernel"] == key and c["dtype"] == "bfloat16"
                     and c["launch"] == "decode" and c.get("codes", "int8") == "int8"]
            shape = ("one decode layer: wo + w_gate + w_up + w_down, B=4, bfloat16"
                     + (", int8 codes" if key.startswith("K2") else "")
                     + (", 50% of each stack's neurons ablated"
                        if key not in ("K1", "K2") else ""))
        total = {t: sum(c[t] * per_layer[c["stack"]] for c in layer)
                 for t in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(c["max_abs_err"] for c in layer),
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("bytes" if all(c["bound_by"] == "bytes" for c in layer)
                         else "operations"),
            "library_ms": total["library_ms"],
            "shape": shape,
        })
    print(f"[time] total: {time.perf_counter() - _T_START:.1f}s from the script's start")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
