#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device: the card's name and power limit, the kernel build (one
   ``nvcc`` per CUDA source, all started together) and its seconds;
   TF32 is switched off for matmuls and convolutions;
2. kernels: ``head_select`` and ``msp_select`` against their plain
   PyTorch versions on the card — msp and energy detectors, float32 and
   bfloat16 inputs, at the IDKD main-path shapes (k = 8 and k = 1) and at
   an LM head shape (Qwen3-1.7B's head: D = 2048, C = 151,936, which the
   tensor-core ``head_select`` splits over column slices) — with their
   times beside the card's bound; in bf16, ``head_select``'s SIMT and
   tensor-core kernels timed in turns;
3. main path: ResNet-20 at full width on 16 ring nodes with QG-DSGDm-N,
   120 plain steps, one streaming IDKD round on the sparse backend
   (``head_select``), 120 KD steps; the consensus model must learn (its
   eval NLL falls over the run and over the KD phase, its accuracy
   clears a floor); its peak device memory is printed;
4. the one-shot ``fused`` round (``msp_select``) on the final params,
   held against the streaming round;
5. the quickstart twin, held to an accuracy floor;
GRID. the paper's method grid at the main path's full width
   (``mainpath.grid_sim``): centralized SGD, DSGD, RelaySGD on a chain,
   QG-DSGDm-N with vanilla KD (the streaming round through
   ``head_select`` with the OoD filter off), D² and gradient tracking,
   each cut to 120 steps (the round at 60, an eval every 30): ms per
   step, final accuracy, consensus distance and peak memory per method;
   every eval finite and the eval NLL falling over each run, centralized
   SGD's nodes kept together, RelaySGD on a ring refused; then each new
   algorithm 3 steps of ResNet-8 (f32, 4 nodes) on the card and on the
   CPU from the same params and draws, to the same params;
PAPER. the paper's tables at full width (``repro_torch.paper`` at its
   ``"full"`` setting, 8 ring nodes, 200 steps a cell, no cache): Table
   2's five methods at alpha 0.05, Table 4's noise public set for the two
   KD methods, Table 6 and Figure 3 from those cells, printed as the
   tables; every eval finite, no method a constant predictor, every KD
   round through ``head_select``'s SIMT kernel, Table 6's gossip bytes
   exact, Figure 3's skew dropping;
RESIL. checkpoint, telemetry and resilience on the main path at full
   width (``mainpath.grid_sim``'s qg-idkd cut to 100 steps, the round at
   50), in deterministic mode (cuDNN's deterministic algorithms and
   ``torch.use_deterministic_algorithms``; the default mode is not
   bitwise run to run, which the first, 30-step, pair prints): a schedule
   that freezes node 5 over [40, 60), across the round, rewires the ring
   to the exponential graph at 70, drops node 3's payloads over [15, 25),
   corrupts node 7's with nan (detected) over [85, 95) and crashes at
   80, after a snapshot; run with telemetry, the guard and snapshots on,
   then resumed. One line each: (a) the
   fault-free run twice (the control pair: its largest parameter
   difference bounds every comparison below, 0 meaning bitwise); (b)
   telemetry and guard on = off, every segment under
   ``torch.cuda.set_sync_debug_mode("error")``; (c) crash + resume from
   the newest valid snapshot (a truncated newer one skipped) = the
   uninterrupted run; (d) node 5's params and momentum the same bits
   across its window, its row of the round's selection empty,
   ``head_select`` launched for the round; (e) a detected-corrupt window
   = a drop window; (f) nan with validation off trips the guard, node 7
   quarantined, the segment rolled back, the params finite; (g) the run
   log and trace valid, each event kind counted as the schedule implies;
   (h) the consensus checkpoint saved and loaded on the card bitwise;
   with the card's costs: run wall with telemetry and guard on and off,
   a snapshot's write, the resume, the phase's peak memory;
LM-1. the LM kernels against their plain versions on the card at
   Hymba-1.5B's shapes: ``flash_attention`` (global and windowed, f32
   and bf16, timed beside ``scaled_dot_product_attention``),
   ``ssd_scan`` (three passes on the tensor cores, 3xTF32, held to the
   plain version in float64; and at Mamba-2-780M's state size N = 128) and
   ``head_select`` at Hymba's head (D = 1600, C = 32,001, bf16, 65,536
   rows); in bf16, each kernel's SIMT and tensor-core variants timed in
   turns, with achieved TFLOP/s and share of the bound;
LM-2. the LM homogenization round at full width (``repro_torch.lmpath``:
   Hymba-1.5B on 4 ring nodes, 64 public and 16 private sequences of
   2048 tokens per node): wall time, each kernel's launches (every
   ``flash_attention`` and ``head_select`` launch must go through the
   tensor-core variant, every ``ssd_scan`` call must launch its kernels)
   and device time, kept fraction, thresholds,
   finite and well-formed labels; the kernels against their plain
   versions on activations captured from the round's first microbatch (a
   global and a windowed attention layer, an SSD layer, the head pass's
   features, beside ``torch.matmul``'s time for the product alone); and
   the same round at a reduced Hymba on the card against the CPU's plain
   path (thresholds, masks and labels);
   LM-1 also holds the two backward kernels to their plain versions at
   Hymba's training shapes (2 sequences of 2048 + 128 meta tokens):
   ``flash_attention``'s (global and windowed; the SIMT kernel in f32,
   the bf16 tensor-core kernel against the plain version that rounds P
   and dS to bf16 as it does element by element, within twice that
   version's own excess when lse moves by one f32 ulp, and against it and
   the f32 one no farther than twice
   ``scaled_dot_product_attention``'s backward; its SIMT and
   tensor-core variants timed in turns beside SDPA's backward) and
   ``ssd_scan``'s (four passes over tiles, in float64, and at
   Mamba-2-780M's N = 128); and, for the dense family, both flash
   kernels at head_dim 96 (Phi-3-mini: B 8 x 2048 tokens x 32/32 heads
   forward, B 2 training forward and backward, a ragged S with a window;
   f32 on the SIMT kernels, bf16 on the tensor cores, by the same rules)
   and ``head_select`` at Qwen3-1.7B's tied head and Phi-3-mini's;
LM-3. the one-shot round (``msp_select`` on (n, P, S, V) logits) on the
   first 8 public sequences, held against the streaming round, and
   ``msp_select`` against its plain version on that round's logits;
LM-4. decentralized training with IDKD at full width
   (``repro_torch.lmpath.train``: Hymba-1.5B on 4 ring nodes, 2 plain
   QG-DSGDm-N steps, the round, 2 sparse-KD steps): step and round wall
   times, peak memory, the loss history, each kernel's forward and
   backward launches per step; every loss finite, every parameter leaf
   of every node given a finite non-zero gradient, the backward kernels
   launched nodes x layers times a plain step (twice that a KD step),
   every bf16 attention backward on the tensor cores, and a reduced
   Hymba trained the same 4 steps on the card and on the CPU to the same
   params;
LM-5. the same for Qwen3-1.7B, the reference CLI's default arch
   (``lmpath.QWEN3_TRAIN``: 4 ring nodes, 1 private and 2 public
   sequences per node and step; tied head, qk-norm, head_dim 128);
LM-6. the same for Phi-3-mini (``lmpath.PHI3_TRAIN``: 2 ring nodes),
   every attention launch on the tensor-core kernels at head_dim 96; then
   the four dense configs (Qwen3-1.7B, Phi-3-mini at head_dim 96,
   Qwen1.5-0.5B, Mistral-Nemo-12B) at ``reduced()`` in f32, one plain and
   one KD step each on the card and on the CPU to the same params;
LM-7. MusicGen-medium's decentralized train step at full width
   (``lmpath.train_steps`` with ``lmpath.MUSICGEN_TRAIN``: 4 ring nodes,
   48 layers, 4 codebooks, 2 sequences of 1500 frames per node,
   cross-attention to 64 conditioning vectors, 3 steps): each step's
   wall time and loss, peak memory, the flash launches by kernel, mode
   and variant; every loss finite, every leaf of every node given a
   finite non-zero gradient, the params moved, every flash launch `tc`
   at head_dim 64 and each mode's launches what the layer loop implies
   (nodes x layers x 2 forward, with the recompute, and nodes x layers
   backward, a step); then the reduced MusicGen (2 layers, Sk 8, f32)
   one step on the card and on the CPU to the same params. LM-1 holds
   both flash kernels' non-causal mode (cross-attention) to their plain
   versions first: at MusicGen's layer (B 2, Sq 1500, Sk 64, 24/24 x 64;
   SIMT in f32, tc in bf16, forward and backward, timed beside SDPA), at
   a multi-tile ragged key set longer than the queries with GQA (B 1,
   Sq 333, Sk 700, 8/2 x 64), and MusicGen's causal self-attention
   (B 2, S 1500).
LM-8. PaliGemma-3B's decentralized train step and prefill at full width
   (``lmpath.train_steps`` with ``lmpath.PALIGEMMA_TRAIN``: 4 ring nodes,
   18 layers, 8/1 heads x 256, tied head over 257,216 tokens, 2
   sequences of 256 patch embeddings + 256 text tokens per node under
   the prefix-LM mask, 3 steps): each step's wall time and loss, peak
   memory, the flash launches by kernel, mode and variant; every loss
   finite, every leaf of every node given a finite non-zero gradient,
   the params moved, every flash launch a tc "prefix" launch at head_dim
   256, nodes x layers x 2 forward and nodes x layers backward a step;
   then one prefill (``launch.steps.make_prefill_step``, no grad) on the
   final params: (4, 2, 256, 257,216) finite logits from nodes x layers
   forward launches that write no log-sum-exp; then the reduced
   PaliGemma with its prefix cut to the 8 patches (f32), one step on the
   card and on the CPU to the same params. LM-1 holds both flash kernels
   at head_dim 256 with the prefix-LM mask to their plain versions
   first, forward and backward, timed beside SDPA with the same boolean
   mask: PaliGemma's layer (B 2, S 512, prefix 256, 8/1 x 256; SIMT in
   f32, tc in bf16, in turns), the same shape causal, a prefix ending
   mid-tile with GQA (B 1, S 333, prefix 200, 8/2 x 256) and a prefix
   past the sequence (S 200, prefix 300).

LM-9. the LM baselines at full width: ``lmpath.TRAIN``'s Hymba-1.5B
   setting (4 ring nodes, 2 x 2048 tokens a node, lr 0.1) with
   centralized SGD, D² and gradient tracking, 2 steps each through
   ``lmpath.train_steps``: step times, losses and peak memory; every
   loss finite, the params moved, every flash launch tc, flash and
   ``ssd_scan`` launched nodes x layers times backward and twice that
   forward a step, the peak under 72 GiB; then a reduced Hymba trained
   with each (2 plain steps, the round, 2 KD steps) on the card and on
   the CPU with the same draws, to the same params and losses.
LM-10. DeepSeek-V3 at full width (``lmpath.DEEPSEEK_ROUND_CONFIG``:
   d_model 7168, 128 heads of multi-head latent attention at qk 192 /
   v 128, all 256 routed experts top-8 with the sigmoid router and a
   shared expert, vocabulary 129,280; 2 layers, 2 ring nodes, 13.94 B
   parameters a node filled in place): one homogenization round and one
   prefill of 1 x 2048 tokens a node; wall times, kept fraction,
   head_select's launches at D 7168, C 129,280, the flash launches (all
   tc, MLA mode), the share of MoE assignments dropped past capacity,
   the peak. LM-1 first holds flash's MLA mode to its plain version
   (both kernels, forward and backward: bf16 tc at LM-10's layer, B 8 x
   2048 x 128 heads, timed beside SDPA; f32 SIMT at (192, 128) and
   (48, 32); a ragged S) and ``head_select`` at DeepSeek's head.
LM-11. DeepSeek-V3 trained with IDKD (``lmpath.DEEPSEEK_TRAIN``: the
   same widths with 16 routed experts, the one width cut, and MTP; 2
   ring nodes, 2 plain steps, the round, 2 KD steps) by LM-4's checks,
   each step's aux loss printed; then the reduced DeepSeek-V3 (MLA 48 /
   32, MTP) and Arctic trained the same 4 steps on the card and on the
   CPU with the same draws, to the same params and losses.
LM-12. Arctic's prefill at full width (``lmpath.ARCTIC_PREFILL_CONFIG``:
   128 experts top-2 with the softmax router and the dense residual, 1
   layer, 14.07 B parameters): 2 x 2048 tokens, its wall time and peak.
GOSSIP (after RESIL). compressed, delayed and straggler gossip on the
   main path at full width (16 ring nodes, 30 plain steps, the round,
   30 KD steps): the plain run, then top-k 1%, random-k 1%, top-k 1%
   delayed, uncompressed delayed, and two stale stragglers over [15,
   30); accuracy, NLL, ms a step, peak, the ledger's bytes (exact
   against the payload formula, stale senders at 0) and the EF
   residual; final accuracy within a band of the plain run's, the
   stragglers' rows frozen over their window, every ``head_select``
   launch SIMT; gather (Florentine), roll and auto against dense, top-k
   at frac 1 against the dense mix, the stateful uncompressed mixer
   bitwise the plain one, and a mixer step on the card against the CPU
   (payload indices equal, x̂ within 1e-6);
SHARD (after GOSSIP). the sharded driver (``driver_mode="shard"``) on 4
   ranks that share the card (gloo, CUDA tensors staged through the
   host): the main path at full width cut to 30 plain steps, the round,
   30 KD steps, (a) on the 1-D node mesh and (b) on the 2 x 2
   federation mesh (``model_parallel`` 2, the vocab-sharded round
   through ``head_select``'s SIMT raw_stats mode), (c) on the complete
   graph (10 + round + 10 steps), and with top-k 1% gossip (d) on the
   1-D ring, (e) delayed on the complete graph and (f) on the 2 x 2
   mesh (10 + round + 10 steps each), each against the node-stacked
   run from the same params, draws and wire, both in deterministic
   mode: params at the round and at the end ((a) to (c)), accuracy, and
   the sharded round against the node-stacked round on the same params;
   the top-k cases also one mixer step and TRAJ_STEPS steps from the
   round's state against the node-stacked ones; RelaySGD,
   churn and wire faults refused first; wall time a step, each rank's
   peak; then (a) with durable snapshots: snapshotted at every boundary
   (rank 0 writes the whole federation), crashed 5 steps past the round
   and resumed, equal to the uninterrupted sharded run within SHARD's
   bound on every rank, and its snapshot resuming the node-stacked run,
   which ends within that bound of the node-stacked run;
LM-13. the LM round at Hymba-1.5B's width with ``model_parallel`` 2 on 2
   ranks (every ``head_select`` launch the tensor-core raw_stats mode)
   against the unsharded round on the same params; phase 2 and LM-1
   also hold both raw modes to their plain versions.
LM-14. Hymba-1.5B x 4 trained with top-k 1% delayed gossip at full
   width (``run_training``, the auto backend: the roll mixer), 3 plain
   steps: seconds a step, peak (under 72 GiB), the ledger's bytes
   against the uncompressed bytes, the EF residual, every loss finite;
   then a reduced Hymba with the same wire on the card and on the CPU
   (top-k near-ties replayed), params and losses within 1e-5.
SERVE (after LM-14). the serving path at full width: (a)
   ``launch.serve.BatchedServer`` on Qwen3-1.7B in bf16, 8 requests
   drawn as the reference's CLI draws them on 4 slots, prompts of 64
   tokens (cut from 128 for time), 64 new tokens, a cache of 256 (2
   waves of 128 decode steps):
   every request answered with 64 tokens in the vocabulary, request 0's
   prompt alone twice the same tokens; decode ms a step beside a step's
   bytes bound, tokens/s, peak; (b) ``decode_step`` against ``forward``
   in f32, token by token (steps 2 to S replayed from a CUDA graph of
   the step), at the reference test's tolerances (2e-2 dense, 5e-2 MLA,
   SSM, MusicGen): Qwen3-1.7B, Mamba-2-780M (each layer's decode SSM
   state against the forward's ``ssd_scan`` final state), MusicGen-medium
   (4 codebooks, a memory), DeepSeek-V3 (2 layers, 256 experts, capacity
   factor E / k: no drops; a routing near-tie left out), Mistral-Nemo-12B
   sw4096 cut to 1 layer over 4160 tokens (the ring wraps) and Hymba-1.5B
   with no meta tokens over 1032 (past its window), each error printed;
   (c) ``flash_attention``'s offset mode (q_offset, kv_valid_len)
   against its plain version (Qwen3's chunked prefill of 512 at 1536 over
   2048, a decode-shaped call with valid lengths 1 to 2048, Hymba's
   windowed layer at 1100) in bf16 and f32, timed beside its bound, the
   plain version and SDPA with the same boolean mask, and against
   ``attention_decode`` on (a)'s caches; (d) ``ssd_scan``'s initial /
   final state mode at Hymba's and Mamba-2's shapes, y, h_T and the
   continuation over a split, by the float64 rule, timed.
LM-4 dots (after LM-4). Hymba-1.5B under remat_policy "dots" (each
   layer's projections saved, the rest recomputed): one node's loss and
   gradients at full width against per-layer recompute's, leaf by leaf,
   within twice the distance between two per-layer recompute runs (or
   one bf16 ulp of the leaf's largest gradient where those agree
   bitwise); then 2 plain steps at the first of 4, 3, 2 ring nodes that
   fits under 72 GiB, and under per-layer recompute at the same count:
   step times and peaks, the losses equal to bf16 rounding, every flash
   and SSD kernel launched (flash on the tensor cores).
DRYRUN (last). the dry run (``launch.dryrun``) on the meta device over
   the single-pod production mesh (data 16 x model 16): one arch of each
   family at decode_32k (Qwen3-1.7B, Mamba-2-780M, Hymba-1.5B,
   DeepSeek-V3; the rest and train_4k left out for time), argument and
   temp GiB a device and the dominant roofline term each; then the
   estimate held to the card: a Qwen3-1.7B bf16 train step of one node
   (1 x 2048 tokens) on ``make_host_mesh(1, 1)``, argument bytes equal
   to its inputs' bytes and within 1% of the allocator's rise, its peak
   within 0.5-2x of argument plus temp bytes (the ratio printed). Its
   traces on the meta device run in a thread while ``nvcc`` builds the
   kernels (phase 1); the phase prints them and runs the card's step.

Each phase prints its seconds. It then prints one ``{"kernels": [...]}``
line and, last, one line ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.

``python3 chip_smoke.py --shard-norm-fault`` runs the device phase and
then only SHARD (b), sound and with a planted fault (QG-DSGDm-N's norm
counting each model-replicated leaf twice), and prints how far each run
lies from the node-stacked one; SHARD's bounds sit between the two.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Tolerances of a kernel against its plain version, both in f32 math on
# the same inputs; the sums run in another order (a D-long dot product,
# a C-long exp sum), a few ulp of the values involved. Class indices
# must match except where the two logits are within IDX_TIE of each
# other (a near-tie the summation order may flip).
ATOL, RTOL, IDX_TIE = 1e-4, 1e-5, 1e-4
THRESH_ATOL = 1e-5           # streaming vs one-shot round thresholds
QUICKSTART_FLOOR = 0.75      # on the CPU the port reaches 0.854 and the
                             # reference 0.904 (see PERF.md)
MAIN_ACC_FLOOR = 0.3         # the full-width main path's final consensus
                             # accuracy (chance is 0.1; see PERF.md)
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's own
                             # kernel tolerances: a few f32 ulp of the
                             # output, one bf16 ulp where it rounds to bf16
SSD_VS_F32 = 4.0             # ssd_scan's max error against the plain
                             # version in float64 may be at most this many
                             # times that of the plain version in float32,
                             # plus SSD_ATOL: its decays exp(cum_t - cum_u)
                             # difference two cumulative sums of up to 256
                             # log-decays (|cum| ~ 1e4 at A = 50), so any
                             # f32 summation order carries |cum|·eps
                             # relative error; the kernel must be no less
                             # exact than the plain f32 computation
SSD_ATOL = 1e-5
LM_CHECK_ATOL, LM_CHECK_RTOL = 1e-6, 1e-4   # reduced head pass, card vs
                             # CPU: conf and label values after 3 f32 layers
MASK_BAND = 1e-5             # one-shot (bf16 logits) vs streaming (f32
                             # logits) D_ID masks may differ only for
                             # sequences this close to the threshold
FLASH_BWD_RTOL = 1e-4        # flash backward: each gradient's error
                             # against the plain version, of its max
                             # |value| (sums of up to S products reordered,
                             # in f32 either way); in bf16, plus two bf16
                             # ulps of the element's own |value| (each side
                             # rounds its f32 sum to bf16)
FLASH_BWD_TC_FLIP = 2.0      # the bf16 tensor-core flash backward rounds
                             # P and dS to bf16 as its tensor-core
                             # operands: against the plain version with
                             # the same rounding points, each element
                             # within FLASH_BWD_RTOL's rule, or, where the
                             # plain version itself breaks that rule when
                             # lse moves by one f32 ulp (a one-ulp f32
                             # difference before a bf16 rounding moves a
                             # term by a bf16 ulp), within this many times
                             # its worst excess (the kernel's P also comes
                             # from exp2 of an f32 argument and f32 sums
                             # in another order, each a few ulps off)
FLASH_BWD_TC_VS_SDPA = 2.0   # and, beside it, each gradient's max error
                             # against that plain version and against the
                             # f32 one at most this many times that of
                             # SDPA's backward (which rounds P and dS to
                             # bf16 too) on the same inputs
LSE_RTOL = 1e-5              # the training forward's row log-sum-exp
                             # against the plain masked logsumexp, of
                             # max(1, max |lse|)
SSD_BWD_ATOL = 1e-5          # ssd_scan's backward: the float64 rule above,
                             # its additive term relative to each
                             # gradient's max |value| (ddta sums over S)
TRAIN_PARAM_ATOL = 1e-5      # reduced Hymba (f32) trained 4 steps on the
TRAIN_LOSS_RTOL = 1e-5       # card and on the CPU: consensus params and
                             # the loss history (see phase_lm_train)
RELU_TIE = 1e-5              # ResNet card vs CPU: a ReLU input within
                             # this share of max(1, max |x|) over its call
                             # of 0 may fall on either side of it in the
                             # two f32 runs (convolutions summed in another
                             # order, their rounding in proportion to the
                             # activations' scale: an absolute 1e-5 failed
                             # at 1.03e-5 in GOSSIP's 3-step check at full
                             # width); the CPU run takes the card's branch
                             # there, and fails on any other flip
TRAIN_PEAK_GIB = 72.0       # LM-4's to LM-9's peak device memory
                             # budget
CONSENSUS_RTOL = 1e-5        # GRID: centralized SGD's nodes, identical at
                             # init and averaged exactly, stay within this
                             # share of the params' norm of each other
GRID_METHODS = ("sgd-centralized", "dsgd", "relay-sgd", "qg-dsgdm-n+kd",
                "d2", "gradient-tracking")
GRID_STEPS, GRID_ROUND, GRID_EVAL = 120, 60, 30
PAPER_STEPS = 200            # PAPER: each cell's depth (the harness's
                             # own is 300; at 120 the noise cell's KD
                             # phase has not recovered its NLL spike)
PAPER_ALPHA = 0.05           # PAPER: Table 2's most skewed column
PAPER_NLL_MARGIN = 0.05      # PAPER: a final eval NLL within this of ln 10
                             # (10 classes) is a constant predictor
RESIL_STEPS, RESIL_ROUND, RESIL_EVAL = 100, 50, 20   # RESIL: depth, round
RESIL_CHURN = (5, 40, 60)    # RESIL: node 5 frozen over [40, 60)
RESIL_REWIRE = (70, "exponential")
RESIL_DROP = (3, 15, 25)     # RESIL: node 3's payloads dropped over [15, 25)
RESIL_CRASH = 80             # RESIL: after the snapshot at 80
RESIL_CORRUPT = (7, 85, 95)  # RESIL: node 7's payloads nan, detected
RESIL_SHORT = 30             # RESIL: depth of the default-mode pair and
                             # the drop/corrupt/rollback runs
LM_BASELINES = ("centralized", "d2", "gradient-tracking")
GOSSIP_STEPS, GOSSIP_ROUND, GOSSIP_EVAL = 60, 30, 15   # GOSSIP: depth,
                             # SHARD's 30 + round + 30
GOSSIP_STALE = ((3, 11), 15, 30)   # GOSSIP (e): nodes 3 and 11 stale
                             # over [15, 30)
GOSSIP_CASES = (("plain", None, "sync", False),
                ("a top-k 1% sync", ("topk", 0.01), "sync", False),
                ("b random-k 1%", ("randk", 0.01), "sync", False),
                ("c top-k 1% delayed", ("topk", 0.01), "delayed", False),
                ("d uncompressed delayed", None, "delayed", False),
                ("e stale stragglers", None, "sync", True))
GOSSIP_ACC_BAND = 0.1        # GOSSIP (and SHARD's top-k cases): each
                             # run's final consensus accuracy against the
                             # uncompressed (node-stacked) run's; at this
                             # depth every run sits near chance (0.096 to
                             # 0.156 on one H100, deltas 0.030-0.061):
                             # the band catches a run that breaks only, so
                             # in GOSSIP it is one-sided: a run fails if
                             # it ends more than the band below the plain
                             # run (random-k 1% has ended 0.086-0.110
                             # above it, learning more than the plain run
                             # at chance, which breaks nothing); SHARD's
                             # sharded-vs-node-stacked pairs, one wire
                             # each, stay two-sided; the exact gates are
                             # TRAJ_STEPS steps and a mixer step from the
                             # round's state (see phase_gossip)
TRAJ_STEPS = 3               # GOSSIP and SHARD: full train steps from the
                             # params, optimizer and comm state captured
                             # at the round, through the host runner
TRAJ_RTOL = 1e-5             # ... their params and x̂ after those steps,
                             # card vs CPU (GOSSIP) and sharded vs
                             # node-stacked (SHARD), as a share of
                             # max(1, max |x|) at the capture: f32 sums
                             # in another order; a payload lost or applied
                             # twice moves x̂ by its value, a top 1% |x − x̂|
TOPK_TIE_RTOL = 1e-5         # a top-k payload replayed from the other run
                             # (_topk_replay) is taken where the row's
                             # least selected |x − x̂| lies within this
                             # share of max(1, the row's largest) below
                             # its largest unselected one (the two runs
                             # break a near-tie differently); any other
                             # difference fails
GOSSIP_MIX_ATOL = 1e-6       # GOSSIP: a backend against dense, and a
                             # mixer step card vs CPU (x̂), on the run's
                             # f32 params (f32 sums in another order)
LM14_STEPS = 3               # LM-14: plain steps (PERF.md's reckoning)
SHARD_RANKS = 4              # SHARD: ranks sharing the card (gloo)
SHARD_STEPS, SHARD_ROUND = 60, 30   # SHARD: 30 plain steps, the round,
                             # 30 KD steps (ring, 1-D and 2 x 2)
SHARD_SNAP_CRASH = 5         # SHARD (a)'s snapshot run: a crash this many
#                              steps past the round, after a snapshot at
#                              every eval boundary and the crash's own
SHARD_SHORT_STEPS, SHARD_SHORT_ROUND = 20, 10   # SHARD's complete-graph
                             # and top-k cases
TOPK = ("topk", 0.01)        # the compressed wire of SHARD and GOSSIP
# (name, graph, model_parallel, steps, round, compression, gossip)
SHARD_CASES = (("a ring 1-D", "ring", 1, SHARD_STEPS, SHARD_ROUND, None,
                "sync"),
               ("b ring 2x2", "ring", 2, SHARD_STEPS, SHARD_ROUND, None,
                "sync"),
               ("c complete 1-D", "full", 1, SHARD_SHORT_STEPS,
                SHARD_SHORT_ROUND, None, "sync"),
               ("d ring 1-D top-k", "ring", 1, SHARD_SHORT_STEPS,
                SHARD_SHORT_ROUND, TOPK, "sync"),
               ("e complete 1-D top-k delayed", "full", 1, SHARD_SHORT_STEPS,
                SHARD_SHORT_ROUND, TOPK, "delayed"),
               ("f ring 2x2 top-k", "ring", 2, SHARD_SHORT_STEPS,
                SHARD_SHORT_ROUND, TOPK, "sync"))
SHARD_MIX_YTOL = 1e-5        # SHARD top-k: the mixed params of one sharded
                             # mixer step against the node-stacked one on
                             # the same state (the complete graph's
                             # replicated sum carries its own rounding)
SHARD_PARAM_ATOL = 1e-2      # SHARD vs the node-stacked run, both in
                             # deterministic mode: the sharded mix and the
                             # global sums add in another order (~1e-7 a
                             # step), which 30 + round + 30 steps at lr
                             # 0.5 grow to up to 6.4e-4 (one H100), not
                             # bitwise; this end-of-run bound catches
                             # gross faults only: a norm counting the
                             # replicated leaves twice ended 1.93e-3 away
                             # (--shard-norm-fault)
SHARD_CAP_ATOL = 8e-5        # ... params at the round, after the 30
                             # plain steps: sound runs 1.2e-6 to 1.07e-5,
                             # the planted norm fault 5.99e-4 (one H100,
                             # --shard-norm-fault); the bound near the
                             # geometric mean, ~7.5x from each
SHARD_ACC_ATOL = 0.03        # ... and the consensus accuracy at each eval
                             # (1024 test images; 0.0146 apart at the end
                             # when measured on one H100)
LM13_PUBLIC = 16             # LM-13: public sequences (LM-2 takes 64)
RAW_Z_RTOL = 1e-4            # head_select raw_stats: z, the sum of exp
                             # over a slice (16,001 columns at Hymba's),
                             # relative: the tc kernel takes ex2.approx
                             # and sums in its own order (at the finalized
                             # conf = 1/z that is far inside ATOL)
LM_DOTS_NODES = (4, 3, 2)    # LM-4 under remat "dots": the first node
#                              count whose "dots" run fits under
#                              TRAIN_PEAK_GIB (Hymba saves ~49 KB a token
#                              and a layer more than per-layer recompute)
LM_DOTS_STEPS = 2            # ... plain steps of each policy
BF16_LOSS_RTOL = 2 ** -8     # ... the two policies' losses: bf16 rounding
DOTS_NOISE_MULT = 2          # LM-4 dots' gradients, one node, per leaf:
#                              "dots" within this many times the distance
#                              between two per-layer recompute runs (the
#                              card's run-to-run noise), or within one
#                              bf16 ulp of the leaf's largest gradient
#                              where those two runs agree bitwise
DRYRUN_SHAPE = "decode_32k"  # DRYRUN's shape (1-4 s an arch; a
#                              train_4k trace takes ~11 s, past the
#                              script's budget: the card check's train
#                              step stands for it) ...
DRYRUN_ARCHS = ("qwen3-1.7b", "mamba2-780m", "hymba-1.5b",
                "deepseek-v3-671b")   # ... for one arch of each family
#                              (dense, SSM, hybrid, MoE + MLA): the budget's
#                              subset; `--all` runs every one
DRYRUN_HOST_TOKENS = 2048    # DRYRUN: the card's Qwen3-1.7B step, one
#                              sequence of this length on one card
DRYRUN_ARG_RTOL = 0.01       # ... argument bytes against the allocator
DRYRUN_PEAK_BAND = (0.5, 2.0)   # ... peak over argument + temp bytes
SERVE_REQUESTS, SERVE_SLOTS = 8, 4   # SERVE (a): the reference CLI's
                             # default requests and slots
# The serving phase's time cuts, in the order the budget (SERVE at most
# 90 s, the whole script at most 1050 s) allows them: the whole script
# took 1070.5 s with SERVE at 89.0 s (one H100, 700 W), so all three are
# made: Hymba's S 1040 -> 1032, Mistral's depth 2 -> 1, (a)'s prompt
# 128 -> 64.
SERVE_PROMPT, SERVE_NEW, SERVE_CONTEXT = 64, 64, 256   # SERVE (a)
SERVE_MISTRAL_LAYERS = 1     # SERVE (b): Mistral-Nemo sw4096's depth cut
SERVE_MISTRAL_S = 4160       # ... 64 positions past its 4096 window
SERVE_HYMBA_S = 1032         # SERVE (b): Hymba, 8 past its 1024 window
SERVE_STATE_RTOL = 1e-3      # SERVE (b): Mamba-2's decode SSM state after
                             # S tokens against the forward's ssd_scan final
                             # state, each layer, of max(1, max |h|): both
                             # f32, but each layer's input carries the
                             # earlier layers' decode-vs-forward differences
SERVE_DEEPSEEK_CF = 256 / 8  # SERVE (b), DeepSeek-V3: capacity factor
                             # E / k, capacity int(cf * T * k / E) + 1 =
                             # T + 1, so
                             # the forward drops no assignment (decode, a
                             # token at a time, drops none; the reference
                             # test's precondition). At its 8, 32 tokens
                             # dropped 5.47% at full width (one H100)
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM
H100_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 FMA units;
                                                      # bf16 tensor cores


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def timed(fn, reps: int, torch):
    """Mean device ms of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sms(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def in_turns(simt, tc, reps: int, torch):
    """Device ms of two variants of one kernel, timed simt, tc, tc, simt
    on the same inputs; each the mean of its two turns."""
    a1, b1 = timed(simt, reps, torch), timed(tc, reps, torch)
    b2, a2 = timed(tc, reps, torch), timed(simt, reps, torch)
    return (a1 + a2) / 2, (b1 + b2) / 2


def variants_line(what, simt_ms, tc_ms, flops, bnd):
    return (f"{what}: simt {simt_ms:.4f} ms ({flops / simt_ms / 1e9:.1f} "
            f"TFLOP/s, {bnd / simt_ms:.2%} of the bound), tc {tc_ms:.4f} ms "
            f"({flops / tc_ms / 1e9:.1f} TFLOP/s, {bnd / tc_ms:.2%} of the "
            f"bound), in turns; tc {simt_ms / tc_ms:.1f}x faster")


# ------------------------------------------------------------------ phases
def phase_device(torch, build):
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmuls and cuDNN convolutions (full f32)")
    t0 = time.perf_counter()
    secs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in build.KERNELS:
        log = build.lib_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "arning",
                                           "Performance")):
                    print(f"  {name}: {line.strip()}")


def _compare(torch, out, ref, logits, what):
    """Max error of (conf, vals) and the near-tie-tolerant idx check."""
    (c, v, i), (cr, vr, ir) = out, ref
    err = 0.0
    for a, b in ((c, cr), (v, vr)):
        d = (a - b).abs()
        check(bool((d <= ATOL + RTOL * b.abs()).all()),
              f"{what}: max error {float(d.max()):.3g} over tolerance")
        err = max(err, float(d.max()))
    diff = i != ir
    ties = int(diff.sum())
    if ties:
        li = torch.gather(logits, -1, i.long())
        lr = torch.gather(logits, -1, ir.long())
        gap = float((li - lr).abs()[diff].max())
        check(gap <= IDX_TIE, f"{what}: {ties} class indices differ with "
                              f"logit gap {gap:.3g}")
    return err, ties


def phase_kernels(torch, ops):
    from repro_torch.kernels.head_select import ops as head_ops
    head_select, head_plain, msp_select, msp_plain = ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    results = {"head_select": [], "msp_select": []}
    # (label, L, N, D, C, k, reps): main path (per-microbatch head pass,
    # the k=1 validation pass) and the LM head
    shapes = [("main", 16, 256, 64, 10, 8, 100),
              ("main_k1", 16, 256, 64, 10, 1, 100),
              ("lm_head", 1, 512, 2048, 151936, 8, 3)]
    for label, L, N, D, C, k, reps in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            h = torch.randn((L, N, D), generator=gen, device=dev)
            w = torch.randn((L, D, C), generator=gen, device=dev) / D ** 0.5
            b = 0.1 * torch.randn((L, C), generator=gen, device=dev)
            h, w = h.to(dtype), w.to(dtype)
            logits = torch.matmul(h.float(), w.float()) + b[:, None, :]
            # msp_select's main-path input is the (n·P, C) public logit
            # stack of the one-shot round: 16 nodes × 2048 samples
            x = (torch.randn((16 * 2048, C), generator=gen, device=dev) * 4
                 if label.startswith("main") else
                 logits.reshape(-1, C)).to(dtype)
            xf = x.float()
            for det in ("msp", "energy"):
                kw = dict(temperature=10.0, k=k, detector=det)
                tag = f"{label} {dname} {det} k={k}"
                hb = (2 if dtype == torch.bfloat16 else 4)
                nbytes = (L * N * D + L * D * C) * hb + L * C * 4 \
                    + L * N * (4 + 8 * k)
                bnd, by = bound_ms(nbytes, 2.0 * L * N * D * C, dname)
                out = head_select(h, w, b, **kw)
                ref = head_plain(h, w, b, **kw)
                err, ties = _compare(torch, out, ref, logits,
                                     f"head_select {tag}")
                ms = timed(lambda: head_select(h, w, b, **kw), reps, torch)
                pms = timed(lambda: head_plain(h, w, b, **kw), reps, torch)
                results["head_select"].append(dict(
                    shape=label, dtype=dname, detector=det, k=k, err=err,
                    ties=ties, ms=ms, plain_ms=pms, bound_ms=bnd,
                    bound_by=by))
                if dname == "bfloat16" and det == "msp":
                    sms, tms = in_turns(
                        lambda: head_ops._launch("simt", h, w, b, **kw),
                        lambda: head_ops._launch("tc", h, w, b, **kw),
                        max(1, reps // 2), torch)
                    split = head_ops._column_splits(L, N, C, D, _sms(torch))
                    print(variants_line(
                        f"head_select {tag} variants (column split "
                        f"{split[1]})", sms, tms, 2.0 * L * N * D * C, bnd))
                print(f"head_select {tag}: max_abs_err {err:.3g} "
                      f"(tol {ATOL}+{RTOL}|ref|), idx near-ties {ties}; "
                      f"{ms:.4f} ms, bound {bnd:.4f} ms ({by}), "
                      f"plain {pms:.4f} ms")
                n_rows = x.shape[0]
                nbytes = n_rows * C * hb + n_rows * (4 + 8 * k)
                bnd, by = bound_ms(nbytes, 4.0 * n_rows * C, "float32")
                out = msp_select(x, **kw)
                ref = msp_plain(x, **kw)
                err, ties = _compare(torch, out, ref, xf,
                                     f"msp_select {tag}")
                ms = timed(lambda: msp_select(x, **kw), reps, torch)
                pms = timed(lambda: msp_plain(x, **kw), reps, torch)
                results["msp_select"].append(dict(
                    shape=label, dtype=dname, detector=det, k=k, err=err,
                    ties=ties, ms=ms, plain_ms=pms, bound_ms=bnd,
                    bound_by=by))
                print(f"msp_select {tag} rows={n_rows}: max_abs_err "
                      f"{err:.3g}, idx near-ties {ties}; {ms:.4f} ms, "
                      f"bound {bnd:.4f} ms ({by}), plain {pms:.4f} ms")
            del h, w, b, logits, x, xf
            torch.cuda.empty_cache()
    # the raw_stats mode at SHARD (b)'s head pass: 8 local nodes x 256
    # rows, one 5-wide slice of C = 10 (k_loc 5; 1 for the val pass),
    # and an all-padding slice
    results["head_select_raw_simt"] = [
        _raw_row(torch, gen, "resnet slice", 8, 256, 64, 5, 5,
                 torch.float32, 100),
        _raw_row(torch, gen, "resnet slice k=1", 8, 256, 64, 5, 1,
                 torch.float32, 100),
        _raw_row(torch, gen, "all-padding slice", 8, 256, 64, 5, 5,
                 torch.float32, 20, pad=5)]
    return results


def _raw_row(torch, gen, label, L, N, D, C, k, dtype, reps, *, pad=0):
    """head_select's raw_stats mode (the vocab-sharded round's per-slice
    carry) against head_select_stats_plain on one vocabulary slice of C
    columns whose last ``pad`` are zero weights with a NEG bias (as the
    round pads C; ``pad == C`` is an all-padding slice, where m is NEG
    and z the slice's width): m and the top-k logits within ATOL +
    RTOL|ref|, z within RAW_Z_RTOL relative, indices equal except near-ties within IDX_TIE and the
    padding slots (which never win the merge). Timed beside the bound
    and the plain version; no one PyTorch call computes the carry."""
    from repro_torch.kernels.head_select import (head_select,
                                                 head_select_stats_plain)
    dev, dname = "cuda", str(dtype).split(".")[-1]
    h = torch.randn((L, N, D), generator=gen, device=dev).to(dtype)
    w = torch.randn((L, D, C), generator=gen, device=dev) / D ** 0.5
    b = 0.1 * torch.randn((L, C), generator=gen, device=dev)
    if pad:
        w[..., C - pad:] = 0.0
        b[..., C - pad:] = -1e30
    w = w.to(dtype)
    out = head_select(h, w, b, k=k, raw_stats=True)
    ref = head_select_stats_plain(h, w, b, k=k)
    tag = f"head_select raw {label} L={L} rows={L * N} D={D} C={C} {dname} k={k}"
    err = 0.0
    for name, a, r in zip(("m", "z", "tv"), out[:3], ref[:3]):
        d = (a - r).abs()
        tol = RAW_Z_RTOL * r.abs() if name == "z" else ATOL + RTOL * r.abs()
        check(bool((d <= tol).all()),
              f"{tag}: {name} max error {float(d.max()):.3g} over tolerance")
        err = max(err, float(d.max()))
    zrel = float(((out[1] - ref[1]).abs() / ref[1]).max())
    real = ref[2] > -1e29
    diff = (out[3] != ref[3]) & real
    ties = int(diff.sum())
    if ties:
        logits = torch.matmul(h.float(), w.float()) + b[:, None, :]
        gap = (torch.gather(logits, -1, out[3].long())
               - torch.gather(logits, -1, ref[3].long())).abs()[diff]
        check(float(gap.max()) <= IDX_TIE, f"{tag}: {ties} indices differ "
                                           f"with logit gap {float(gap.max()):.3g}")
        del logits
    if pad == C:
        check(bool((out[0] == -1e30).all() and (out[1] == C).all()),
              f"{tag}: the all-padding slice's m / z are not NEG / {C}")
    hb = 2 if dtype == torch.bfloat16 else 4
    nbytes = (L * N * D + L * D * C) * hb + L * C * 4 + L * N * (8 + 8 * k)
    bnd, by = bound_ms(nbytes, 2.0 * L * N * D * C, dname)
    ms = timed(lambda: head_select(h, w, b, k=k, raw_stats=True), reps,
               torch)
    pms = timed(lambda: head_select_stats_plain(h, w, b, k=k),
                max(1, reps // 2), torch)
    print(f"{tag}{f' (last {pad} columns padding)' if pad else ''}: "
          f"max_abs_err {err:.3g} (tol {ATOL}+{RTOL}|ref|; z {zrel:.3g} "
          f"relative, tol {RAW_Z_RTOL}), idx near-ties "
          f"{ties}; {ms:.4f} ms, bound {bnd:.4f} ms ({by}, {bnd / ms:.2%} "
          f"of it), plain {pms:.4f} ms")
    del h, w, b, out, ref
    torch.cuda.empty_cache()
    return dict(shape=label, dtype=dname, k=k, err=err, ties=ties, ms=ms,
                plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=None)


def phase_main_path(torch, ops):
    from repro_torch.core.idkd import skew_metric
    from repro_torch.mainpath import (EVAL_EVERY, ROUND_STEP, STEPS,
                                      full_width_sim)
    head_select, msp_select = ops[0], ops[2]
    sim = full_width_sim("cuda")

    # per-step and per-round device time, from events around each call
    events = []

    def wrap(fn, tag):
        def timed_call(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            events.append((tag, s, e))
            return out
        return timed_call

    for phase in list(sim.steps):
        sim.steps[phase] = wrap(sim.steps[phase], phase)
    homogenize = sim.homogenize
    sim.homogenize = wrap(homogenize, "round")

    head_select.launches = 0
    head_select.launches_by_variant = {"tc": 0, "simt": 0}
    msp_select.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"head_select": head_select.launches,
                "msp_select": msp_select.launches}
    variants = {"head_select": dict(head_select.launches_by_variant)}

    times = {}
    for tag, s, e in events:
        times.setdefault(tag, []).append(s.elapsed_time(e))
    for tag, ts in times.items():
        warm = ts[1:] if len(ts) > 1 else ts
        print(f"main path {tag}: {len(ts)} calls, first {ts[0]:.2f} ms, "
              f"then mean {sum(warm) / len(warm):.2f} ms "
              f"(min {min(warm):.2f}, max {max(warm):.2f})")
    pre, post = skew_metric(result.pre_hist), skew_metric(result.post_hist)
    print(f"main path: {wall:.1f} s wall, peak {peak:.3f} GiB (the "
          f"simulator's data included), acc {result.acc_history}, "
          f"losses {[round(x, 4) for x in result.loss_history]}, "
          f"id_fraction {result.id_fraction:.4f}, skew {pre:.4f} -> "
          f"{post:.4f}, launches {launches}, by variant {variants}")
    check(all(map(_finite, result.loss_history)), "non-finite eval loss")
    check(launches["head_select"] > 0,
          "head_select was not launched on the main path")
    check(0.0 < result.id_fraction < 1.0,
          f"id_fraction {result.id_fraction} not in (0, 1)")
    check(post < pre, f"class skew did not drop: {pre} -> {post}")
    nll = result.loss_history
    eval_steps = [s for s in range(STEPS)
                  if s % EVAL_EVERY == 0 or s == STEPS - 1]
    before_round = nll[max(i for i, s in enumerate(eval_steps)
                           if s < ROUND_STEP)]
    check(nll[-1] < nll[0], f"eval NLL grew over the run: {nll}")
    check(nll[-1] <= before_round,
          f"eval NLL grew over the KD phase: {before_round} before the "
          f"round, {nll[-1]} at the end")
    check(result.final_acc >= MAIN_ACC_FLOOR,
          f"main path accuracy {result.final_acc} below {MAIN_ACC_FLOOR}")
    print(f"main path learns: eval NLL {nll[0]:.4f} -> {before_round:.4f} "
          f"(last eval before the round) -> {nll[-1]:.4f}, final accuracy "
          f"{result.final_acc:.4f} (floor {MAIN_ACC_FLOOR})")
    sim.homogenize = homogenize
    return sim, result, launches, variants


def _finite(x):
    return x == x and abs(x) != float("inf")


def phase_fused_round(torch, sim, result, ops):
    from repro_torch.core import ood
    msp_select = ops[2]
    params, icfg = result.params, sim.tcfg.idkd
    stream = sim.homogenize(params, icfg)
    fused_cfg = dataclasses.replace(icfg, label_backend="fused",
                                    stream_labels=False)
    msp_select.launches = 0
    t0 = time.perf_counter()
    fused = sim.homogenize(params, fused_cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = msp_select.launches
    check(launches > 0, "msp_select was not launched on the fused round")
    dthr = float((stream.thresholds - fused.thresholds).abs().max())
    check(dthr <= THRESH_ATOL, f"fused vs streaming thresholds differ by "
                               f"{dthr:.3g} > {THRESH_ATOL}")
    conf = ood.confidence(sim.node_logits(params, sim.public_x),
                          icfg.detector)
    differ = stream.id_masks != fused.id_masks
    near = (conf - fused.thresholds[:, None]).abs() <= 1e-5
    check(bool((~differ | near).all()),
          "fused vs streaming D_ID masks differ away from the threshold")
    print(f"fused round: {dt * 1e3:.1f} ms wall, msp_select launches "
          f"{launches}, thresholds max diff {dthr:.3g} (tol "
          f"{THRESH_ATOL}), mask differences {int(differ.sum())} (all "
          f"within 1e-5 of the threshold), id_fraction "
          f"{float(fused.id_masks.float().mean()):.4f}")
    return launches


def phase_quickstart(torch):
    from repro_torch.core.idkd import skew_metric
    from repro_torch.quickstart import run
    t0 = time.perf_counter()
    r = run("cuda")
    print(f"quickstart: {time.perf_counter() - t0:.1f} s, acc "
          f"{[round(a, 4) for a in r.acc_history]}, final "
          f"{r.final_acc:.4f} (floor {QUICKSTART_FLOOR}), skew "
          f"{skew_metric(r.pre_hist):.4f} -> {skew_metric(r.post_hist):.4f}"
          f", kept {r.id_fraction:.4f}")
    check(r.final_acc >= QUICKSTART_FLOOR,
          f"quickstart accuracy {r.final_acc} below {QUICKSTART_FLOOR}")


# ------------------------------------------------------------- LM phases
def phase_grid(torch, ops):
    """GRID: the paper's method grid on the card at the main path's full
    width (``mainpath.grid_sim``: ResNet-20, 16 nodes, α 0.1, batch 32,
    8192 images, 2048 aligned public samples; RelaySGD on a chain, the
    rest on the ring; the grid's lr and weight decay rules), each method
    cut in depth to GRID_STEPS = 120 steps, evaluated every 30, the KD
    method's round at step 60 (``qg-idkd`` is phase 3). Per method: ms
    per step (each step ended by a synchronize; the median after the
    first), final accuracy, consensus distance and peak memory. Fails
    unless every eval loss is finite and the eval NLL falls over the
    run, centralized SGD's nodes stay together (consensus distance
    within CONSENSUS_RTOL of the params' norm), the KD method launches
    ``head_select``, and RelaySGD on a ring raises at construction."""
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.mainpath import grid_config, grid_sim
    head_select = ops[0]
    tcfg, _ = grid_config("relay-sgd", GRID_STEPS)
    tiny = make_classification_data(image_size=32, n_train=64, n_val=8,
                                    n_test=8, seed=0)
    try:
        DecentralizedSimulator(CONFIG, dataclasses.replace(
            tcfg, topology="ring"), tiny, device="cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        fail("GRID: relaysgd on a ring did not raise at construction")
    print(f"GRID: relaysgd on a ring raises: {refusal}")
    launches, variants, rows = 0, {"tc": 0, "simt": 0}, {}
    for method in GRID_METHODS:
        sim = grid_sim(method, GRID_STEPS, GRID_ROUND, GRID_EVAL, "cuda")
        secs = []

        def timed_step(real):
            def step(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                return out
            return step
        for phase in list(sim.steps):
            sim.steps[phase] = timed_step(sim.steps[phase])
        head_select.launches = 0
        head_select.launches_by_variant = {"tc": 0, "simt": 0}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        norm = math.sqrt(sum(float(v.float().pow(2).sum())
                             for v in r.params.values()))
        cons = r.consensus_history[-1]
        warm = sorted(secs[1:])
        ms = 1e3 * warm[len(warm) // 2]
        nll = r.loss_history
        rows[method] = dict(ms=ms, acc=r.final_acc, consensus=cons,
                            peak_gib=peak, nll=nll, wall=wall)
        print(f"GRID {method} ({sim.tcfg.algorithm}, "
              f"{sim.gossip_topo.name}, lr {sim.tcfg.lr}, wd "
              f"{sim.tcfg.weight_decay}, kd {sim.kd_mode}): {len(secs)} "
              f"steps, {ms:.2f} ms a step (median after the first; first "
              f"{1e3 * secs[0]:.2f}, mean {1e3 * sum(warm) / len(warm):.2f})"
              f", final accuracy {r.final_acc:.4f}, eval NLL "
              f"{[round(x, 4) for x in nll]}, consensus distance "
              f"{cons:.4g} (params' norm {norm:.4g}), peak "
              f"{peak:.3f} GiB, {wall:.1f} s wall, head_select launches "
              f"{head_select.launches}")
        check(len(secs) == GRID_STEPS,
              f"GRID {method}: {len(secs)} steps ran")
        check(all(map(_finite, nll)), f"GRID {method}: eval NLL {nll}")
        check(nll[-1] < nll[0], f"GRID {method}: eval NLL grew: {nll}")
        if sim.tcfg.algorithm == "centralized":
            check(cons <= CONSENSUS_RTOL * norm,
                  f"GRID {method}: consensus distance {cons:.3g} > "
                  f"{CONSENSUS_RTOL} x params' norm {norm:.3g}")
        if sim.kd_mode is not None:
            check(head_select.launches > 0 and len(r.rounds) == 1,
                  f"GRID {method}: {len(r.rounds)} rounds, "
                  f"{head_select.launches} head_select launches")
        launches += head_select.launches
        for v, c in head_select.launches_by_variant.items():
            variants[v] += c
        del sim, r
    return ({"head_select": launches}, {"head_select": variants}, rows)


def phase_grid_card_vs_cpu(torch):
    """Each new algorithm (centralized, D², gradient tracking, RelaySGD on
    a chain) trains ResNet-8 (``SMALL_CONFIG``, 32 × 32, f32) on 4 nodes
    for 3 steps of the simulator, on the card and on the CPU, from the
    same params (the init is made on the CPU) and the same index draws
    (``_same_draws``), under the grid's lr and weight decay: the final
    node-stacked params within TRAIN_PARAM_ATOL. The CPU run takes the
    card's branch at each ReLU input near 0 by RELU_TIE
    (``_relu_replay``): one such flip passes its whole gradient or none,
    and moves centralized SGD's params at the grid's lr by more than
    TRAIN_PARAM_ATOL (``tests/test_torch_relu_tie.py``)."""
    from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.mainpath import grid_config
    data = make_classification_data(image_size=32, n_train=256, n_val=32,
                                    n_test=64, noise=1.6, seed=0)
    for method in ("sgd-centralized", "d2", "gradient-tracking",
                   "relay-sgd"):
        tcfg, _ = grid_config(method, steps=3)
        tcfg = dataclasses.replace(tcfg, num_nodes=4, batch_size=8)
        runs, masks, flips = {}, [], []
        for device, relu in (("cuda", _relu_record(masks)),
                             ("cpu", _relu_replay(torch, masks, flips))):
            with _same_draws(torch, 7), relu:
                runs[device] = DecentralizedSimulator(
                    SMALL_CONFIG, tcfg, data, eval_every=100,
                    eval_batches=1, device=device).run()
        check(len(flips) == len(masks), f"{method}: the CPU run made "
              f"{len(flips)} ReLU calls, the card's {len(masks)}")
        gpu, cpu = runs["cuda"].params, runs["cpu"].params
        dp = max(float((gpu[k].cpu() - v).abs().max())
                 for k, v in cpu.items())
        print(f"{method} ({tcfg.algorithm}, {tcfg.topology}), ResNet-8 f32 "
              f"on 4 nodes, 3 steps on the card and on the CPU with the "
              f"same draws: params within {dp:.3g} (tol "
              f"{TRAIN_PARAM_ATOL}); ReLU inputs near 0 by {RELU_TIE} "
              f"(relative) that took the card's branch on the CPU: {sum(flips)}; eval "
              f"NLL card {runs['cuda'].loss_history} CPU "
              f"{runs['cpu'].loss_history}")
        check(dp <= TRAIN_PARAM_ATOL,
              f"{method}, card vs CPU: params differ by {dp:.3g}")


def _relu_record(masks):
    """``F.relu`` that appends each call's branch mask (input > 0), on the
    host, to ``masks``."""
    import torch.nn.functional as F
    relu = F.relu

    def record(x, inplace=False):
        masks.append((x > 0).cpu())
        return relu(x, inplace=inplace)
    return _Patch((F, "relu", record))


def _relu_replay(torch, masks, flips):
    """``F.relu`` that takes, call by call, the branches ``_relu_record``
    recorded in another run: it fails where this run's input takes the
    other branch more than RELU_TIE x max(1, max |x|) from 0 (``x`` the
    call's input), and appends to ``flips`` the number of elements whose
    branch it took over."""
    import torch.nn.functional as F

    def replay(x, inplace=False):
        i = len(flips)
        check(i < len(masks) and masks[i].shape == x.shape,
              f"ReLU call {i} of shape {tuple(x.shape)} was not recorded")
        m = masks[i].to(x.device)
        other = (x > 0) != m
        far = float(x.detach()[other].abs().max()) if bool(other.any()) \
            else 0.0
        scale = max(1.0, float(x.detach().abs().max()))
        check(far <= RELU_TIE * scale, f"ReLU call {i}: an input {far:.3g} "
              f"from 0 ({far / scale:.3g} of max(1, max |x|) {scale:.4g}, "
              f"tol {RELU_TIE}) takes a different branch than on the card")
        flips.append(int(other.sum()))
        return torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    return _Patch((F, "relu", replay))


def _consensus_classes(torch, sim, params):
    """How many classes the consensus model predicts over the test set."""
    mean_p = {k: v.float().mean(dim=0, keepdim=True).to(v.dtype)
              for k, v in params.items()}
    with torch.no_grad():
        preds = torch.cat([sim.model.forward(mean_p, {"images": xb[None]})
                           [0][0].argmax(-1)
                           for xb in sim.test_x.split(256)])
    return int(torch.unique(preds).numel())


def phase_paper(torch, ops):
    """PAPER: the paper's tables on the card at the ``"full"`` setting
    (``repro_torch.paper``: ResNet-20 at 32 x 32, 8 ring nodes, 8192
    images, 2048 public samples, batch 32, the main path's streaming
    sparse round at T = 10 from 0.65 of the run, ``FULL_WIDTH_LR``), each
    cell through ``common.run_cell`` with ``use_cache=False``: Table 2's
    five methods at alpha 0.05, Table 4's ``noise`` public set for the
    two KD methods, and Table 6 and Figure 3 from those cells. Cut from
    the whole tables (``python -m repro_torch.paper --setting full``):
    Table 2's alpha 1.0 and 0.1 columns, Table 4's ``shifted`` column
    (its ``aligned`` one is Table 2's cells), Tables 3 and 7, Table 6
    and Figure 3 at alpha 0.05 instead of 0.1; depth PAPER_STEPS. Fails
    unless every eval loss is finite, no method ends as a constant
    predictor (final eval NLL below ln 10 - PAPER_NLL_MARGIN, test
    predictions over more than one class), each KD cell launches
    ``head_select`` in its round, every launch through ``simt``, Table
    6's gossip bytes per iteration are ResNet-20's parameter count x 2
    ring neighbours x 4 bytes, and Figure 3's skew drops. The paper's
    ordering at alpha 0.05 is printed, not asserted."""
    from repro_torch.core.idkd import skew_metric
    from repro_torch.paper import (common, fig3_homogenize, table2_noniid,
                                   table4_public, table6_comm)
    head_select = ops[0]
    done, cells, runs = [], {}, {}

    class Recording(common.DecentralizedSimulator):
        def run(self, *a, **k):
            r = super().run(*a, **k)
            done.append((self, r))
            return r

    def cell(method, alpha, nodes=8, topology="ring", public_kind="aligned",
             seed=4, steps=None, use_cache=True, *, setting, device):
        key = (method, alpha, nodes, topology, public_kind, seed)
        if key in cells:
            return cells[key]
        head_select.launches = 0
        head_select.launches_by_variant = {"tc": 0, "simt": 0}
        t0 = time.perf_counter()
        out = common.run_cell(method, alpha, nodes, topology, public_kind,
                              seed, PAPER_STEPS, use_cache=False,
                              setting=setting, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sim, r = done.pop()
        nll = out["loss_history"]
        classes = _consensus_classes(torch, sim, r.params)
        nparams = sum(v[0].numel() for v in r.params.values())
        launches = head_select.launches
        variants = dict(head_select.launches_by_variant)
        tag = f"PAPER {method} alpha {alpha} {public_kind}"
        print(f"{tag}: lr {sim.tcfg.lr}, {wall:.1f} s wall, final "
              f"accuracy {out['final_acc']:.4f}, eval NLL "
              f"{[round(x, 4) for x in nll]}, {classes} classes predicted, "
              f"id_fraction {out['id_fraction']:.4f}, gossip "
              f"{out['comm_bytes_per_iter']:.0f} B/iter, labels "
              f"{out['label_bytes_total']:.0f} B, head_select launches "
              f"{launches} {variants}", flush=True)
        check(len(nll) > 0 and all(map(_finite, nll)),
              f"{tag}: eval NLL {nll}")
        check(nll[-1] < math.log(10) - PAPER_NLL_MARGIN and classes > 1,
              f"{tag}: a constant predictor (final eval NLL {nll[-1]:.4f}, "
              f"{classes} classes predicted)")
        if sim.kd_mode is not None:
            check(launches > 0 and variants == {"tc": 0, "simt": launches},
                  f"{tag}: head_select launches {launches} {variants}")
        cells[key] = out
        runs[key] = dict(launches=launches, variants=variants,
                         nparams=nparams, wall=wall)
        return out

    t0 = time.perf_counter()
    kw = dict(setting="full", device="cuda")
    with _Patch((common, "DecentralizedSimulator", Recording),
                (table2_noniid, "run_cell", cell),
                (table2_noniid, "ALPHAS", [PAPER_ALPHA]),
                (table4_public, "run_cell", cell),
                (table4_public, "KINDS", ["noise"]),
                (table6_comm, "run_cell", cell),
                (fig3_homogenize, "run_cell", cell)):
        tables = {"table2": table2_noniid.run(**kw),
                  "table4": table4_public.run(alpha=PAPER_ALPHA, **kw),
                  "table6": table6_comm.run(alpha=PAPER_ALPHA, **kw),
                  "fig3": fig3_homogenize.run(alpha=PAPER_ALPHA, **kw)[:2]}
        for name, (rows, csv) in tables.items():
            for row in csv:
                print(",".join(str(x) for x in row))
            mod = {"table2": table2_noniid, "table4": table4_public,
                   "table6": table6_comm}.get(name)
            print(f"PAPER {name}:\n{mod.render(rows) if mod else rows}")
    ring = (lambda m: cells[(m, PAPER_ALPHA, 8, "ring", "aligned", 4)])
    for method in ("qg-dsgdm-n", "qg-idkd"):
        key = (method, PAPER_ALPHA, 8, "ring", "aligned", 4)
        want = runs[key]["nparams"] * 2 * 4
        got = cells[key]["comm_bytes_per_iter"]
        check(got == want, f"PAPER table6 {method}: {got} gossip B/iter, "
                           f"want {want} (params x 2 x 4 B)")
    idkd = ring("qg-idkd")
    pre, post = skew_metric(idkd["pre_hist"]), skew_metric(idkd["post_hist"])
    check(post < pre, f"PAPER fig3: skew {pre:.4f} -> {post:.4f}")
    acc = {m: ring(m)["final_acc"] for m in
           ("qg-idkd", "qg-dsgdm-n+kd", "qg-dsgdm-n", "dsgd")}
    holds = (acc["qg-idkd"] > acc["qg-dsgdm-n+kd"] >= acc["qg-dsgdm-n"]
             > acc["dsgd"])
    print(f"PAPER: table6 gossip {want} B/iter (ResNet-20's "
          f"{runs[key]['nparams']} params x 2 x 4 B), fig3 skew "
          f"{pre:.4f} -> {post:.4f}; the paper's ordering IDKD > vanilla "
          f"KD >= QG-DSGDm-N > DSGD at alpha {PAPER_ALPHA} "
          f"{'holds' if holds else 'does not hold'}: {acc}; {len(cells)} "
          f"cells in {time.perf_counter() - t0:.1f} s")
    launches = sum(r["launches"] for r in runs.values())
    variants = {v: sum(r["variants"][v] for r in runs.values())
                for v in ("tc", "simt")}
    return {"head_select": launches}, {"head_select": variants}


def _max_diff(torch, a, b):
    """Largest |a - b| over two node-stacked param dicts: 0.0 when they
    are the same bits, inf where a NaN sits on one side only."""
    worst = 0.0
    for k, v in a.items():
        if not torch.equal(v, b[k]):
            d = (v.float() - b[k].float()).abs()
            worst = max(worst, float(d.max()) if bool(d.isfinite().all())
                        else float("inf"))
    return worst


class _deterministic:
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warning, not failing, where an op has no deterministic kernel) for
    the length of a ``with`` block."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        self.torch.backends.cudnn.deterministic = True
        self.torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(False)
        self.torch.backends.cudnn.deterministic = False
        if self.cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def _strict_segments(torch, fed):
    """Run every segment of ``fed`` (the simulator's scheduler hooks)
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside
    a segment raises. Building the runner stays outside."""
    make = type(fed).runner

    def runner(*a):
        run = make(fed, *a)

        def strict(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        strict.metrics, strict.guard = run.metrics, run.guard
        return strict
    fed.runner = runner


def phase_resil(torch, ops):
    """RESIL: the main path at full width (``mainpath.grid_sim``'s
    qg-idkd: ResNet-20 on 16 ring nodes, QG-DSGDm-N at lr 0.5, alpha
    0.1, batch 32, the streaming sparse round over 2048 public samples),
    cut to RESIL_STEPS with the round at RESIL_ROUND, through the
    checkpoint, telemetry and resilience layers. The schedule takes node
    5 out across the round (freeze), rewires the ring to the exponential
    graph, drops node 3's payloads over a window and corrupts node 7's
    (nan, detected) over another, and crashes after the snapshot at
    RESIL_CRASH. Checks, one line each: (a) the fault-free run twice, the
    control pair: RESIL_SHORT plain steps in the card's default mode
    (printed: not bitwise on an H100), then the whole run in
    deterministic mode, which every later run keeps and whose largest
    parameter difference bounds every later comparison (0 = bitwise); (b) telemetry and guard on = off,
    their segments under ``set_sync_debug_mode("error")``; (c) crash,
    a truncated newer snapshot skipped, resume = the uninterrupted run;
    (d) node 5's params and momentum the same bits across its window
    (the snapshots at its ends), its ``selected`` row 0 in the round,
    ``head_select`` launched for the round; (e) a detected-corrupt
    window = a drop window; (f) nan corruption with validation off
    trips the guard, the sender is quarantined, the segment rolls back
    and the params stay finite; (g) ``run.jsonl`` and ``trace.json`` pass
    the port's validators with each event kind counted as the schedule
    implies; (h) the consensus checkpoint saved and loaded on the card,
    bitwise, in the port's layout and the reference's. Prints the card's
    costs: run wall with telemetry and guard on and off, snapshot write,
    resume, peak memory."""
    import shutil
    import tempfile

    from repro_torch import sched
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.launch.steps import consensus_params
    from repro_torch.mainpath import grid_sim
    from repro_torch.models.convert import from_jax_params, to_jax_params
    from repro_torch.obs import (Telemetry, read_events, validate_runlog,
                                 validate_trace)
    from repro_torch.resil import GuardSpec, Resilience, SimulatedCrash
    head_select = ops[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    tmp = Path(tempfile.mkdtemp(prefix="resil-"))
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = grid_sim("qg-idkd", RESIL_STEPS, RESIL_ROUND, RESIL_EVAL, "cuda")
    node, down, up = RESIL_CHURN
    bad, c0, c1 = RESIL_CORRUPT

    def schedule(*extra, steps=RESIL_STEPS, rounds=(RESIL_ROUND,)):
        return sched.compile_schedule(steps, RESIL_EVAL, round_steps=rounds,
                                      events=list(extra))

    events = (sched.ChurnEvent(down, down=(node,)),
              sched.ChurnEvent(up, up=(node,)),
              sched.RewireEvent(*RESIL_REWIRE),
              sched.FaultEvent(RESIL_DROP[1], "drop", (RESIL_DROP[0],)),
              sched.FaultEvent(RESIL_DROP[2], "clear"),
              sched.FaultEvent(c0, "corrupt", (bad,), "nan"),
              sched.FaultEvent(c1, "clear"))

    def timed_run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sim.run(*a, **k)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # (a) the control pair: first as the card runs by default (short:
    # it only shows whether the default is deterministic), then in
    # deterministic mode, which every later run keeps
    plain = schedule(steps=RESIL_SHORT, rounds=())
    r0, w0 = timed_run(plain)
    r1, w1 = timed_run(plain)
    d_default = _max_diff(torch, r0.params, r1.params)
    print(f"RESIL a. control pair by default (cuDNN's own algorithm "
          f"choice), {RESIL_SHORT} plain steps: largest param difference "
          f"{d_default:.3g}, eval NLL {r0.loss_history} and "
          f"{r1.loss_history}; walls {w0:.2f} s and {w1:.2f} s", flush=True)
    with _deterministic(torch):
        r0, w0 = timed_run(schedule())
        r1, w1 = timed_run(schedule())
        tol = _max_diff(torch, r0.params, r1.params)
        same = tol == 0.0 and r0.loss_history == r1.loss_history
        print(f"RESIL a. control pair in deterministic mode (cudnn."
              f"deterministic, use_deterministic_algorithms): largest param "
              f"difference {tol:.3g}, eval NLL "
              f"{'equal' if same else 'differs'} ({r0.loss_history}); every "
              f"comparison below "
              f"{'bitwise' if same else f'within {tol:.3g}'}; walls "
              f"{w0:.2f} s and {w1:.2f} s", flush=True)
        check(all(map(_finite, r0.loss_history)), "RESIL a: non-finite eval")

        def close(a, b, what, history=True):
            d = _max_diff(torch, a.params, b.params)
            check(d <= tol and (not same or not history
                                or a.loss_history == b.loss_history),
                  f"RESIL {what}: params {d:.3g} apart, control {tol:.3g}")
            return d

        # (b) telemetry and guard on = off, no host sync inside a segment
        _strict_segments(torch, sim._fed)
        tel = Telemetry(tmp / "b", trace=True)
        r2, w2 = timed_run(schedule(), telemetry=tel,
                           resil=Resilience(guard=GuardSpec()))
        tel.close()
        d = close(r2, r0, "b (telemetry + guard on vs off)")
        seg = [e for e in json.load(open(tmp / "b" / "trace.json"))[
            "traceEvents"] if e["name"] == "segment"]
        seg_ms = sum(e["dur"] for e in seg) / 1e3 / RESIL_STEPS
        print(f"RESIL b. telemetry + guard on against off: params {d:.3g} "
              f"apart, eval NLL equal {r2.loss_history == r0.loss_history}; "
              f"every segment under set_sync_debug_mode('error'); run wall "
              f"{w2:.2f} s on against {w1:.2f} s off (+{(w2 - w1) * 1e3 / RESIL_STEPS:.2f}"
              f" ms a step, rounds and evals included), segments "
              f"{seg_ms:.2f} ms a step on [{smi}]", flush=True)

        # the schedule with every event, telemetry and resilience on
        head_select.launches = 0
        head_select.launches_by_variant = {"tc": 0, "simt": 0}
        tel = Telemetry(tmp / "u", trace=True)
        u, wu = timed_run(schedule(*events), telemetry=tel, resil=Resilience(
            guard=GuardSpec(), snapshot_dir=str(tmp / "u" / "snap"),
            snapshot_every=0, keep=100))
        tel.close()
        launches = head_select.launches
        variants = dict(head_select.launches_by_variant)
        check(all(map(_finite, u.loss_history)), f"RESIL: eval {u.loss_history}")
        print(f"RESIL schedule run ({len(schedule(*events).segments)} "
              f"segments): {wu:.2f} s wall, eval NLL {u.loss_history}, "
              f"accuracy {u.final_acc:.4f}, head_select launches {launches} "
              f"{variants}", flush=True)

        # (d) the churned node is held, the round masks it out
        dev = next(iter(u.params.values())).device
        like = {"params": u.params, "opt_state": {"m": u.params},
                "key": torch.Generator(device=dev).get_state()}
        snap = {}
        for s in (down, up):
            tree = load_checkpoint(str(tmp / "u" / "snap" / f"snap-{s:08d}"),
                                   like)[0]
            snap[s] = (tree["params"], tree["opt_state"]["m"])
        pairs = [(a[k], b[k]) for a, b in zip(snap[down], snap[up]) for k in a]
        held = all(torch.equal(a[node], b[node]) for a, b in pairs)
        moved = all(not torch.equal(a[0], b[0]) for a, b in pairs)
        labels = read_events(tmp / "u" / "run.jsonl", "labels")
        sel = labels[0]["selected"]
        check(held and moved, f"RESIL d: over [{down}, {up}) node {node} "
                              f"held {held}, node 0 moved {moved}")
        check(sel[node] == 0 and min(sel) == 0 and sum(sel) > 0,
              f"RESIL d: the round's selected counts {sel}")
        check(launches > 0 and sum(variants.values()) == launches,
              f"RESIL d: head_select launches {launches} {variants}")
        print(f"RESIL d. churn: node {node}'s params and momentum the same "
              f"bits in the snapshots at {down} and {up}, every other node's "
              f"moved; the round at {RESIL_ROUND} selected {sel} (node "
              f"{node}: 0); head_select launched {launches} times "
              f"{variants}", flush=True)

        # (c) crash after a snapshot, resume = the uninterrupted run
        res = Resilience(guard=GuardSpec(), snapshot_dir=str(tmp / "c"),
                         snapshot_every=10)
        crash = schedule(*events, sched.FaultEvent(RESIL_CRASH, "crash"))
        try:
            sim.run(crash, resil=res)
        except SimulatedCrash as e:
            check(e.step == RESIL_CRASH, f"RESIL c: crashed at {e.step}")
        else:
            fail("RESIL c: the crash did not fire")
        last = max(int(p.name[5:13]) for p in (tmp / "c").glob("snap-*.npz"))
        fake = tmp / "c" / f"snap-{last + 5:08d}"
        raw = (tmp / "c" / f"snap-{last:08d}.npz").read_bytes()
        Path(str(fake) + ".npz").write_bytes(raw[:len(raw) // 2])
        shutil.copy(tmp / "c" / f"snap-{last:08d}.meta.json",
                    str(fake) + ".meta.json")
        shutil.copy(tmp / "c" / f"snap-{last:08d}.ctx.npz",
                    str(fake) + ".ctx.npz")
        tel = Telemetry(tmp / "r", trace=True)
        r, wr = timed_run(crash, telemetry=tel, resil=res)
        tel.close()
        resume = read_events(tmp / "r" / "run.jsonl", "resume")
        d = close(r, u, "c (crash + resume vs uninterrupted)", history=False)
        tail = u.loss_history[-len(r.loss_history):]
        check(resume and resume[0]["step"] == last and r.loss_history == tail
              if same else resume and resume[0]["step"] == last,
              f"RESIL c: resumed {resume}, eval {r.loss_history} vs {tail}")
        print(f"RESIL c. crash at {RESIL_CRASH}, a truncated snapshot at "
              f"{last + 5} skipped, resumed from {last}: params {d:.3g} from "
              f"the uninterrupted run, eval NLL {r.loss_history} (uninterrupted "
              f"{tail}); resume {resume[0]['t'] * 1e3:.1f} ms to the resume "
              f"event, {wr:.2f} s for the rest of the run [{smi}]", flush=True)

        # (e) a detected-corrupt window = a drop window
        short = {kind: sim.run(schedule(
            sched.FaultEvent(10, kind, (bad,), "nan"),
            sched.FaultEvent(20, "clear"), steps=RESIL_SHORT, rounds=()))
            for kind in ("corrupt", "drop")}
        d = close(short["corrupt"], short["drop"], "e (corrupt vs drop)")
        print(f"RESIL e. node {bad}'s payloads nan (detected) over [10, 20) "
              f"against dropped over the same window, {RESIL_SHORT} steps: "
              f"params {d:.3g} apart", flush=True)

        # (f) nan with validation off: guard trip, quarantine, rollback
        tel = Telemetry(tmp / "f")
        f = sim.run(schedule(sched.FaultEvent(10, "corrupt", (bad,), "nan"),
                             steps=RESIL_SHORT, rounds=()), telemetry=tel,
                    resil=Resilience(guard=GuardSpec(validate_wire=False),
                                     rollback=True))
        tel.close()
        health = read_events(tmp / "f" / "run.jsonl", "health")
        rolls = read_events(tmp / "f" / "run.jsonl", "rollback")
        q = [i for i, v in enumerate(health[0]["quarantined"]) if v] \
            if health else []
        finite = all(bool(v.isfinite().all()) for v in f.params.values())
        check(q == [bad] and rolls and finite
              and all(map(_finite, f.loss_history)),
              f"RESIL f: quarantined {q}, rollbacks {rolls}, finite {finite}")
        print(f"RESIL f. node {bad}'s payloads nan with validation off: the "
              f"guard tripped at {health[0]['step']} (victims "
              f"{[i for i, v in enumerate(health[0]['tripped']) if v]}), node "
              f"{bad} quarantined, {len(rolls)} rollback(s), params finite, "
              f"eval NLL {f.loss_history}", flush=True)

        # (g) the files, each event kind as often as the schedule implies
        sc = schedule(*events)
        counts = validate_runlog(tmp / "u" / "run.jsonl")
        n_trace = validate_trace(tmp / "u" / "trace.json")
        n_seg = len(sc.segments)
        n_eval = sum(s.eval_after for s in sc.segments)
        want = {"schedule": 1, "segment": n_seg, "metrics": n_seg,
                "topology": 3, "fault": 4, "round": 1, "labels": 1,
                "comm": n_seg + 1, "snapshot": n_seg, "eval": n_eval,
                "accuracy": n_eval, "health": 1, "run_end": 1}
        check(dict(counts) == want, f"RESIL g: event counts {dict(counts)}, "
                                    f"want {want}")
        snaps = [e["dur"] / 1e3 for e in json.load(open(
            tmp / "u" / "trace.json"))["traceEvents"] if e["name"] == "snapshot"]
        print(f"RESIL g. run.jsonl ({sum(counts.values())} events, counts as "
              f"the schedule implies: {dict(counts)}) and trace.json "
              f"({n_trace} spans) valid; a snapshot (params + momentum of "
              f"{sim.tcfg.num_nodes} nodes) takes {sum(snaps) / len(snaps):.1f} ms to write (mean of "
              f"{len(snaps)}, max {max(snaps):.1f}) [{smi}]", flush=True)

        # (h) the consensus checkpoint through save and load on the card
        cons = consensus_params(u.params)
        save_checkpoint(str(tmp / "h" / "consensus"), cons, step=RESIL_STEPS)
        back, step = load_checkpoint(str(tmp / "h" / "consensus"), cons)
        save_checkpoint(str(tmp / "h" / "reference"), to_jax_params(cons))
        ref = from_jax_params(load_checkpoint(str(tmp / "h" / "reference"),
                                              to_jax_params(cons))[0], dev)
        check(step == RESIL_STEPS and all(
            back[k].device == v.device and torch.equal(back[k], v)
            and torch.equal(ref[k], v) for k, v in cons.items()),
            "RESIL h: the checkpoint changed")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"RESIL h. the consensus checkpoint ({len(cons)} leaves) saved "
              f"and loaded on the card bitwise, in the port's layout and the "
              f"reference's; RESIL peak {peak:.3f} GiB, "
              f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"head_select": launches}, {"head_select": variants}


def _flash_pairs(S, window, Sk=None, prefix=0):
    """The visible (q, k) pairs of one head: causal (windowed, or with a
    prefix-LM mask of ``prefix`` positions: the causal triangle and the
    prefix square's upper part, P(P - 1)/2 pairs more) or, with ``Sk``,
    non-causal over Sk keys."""
    if Sk is not None:
        return S * Sk
    pc = min(prefix, S)
    return sum(min(q + 1, window) if window else max(q + 1, pc)
               if q < pc else q + 1 for q in range(S))


def _flash_work(B, S, H, KVH, D, window, elem, Sk=None, prefix=0, Dv=None):
    """(bytes, flops) of one attention call (:func:`_flash_pairs`'s
    pairs): q, k, v read and o written once; 2·D flops per visible (q,
    k) pair and head for the scores and 2·Dv for P·V (Dv = D but in
    MLA's mode)."""
    Dv = D if Dv is None else Dv
    pairs = _flash_pairs(S, window, Sk, prefix)
    Sk = S if Sk is None else Sk
    return ((B * S * H * (D + Dv) + B * Sk * KVH * (D + Dv)) * elem,
            2.0 * (D + Dv) * H * B * pairs)


def _ssd_work(B, S, H, P, G, N):
    """(bytes, flops) of one scan: xdt, dta, b, c read and y written once;
    the function's least work is the recurrence, per position and head a
    rank-1 update of the (P, N) state and its readout by c, 2·N·P flops
    each (the decays scale the state once per chunk). The chunked dual
    form's intra-chunk products are the kernel's choice, not counted."""
    flops = B * S * H * 4 * N * P
    nbytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N)
    return nbytes, float(flops)


def _allow(torch, S, window, prefix=0):
    """(S, S) boolean mask of a causal call's visible pairs: kp <= qp, or
    both below ``prefix`` (the prefix-LM mask), within the window."""
    pos = torch.arange(S, device="cuda")
    allow = pos[None, :] <= pos[:, None]
    if prefix:
        allow |= (pos[:, None] < prefix) & (pos[None, :] < prefix)
    if window:
        allow &= pos[:, None] - pos[None, :] < window
    return allow


def _sdpa(torch, q, k, v, window, causal=True, prefix=0):
    """The library yardstick: one scaled_dot_product_attention call on
    (B, H, S, D) copies of the same inputs (made outside the timing),
    with the same boolean mask where is_causal cannot say it."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = _allow(torch, q.shape[1], window, prefix) \
        if window or prefix else None

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True).transpose(1, 2)
    return call


def _check_flash(torch, q, k, v, window, what, causal=True, prefix=0):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    kw = dict(window=window, causal=causal, prefix_len=prefix)
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    dname = str(q.dtype).split(".")[-1]
    err = float((out.float() - ref.float()).abs().max())
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    check(err <= FLASH_ATOL[dname], f"{what}: max error {err:.3g} > "
                                    f"{FLASH_ATOL[dname]}")
    return err


def _check_ssd(torch, xdt, dta, b, c, chunk, what):
    """The kernel against the plain version (f32, the reported error) and
    both against the plain version in float64 (the check)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    y = ssd_scan(xdt, dta, b, c, chunk=chunk)
    ref = ssd_scan_plain(xdt, dta, b, c, chunk=chunk)
    exact = ssd_scan_plain(*(t.double() for t in (xdt, dta, b, c)),
                           chunk=chunk)
    err = float((y - ref).abs().max())
    e_kernel = float((y.double() - exact).abs().max())
    e_plain = float((ref.double() - exact).abs().max())
    del exact
    check(bool(torch.isfinite(y).all()), f"{what}: non-finite output")
    check(e_kernel <= SSD_VS_F32 * e_plain + SSD_ATOL,
          f"{what}: max error against float64 {e_kernel:.3g}, the plain "
          f"f32 version's {e_plain:.3g} (kernel vs plain {err:.3g}; max "
          f"|y| {float(ref.abs().max()):.3g})")
    print(f"  {what}: max error against the float64 plain version: kernel "
          f"{e_kernel:.3g}, plain f32 {e_plain:.3g}")
    return err


def _flash_bwd_work(B, S, H, KVH, D, window, elem, Sk=None, prefix=0,
                    Dv=None):
    """(bytes, flops) of one attention backward: q, o, dO (S rows), k, v
    (Sk, S without ``Sk``) and the f32 lse read, dq, dk, dv written once;
    five products of the (causal, windowed, prefix-LM) score matrix's
    size, three over D (Q·Kᵀ, dS·K, dSᵀ·Q) and two over Dv (dO·Vᵀ,
    Pᵀ·dO): 2.5 times the forward's two when Dv = D."""
    Dv = D if Dv is None else Dv
    pairs = _flash_pairs(S, window, Sk, prefix)
    Sk = S if Sk is None else Sk
    return ((B * S * H * (2 * D + 2 * Dv) + B * Sk * KVH * (2 * D + 2 * Dv))
            * elem + 4 * B * H * S,
            2.0 * (3 * D + 2 * Dv) * H * B * pairs)


def _ssd_bwd_work(B, S, H, P, G, N):
    """(bytes, flops) of one SSD backward: xdt, dy, dta, b, c read and
    dxdt, ddta, db, dc written once (three (B, S, H, P) tensors, two
    (B, S, H), four (B, S, G, N)); per position and head the forward
    and reverse state updates and the dc, dxdt and db readouts, 2·N·P
    flops each (ddta's two terms, 4·N·P more in the kernel, are not
    counted: dy·y − xdt·dxdt would give it in O(P))."""
    nbytes = 4 * (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * G * N)
    return nbytes, float(B * S * H * 10 * N * P)


def _flash_saved(torch, q, k, v, window, what, causal=True, prefix=0):
    """o and lse as the training forward writes them (FlashAttentionFn's
    saved tensors; in bf16 the tc kernel's instantiation that stores the
    log-sum-exp), each held to its plain version: o to
    flash_attention_plain by FLASH_ATOL, lse to the masked logsumexp of
    the scaled f32 scores by LSE_RTOL."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    kw = dict(window=window, causal=causal, prefix_len=prefix)
    out = flash_attention(q.clone().requires_grad_(True), k, v, **kw)
    check(out.grad_fn is not None, "flash_attention with grad returned no "
                                   "grad_fn")
    _, _, _, o, lse = (t.detach() for t in out.grad_fn.saved_tensors)
    dname = str(q.dtype).split(".")[-1]
    e_o = float((o.float() - flash_attention_plain(
        q, k, v, **kw).float()).abs().max())
    B, S, H, D = q.shape
    G = H // k.shape[2]
    allow = _allow(torch, S, window, prefix) if causal else \
        torch.ones((S, k.shape[1]), dtype=torch.bool, device=q.device)
    lse_ref = torch.empty_like(lse)
    for h in range(H):                     # one head's (B, S, S) at a time
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(),
                         k[:, :, h // G].float()) / math.sqrt(D)
        lse_ref[:, h] = torch.logsumexp(s.masked_fill(~allow, -1e30), -1)
    e_lse = float((lse - lse_ref).abs().max())
    tol_lse = LSE_RTOL * max(1.0, float(lse_ref.abs().max()))
    check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
          f"{what}: the training forward wrote non-finite o or lse")
    check(e_o <= FLASH_ATOL[dname], f"{what}: the training forward's o, max "
                                    f"error {e_o:.3g} > {FLASH_ATOL[dname]}")
    check(e_lse <= tol_lse, f"{what}: the training forward's lse, max error "
                            f"{e_lse:.3g} > {tol_lse:.3g}")
    print(f"  {what}: training forward o max error {e_o:.3g} (tol "
          f"{FLASH_ATOL[dname]}), lse {e_lse:.3g} (tol {tol_lse:.3g})")
    return o, lse


def _flash_bwd_excess(torch, a, r, dname):
    """Max over elements of |a − r| over its tolerance (FLASH_BWD_RTOL),
    which must not pass 1: FLASH_BWD_RTOL · max |r|, plus in bf16 two
    ulps of bf16 at the element's own |r|."""
    rf = r.float()
    tol = FLASH_BWD_RTOL * rf.abs().max()
    if dname == "bfloat16":
        _, e = torch.frexp(rf.abs())           # |r| = m · 2^e, m in [0.5, 1)
        ulp = torch.ldexp(torch.ones_like(rf), e - 8)
        tol = tol + torch.where(rf == 0, 0.0, 2.0 * ulp)
    return float(((a.float() - rf).abs() / tol).max())


def _sdpa_bwd(torch, q, k, v, do, window, causal=True, prefix=0):
    """The library yardstick of the backward: autograd of one
    scaled_dot_product_attention call (enable_gqa, the same masks) on
    (B, H, S, D) copies, its forward run once outside the timing."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = _allow(torch, q.shape[1], window, prefix) \
        if window or prefix else None
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None,
                                         enable_gqa=True)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return call


def _check_flash_bwd_simt(torch, got, ref, dname, tag):
    """The SIMT backward against the f32 plain version: every element
    within FLASH_BWD_RTOL's element-wise rule. Returns the max error."""
    err = 0.0
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        e = float((a.float() - r.float()).abs().max())
        scale = float(r.float().abs().max())
        excess = _flash_bwd_excess(torch, a, r, dname)
        check(excess <= 1.0, f"{tag}: {name} error over its element-wise "
                             f"tolerance by {excess:.3g}x (max error "
                             f"{e:.3g}, max |{name}| {scale:.3g})")
        print(f"  {tag}: {name} max error {e:.3g} (max |{name}| "
              f"{scale:.3g}; worst element at {excess:.3g} of its "
              f"tolerance)")
        err = max(err, e)
    return err


def _check_flash_bwd_tc(torch, q, k, v, o, lse, do, window, got, ref, tag,
                        causal=True, prefix=0):
    """The tensor-core backward against the plain version that rounds P
    and dS to bf16 as the kernel does: (a) element-wise, by
    FLASH_BWD_RTOL's rule or within FLASH_BWD_TC_FLIP times the worst
    excess of that plain version against itself with lse moved by one f32
    ulp either way; and, beside it, each gradient's max error against the
    same plain version and (b) against the f32 one at most
    FLASH_BWD_TC_VS_SDPA times SDPA's backward's on the same inputs.
    Returns the max error against the bf16-operand version."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
    kw = dict(window=window, causal=causal, prefix_len=prefix,
              operands="bf16")
    ref_b = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    moved = [flash_attention_bwd_plain(
        q, k, v, o, torch.nextafter(lse, torch.full_like(lse, to)), do,
        **kw) for to in (math.inf, -math.inf)]
    lib = [g.transpose(1, 2) for g in _sdpa_bwd(torch, q, k, v, do,
                                                window, causal, prefix)()]
    err = 0.0
    for i, (name, a, rb, rf, sd) in enumerate(zip(("dq", "dk", "dv"), got,
                                                  ref_b, ref, lib)):
        excess = _flash_bwd_excess(torch, a, rb, "bfloat16")
        flip = max(_flash_bwd_excess(torch, mv[i], rb, "bfloat16")
                   for mv in moved)
        limit = max(1.0, FLASH_BWD_TC_FLIP * flip)
        check(excess <= limit,
              f"{tag}: {name} rule (a): worst element at {excess:.3g} of "
              f"its element-wise tolerance, limit {limit:.3g} (the plain "
              f"version at lse ± 1 ulp reads {flip:.3g})")
        errs = {}
        for rule, yard in (("a", rb), ("b", rf)):
            e_k = float((a.float() - yard.float()).abs().max())
            e_l = float((sd.float() - yard.float()).abs().max())
            check(e_k <= FLASH_BWD_TC_VS_SDPA * e_l,
                  f"{tag}: {name} against the "
                  f"{'bf16-operand' if rule == 'a' else 'f32'} plain "
                  f"version: max error {e_k:.3g}, SDPA's {e_l:.3g}")
            errs[rule] = (e_k, e_l)
        print(f"  {tag}: {name} rule (a) element-wise excess {excess:.3g} "
              f"(limit {limit:.3g}; the plain version at lse ± 1 ulp "
              f"{flip:.3g}); max error against the bf16-operand plain "
              f"version {errs['a'][0]:.3g} (SDPA {errs['a'][1]:.3g}), "
              f"against the f32 one {errs['b'][0]:.3g} (SDPA "
              f"{errs['b'][1]:.3g})")
        err = max(err, errs["a"][0])
    return err


def _mode_tag(window, causal, prefix):
    return (f"prefix={prefix}" if prefix else f"window={window}") \
        if causal else "cross"


def _flash_fwd_row(torch, gen, B, S, H, KVH, D, window, dtype, label,
                   Sk=None, prefix=0, Dv=None):
    """One forward case on fresh random q, k, v: the kernel against its
    plain version (FLASH_ATOL), its time beside its bound, the plain
    version's and SDPA's; in bf16 the SIMT and tc variants in turns.
    With ``Sk`` the call is non-causal over Sk keys (cross-attention);
    ``prefix`` > 0 gives the prefix-LM mask; ``Dv`` v's head dim (MLA's
    mode), D by default."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    dev = "cuda"
    dname = str(dtype).split(".")[-1]
    causal = Sk is None
    kw = dict(window=window, causal=causal, prefix_len=prefix)
    Dv = D if Dv is None else Dv
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S if causal else Sk, KVH, D), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn(k.shape[:-1] + (Dv,), generator=gen,
                    device=dev).to(dtype)
    tag = (f"flash_attention {label}S={S}{'' if causal else f' Sk={Sk}'} "
           f"B={B} {_mode_tag(window, causal, prefix)} {dname}")
    err = _check_flash(torch, q, k, v, window, tag, causal, prefix)
    nbytes, flops = _flash_work(B, S, H, KVH, D, window, q.element_size(),
                                Sk, prefix, Dv)
    bnd, by = bound_ms(nbytes, flops, dname)
    ms = timed(lambda: flash_attention(q, k, v, **kw), 5, torch)
    pms = timed(lambda: flash_attention_plain(q, k, v, **kw), 2, torch)
    lib = _sdpa(torch, q, k, v, window, causal, prefix)
    try:
        lib_err = float((lib().float() - flash_attention_plain(
            q, k, v, **kw).float()).abs().max())
        lms = timed(lib, 5, torch)
    except RuntimeError as exc:      # no SDPA backend takes it
        print(f"{tag}: scaled_dot_product_attention refused: {exc}")
        lib_err = lms = None
    row = dict(window=window, dtype=dname, err=err, ms=ms, plain_ms=pms,
               shape=f"B {B} S {S} H {H}/{KVH} D {D}/{Dv}",
               bound_ms=bnd, bound_by=by, library_ms=lms)
    print(f"{tag}: variant {flash_ops._variant(q.dtype, D, Dv)}, "
          f"max_abs_err {err:.3g} (tol {FLASH_ATOL[dname]}); "
          f"{ms:.3f} ms, bound {bnd:.3f} ms ({by}, "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved, {bnd / ms:.2%} of the "
          f"bound), plain {pms:.3f} ms, sdpa {lms} ms (its max diff from "
          f"the plain version {lib_err})")
    if dname == "bfloat16":
        row["simt_ms"], row["tc_ms"] = in_turns(
            lambda: flash_ops._launch("simt", q, k, v, window, causal,
                                      prefix_len=prefix),
            lambda: flash_ops._launch("tc", q, k, v, window, causal,
                                      prefix_len=prefix), 5, torch)
        print(variants_line(f"{tag} variants", row["simt_ms"], row["tc_ms"],
                            flops, bnd))
    return row


def _flash_bwd_row(torch, gen, B, S, H, KVH, D, window, dtype, label,
                   timing=True, Sk=None, prefix=0, Dv=None):
    """One backward case on fresh random q, k, v, dO: the training
    forward's o and lse held to their plain versions (_flash_saved), then
    the backward kernel of the forward's variant against the plain
    version (the SIMT kernel by the element-wise rule, the tc kernel by
    _check_flash_bwd_tc's); with ``timing``, its time beside its bound,
    the plain version's and SDPA's backward, and in bf16 both variants
    in turns. With ``Sk`` the call is non-causal over Sk keys; ``prefix``
    > 0 gives the prefix-LM mask; ``Dv`` v's head dim (MLA's mode)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    dev = "cuda"
    dname = str(dtype).split(".")[-1]
    causal = Sk is None
    kw = dict(window=window, causal=causal, prefix_len=prefix)
    Dv = D if Dv is None else Dv
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    do = torch.randn((B, S, H, Dv), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S if causal else Sk, KVH, D), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn((B, S if causal else Sk, KVH, Dv), generator=gen,
                    device=dev).to(dtype)
    variant = flash_ops._variant(dtype, D, Dv)
    tag = (f"flash_attention backward {label}S={S}"
           f"{'' if causal else f' Sk={Sk}'} B={B} "
           f"{_mode_tag(window, causal, prefix)} {dname}")
    o, lse = _flash_saved(torch, q, k, v, window, tag, causal, prefix)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, a, t in zip(("dq", "dk", "dv"), got, (q, k, v)):
        check(a.dtype == dtype and a.shape == t.shape
              and bool(torch.isfinite(a).all()),
              f"{tag}: {name} non-finite, {a.dtype} or {tuple(a.shape)}")
    if variant == "tc":
        err = _check_flash_bwd_tc(torch, q, k, v, o, lse, do, window, got,
                                  ref, tag, causal, prefix)
    else:
        err = _check_flash_bwd_simt(torch, got, ref, dname, tag)
    del got, ref
    row = dict(window=window, dtype=dname, err=err,
               shape=f"B {B} S {S} H {H}/{KVH} D {D}/{Dv}")
    if not timing:
        print(f"{tag}: variant {variant}, max_abs_err {err:.3g}")
        return row
    nbytes, flops = _flash_bwd_work(B, S, H, KVH, D, window,
                                    q.element_size(), Sk, prefix, Dv)
    bnd, by = bound_ms(nbytes, flops, dname)
    ms = timed(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), 3,
               torch)
    pms = timed(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), 1, torch)
    try:
        lms = timed(_sdpa_bwd(torch, q, k, v, do, window, causal, prefix), 3,
                    torch)
    except RuntimeError as exc:      # no SDPA backend takes it
        print(f"{tag}: scaled_dot_product_attention backward refused: {exc}")
        lms = None
    row.update(ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
               library_ms=lms)
    print(f"{tag}: variant {variant}, max_abs_err {err:.3g}; "
          f"{ms:.3f} ms, bound {bnd:.3f} ms ({by}, "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved, {bnd / ms:.2%} "
          f"of the bound), plain {pms:.3f} ms, sdpa backward {lms} ms")
    # the training forward (the instantiation that writes lse) alone
    buf = torch.empty_like(lse)
    fbnd = bound_ms(*_flash_work(B, S, H, KVH, D, window, q.element_size(),
                                 Sk, prefix, Dv), dname)[0]
    row["train_fwd_ms"] = timed(lambda: flash_ops._launch(
        variant, q, k, v, window, causal, buf, prefix), 5, torch)
    row["train_fwd_bound_ms"] = fbnd
    print(f"{tag}: the training forward (o and lse) {row['train_fwd_ms']:.3f}"
          f" ms, bound {fbnd:.3f} ms ({fbnd / row['train_fwd_ms']:.2%})")
    if variant == "tc":
        row["simt_ms"], row["tc_ms"] = in_turns(
            lambda: flash_ops._bwd_launch("simt", q, k, v, o, lse, do,
                                          window, causal, prefix),
            lambda: flash_ops._bwd_launch("tc", q, k, v, o, lse, do,
                                          window, causal, prefix), 3, torch)
        print(variants_line(f"{tag} variants", row["simt_ms"],
                            row["tc_ms"], flops, bnd))
    return row


def phase_lm_backward(torch, rows):
    """LM-1's backward checks, at Hymba-1.5B's training shapes (2
    sequences of 2048 tokens + 128 meta tokens per node): the attention
    backward kernels against flash_attention_bwd_plain (global and
    windowed; the SIMT kernel in f32, the tensor-core one in bf16, its
    SIMT twin timed in turns; scaled_dot_product_attention's backward as
    the library figure and the tc kernel's yardstick), and the SSD
    backward kernels against ssd_scan_bwd_plain in float64, at Hymba's
    and Mamba-2-780M's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_plain
    from repro_torch.lmpath import CONFIG, TRAIN
    from repro_torch.models.ssm import ssm_dims
    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = "cuda"
    cfg = CONFIG
    B, S = TRAIN.batch_size, 2048 + cfg.num_prefix_tokens
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows["flash_attention_bwd"], rows["ssd_scan_bwd"] = [], []
    for window in (0, cfg.sliding_window):
        for dtype in (torch.float32, torch.bfloat16):
            rows["flash_attention_bwd"].append(_flash_bwd_row(
                torch, gen, B, S, H, KVH, D, window, dtype, ""))
    for label, mcfg, Ss in (("hymba", cfg, S),
                            ("mamba2-780m", get_config("mamba2-780m"), 2048)):
        Hs, P = ssm_dims(mcfg)[1], mcfg.ssm.head_dim
        G, N = mcfg.ssm.ngroups, mcfg.ssm.state_size
        x = torch.randn((B, Ss, Hs, P), generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((B, Ss, Hs), generator=gen, device=dev))
        a_log = torch.log(torch.arange(1, Hs + 1, device=dev,
                                       dtype=torch.float32))
        dta = (dt * -torch.exp(a_log)).contiguous()
        xdt = (x * dt[..., None]).contiguous()
        b, c = (torch.randn((B, Ss, G, N), generator=gen, device=dev)
                for _ in range(2))
        dy = torch.randn((B, Ss, Hs, P), generator=gen, device=dev)
        ins = (xdt, dta, b, c, dy)
        tag = f"ssd_scan backward {label} B={B} S={Ss} H={Hs} P={P} N={N}"
        got = ssd_scan_bwd(*ins)
        t0 = time.perf_counter()
        plain = ssd_scan_bwd_plain(*ins)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        exact = ssd_scan_bwd_plain(*(t.double() for t in ins))
        err = 0.0
        for name, a, p_, e_ in zip(("dxdt", "ddta", "db", "dc"), got, plain,
                                   exact):
            check(bool(torch.isfinite(a).all()), f"{tag}: non-finite {name}")
            e_k = float((a.double() - e_).abs().max())
            e_p = float((p_.double() - e_).abs().max())
            scale = float(e_.abs().max())
            check(e_k <= SSD_VS_F32 * e_p + SSD_BWD_ATOL * scale,
                  f"{tag}: {name} max error against float64 {e_k:.3g}, the "
                  f"plain f32 version's {e_p:.3g} (max |{name}| "
                  f"{scale:.3g})")
            print(f"  {tag}: {name} max error against the float64 plain "
                  f"version: kernel {e_k:.3g}, plain f32 {e_p:.3g}")
            err = max(err, float((a - p_).abs().max()))
        del got, plain, exact
        nbytes, flops = _ssd_bwd_work(B, Ss, Hs, P, G, N)
        bnd, by = bound_ms(nbytes, flops, "float32")
        ms = timed(lambda: ssd_scan_bwd(*ins), 3, torch)
        rows["ssd_scan_bwd"].append(dict(shape=label, err=err, ms=ms,
                                         plain_ms=pms, bound_ms=bnd,
                                         bound_by=by))
        print(f"{tag}: max_abs_err {err:.3g} against the plain f32 version; "
              f"{ms:.3f} ms, bound {bnd:.3f} ms ({by}; {bnd / ms:.2%} of the "
              f"bound), plain {pms:.1f} ms (one call, a Python loop over "
              f"positions)")
        del x, dt, dta, xdt, b, c, dy, ins
    torch.cuda.empty_cache()


def _head_select_row(torch, gen, label, L, N, Dm, C, *, tied, turns):
    """head_select (bf16, msp, k = 8) on L nodes' N rows against its plain
    version one node at a time, its time beside its bound and the plain
    version's; ``tied`` passes the head as the transpose of an (L, C, Dm)
    embedding, as a tied model's ``head_params`` does (no copy), else an
    (L, Dm, C) head that the tc kernel repacks K-major per call; with
    ``turns`` the SIMT and tc variants timed in turns. The plain version
    runs on at most 2^29 logits at a time (its f32 logits and its sort's
    values and int64 indices: 8 GiB), rows being independent."""
    from repro_torch.kernels.head_select import head_select, head_select_plain
    from repro_torch.kernels.head_select import ops as head_ops
    dev = "cuda"
    h = torch.randn((L, N, Dm), generator=gen, device=dev).to(torch.bfloat16)
    if tied:
        w = (torch.randn((L, C, Dm), generator=gen, device=dev) / Dm ** 0.5
             ).to(torch.bfloat16).transpose(-1, -2)
    else:
        w = (torch.randn((L, Dm, C), generator=gen, device=dev) / Dm ** 0.5
             ).to(torch.bfloat16)
    kw = dict(temperature=10.0, k=8, detector="msp")
    out = head_select(h, w, None, **kw)
    step = min(N, (1 << 29) // C)
    chunks = [(i, r) for i in range(L) for r in range(0, N, step)]

    def plain(i, r):
        return head_select_plain(h[i:i + 1, r:r + step], w[i:i + 1], None,
                                 **kw)
    err = 0.0
    for i, r in chunks:             # the plain version a node's rows at a
        ref = plain(i, r)           # time
        logits = torch.matmul(h[i:i + 1, r:r + step].float(),
                              w[i:i + 1].float())
        e, ties = _compare(torch, [t[i:i + 1, r:r + step] for t in out],
                           ref, logits, f"head_select {label} node {i} "
                                        f"rows {r}:{r + step}")
        err = max(err, e)
        del ref, logits
    nbytes = (L * N * Dm + L * Dm * C) * 2 + L * N * (4 + 8 * 8)
    bnd, by = bound_ms(nbytes, 2.0 * L * N * Dm * C, "bfloat16")
    ms = timed(lambda: head_select(h, w, None, **kw), 2, torch)
    pms = sum(timed(lambda: plain(i, r), 1, torch) for i, r in chunks)
    tag = (f"head_select {label} L={L} rows={L * N} D={Dm} C={C} "
           f"{'tied ' if tied else ''}bf16 msp k=8")
    split = head_ops._column_splits(L, N, C, Dm, _sms(torch))
    print(f"{tag}: variant {head_ops._variant(h.dtype)}, column split "
          f"{split[1]}, max_abs_err {err:.3g}; {ms:.2f} ms, bound "
          f"{bnd:.3f} ms ({by}, {bnd / ms:.2%} of it), plain {pms:.2f} ms "
          f"({len(chunks)} calls)")
    if turns:
        sms, tms = in_turns(
            lambda: head_ops._launch("simt", h, w, None, **kw),
            lambda: head_ops._launch("tc", h, w, None, **kw), 1, torch)
        print(variants_line(f"{tag} variants", sms, tms,
                            2.0 * L * N * Dm * C, bnd))
    del h, w, out
    torch.cuda.empty_cache()
    return dict(shape=label, err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                bound_by=by)


def phase_lm_kernels(torch):
    """LM-1: each LM kernel against its plain version at Hymba's shapes;
    in bf16 the SIMT and tensor-core variants timed in turns."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.configs import get_config
    from repro_torch.lmpath import CONFIG
    from repro_torch.models.ssm import ssm_dims
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    cfg = CONFIG
    S = 2048 + cfg.num_prefix_tokens                 # meta tokens prepended
    B = 8                                            # one microbatch
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = {"flash_attention": [], "ssd_scan": [], "head_select": []}
    for window in (0, cfg.sliding_window):
        for dtype in (torch.float32, torch.bfloat16):
            rows["flash_attention"].append(_flash_fwd_row(
                torch, gen, B, S, H, KVH, D, window, dtype, ""))
    # Hymba's mixer, and Mamba-2-780M's (state size 128) at 2048 tokens
    for label, mcfg, Ss in (("hymba", cfg, S),
                            ("mamba2-780m", get_config("mamba2-780m"), 2048)):
        Bs, Hs, P = B, ssm_dims(mcfg)[1], mcfg.ssm.head_dim
        G, N, chunk = mcfg.ssm.ngroups, mcfg.ssm.state_size, mcfg.ssm.chunk_size
        x = torch.randn((Bs, Ss, Hs, P), generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((Bs, Ss, Hs), generator=gen, device=dev))
        a_log = torch.log(torch.arange(1, Hs + 1, device=dev,
                                       dtype=torch.float32))
        dta = (dt * -torch.exp(a_log)).contiguous()
        xdt = (x * dt[..., None]).contiguous()
        b = torch.randn((Bs, Ss, G, N), generator=gen, device=dev)
        c = torch.randn((Bs, Ss, G, N), generator=gen, device=dev)
        tag = f"ssd_scan {label} B={Bs} S={Ss} H={Hs} P={P} N={N}"
        err = _check_ssd(torch, xdt, dta, b, c, chunk, tag)
        nbytes, flops = _ssd_work(Bs, Ss, Hs, P, G, N)
        bnd, by = bound_ms(nbytes, flops, "float32")
        ms = timed(lambda: ssd_scan(xdt, dta, b, c, chunk=chunk), 5, torch)
        pms = timed(lambda: ssd_scan_plain(xdt, dta, b, c, chunk=chunk), 2,
                    torch)
        rows["ssd_scan"].append(dict(shape=label, err=err, ms=ms,
                                     plain_ms=pms, bound_ms=bnd, bound_by=by))
        print(f"{tag}: max_abs_err {err:.3g} (vs float64: within "
              f"{SSD_VS_F32}x the plain f32 error); {ms:.3f} ms, bound "
              f"{bnd:.3f} ms ({by}; {bnd / ms:.2%} of the bound, "
              f"{flops / ms / 1e9:.2f} TFLOP/s of the recurrence's flops, "
              f"{nbytes / ms / 1e6:.0f} GB/s of the function's bytes), "
              f"plain {pms:.3f} ms")
        del x, dt, dta, xdt, b, c
    # head_select at Hymba's head: 4 nodes x 8 sequences x 2048 tokens
    rows["head_select"].append(_head_select_row(
        torch, gen, "hymba", 4, 8 * 2048, cfg.d_model, cfg.vocab_size,
        tied=False, turns=True))
    # the raw_stats mode at LM-13's head pass: one of two vocabulary
    # slices of Hymba's head (32,001 -> 2 x 16,001, the second with one
    # padded column), and a ragged and an all-padding slice
    w_sh = -(-cfg.vocab_size // 2)
    rows["head_select_raw_tc"] = [
        _raw_row(torch, gen, "hymba slice", 4, 8 * 2048, cfg.d_model, w_sh,
                 8, torch.bfloat16, 5, pad=w_sh * 2 - cfg.vocab_size),
        _raw_row(torch, gen, "ragged slice", 2, 300, cfg.d_model, 700, 8,
                 torch.bfloat16, 5, pad=300),
        _raw_row(torch, gen, "all-padding slice", 2, 300, cfg.d_model, 512,
                 8, torch.bfloat16, 5, pad=512)]
    torch.cuda.empty_cache()
    phase_lm_backward(torch, rows)
    return rows


def phase_lm_dense_kernels(torch, rows):
    """LM-1 for the dense family. The flash kernels at head_dim 96
    (Phi-3-mini's 3072 / 32 heads), SIMT in f32 and tc in bf16: the
    forward at Phi-3's round shape (B 8, S 2048, 32/32 heads, global),
    the training forward (o and its log-sum-exp) and the backward at its
    training shape (B 2), each held to its plain version by the rules of
    head_dim 64 and 128 and timed beside its bound, the plain version and
    SDPA; then a ragged S (1000) with a window (300), both directions,
    both dtypes, checked. Then the bf16 tc kernels at Qwen3-1.7B's
    attention (16/8 heads x 128, global, S 2048) by the same rules: the
    forward at its round shape (B 8), the training forward and the
    backward at its KD step's public batch (B 2). Then head_select at
    Qwen3-1.7B's tied head (4 nodes x 8 sequences x 2048 tokens over
    151,936 tokens) and at Phi-3-mini's untied one (2 nodes, 32,064
    tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.lmpath import (PHI3_TRAIN, QWEN3_PUB_BATCH,
                                    QWEN3_TRAIN, ROUND)
    gen = torch.Generator(device="cuda").manual_seed(9)
    phi3, qwen3 = get_config("phi3-mini-3.8b"), get_config("qwen3-1.7b")
    H, KVH, D = phi3.num_heads, phi3.num_kv_heads, phi3.resolved_head_dim
    S, B_round, B_train = 2048, ROUND.stream_microbatch, PHI3_TRAIN.batch_size
    rows["flash_attention_d96"], rows["flash_attention_bwd_d96"] = [], []
    for dtype in (torch.float32, torch.bfloat16):
        rows["flash_attention_d96"].append(_flash_fwd_row(
            torch, gen, B_round, S, H, KVH, D, 0, dtype, "D=96 "))
        rows["flash_attention_bwd_d96"].append(_flash_bwd_row(
            torch, gen, B_train, S, H, KVH, D, 0, dtype, "D=96 "))
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):     # ragged, windowed
        q, k, v = (torch.randn((2, 1000, 8, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        err = _check_flash(torch, q, k, v, 300, f"flash_attention D=96 "
                                                f"S=1000 window=300 {dtype}")
        rows["flash_attention_d96"].append(dict(window=300, err=err))
        rows["flash_attention_bwd_d96"].append(_flash_bwd_row(
            torch, gen, 2, 1000, 8, 4, D, 300, dtype, "D=96 ", timing=False))
        del q, k, v
    torch.cuda.empty_cache()
    H, KVH, D = qwen3.num_heads, qwen3.num_kv_heads, qwen3.resolved_head_dim
    rows["flash_attention_qwen3"] = [_flash_fwd_row(
        torch, gen, B_round, S, H, KVH, D, 0, torch.bfloat16, "Qwen3 ")]
    rows["flash_attention_bwd_qwen3"] = [_flash_bwd_row(
        torch, gen, QWEN3_PUB_BATCH, S, H, KVH, D, 0, torch.bfloat16,
        "Qwen3 ")]
    torch.cuda.empty_cache()
    rows["head_select_dense"] = [
        _head_select_row(torch, gen, "qwen3", QWEN3_TRAIN.num_nodes,
                         ROUND.stream_microbatch * S, qwen3.d_model,
                         qwen3.vocab_size, tied=True, turns=False),
        _head_select_row(torch, gen, "phi3", PHI3_TRAIN.num_nodes,
                         ROUND.stream_microbatch * S, phi3.d_model,
                         phi3.vocab_size, tied=False, turns=False)]


class _KernelClock:
    """Wraps a kernel entry point where a module calls it: CUDA events
    around each call (device time, read after the run) and, for the
    calls listed in ``keep``, copies of the arguments."""

    def __init__(self, torch, module, attr, keep=()):
        self.torch, self.module, self.attr = torch, module, attr
        self.fn = getattr(module, attr)
        self.keep, self.kept, self.events, self.calls = keep, {}, [], 0
        setattr(module, attr, self)

    def __call__(self, *args, **kw):
        if self.calls in self.keep:
            self.kept[self.calls] = (
                [a.clone() if hasattr(a, "clone") else a for a in args],
                dict(kw))
        self.calls += 1
        s = self.torch.cuda.Event(enable_timing=True)
        e = self.torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.fn(*args, **kw)
        e.record()
        self.events.append((s, e))
        return out

    def ms(self):
        return sum(s.elapsed_time(e) for s, e in self.events)

    def restore(self):
        setattr(self.module, self.attr, self.fn)


def _check_round(torch, out, vocab, what):
    """Finite, well-formed round outputs: every kept (node, sequence)
    carries, per token, labels that sum to 1; the others are empty."""
    labels, weights, id_mask, thr = out
    n, P = weights.shape
    check(labels.values.shape[:2] == (n, P), f"{what}: labels "
                                             f"{tuple(labels.values.shape)}")
    for name, t in (("values", labels.values), ("weights", weights),
                    ("thresholds", thr)):
        check(bool(torch.isfinite(t).all()), f"{what}: non-finite {name}")
    mass = labels.values.sum(-1)                       # (n, P, S)
    want = weights[..., None].expand_as(mass)
    gap = float((mass - want).abs().max())
    check(gap <= 1e-4, f"{what}: label mass differs from the weights by "
                       f"{gap:.3g}")
    idx = labels.indices
    check(bool(((idx >= 0) & (idx < vocab)).all()),
          f"{what}: label indices outside the vocabulary")
    return float(id_mask.float().mean())


def phase_lm_round(torch):
    """LM-2: the full-width Hymba-1.5B round, then the captured layers and
    a reduced round on the card against the CPU."""
    import repro_torch.core.labeling as lab
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.ssm as ssm_mod
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.head_select import head_select, head_select_plain
    from repro_torch.kernels.ssd_scan import ssd_scan
    t0 = time.perf_counter()
    lm = lmpath.setup(device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v[0].numel() for v in lm.params.values())
    print(f"LM round setup: {time.perf_counter() - t0:.1f} s; "
          f"{lm.model.cfg.name}, {n_params / 1e9:.3f} B params per node x "
          f"{lm.params['embed'].shape[0]} nodes, public "
          f"{lm.public.shape}, private {lm.private.shape}, windows "
          f"{lm.model.layer_windows()}")
    # flash calls 0 and 1 are node 0's layers 0 (global) and 1 (windowed)
    # on the first public microbatch; ssd call 0 is its layer 0;
    # head_select call 0 is the first public microbatch's head pass
    clocks = {"flash_attention": _KernelClock(torch, attn_mod,
                                              "flash_attention", (0, 1)),
              "ssd_scan": _KernelClock(torch, ssm_mod, "ssd_scan", (0,)),
              "head_select": _KernelClock(torch, lab, "head_select", (0,))}
    counters = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
                "head_select": head_select}
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    _zero_serve_modes(flash_attention, ssd_scan)
    for f in (flash_attention, head_select):
        f.launches_by_variant = {"tc": 0, "simt": 0}
    flash_attention.launches_by_head_dim = dict.fromkeys(
        flash_attention.launches_by_head_dim, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = lm.run()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    ssd_modes = dict(ssd_scan.launches_by_mode)
    modes = _serve_mode_counts(flash_attention, ssd_scan)
    variants = {k: dict(counters[k].launches_by_variant)
                for k in ("flash_attention", "head_select")}
    dims = {"flash_attention": dict(flash_attention.launches_by_head_dim)}
    for c in clocks.values():
        c.restore()
    dev_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vocab = lm.model.cfg.vocab_size
    kept = _check_round(torch, out, vocab, "LM round")
    thr = out[3]
    per_kernel = {k: c.ms() for k, c in clocks.items()}
    print(f"LM round: {wall:.2f} s wall, {dev_ms:.1f} ms between events, "
          f"peak memory {peak:.1f} GiB; launches {launches}; kernel device "
          f"ms " + ", ".join(f"{k} {v:.1f}" for k, v in per_kernel.items())
          + f" (rest {dev_ms - sum(per_kernel.values()):.1f}); by variant "
          f"{variants}; kept "
          f"{kept:.4f}, per node "
          f"{[round(float(x), 4) for x in out[2].float().mean(1)]}, "
          f"thresholds {[round(float(x), 7) for x in thr]}, labels "
          f"{tuple(out[0].values.shape)}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched in the LM round")
    ssd_calls = clocks["ssd_scan"].calls
    check(launches["ssd_scan"] == ssd_calls,
          f"ssd_scan: {launches['ssd_scan']} kernel launches for "
          f"{ssd_calls} calls in the LM round; every call must launch")
    check(ssd_modes == {"y": ssd_calls, "state": 0},
          f"ssd_scan launches by mode {ssd_modes}: ssm_forward asks for no "
          f"final state")
    print(f"ssd_scan: all {ssd_calls} calls of the round launched the "
          f"three-pass tensor-core kernels, {per_kernel['ssd_scan']:.1f} "
          f"device ms ({per_kernel['ssd_scan'] / ssd_calls:.3f} ms a call)")
    for name, by in variants.items():
        check(by == {"tc": launches[name], "simt": 0},
              f"{name}: {by} of {launches[name]} launches of the LM round "
              f"went through each variant; all must be tc")

    # the kernels on the round's own activations
    for i, what in ((0, "global layer 0"), (1, "windowed layer 1")):
        (q, k, v), kw = clocks["flash_attention"].kept[i]
        check((kw["window"] == 0) == (i == 0), f"captured flash call {i} "
                                               f"has window {kw['window']}")
        err = _check_flash(torch, q, k, v, kw["window"],
                           f"flash_attention on captured {what}")
        print(f"flash_attention on the round's {what} (q "
              f"{tuple(q.shape)} {q.dtype}, window {kw['window']}): "
              f"max_abs_err {err:.3g}")
    (xdt, dta, b, c), kw = clocks["ssd_scan"].kept[0]
    err = _check_ssd(torch, xdt, dta, b, c, kw["chunk"],
                     "ssd_scan on captured layer 0")
    print(f"ssd_scan on the round's layer 0 (xdt {tuple(xdt.shape)}, max "
          f"|xdt| {float(xdt.abs().max()):.3g}): max_abs_err {err:.3g}")
    (feats, w, b), kw = clocks["head_select"].kept[0]
    del clocks, out
    torch.cuda.empty_cache()
    check(b is None and feats.dtype == torch.bfloat16,
          f"captured head pass: bias {b is not None}, {feats.dtype}")
    out = head_select(feats, w, None, **kw)
    err, ties = 0.0, 0
    for i in range(feats.shape[0]):        # the plain version node by node
        ref = head_select_plain(feats[i:i + 1], w[i:i + 1], None, **kw)
        logits = torch.matmul(feats[i:i + 1].float(), w[i:i + 1].float())
        e, t = _compare(torch, [o[i:i + 1] for o in out], ref, logits,
                        f"head_select on the round's head pass, node {i}")
        err, ties = max(err, e), ties + t
        del ref, logits
    mm = timed(lambda: torch.matmul(feats, w), 2, torch)
    Lh, Nh, Dh = feats.shape
    print(f"head_select on the round's first public head pass (features "
          f"{tuple(feats.shape)} bf16, head {tuple(w.shape)}, {kw}): "
          f"max_abs_err {err:.3g} (tol {ATOL}+{RTOL}|ref|), idx near-ties "
          f"{ties}; torch.matmul of the product alone (bf16 out, no "
          f"softmax or top-k): {mm:.3f} ms "
          f"({2.0 * Lh * Nh * Dh * w.shape[-1] / mm / 1e9:.1f} TFLOP/s)")
    del feats, w, out
    torch.cuda.empty_cache()

    # a reduced Hymba on the card against the CPU's plain path: the head
    # pass (all three kernels) on public and private tokens, then the
    # whole round. 256 private sequences give every node its 16
    # calibration sequences, so the ROC thresholds move with the scores
    # (at 1e-6 of noise on every score, by < 1e-6 on the CPU) and do not
    # jump between the plateaus of a 2-sequence curve
    cfg = lmpath.CONFIG.reduced().replace(num_layers=3, num_kv_heads=2)
    small = lmpath.setup(cfg, seq_len=120, n_private=256, n_public=12,
                         icfg=dataclasses.replace(lm.icfg,
                                                  stream_microbatch=5),
                         device="cpu")
    n = small.private.shape[0]
    batches = [torch.as_tensor(small.public[None].repeat(n, 0)),
               torch.as_tensor(small.private)]
    cpu = [lab._head_pass(small.model, small.params, x.long(), small.icfg, 8)
           for x in batches]
    cpu_round = small.run()
    small.params = {k: v.cuda() for k, v in small.params.items()}
    gpu = [lab._head_pass(small.model, small.params, x.cuda().long(),
                          small.icfg, 8) for x in batches]
    gpu_round = small.run()
    err = 0.0
    for (c, v, i), (cr, vr, ir), what in zip(gpu, cpu, ("public",
                                                        "private")):
        for a, b in ((c, cr), (v, vr)):
            d = (a.cpu() - b).abs()
            check(bool((d <= LM_CHECK_ATOL + LM_CHECK_RTOL * b.abs()).all()),
                  f"reduced head pass on {what} tokens, card vs CPU: max "
                  f"error {float(d.max()):.3g}")
            err = max(err, float(d.max()))
        swap = i.cpu() != ir
        check(bool((~swap | ((v.cpu() - vr).abs() <= 1e-6)).all()),
              f"reduced head pass on {what} tokens: label indices differ "
              f"outside near-ties")
    check(small.private.shape[1] == 16, f"reduced round calibrates on "
                                        f"{small.private.shape[1]} sequences")
    labels, weights, mask, thr = (t.cpu() if torch.is_tensor(t) else t
                                  for t in gpu_round)
    dthr = float((thr - cpu_round[3]).abs().max())
    check(dthr <= THRESH_ATOL, f"reduced round, card vs CPU: thresholds "
                               f"differ by {dthr:.3g} > {THRESH_ATOL}")
    check(bool((mask == cpu_round[2]).all()), "reduced round, card vs CPU: "
                                              "D_ID masks differ")
    check(bool((weights == cpu_round[1]).all()), "reduced round, card vs "
                                                 "CPU: weights differ")
    v, vr = labels.values.cpu(), cpu_round[0].values
    dlab = float((v - vr).abs().max())
    check(bool(((v - vr).abs() <= LM_CHECK_ATOL + LM_CHECK_RTOL
                * vr.abs()).all()),
          f"reduced round, card vs CPU: merged labels differ by {dlab:.3g}")
    swap = labels.indices.cpu() != cpu_round[0].indices
    check(bool((~swap | ((v - vr).abs() <= 1e-6)).all()),
          "reduced round, card vs CPU: label indices differ outside "
          "near-ties")
    print(f"reduced Hymba (3 layers, kv 2, S 120 + 8 meta > window "
          f"{cfg.sliding_window}, 16 calibration sequences per node), card "
          f"vs CPU plain path: head pass conf and labels within {err:.3g} "
          f"(tol {LM_CHECK_ATOL} + {LM_CHECK_RTOL}|ref|); whole round: "
          f"thresholds within {dthr:.3g} (tol {THRESH_ATOL}), D_ID masks "
          f"and weights equal, merged labels within {dlab:.3g}, kept "
          f"{float(mask.float().mean()):.4f}")
    lm.stats = dict(wall_s=wall, device_ms=dev_ms, kernel_ms=per_kernel,
                    peak_gib=peak, kept=kept)
    launches.update(modes)
    return lm, launches, variants, dims


def _check_msp_rows(torch, x, kw, what, rows=8192):
    """msp_select against its plain version on the (R, V) logit rows ``x``,
    ``rows`` at a time (the plain version's f32 softmax of all of them
    would not fit beside the nodes), then both timed on all of ``x``."""
    from repro_torch.kernels.msp_select import msp_select, msp_select_plain
    err, ties = 0.0, 0
    for r0 in range(0, x.shape[0], rows):
        xc = x[r0:r0 + rows]
        e, t = _compare(torch, msp_select(xc, **kw),
                        msp_select_plain(xc, **kw), xc.float(),
                        f"{what} rows {r0}..")
        err, ties = max(err, e), ties + t
    n_rows, C = x.shape
    nbytes = n_rows * C * x.element_size() + n_rows * (4 + 8 * kw["k"])
    bnd, by = bound_ms(nbytes, 4.0 * n_rows * C, "float32")
    ms = timed(lambda: msp_select(x, **kw), 2, torch)
    pms = sum(timed(lambda: msp_select_plain(x[r0:r0 + rows], **kw), 1,
                    torch) for r0 in range(0, n_rows, rows))
    print(f"{what} rows={n_rows} V={C} {x.dtype}: max_abs_err {err:.3g} "
          f"(tol {ATOL}+{RTOL}|ref|), idx near-ties {ties}; {ms:.2f} ms, "
          f"bound {bnd:.3f} ms ({by}), plain {pms:.2f} ms "
          f"({-(-n_rows // rows)} calls)")
    return dict(shape="hymba_oneshot", err=err, ties=ties, ms=ms,
                plain_ms=pms, bound_ms=bnd, bound_by=by)


def phase_lm_oneshot(torch, lm):
    """LM-3: the one-shot fused round on the first 8 public sequences
    against the streaming round on the same 8, and msp_select against its
    plain version on the round's own (n·P·S, V) logits."""
    import repro_torch.core.labeling as lab
    from repro_torch.core.labeling import detector_scores
    from repro_torch.kernels.msp_select import msp_select
    pub = lm.public[:8]
    stream = lm.run(public=pub)
    fused_cfg = dataclasses.replace(lm.icfg, stream_labels=False,
                                    label_backend="fused")
    clock = _KernelClock(torch, lab, "msp_select", (0,))
    msp_select.launches = 0
    t0 = time.perf_counter()
    try:
        fused = lm.run(icfg=fused_cfg, public=pub)
    finally:
        clock.restore()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = msp_select.launches
    check(launches > 0, "msp_select was not launched in the one-shot round")
    (x,), kw = clock.kept[0]
    del clock
    row = _check_msp_rows(torch, x, kw, "msp_select on the one-shot round's "
                                        "logits")
    del x
    torch.cuda.empty_cache()
    _check_round(torch, fused, lm.model.cfg.vocab_size, "one-shot LM round")
    dthr = float((stream[3] - fused[3]).abs().max())
    check(dthr <= THRESH_ATOL, f"one-shot vs streaming thresholds differ by "
                               f"{dthr:.3g} > {THRESH_ATOL}")
    # the streaming round's sequence scores: f32 logits of the features
    n = lm.params["embed"].shape[0]
    toks = torch.as_tensor(pub, device="cuda")[None].expand((n,) + pub.shape)
    h, _ = lm.model.forward_features(lm.params, {"tokens": toks})
    w = lm.model.head_params(lm.params)[0].float()
    logits = torch.bmm(h.float().reshape(n, -1, h.shape[-1]), w)
    conf = detector_scores(logits.reshape(h.shape[:-1] + (-1,)),
                           lm.icfg.detector)
    del h, w, logits
    differ = stream[2] != fused[2]
    near = (conf - stream[3][:, None]).abs() <= MASK_BAND
    check(bool((~differ | near).all()), "one-shot vs streaming D_ID masks "
                                        "differ away from the threshold")
    print(f"one-shot LM round (8 public sequences): {dt * 1e3:.1f} ms wall, "
          f"msp_select launches {launches}, thresholds max diff {dthr:.3g} "
          f"(tol {THRESH_ATOL}), mask differences {int(differ.sum())} (all "
          f"within {MASK_BAND} of the threshold), kept "
          f"{float(fused[2].float().mean()):.4f} vs streaming "
          f"{float(stream[2].float().mean()):.4f}")
    return launches, row


class _Patch:
    """Set module attributes for the length of a ``with`` block."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.old = [(m, a, getattr(m, a)) for m, a, _ in self.triples]
        for m, a, v in self.triples:
            setattr(m, a, v)

    def __exit__(self, *exc):
        for m, a, v in self.old:
            setattr(m, a, v)


def _same_draws(torch, seed):
    """Patches under which a training run on the card and one on the CPU
    take the same steps: weights made on the CPU and moved (the pieces
    that ``DecoderModel.init`` and ``lmpath.node_params`` assemble), and
    every index draw (private rows, public sub-batches) from one CPU
    generator seeded here (a CUDA and a CPU torch.Generator give
    different numbers from one seed)."""
    import repro_torch.core.driver as drv
    from repro_torch.models.transformer import DecoderModel
    gen = torch.Generator().manual_seed(seed)
    sample, draw, pieces = drv.sample_partition, drv.draw_public, \
        DecoderModel.pieces

    def sample_partition(parts, _gen, batch_size):
        cpu = drv.PaddedParts(parts.idx.cpu(), parts.size.cpu())
        return sample(cpu, gen, batch_size).to(parts.idx.device)

    def draw_public(_gen, n, pub_batch, n_public, device):
        return draw(gen, n, pub_batch, n_public, "cpu").to(device)

    def pieces_on_cpu(self, seed, device="cuda"):
        for path, shape, idx, v in pieces(self, seed, "cpu"):
            yield path, shape, idx, v.to(device)

    return _Patch((drv, "sample_partition", sample_partition),
                  (drv, "draw_public", draw_public),
                  (DecoderModel, "pieces", pieces_on_cpu))


def _grad_checked(torch, make_algorithm, bad):
    """``make_algorithm`` whose step first records in ``bad`` each leaf
    of a node without a finite gradient that is non-zero somewhere, as
    (step, leaf, per-node norms), steps counted from 0 over every
    algorithm it makes. An MoE router bias only ranks the experts and
    gets a zero gradient, as in the reference; its gradient must be
    finite."""
    calls = [0]

    def checked_algorithm(*a, **kw):
        algo = make_algorithm(*a, **kw)
        real = algo.step

        def step(params, grads, state, lr, mix):
            for k, g in grads.items():
                norm = torch.linalg.vector_norm(
                    g.reshape(g.shape[0], -1), dim=1, dtype=torch.float32)
                ok = torch.isfinite(norm) & (
                    (norm > 0) | k.endswith("/router_bias"))
                if not bool(ok.all()):
                    bad.append((calls[0], k, norm.tolist()))
            calls[0] += 1
            return real(params, grads, state, lr, mix)
        return dataclasses.replace(algo, step=step)
    return checked_algorithm


def _train_full(torch, label, cfg, tcfg, pub_batch=None):
    """One full-width ``repro_torch.lmpath.train`` run (2 plain
    QG-DSGDm-N steps, the homogenization round, 2 sparse-KD steps): each
    step's and the round's wall time, peak memory, the loss history and
    each kernel's forward and backward launches per step. Fails unless
    every loss is finite, every parameter leaf of every node gets a
    finite gradient that is non-zero somewhere at every step, the
    backward kernels launch nodes x layers times per plain step and twice
    that per KD step (the KD adapter's second forward; with multi-token
    prediction nodes more a step, its layer's, which is not recomputed),
    every bf16 flash and head_select launch goes through the tc variant,
    every flash launch runs at the config's head_dim (MLA's (qk, v)
    pair), and the peak stays within TRAIN_PEAK_GIB. Launches are counted
    from 0 over this run. With MoE, each step's aux loss (the node mean)
    is printed."""
    import repro_torch.core.driver as drv
    import repro_torch.launch.train as train_mod
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.head_select import head_select
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.models.transformer import DecoderModel
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd,
                "head_select": head_select}
    steps, rounds, bad, auxs = [], [], [], []
    make_step, make_algorithm = drv.make_step, train_mod.make_algorithm
    label_round = train_mod.idkd_label_round
    real_loss = DecoderModel.loss

    def recorded_loss(self, params, batch):
        loss, metrics = real_loss(self, params, batch)
        auxs.append(metrics["aux"].detach().float().mean())
        return loss, metrics

    def timed_make_step(*a, **kw):
        real = make_step(*a, **kw)

        def step(params, opt_state, batch, lr):
            torch.cuda.synchronize()
            before = {k: f.launches for k, f in counters.items()}
            t0 = time.perf_counter()
            out = real(params, opt_state, batch, lr)
            torch.cuda.synchronize()
            steps.append(dict(
                kind="kd" if "pub_tokens" in batch else "plain",
                s=time.perf_counter() - t0, loss=float(out[2]),
                launches={k: f.launches - before[k]
                          for k, f in counters.items()}))
            return out
        step.init_opt = real.init_opt
        return step

    checked_algorithm = _grad_checked(torch, make_algorithm, bad)

    def timed_round(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = label_round(*a, **kw)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
        return out

    for f in counters.values():
        f.launches = 0
    _zero_serve_modes(flash_attention, ssd_scan)
    with_variants = ("flash_attention", "flash_attention_bwd", "head_select")
    for name in with_variants:
        counters[name].launches_by_variant = {"tc": 0, "simt": 0}
    for f in (flash_attention, flash_attention_bwd):
        f.launches_by_head_dim = dict.fromkeys(f.launches_by_head_dim, 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Patch((drv, "make_step", timed_make_step),
                (train_mod, "make_algorithm", checked_algorithm),
                (train_mod, "idkd_label_round", timed_round),
                (DecoderModel, "loss", recorded_loss)):
        out = lmpath.train(cfg, tcfg, pub_batch=pub_batch, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    launches.update(_serve_mode_counts(flash_attention, ssd_scan))
    variants = {k: dict(counters[k].launches_by_variant)
                for k in with_variants}
    by_dim = {k: dict(counters[k].launches_by_head_dim)
              for k in ("flash_attention", "flash_attention_bwd")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist, pub = out["loss_history"], out["pub_batch"]
    del out
    torch.cuda.empty_cache()
    n, L, mtp = tcfg.num_nodes, cfg.num_layers, cfg.mtp_depth
    hd = _mla_dims(cfg) if cfg.mla.enabled else cfg.resolved_head_dim
    print(f"{label}: LM training ({cfg.name}, {n} ring nodes, {L} layers"
          f"{f', {cfg.moe.num_experts} experts' if cfg.moe.enabled else ''}"
          f"{f', MTP {mtp}' if mtp else ''}, head_dim {hd}, batch "
          f"{tcfg.batch_size} x 2048 tokens, KD "
          f"public {pub} x 2048, lr {tcfg.lr}): {wall:.1f} s wall with "
          f"set-up, peak memory {peak:.2f} GiB; round {rounds} s; losses "
          f"{hist}")
    if cfg.moe.enabled:
        check(len(auxs) == len(steps) and all(
            math.isfinite(float(a)) and float(a) > 0 for a in auxs),
            f"{label}: aux losses {[float(a) for a in auxs]} over "
            f"{len(steps)} steps")
        for st, a in zip(steps, auxs):
            st["aux"] = float(a)
    for i, st in enumerate(steps):
        aux = f", aux {st['aux']:.4f}" if "aux" in st else ""
        print(f"  step {i} ({st['kind']}): {st['s']:.2f} s, loss "
              f"{st['loss']:.4f}{aux}, launches {st['launches']}")
    check(len(rounds) == 1, f"{label}: {len(rounds)} label rounds ran, "
                            f"not 1")
    kinds = [st["kind"] for st in steps]
    check(kinds == ["plain", "plain", "kd", "kd"],
          f"{label}: steps ran as {kinds}")
    check(len(hist) == 4 and all(math.isfinite(x) for x in hist),
          f"{label}: loss history {hist}")
    check(not bad, f"{label}: parameter leaves without a finite, non-zero "
                   f"gradient (step, leaf, per-node norms): {bad[:5]}")
    ssm = cfg.ssm.enabled
    for st in steps:
        want = n * L * (2 if st["kind"] == "kd" else 1)
        for name in ("flash_attention_bwd", "ssd_scan_bwd"):
            got = st["launches"][name]
            flash = name.startswith("flash")
            check(got == (want + n * mtp if flash else want if ssm else 0),
                  f"{label}: {st['kind']} step: {got} {name} launches, the "
                  f"schedule implies {n} nodes x {L} layers"
                  f"{' x 2 (the KD forward)' if st['kind'] == 'kd' else ''}"
                  f"{f' + {n} x {mtp} MTP' if mtp and flash else ''}"
                  f" = {want + n * mtp if flash else want}"
                  f"{'' if ssm else ' (no SSM: 0 for ssd_scan)'}")
        for name in ("flash_attention", "ssd_scan"):
            got = st["launches"][name]
            flash = name.startswith("flash")
            check(got == (2 * want + n * mtp if flash else 2 * want if ssm
                          else 0),
                  f"{label}: {st['kind']} step: {got} {name} launches; "
                  f"with per-layer recompute, {2 * want}"
                  f"{f' + {n} x {mtp} MTP' if mtp and flash else ''}")
    check(launches["head_select"] > 0, f"{label}: head_select was not "
                                       f"launched in the training run's "
                                       f"round")
    for name, by in variants.items():
        check(by == {"tc": launches[name], "simt": 0},
              f"{label}: {name}: {by} of {launches[name]} launches went "
              f"through each variant; all must be tc")
    for name, by in by_dim.items():
        check(by[hd] == launches[name],
              f"{label}: {name}: {by} launches by head_dim; all "
              f"{launches[name]} must run at {hd}")
    check(peak <= TRAIN_PEAK_GIB, f"{label}: peak memory {peak:.1f} GiB > "
                                  f"{TRAIN_PEAK_GIB} GiB")
    print(f"{label}: every leaf of every node got a finite, non-zero "
          f"gradient at every step; backward launches per step = nodes x "
          f"layers (x 2 in KD steps): "
          f"{[st['launches']['flash_attention_bwd'] for st in steps]}, "
          f"all tc at head_dim {hd}")
    return dict(launches=launches, variants=variants, by_head_dim=by_dim,
                steps=steps, rounds=rounds, peak_gib=peak, hist=hist)


def _train_card_vs_cpu(torch, label, cfg, tcfg, pub_batch=None,
                       calls=None, **kw):
    """``lmpath.train`` of a reduced f32 config on the card and on the
    CPU with the same weights and index draws: consensus params within
    TRAIN_PARAM_ATOL, losses within TRAIN_LOSS_RTOL, label bytes equal.
    With ``calls`` (a list; a compressed wire) the CPU run takes the
    card's top-k payloads where the two differ by a near-tie only
    (``_topk_replay``, which appends to ``calls``). Returns (param
    error, loss error)."""
    import contextlib

    from repro_torch import lmpath
    runs, tape = {}, []
    for device in ("cuda", "cpu"):
        sel = (contextlib.nullcontext() if calls is None
               else _topk_record(tape) if device == "cuda"
               else _topk_replay(torch, tape, calls))
        with _same_draws(torch, 7), sel:
            runs[device] = lmpath.train(cfg, tcfg, pub_batch=pub_batch,
                                        device=device, **kw)
    check(calls is None
          or sum(r for r, _ in calls) == sum(t.shape[0] for t in tape),
          f"{label}: the CPU run made {len(calls or ())} top-k calls, the "
          f"card's {len(tape)}")
    gpu, cpu = runs["cuda"], runs["cpu"]
    dp = max(float((gpu["params"][k].cpu() - v).abs().max())
             for k, v in cpu["params"].items())
    dl = max(abs(a - b) / abs(b) for a, b in zip(gpu["loss_history"],
                                                 cpu["loss_history"]))
    check(gpu["ledger"]["label_bytes"] == cpu["ledger"]["label_bytes"],
          f"{label}: label bytes {gpu['ledger']['label_bytes']} on the "
          f"card, {cpu['ledger']['label_bytes']} on the CPU")
    check(calls is None
          or gpu["ledger"]["gossip_bytes"] == cpu["ledger"]["gossip_bytes"],
          f"{label}: gossip bytes {gpu['ledger']['gossip_bytes']} on the "
          f"card, {cpu['ledger']['gossip_bytes']} on the CPU")
    check(dl <= TRAIN_LOSS_RTOL, f"{label}, card vs CPU: losses "
                                 f"{gpu['loss_history']} vs "
                                 f"{cpu['loss_history']}")
    check(dp <= TRAIN_PARAM_ATOL, f"{label}, card vs CPU: params differ by "
                                  f"{dp:.3g}")
    return dp, dl


def phase_lm_train(torch):
    """LM-4: decentralized training with IDKD at full width
    (``repro_torch.lmpath.train``: Hymba-1.5B on 4 ring nodes,
    _train_full's checks), then a reduced Hymba (f32) trained the same 4
    steps on the card and on the CPU (_train_card_vs_cpu)."""
    from repro_torch import lmpath
    out = _train_full(torch, "LM-4", lmpath.CONFIG, lmpath.TRAIN)
    small = lmpath.CONFIG.reduced().replace(num_layers=3, num_kv_heads=2,
                                            remat=True)
    tcfg = dataclasses.replace(lmpath.TRAIN, idkd=dataclasses.replace(
        lmpath.TRAIN.idkd, stream_microbatch=5))
    dp, dl = _train_card_vs_cpu(torch, "reduced Hymba", small, tcfg,
                                seq_len=120, n_private=256, n_public=12)
    print(f"reduced Hymba (3 layers, kv 2, f32, S 120 + 8 meta > window "
          f"{small.sliding_window}, per-layer recompute), 4 steps on the card "
          f"and on the CPU with the same draws: consensus params within "
          f"{dp:.3g} (tol {TRAIN_PARAM_ATOL}), losses within {dl:.3g} "
          f"relative (tol {TRAIN_LOSS_RTOL}), label bytes equal")
    return out


def phase_lm_dense(torch):
    """LM-5 and LM-6: the dense family trained with IDKD at full width
    (_train_full's checks): Qwen3-1.7B, the reference CLI's default arch,
    on 4 ring nodes (``lmpath.QWEN3_TRAIN``, 1 private and
    ``QWEN3_PUB_BATCH`` public sequences per node), and Phi-3-mini on 2
    (``lmpath.PHI3_TRAIN``), every attention launch of it at head_dim 96
    on the tc kernels. Then each of the four dense configs at
    ``reduced()`` (Phi-3 at head_dim 96), f32, one plain and one KD step
    on the card and on the CPU (_train_card_vs_cpu): qkv-bias, qk-norm,
    tied heads and the ring of 2 on the card."""
    from repro_torch import lmpath
    from repro_torch.configs import get_config
    qwen3 = _train_full(torch, "LM-5", get_config("qwen3-1.7b"),
                        lmpath.QWEN3_TRAIN, lmpath.QWEN3_PUB_BATCH)
    phi3 = _train_full(torch, "LM-6", get_config("phi3-mini-3.8b"),
                       lmpath.PHI3_TRAIN)
    runs = {"qwen3-1.7b": (lmpath.QWEN3_TRAIN, lmpath.QWEN3_PUB_BATCH),
            "phi3-mini-3.8b": (lmpath.PHI3_TRAIN, None),
            "qwen1.5-0.5b": (lmpath.TRAIN, None),
            "mistral-nemo-12b": (lmpath.TRAIN, None)}
    for arch, (tcfg, pub) in runs.items():
        small = get_config(arch).reduced().replace(remat=True)
        if arch == "phi3-mini-3.8b":
            small = small.replace(head_dim=96)
        tcfg = dataclasses.replace(tcfg, steps=2, idkd=dataclasses.replace(
            tcfg.idkd, start_step=1, stream_microbatch=5))
        dp, dl = _train_card_vs_cpu(torch, f"reduced {arch}", small, tcfg,
                                    pub, seq_len=120, n_private=256,
                                    n_public=12)
        print(f"reduced {arch} ({small.num_layers} layers, "
              f"{small.num_heads}/{small.num_kv_heads} heads x "
              f"{small.resolved_head_dim}, f32, {tcfg.num_nodes} nodes), one "
              f"plain and one KD step on the card and on the CPU with the "
              f"same draws: consensus params within {dp:.3g} (tol "
              f"{TRAIN_PARAM_ATOL}), losses within {dl:.3g} relative (tol "
              f"{TRAIN_LOSS_RTOL}), label bytes equal")
    return qwen3, phi3


def phase_lm_musicgen_kernels(torch, rows):
    """LM-1 for MusicGen-medium: both flash kernels' non-causal mode
    (cross-attention) at its layer's shape (B 2, Sq 1500, Sk 64, 24/24
    heads x 64: the SIMT kernels in f32, the tc kernels in bf16, forward
    and backward, each held to its plain version by the rules above and
    timed beside its bound, the plain version and SDPA with
    is_causal=False), at a multi-tile ragged key set longer than the
    queries with GQA (B 1, Sq 333, Sk 700, 8/2 x 64; both dtypes, both
    directions, checked), then its causal self-attention (B 2, S 1500,
    bf16, forward and backward, timed)."""
    from repro_torch.configs import get_config
    from repro_torch.lmpath import MUSICGEN_SEQ_LEN, MUSICGEN_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(11)
    cfg = get_config("musicgen-medium")
    B, S, Sk = MUSICGEN_TRAIN.batch_size, MUSICGEN_SEQ_LEN, cfg.cross_attn_len
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows["flash_attention_cross"], rows["flash_attention_bwd_cross"] = [], []
    for dtype in (torch.float32, torch.bfloat16):
        rows["flash_attention_cross"].append(_flash_fwd_row(
            torch, gen, B, S, H, KVH, D, 0, dtype, "MusicGen ", Sk=Sk))
        rows["flash_attention_bwd_cross"].append(_flash_bwd_row(
            torch, gen, B, S, H, KVH, D, 0, dtype, "MusicGen ", Sk=Sk))
    for dtype in (torch.float32, torch.bfloat16):     # Sk > Sq, GQA
        q = torch.randn((1, 333, 8, 64), generator=gen, device="cuda"
                        ).to(dtype)
        k, v = (torch.randn((1, 700, 2, 64), generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
        err = _check_flash(torch, q, k, v, 0, f"flash_attention S=333 "
                           f"Sk=700 8/2 heads cross {dtype}", causal=False)
        rows["flash_attention_cross"].append(dict(window=0, err=err))
        rows["flash_attention_bwd_cross"].append(_flash_bwd_row(
            torch, gen, 1, 333, 8, 2, 64, 0, dtype, "", timing=False,
            Sk=700))
        del q, k, v
    rows["flash_attention_musicgen"] = [_flash_fwd_row(
        torch, gen, B, S, H, KVH, D, 0, torch.bfloat16, "MusicGen ")]
    rows["flash_attention_bwd_musicgen"] = [_flash_bwd_row(
        torch, gen, B, S, H, KVH, D, 0, torch.bfloat16, "MusicGen ")]
    torch.cuda.empty_cache()


def _steps_card_vs_cpu(torch, label, cfg, tcfg, seq_len):
    """``lmpath.train_steps`` of a reduced f32 config (MusicGen's,
    PaliGemma's), one step on the card and on the CPU from the same
    weights and batch (both made on the CPU): params within
    TRAIN_PARAM_ATOL, the loss within TRAIN_LOSS_RTOL. Returns (param
    error, loss error, the card run's flash launches)."""
    from repro_torch import lmpath
    real = lmpath.train_batch
    runs = {}
    for device in ("cuda", "cpu"):
        cpu_gen = torch.Generator().manual_seed(7)

        def train_batch(cfg_, n, batch_size, seq, gen):
            return {k: v.to(gen.device) for k, v in real(
                cfg_, n, batch_size, seq, cpu_gen).items()}
        with _same_draws(torch, 7), _Patch((lmpath, "train_batch",
                                            train_batch)):
            runs[device] = lmpath.train_steps(cfg, tcfg, seq_len=seq_len,
                                              steps=1, device=device)
    gpu, cpu = runs["cuda"], runs["cpu"]
    dp = max(float((gpu["params"][k].cpu() - v).abs().max())
             for k, v in cpu["params"].items())
    lg, lc = gpu["steps"][0]["loss"], cpu["steps"][0]["loss"]
    dl = abs(lg - lc) / abs(lc)
    check(dl <= TRAIN_LOSS_RTOL, f"{label}, card vs CPU: loss {lg} vs "
                                 f"{lc}")
    check(dp <= TRAIN_PARAM_ATOL, f"{label}, card vs CPU: params differ by "
                                  f"{dp:.3g}")
    return dp, dl, gpu["steps"][0]["launches"]


def phase_lm_musicgen(torch):
    """LM-7: MusicGen-medium's decentralized train step at full width
    (``lmpath.train_steps``, ``lmpath.MUSICGEN_TRAIN``: 4 ring nodes, 2
    sequences of 1500 frames, 4 codebooks, 64 conditioning vectors, 3
    steps). Fails unless every loss is finite, every leaf of every node
    gets a finite gradient that is non-zero somewhere at every step, the
    params move, every flash launch is tc at head_dim 64, each mode's
    launches a step are nodes x layers x 2 forward (the recompute) and
    nodes x layers backward, and the peak stays within TRAIN_PEAK_GIB.
    Then the reduced MusicGen (2 layers, Sk 8, f32, per-layer recompute)
    one step on the card and on the CPU (_steps_card_vs_cpu), whose
    card run must go through the SIMT kernels in both modes."""
    import repro_torch.launch.steps as steps_mod
    from repro_torch import lmpath
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ops import _zero_counts
    cfg, tcfg = get_config("musicgen-medium"), lmpath.MUSICGEN_TRAIN
    n, L, hd = tcfg.num_nodes, cfg.num_layers, cfg.resolved_head_dim
    for f in (flash_attention, flash_attention_bwd):
        _zero_counts(f)
    bad = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with _Patch((steps_mod, "make_algorithm", _grad_checked(
            torch, steps_mod.make_algorithm, bad))):
        out = lmpath.train_steps(cfg, tcfg, seq_len=lmpath.MUSICGEN_SEQ_LEN,
                                 steps=tcfg.steps, device="cuda")
    wall = time.perf_counter() - t0
    steps, peak = out["steps"], out["peak_gib"]
    moved, pairs = out["moved"], out["pairs"]
    del out
    torch.cuda.empty_cache()
    by_dim = {f.__name__: dict(f.launches_by_head_dim)
              for f in (flash_attention, flash_attention_bwd)}
    print(f"LM-7: MusicGen training step ({cfg.name}, {n} ring nodes, {L} "
          f"layers, {cfg.num_codebooks} codebooks, batch "
          f"{tcfg.batch_size} x {lmpath.MUSICGEN_SEQ_LEN} frames, "
          f"conditioning {cfg.cross_attn_len}, lr {tcfg.lr}): {wall:.1f} s "
          f"wall with set-up, peak memory {peak:.2f} GiB; {moved} of "
          f"{pairs} (leaf, node) pairs moved")
    for i, st in enumerate(steps):
        print(f"  step {i}: {st['s']:.2f} s, loss {st['loss']:.4f}, flash "
              f"launches {st['launches']}")
    check(len(steps) == tcfg.steps and all(
        math.isfinite(st["loss"]) for st in steps),
        f"LM-7: losses {[st['loss'] for st in steps]}")
    check(not bad, f"LM-7: parameter leaves without a finite, non-zero "
                   f"gradient (step, leaf, per-node norms): {bad[:5]}")
    check(moved > 0, "LM-7: no parameter moved")
    want = {"flash_attention": 2 * n * L, "flash_attention_bwd": n * L}
    for i, st in enumerate(steps):
        for name, modes in st["launches"].items():
            for mode, by in modes.items():
                w = 0 if mode in ("prefix", "offset") else want[name]
                check(by == {"tc": w, "simt": 0},
                      f"LM-7 step {i}: {name} {mode} launches {by}; the "
                      f"layer loop implies {w}, all tc")
    for name, dims in by_dim.items():
        total = sum(dims.values())
        check(dims[hd] == total == 2 * want[name] * len(steps),
              f"LM-7: {name} launches by head_dim {dims}")
    check(peak <= TRAIN_PEAK_GIB, f"LM-7: peak memory {peak:.1f} GiB > "
                                  f"{TRAIN_PEAK_GIB} GiB")
    small = cfg.reduced().replace(remat=True)
    dp, dl, launches = _steps_card_vs_cpu(torch, "reduced MusicGen", small,
                                          tcfg, 40)
    ns, ls = tcfg.num_nodes, small.num_layers
    for name, per in (("flash_attention", 2), ("flash_attention_bwd", 1)):
        for mode, by in launches[name].items():
            w = 0 if mode in ("prefix", "offset") else per * ns * ls
            check(by == {"tc": 0, "simt": w},
                  f"reduced MusicGen on the card: {name} {mode} launches "
                  f"{by}, want {w} simt")
    print(f"reduced MusicGen ({small.num_layers} layers, "
          f"{small.num_codebooks} codebooks, Sk {small.cross_attn_len}, f32, "
          f"per-layer recompute), one step on the card and on the CPU with "
          f"the same weights and batch: params within {dp:.3g} (tol "
          f"{TRAIN_PARAM_ATOL}), loss within {dl:.3g} relative (tol "
          f"{TRAIN_LOSS_RTOL}); card launches {launches}")
    # the kernels line's entries: the causal mode under each kernel's
    # name, the cross mode under "<name>_cross"; every launch at hd
    launches, variants, dims = {}, {}, {}
    for name in want:
        for mode in ("causal", "cross"):
            key = name + ("_cross" if mode == "cross" else "")
            variants[key] = {v: sum(st["launches"][name][mode][v]
                                    for st in steps) for v in ("tc", "simt")}
            launches[key] = sum(variants[key].values())
            dims[key] = {hd: launches[key]}
    launches["flash_attention_offset"] = _step_offset_launches(steps)
    return dict(steps=steps, peak_gib=peak, launches=launches,
                variants=variants, by_head_dim=dims)


def phase_lm_paligemma_kernels(torch, rows):
    """LM-1 for PaliGemma-3B: both flash kernels at head_dim 256 with its
    prefix-LM mask, forward and backward, each held to its plain version
    by the rules above and timed beside its bound, the plain version and
    SDPA with the same boolean mask: (a) its training layer (B 2, S 512 =
    256 patches + 256 text tokens, 8/1 heads x 256, prefix 256), f32 on
    the SIMT kernels and bf16 on the tensor cores, both variants timed in
    turns in bf16; (b) the same shape causal without a prefix; (c) a
    prefix that ends mid-tile with GQA (B 1, S 333, prefix 200, 8/2 x
    256) and (d) a prefix past the sequence (S 200, prefix 300: every key
    for every row), both dtypes, both directions, checked."""
    from repro_torch.configs import get_config
    from repro_torch.lmpath import PALIGEMMA_TEXT_LEN, PALIGEMMA_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(12)
    cfg = get_config("paligemma-3b")
    P, B = cfg.prefix_lm_prefix, PALIGEMMA_TRAIN.batch_size
    S = cfg.num_prefix_tokens + PALIGEMMA_TEXT_LEN
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for key in ("prefix", "d256"):
        rows["flash_attention_" + key] = []
        rows["flash_attention_bwd_" + key] = []
    for dtype in (torch.float32, torch.bfloat16):
        for key, p in (("prefix", P), ("d256", 0)):
            rows["flash_attention_" + key].append(_flash_fwd_row(
                torch, gen, B, S, H, KVH, D, 0, dtype, "PaliGemma ",
                prefix=p))
            rows["flash_attention_bwd_" + key].append(_flash_bwd_row(
                torch, gen, B, S, H, KVH, D, 0, dtype, "PaliGemma ",
                prefix=p))
        for Sc, Pc, kvh in ((333, 200, 2), (200, 300, 1)):
            q = torch.randn((1, Sc, H, D), generator=gen, device="cuda"
                            ).to(dtype)
            k, v = (torch.randn((1, Sc, kvh, D), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            err = _check_flash(torch, q, k, v, 0, f"flash_attention S={Sc} "
                               f"prefix={Pc} {H}/{kvh} heads x {D} {dtype}",
                               prefix=Pc)
            rows["flash_attention_prefix"].append(dict(window=0, err=err))
            rows["flash_attention_bwd_prefix"].append(_flash_bwd_row(
                torch, gen, 1, Sc, H, kvh, D, 0, dtype, "", timing=False,
                prefix=Pc))
            del q, k, v
        torch.cuda.empty_cache()


def phase_lm_mla_kernels(torch, rows):
    """LM-1 for DeepSeek-V3: flash_attention's MLA mode (qk head dim 192 =
    128 nope + 64 rope, v head dim 128; 48 and 32 at ``reduced()``), both
    kernels forward and backward, each held to its plain version by the
    rules above and timed beside its bound, the plain version and SDPA
    (which takes v's head dim apart from q's): (a) LM-10's round and
    prefill layer (B 8, S 2048, 128/128 heads, causal) in bf16 on the
    tensor cores, both variants in turns; (b) LM-11's training layer (B
    1, S 2048) in f32 on the SIMT kernels; (c) the reduced config's (48,
    32), f32 (B 2, S 256, 4/4 heads); (d) a ragged S (333) at (192, 128)
    in both dtypes, checked; and ``head_select`` (tc, bf16) at
    DeepSeek-V3's head (D 7168, C 129,280) on LM-10's round microbatch (2
    nodes x 8 sequences x 2048 tokens), against its plain version."""
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(23)
    cfg = get_config("deepseek-v3-671b")
    m = cfg.mla
    D, Dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    H = cfg.num_heads
    rows["flash_attention_mla"], rows["flash_attention_bwd_mla"] = [], []
    for B, dtype in ((8, torch.bfloat16), (1, torch.float32)):
        rows["flash_attention_mla"].append(_flash_fwd_row(
            torch, gen, B, 2048, H, H, D, 0, dtype, "MLA ", Dv=Dv))
        rows["flash_attention_bwd_mla"].append(_flash_bwd_row(
            torch, gen, B, 2048, H, H, D, 0, dtype, "MLA ", Dv=Dv))
        torch.cuda.empty_cache()
    r = cfg.reduced().mla
    Dr, Dvr = r.qk_nope_head_dim + r.qk_rope_head_dim, r.v_head_dim
    rows["flash_attention_mla"].append(_flash_fwd_row(
        torch, gen, 2, 256, 4, 4, Dr, 0, torch.float32, "MLA reduced ",
        Dv=Dvr))
    rows["flash_attention_bwd_mla"].append(_flash_bwd_row(
        torch, gen, 2, 256, 4, 4, Dr, 0, torch.float32, "MLA reduced ",
        Dv=Dvr))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((1, 333, 8, D), generator=gen, device="cuda"
                        ).to(dtype)
        k = torch.randn((1, 333, 8, D), generator=gen, device="cuda"
                        ).to(dtype)
        v = torch.randn((1, 333, 8, Dv), generator=gen, device="cuda"
                        ).to(dtype)
        err = _check_flash(torch, q, k, v, 0, f"flash_attention MLA S=333 "
                           f"8/8 heads x ({D}, {Dv}) {dtype}")
        rows["flash_attention_mla"].append(dict(window=0, err=err))
        rows["flash_attention_bwd_mla"].append(_flash_bwd_row(
            torch, gen, 1, 333, 8, 8, D, 0, dtype, "MLA ragged ",
            timing=False, Dv=Dv))
    rows["head_select_deepseek"] = [_head_select_row(
        torch, gen, "deepseek-v3", 2, 8 * 2048, cfg.d_model, cfg.vocab_size,
        tied=False, turns=False)]
    torch.cuda.empty_cache()


def phase_lm_paligemma(torch):
    """LM-8: PaliGemma-3B's decentralized train step at full width
    (``lmpath.train_steps``, ``lmpath.PALIGEMMA_TRAIN``: 4 ring nodes, 2
    sequences of 256 patch embeddings + 256 text tokens, 3 steps, every
    layer recomputed). Fails unless every loss is finite, every leaf of
    every node gets a finite gradient that is non-zero somewhere at every
    step, the params move, every flash launch is a "prefix" launch on the
    tc kernels at head_dim 256, nodes x layers x 2 forward (the
    recompute) and nodes x layers backward a step, and the peak stays
    within TRAIN_PEAK_GIB. Then one prefill (``launch.steps.
    make_prefill_step``, no grad) on the final params and the first
    step's batch: (4, 2, 256, 257,216) finite logits from nodes x layers
    forward launches that write no log-sum-exp. Then the reduced
    PaliGemma with ``prefix_lm_prefix`` 8 (the 8 patches: both mask
    regions; f32, per-layer recompute) one step on the card and on the
    CPU (_steps_card_vs_cpu), whose card run must go through the SIMT
    kernels in the prefix mode."""
    import repro_torch.launch.steps as steps_mod
    from repro_torch import lmpath
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import _zero_counts
    from repro_torch.models.transformer import DecoderModel
    cfg, tcfg = get_config("paligemma-3b"), lmpath.PALIGEMMA_TRAIN
    n, L, hd = tcfg.num_nodes, cfg.num_layers, cfg.resolved_head_dim
    text = lmpath.PALIGEMMA_TEXT_LEN
    for f in (flash_attention, flash_attention_bwd):
        _zero_counts(f)
    bad = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with _Patch((steps_mod, "make_algorithm", _grad_checked(
            torch, steps_mod.make_algorithm, bad))):
        out = lmpath.train_steps(cfg, tcfg, seq_len=text, steps=tcfg.steps,
                                 device="cuda")
    wall = time.perf_counter() - t0
    steps, peak = out["steps"], out["peak_gib"]
    moved, pairs, params = out["moved"], out["pairs"], out["params"]
    del out
    by_dim = {f.__name__: dict(f.launches_by_head_dim)
              for f in (flash_attention, flash_attention_bwd)}
    print(f"LM-8: PaliGemma training step ({cfg.name}, {n} ring nodes, {L} "
          f"layers, {cfg.num_heads}/{cfg.num_kv_heads} heads x {hd}, batch "
          f"{tcfg.batch_size} x ({cfg.num_prefix_tokens} patches + {text} "
          f"tokens), prefix {cfg.prefix_lm_prefix}, lr {tcfg.lr}): "
          f"{wall:.1f} s wall with set-up, peak memory {peak:.2f} GiB; "
          f"{moved} of {pairs} (leaf, node) pairs moved")
    for i, st in enumerate(steps):
        print(f"  step {i}: {st['s']:.2f} s, loss {st['loss']:.4f}, flash "
              f"launches {st['launches']}")
    check(len(steps) == tcfg.steps and all(
        math.isfinite(st["loss"]) for st in steps),
        f"LM-8: losses {[st['loss'] for st in steps]}")
    check(not bad, f"LM-8: parameter leaves without a finite, non-zero "
                   f"gradient (step, leaf, per-node norms): {bad[:5]}")
    check(moved > 0, "LM-8: no parameter moved")
    want = {"flash_attention": 2 * n * L, "flash_attention_bwd": n * L}
    for i, st in enumerate(steps):
        for name, modes in st["launches"].items():
            for mode, by in modes.items():
                w = want[name] if mode == "prefix" else 0
                check(by == {"tc": w, "simt": 0},
                      f"LM-8 step {i}: {name} {mode} launches {by}; the "
                      f"layer loop implies {w}, all tc")
    for name, dims in by_dim.items():
        total = sum(dims.values())
        check(dims[hd] == total == want[name] * len(steps),
              f"LM-8: {name} launches by head_dim {dims}")
    check(peak <= TRAIN_PEAK_GIB, f"LM-8: peak memory {peak:.1f} GiB > "
                                  f"{TRAIN_PEAK_GIB} GiB")

    # the prefill on the final params, the first step's batch
    batch = lmpath.train_batch(cfg, n, tcfg.batch_size, text,
                               torch.Generator(device="cuda").manual_seed(
                                   tcfg.seed))
    del batch["labels"]
    for f in (flash_attention, flash_attention_bwd):
        _zero_counts(f)
    lse_args = []
    real_launch = flash_ops._launch

    def launch(*a, **kw):
        lse_args.append(kw.get("lse", a[6] if len(a) > 6 else None))
        return real_launch(*a, **kw)
    prefill = steps_mod.make_prefill_step(DecoderModel(cfg))
    with _Patch((flash_ops, "_launch", launch)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    shape = (n, tcfg.batch_size, text, cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    print(f"LM-8: prefill (make_prefill_step, no grad) on the final params: "
          f"{prefill_s:.3f} s, logits {tuple(logits.shape)} "
          f"{str(logits.dtype)[6:]}, finite {finite}; flash launches "
          f"{flash_attention.launches_by_mode}, backward "
          f"{flash_attention_bwd.launches}, lse written by "
          f"{sum(x is not None for x in lse_args)} of {len(lse_args)}")
    check(tuple(logits.shape) == shape and finite,
          f"LM-8 prefill: logits {tuple(logits.shape)} (want {shape}), "
          f"finite {finite}")
    check(flash_attention.launches_by_mode["prefix"] == {"tc": n * L,
                                                         "simt": 0}
          and flash_attention.launches == n * L
          and flash_attention_bwd.launches == 0
          and len(lse_args) == n * L and not any(
              x is not None for x in lse_args),
          f"LM-8 prefill: flash launches {flash_attention.launches_by_mode}"
          f", backward {flash_attention_bwd.launches}; want {n * L} "
          f"prefix tc launches that write no lse")
    prefill_launches = dict(flash_attention.launches_by_mode["prefix"])
    del logits, params, batch
    torch.cuda.empty_cache()

    small = cfg.reduced().replace(prefix_lm_prefix=8, remat=True)
    dp, dl, launches = _steps_card_vs_cpu(torch, "reduced PaliGemma", small,
                                          tcfg, 24)
    ns, ls = tcfg.num_nodes, small.num_layers
    for name, per in (("flash_attention", 2), ("flash_attention_bwd", 1)):
        for mode, by in launches[name].items():
            w = per * ns * ls if mode == "prefix" else 0
            check(by == {"tc": 0, "simt": w},
                  f"reduced PaliGemma on the card: {name} {mode} launches "
                  f"{by}, want {w} simt")
    print(f"reduced PaliGemma ({small.num_layers} layers, "
          f"{small.num_prefix_tokens} patches, prefix "
          f"{small.prefix_lm_prefix}, {small.num_heads}/{small.num_kv_heads} "
          f"heads x {small.resolved_head_dim}, f32, per-layer recompute), one "
          f"step on the card and on the CPU with the same weights and batch: "
          f"params within {dp:.3g} (tol {TRAIN_PARAM_ATOL}), loss within "
          f"{dl:.3g} relative (tol {TRAIN_LOSS_RTOL}); card launches "
          f"{launches}")
    # the kernels line's entries: the train steps' launches and the
    # prefill's, under "<name>_prefix"; every launch at hd
    launches, variants, dims = {}, {}, {}
    for name in want:
        key = name + "_prefix"
        variants[key] = {v: sum(st["launches"][name]["prefix"][v]
                                for st in steps)
                         + (prefill_launches[v] if name == "flash_attention"
                            else 0) for v in ("tc", "simt")}
        launches[key] = sum(variants[key].values())
        dims[key] = {hd: launches[key]}
    launches["flash_attention_offset"] = _step_offset_launches(steps)
    return dict(steps=steps, peak_gib=peak, prefill_s=prefill_s,
                launches=launches, variants=variants, by_head_dim=dims)


def _zero_serve_modes(flash_attention, ssd_scan):
    """Set the launch counts of the serving path's two kernel modes to 0:
    flash's offset mode and ssd_scan's state mode."""
    flash_attention.launches_by_mode["offset"] = {"tc": 0, "simt": 0}
    ssd_scan.launches_by_mode = dict.fromkeys(ssd_scan.launches_by_mode, 0)


def _serve_mode_counts(flash_attention, ssd_scan):
    """The launches of those two modes since :func:`_zero_serve_modes`,
    under the kernels line's names."""
    return {"flash_attention_offset":
            sum(flash_attention.launches_by_mode["offset"].values()),
            "ssd_scan_state": ssd_scan.launches_by_mode["state"]}


def _step_offset_launches(steps):
    """The forward's offset-mode launches summed over training steps."""
    return sum(n for st in steps
               for n in st["launches"]["flash_attention"]["offset"].values())


def _zero_counts(*fns):
    """Set each wrapper's launch counts to 0: the total and those it keeps
    by variant, head dim and mode (flash's modes by variant, ssd_scan's
    plain counts)."""
    for f in fns:
        f.launches = 0
        for key in ("launches_by_variant", "launches_by_head_dim"):
            if hasattr(f, key):
                setattr(f, key, dict.fromkeys(getattr(f, key), 0))
        if hasattr(f, "launches_by_mode"):
            f.launches_by_mode = {
                m: dict.fromkeys(v, 0) if isinstance(v, dict) else 0
                for m, v in f.launches_by_mode.items()}


class _DropCount:
    """Counts, on the card, the MoE assignments that ``moe.dispatch_slots``
    sends to the overflow row (dropped past an expert's capacity) and
    all assignments, while it is entered."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.dispatch_slots
        self.dropped = torch.zeros((), dtype=torch.long, device="cuda")
        self.total = 0

    def __enter__(self):
        def counted(ids, E, cap):
            dest = self.real(ids, E, cap)
            self.dropped += (dest == E * cap).sum()
            self.total += dest.numel()
            return dest
        self.moe.dispatch_slots = counted
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_slots = self.real

    def share(self):
        return int(self.dropped) / max(1, self.total)


def _mla_dims(cfg):
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)


def phase_lm_deepseek(torch):
    """LM-10: DeepSeek-V3 at full width (``lmpath.DEEPSEEK_ROUND_CONFIG``:
    d_model 7168, 128 MLA heads at qk 192 / v 128, all 256 routed
    experts top-8 with the sigmoid router and a shared expert, vocabulary
    129,280, bf16; 2 layers, 2 ring nodes, params filled in place by
    ``lmpath.node_params``): one homogenization round (``lmpath.setup``'s:
    64 public and 16 private sequences of 2048 tokens a node, top-8
    labels, T = 10) and one prefill (``make_prefill_step``, 1 sequence
    of 2048 tokens a node, every logit). Prints the round's and the
    prefill's wall times, the kept fraction, head_select's launches at D
    7168, C 129,280, the flash launches in the MLA mode, the share of
    MoE assignments dropped past capacity and the peak memory. Fails
    unless the round's outputs are finite and well formed, the logits
    (2, 1, 2048, 129,280) finite, every flash launch a tc launch in the
    MLA mode (nodes x layers in the prefill) and every head_select
    launch tc."""
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.head_select import head_select
    from repro_torch.launch.steps import make_prefill_step
    cfg = lmpath.DEEPSEEK_ROUND_CONFIG
    n, L, dims = lmpath.DEEPSEEK_NODES, cfg.num_layers, _mla_dims(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = lmpath.setup(cfg, num_nodes=n, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(v[0].numel() for v in lm.params.values())
    print(f"LM-10: DeepSeek-V3 ({L} layers, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.num_experts_per_tok}, MLA {dims}) on {n} ring "
          f"nodes: {nparams / 1e9:.3f} B parameters a node, set up in "
          f"{init_s:.1f} s, {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB held")
    _zero_counts(flash_attention, head_select)
    with _DropCount(torch) as drops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.run()
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
    kept = _check_round(torch, out, cfg.vocab_size, "LM-10 round")
    rl = {"flash_attention_mla": flash_attention.launches,
          "head_select": head_select.launches}
    by_var = {"flash_attention_mla": dict(flash_attention.launches_by_variant),
              "head_select": dict(head_select.launches_by_variant)}
    by_dim = dict(flash_attention.launches_by_head_dim)
    print(f"LM-10 round: {round_s:.2f} s wall, kept fraction {kept:.4f}, "
          f"thresholds {out[3].tolist()}; head_select {rl['head_select']} "
          f"launches at D {cfg.d_model}, C {cfg.vocab_size} "
          f"({by_var['head_select']}); flash {rl['flash_attention_mla']} "
          f"launches ({by_var['flash_attention_mla']}, at {dims}: "
          f"{by_dim[dims]}); MoE assignments dropped past capacity "
          f"{drops.share():.4%} of {drops.total}")
    check(rl["head_select"] > 0 and by_var["head_select"] == {
        "tc": rl["head_select"], "simt": 0},
        f"LM-10 round: head_select launches {by_var['head_select']}")
    check(rl["flash_attention_mla"] > 0 and by_dim[dims] ==
          rl["flash_attention_mla"] and by_var["flash_attention_mla"] ==
          {"tc": rl["flash_attention_mla"], "simt": 0},
          f"LM-10 round: flash launches {by_var['flash_attention_mla']}, "
          f"by head dims {by_dim}; all must be tc at {dims}")
    del out
    torch.cuda.empty_cache()
    B = lmpath.DEEPSEEK_PREFILL_BATCH
    tokens = torch.as_tensor(lm.public[:B]).long().cuda()[None].expand(
        n, B, -1).contiguous()
    prefill = make_prefill_step(lm.model)
    _zero_counts(flash_attention)
    with _DropCount(torch) as pdrops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(lm.params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    shape = (n, B, tokens.shape[-1], cfg.vocab_size)
    check(tuple(logits.shape) == shape and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"LM-10 prefill: logits {tuple(logits.shape)} {logits.dtype} (want "
          f"{shape} bf16, finite)")
    pl = flash_attention.launches
    check(pl == n * L and flash_attention.launches_by_head_dim[dims] == pl
          and flash_attention.launches_by_variant == {"tc": pl, "simt": 0},
          f"LM-10 prefill: {pl} flash launches "
          f"{flash_attention.launches_by_variant}; want {n * L}, tc at "
          f"{dims}")
    rl["flash_attention_mla"] += pl
    by_var["flash_attention_mla"]["tc"] += pl
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"LM-10 prefill: {prefill_s:.3f} s wall, logits {shape} bf16 "
          f"finite, {pl} flash launches (tc, MLA mode); MoE assignments "
          f"dropped {pdrops.share():.4%} of {pdrops.total}; peak memory of "
          f"the phase {peak:.2f} GiB")
    del lm, logits, prefill
    torch.cuda.empty_cache()
    return dict(launches=rl, variants=by_var,
                by_head_dim={"flash_attention_mla": {
                    dims: rl["flash_attention_mla"]}},
                round_s=round_s, prefill_s=prefill_s, peak_gib=peak,
                kept=kept, drop_share=drops.share())


def phase_lm_deepseek_train(torch):
    """LM-11: DeepSeek-V3 trained with IDKD (``lmpath.train`` with
    ``lmpath.DEEPSEEK_TRAIN_CONFIG``: the published widths but 16 routed
    experts, MTP on, 2 layers; ``lmpath.DEEPSEEK_TRAIN``: 2 ring nodes,
    QG-DSGDm-N, batch 1, 2 public sequences a KD step, the round at step
    2, every layer recomputed), by _train_full's checks, the aux loss of
    each step printed; then the reduced DeepSeek-V3 and Arctic (f32: 2
    layers, 4 experts top-2, DeepSeek's MLA at 48 / 32 and its MTP) each
    trained the same 4 steps on the card and on the CPU from the same
    params and draws, to the same params and losses
    (_train_card_vs_cpu)."""
    from repro_torch import lmpath
    out = _train_full(torch, "LM-11", lmpath.DEEPSEEK_TRAIN_CONFIG,
                      lmpath.DEEPSEEK_TRAIN,
                      pub_batch=lmpath.DEEPSEEK_PUB_BATCH)
    # the kernels line counts the MLA mode's launches apart
    for key in ("launches", "variants", "by_head_dim"):
        for name in ("flash_attention", "flash_attention_bwd"):
            out[key][name + "_mla"] = out[key].pop(name)
    tcfg = dataclasses.replace(lmpath.TRAIN, idkd=dataclasses.replace(
        lmpath.TRAIN.idkd, stream_microbatch=5))
    from repro_torch.configs import get_config
    for arch in ("deepseek-v3-671b", "arctic-480b"):
        small = get_config(arch).reduced().replace(remat=True)
        t0 = time.perf_counter()
        dp, dl = _train_card_vs_cpu(torch, f"reduced {arch}", small, tcfg,
                                    seq_len=120, n_private=256, n_public=12)
        mla = f", MLA {_mla_dims(small)}" if small.mla.enabled else ""
        print(f"reduced {arch} (2 layers, {small.moe.num_experts} experts "
              f"top-{small.moe.num_experts_per_tok}{mla}"
              f"{', MTP' if small.mtp_depth else ''}, f32, per-layer "
              f"recompute), 4 steps on the card and on the CPU with the same "
              f"draws: consensus params within {dp:.3g} (tol "
              f"{TRAIN_PARAM_ATOL}), losses within {dl:.3g} relative (tol "
              f"{TRAIN_LOSS_RTOL}), label bytes equal "
              f"({time.perf_counter() - t0:.1f} s)")
    return out


def phase_lm_arctic(torch):
    """LM-12: Arctic's prefill at full width (``lmpath.
    ARCTIC_PREFILL_CONFIG``: d_model 7168, 56/8 heads x 128, 128 experts
    top-2 with the softmax router and the dense residual, d_ff 4864,
    vocabulary 32,000; 1 layer, 1 node, 14.07 B parameters): one
    ``make_prefill_step`` on 2 sequences of 2048 tokens. Prints its wall
    time, the share of MoE assignments dropped and the peak; fails unless
    the logits (1, 2, 2048, 32,000) are finite and the one flash launch
    is tc at head_dim 128."""
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import DecoderModel
    cfg = lmpath.ARCTIC_PREFILL_CONFIG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = DecoderModel(cfg)
    t0 = time.perf_counter()
    params = lmpath.node_params(model, [0], "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(v[0].numel() for v in params.values())
    B = lmpath.ARCTIC_PREFILL_BATCH
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (1, B, 2048), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(model)
    _zero_counts(flash_attention)
    with _DropCount(torch) as drops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    shape = (1, B, 2048, cfg.vocab_size)
    hd = cfg.resolved_head_dim
    check(tuple(logits.shape) == shape and bool(torch.isfinite(logits).all()),
          f"LM-12: logits {tuple(logits.shape)} (want {shape}, finite)")
    check(flash_attention.launches == 1 and
          flash_attention.launches_by_variant == {"tc": 1, "simt": 0} and
          flash_attention.launches_by_head_dim[hd] == 1,
          f"LM-12: flash launches {flash_attention.launches_by_variant}, by "
          f"head_dim {flash_attention.launches_by_head_dim}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"LM-12: Arctic ({cfg.num_layers} layer, {cfg.moe.num_experts} "
          f"experts top-{cfg.moe.num_experts_per_tok}, dense residual "
          f"{cfg.moe.dense_residual_ff}): {nparams / 1e9:.3f} B parameters, "
          f"set up in {init_s:.1f} s; prefill of {B} x 2048 tokens "
          f"{prefill_s:.3f} s wall, logits {shape} finite, 1 flash launch "
          f"(tc, head_dim {hd}); MoE assignments dropped {drops.share():.4%}"
          f" of {drops.total}; peak memory {peak:.2f} GiB")
    del params, logits
    torch.cuda.empty_cache()
    offset = sum(flash_attention.launches_by_mode["offset"].values())
    return dict(launches={"flash_attention": 1,
                          "flash_attention_offset": offset},
                variants={"flash_attention": {"tc": 1, "simt": 0}},
                by_head_dim={"flash_attention": {hd: 1}},
                prefill_s=prefill_s, peak_gib=peak)


def phase_lm_baselines(torch):
    """LM-9: the LM baselines at full width. ``lmpath.TRAIN``'s setting
    (Hymba-1.5B, 4 ring nodes, 2 sequences of 2048 per node, lr 0.1,
    every layer recomputed) with ``algorithm`` each of LM_BASELINES, 2
    steps each through ``lmpath.train_steps``: each step's wall time and
    loss, peak memory. Fails unless every loss is finite, the params
    moved, every flash launch is a tc launch at head_dim 64 and the
    launches per step are what the layer loop implies (nodes x layers
    backward, twice that forward under the recompute, for flash and for
    ``ssd_scan``), and the peak stays within TRAIN_PEAK_GIB. Then a
    reduced Hymba (f32) trained with each algorithm on the card and on
    the CPU (``_train_card_vs_cpu``: 2 plain steps, the round, 2 KD
    steps, the same draws)."""
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    cfg = lmpath.CONFIG
    n, L, hd = lmpath.TRAIN.num_nodes, cfg.num_layers, cfg.resolved_head_dim
    steps = 2
    flash = {"flash_attention": flash_attention,
             "flash_attention_bwd": flash_attention_bwd}
    ssd = {"ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd}
    launches = dict.fromkeys([*flash, *ssd, "flash_attention_offset",
                              "ssd_scan_state"], 0)
    variants = {k: {"tc": 0, "simt": 0} for k in flash}
    rows = {}
    for algo in LM_BASELINES:
        tcfg = dataclasses.replace(lmpath.TRAIN, algorithm=algo, idkd=None)
        for f in ssd.values():
            f.launches = 0
        _zero_serve_modes(flash_attention, ssd_scan)
        for f in flash.values():
            f.launches = 0
            f.launches_by_variant = {"tc": 0, "simt": 0}
            f.launches_by_head_dim = dict.fromkeys(f.launches_by_head_dim, 0)
        torch.cuda.empty_cache()
        out = lmpath.train_steps(cfg, tcfg, seq_len=lmpath.SEQ_LEN,
                                 steps=steps, device="cuda")
        losses = [st["loss"] for st in out["steps"]]
        secs = [st["s"] for st in out["steps"]]
        peak = out["peak_gib"]
        rows[algo] = dict(s=secs, loss=losses, peak_gib=peak)
        print(f"LM-9 {algo}: {cfg.name}, {n} ring nodes, {L} layers, "
              f"{tcfg.batch_size} x {lmpath.SEQ_LEN} tokens a node, lr "
              f"{tcfg.lr}: steps {[round(x, 3) for x in secs]} s, losses "
              f"{losses}, peak {peak:.2f} GiB, {out['moved']} of "
              f"{out['pairs']} (leaf, node) sums moved, flash launches "
              f"{[st['launches'] for st in out['steps']]}, ssd_scan "
              f"{ssd_scan.launches}, ssd_scan_bwd {ssd_scan_bwd.launches}")
        check(all(math.isfinite(x) for x in losses),
              f"LM-9 {algo}: losses {losses}")
        check(out["moved"] > 0, f"LM-9 {algo}: the params did not move")
        for i, st in enumerate(out["steps"]):
            for name, want in (("flash_attention", 2 * n * L),
                               ("flash_attention_bwd", n * L)):
                by = st["launches"][name]["causal"]
                check(by == {"tc": want, "simt": 0},
                      f"LM-9 {algo} step {i}: {name} launches {by}; the "
                      f"layer loop implies {want}, all tc")
        for name, f in flash.items():
            check(f.launches_by_head_dim[hd] == f.launches,
                  f"LM-9 {algo}: {name} by head_dim "
                  f"{f.launches_by_head_dim}")
        for name, want in (("ssd_scan", 2 * n * L * steps),
                           ("ssd_scan_bwd", n * L * steps)):
            check(ssd[name].launches == want,
                  f"LM-9 {algo}: {ssd[name].launches} {name} launches over "
                  f"{steps} steps; the schedule implies {want}")
        check(peak <= TRAIN_PEAK_GIB, f"LM-9 {algo}: peak memory "
                                      f"{peak:.1f} GiB > {TRAIN_PEAK_GIB}")
        for name, f in {**flash, **ssd}.items():
            launches[name] += f.launches
        for name, count in _serve_mode_counts(flash_attention,
                                              ssd_scan).items():
            launches[name] += count
        for name, f in flash.items():
            for v, c in f.launches_by_variant.items():
                variants[name][v] += c
        del out
        torch.cuda.empty_cache()
    small = cfg.reduced().replace(num_layers=3, num_kv_heads=2, remat=True)
    for algo in LM_BASELINES:
        tcfg = dataclasses.replace(
            lmpath.TRAIN, algorithm=algo, idkd=dataclasses.replace(
                lmpath.TRAIN.idkd, stream_microbatch=5))
        dp, dl = _train_card_vs_cpu(torch, f"reduced Hymba, {algo}", small,
                                    tcfg, seq_len=120, n_private=256,
                                    n_public=12)
        print(f"reduced Hymba, {algo}: 2 plain steps, the round and 2 KD "
              f"steps on the card and on the CPU with the same draws: "
              f"consensus params within {dp:.3g} (tol {TRAIN_PARAM_ATOL}), "
              f"losses within {dl:.3g} relative (tol {TRAIN_LOSS_RTOL})")
    dims = {k: {hd: launches[k]} for k in flash}
    return dict(launches=launches, variants=variants, by_head_dim=dims,
                rows=rows)


# ------------------------------------------- compressed and delayed gossip
def _gossip_sim(case):
    """GOSSIP's simulator for ``case`` (a row of GOSSIP_CASES): the main
    path (``mainpath.grid_sim``'s qg-idkd: ResNet-20, 16 ring nodes,
    QG-DSGDm-N at lr 0.5, the streaming sparse round with KD) cut to
    GOSSIP_STEPS steps, the round at GOSSIP_ROUND, with the case's wire."""
    from repro_torch.mainpath import grid_sim
    _, comp, gossip, _ = case
    return grid_sim("qg-idkd", GOSSIP_STEPS, GOSSIP_ROUND, GOSSIP_EVAL,
                    "cuda", compression=comp, gossip=gossip)


def _gossip_run(torch, case):
    """One GOSSIP run: the head_select counts set to 0 before and read
    after, the comm state's stale rows recorded at every segment end
    (the stale case), the state captured at the round; returns what
    GOSSIP prints and checks."""
    from repro_torch import sched
    from repro_torch.core import simulator
    from repro_torch.kernels.head_select import head_select
    name, comp, gossip, stale = case
    sim = _gossip_sim(case)
    events = ()
    if stale:
        nodes, lo, hi = GOSSIP_STALE
        events = (sched.ChurnEvent(lo, down=nodes, mode="stale"),
                  sched.ChurnEvent(hi, up=nodes, mode="stale"))
    schedule = sched.compile_schedule(
        GOSSIP_STEPS, GOSSIP_EVAL, round_steps=(GOSSIP_ROUND,),
        events=events, gossip=gossip)
    rows = []
    real = simulator._SimFederation.runner

    def runner(self, *a):
        run = real(self, *a)

        def recorded(p, o, g, s0, ns, **carries):
            out = run(p, o, g, s0, ns, **carries)
            if stale and run.comm:
                state = out[4]["prev" if comp is None else "hat"]
                rows.append((s0 + ns, {k: v[list(GOSSIP_STALE[0])].clone()
                                       for k, v in state.items()}))
            return out
        for f in ("comm", "metrics", "guard"):
            setattr(recorded, f, getattr(run, f))
        return recorded

    head_select.launches = 0
    head_select.launches_by_variant = dict.fromkeys(
        head_select.launches_by_variant, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Patch((simulator._SimFederation, "runner", runner)):
        res = sim.run(schedule, capture_at=GOSSIP_ROUND)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cap = res.captured
    ef = None
    if "comm" in cap:
        ref = cap["comm"]["prev" if comp is None else "hat"]
        sq = sum(((cap["params"][k].float().reshape(16, -1)
                   - ref[k].float().reshape(16, -1)) ** 2).sum(dim=1)
                 for k in ref)
        ef = sq.sqrt().cpu()
    return dict(sim=sim, wall_s=wall, res=res, ef=ef, rows=rows,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=head_select.launches,
                variants=dict(head_select.launches_by_variant),
                captured=cap)


def _gossip_bytes(torch, sim, case):
    """The ledger's gossip bytes by the formula: payload elements x
    (wire bytes + 4 index bytes) x active degree a node and step, stale
    senders at 0 over their window."""
    from repro_torch.core.mixing import payload_elem_count
    _, comp, _, stale = case
    proto = sim.model.init(torch.Generator().manual_seed(0))
    elems = payload_elem_count(proto, comp, node_stacked=False)
    per = elems * (4 + (4 if comp is not None else 0))
    topo = sim.gossip_topo
    deg = sum(topo.degree(i) for i in range(topo.n))
    total = deg * per * GOSSIP_STEPS
    if stale:
        nodes, lo, hi = GOSSIP_STALE
        total -= sum(topo.degree(i) for i in nodes) * per * (hi - lo)
    return total


def _mixer_card_vs_cpu(torch, params, comm, comp, gossip):
    """One stateful mixer step (the dense backend on the 16-node ring)
    on the card and on the CPU from the same params and comm state (a
    run's, captured at the round; random-k from the same uniforms, drawn
    on the CPU): each leaf's payload indices and x̂ after the step.
    Returns (indices all torch.equal, max |x̂ card - x̂ CPU|)."""
    from repro_torch.core import mixing
    from repro_torch.core.topology import Topology
    topo = Topology.make("ring", 16)
    g = torch.Generator().manual_seed(11)
    draws = {}

    def uniform(i, shape):
        if i not in draws:
            draws[i] = torch.rand(shape, generator=g)
        return draws[i]

    kind, frac = comp
    out = {}
    for dev in ("cuda", "cpu"):
        mix = mixing.make_compressed_mixer(
            topo, "dense", "float32", dev, compression=comp, gossip=gossip,
            uniform=uniform)
        hat = {k: v.to(dev).clone() for k, v in comm["hat"].items()}
        x = {k: v.to(dev) for k, v in params.items()}
        idx = {}
        for i, k in enumerate(hat):
            d = x[k].float().reshape(16, -1) - hat[k]
            r = uniform(i, d.shape).to(dev) if kind == "randk" else None
            idx[k] = mixing._select_payload(
                d, kind, mixing.payload_k(d.shape[1], frac), r)[1].cpu()
        bound = mix.bind({"hat": hat})
        bound(x)
        bound.finalize()
        out[dev] = (idx, {k: v.cpu() for k, v in hat.items()})
    same = all(torch.equal(out["cuda"][0][k], out["cpu"][0][k])
               for k in out["cpu"][0])
    dhat = max(float((out["cuda"][1][k] - out["cpu"][1][k]).abs().max())
               for k in out["cpu"][1])
    return same, dhat


def _tree_to(tree, device):
    """A copy of a nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True) if hasattr(tree, "to") else tree


def _topk_record(tape):
    """``mixing.topk_indices`` that appends each call's selection, on the
    host, to ``tape``."""
    from repro_torch.core import mixing
    real = mixing.topk_indices

    def record(a, k):
        idx = real(a, k)
        tape.append(idx.cpu())
        return idx
    return _Patch((mixing, "topk_indices", record))


def _topk_replay(torch, tape, calls):
    """``mixing.topk_indices`` that takes, call by call, the selections
    ``_topk_record`` put in ``tape``: a call takes the next rows of the
    current entry, so one entry may serve several calls (a node-stacked
    mixer selects in row blocks, a sharded one a rank's rows at once).
    It fails where a row of this run's own selection differs from the
    recorded one by more than a near-tie (TOPK_TIE_RTOL), and appends
    (rows, rows taken over) to ``calls``."""
    from repro_torch.core import mixing
    real = mixing.topk_indices
    pos = [0, 0]

    def replay(a, k):
        j, r0 = pos
        rows = a.shape[0]
        check(j < len(tape) and tape[j].shape[1] == k
              and r0 + rows <= tape[j].shape[0],
              f"top-k call {len(calls)} ({rows} rows, k {k}) was not "
              f"recorded")
        rec = tape[j][r0:r0 + rows].to(a.device)
        pos[:] = ([j, r0 + rows] if r0 + rows < tape[j].shape[0]
                  else [j + 1, 0])
        other = (real(a, k) != rec).any(dim=1)
        if bool(other.any()):
            least = a.gather(1, rec).amin(dim=1)
            left = a.scatter(1, rec, float("-inf")).amax(dim=1)
            gap = float(((left - least) / a.amax(dim=1).clamp(min=1.0))
                        [other].max())
            check(gap <= TOPK_TIE_RTOL,
                  f"top-k call {len(calls)}: the recorded payload leaves "
                  f"out a value {gap:.3g} (relative) above one it takes "
                  f"(tol {TOPK_TIE_RTOL})")
        calls.append((rows, int(other.sum())))
        return rec
    return _Patch((mixing, "topk_indices", replay))


def _uniform_replay(torch, seed):
    """Random-k's uniforms (``mixing._draw``) from one CPU generator
    seeded here, the comm's generator left unbound (a CUDA and a CPU
    torch.Generator give different numbers from one state)."""
    from repro_torch.core import mixing
    gen = torch.Generator().manual_seed(seed)

    def draw(_uniform, _gen, _i, shape, device):
        return torch.rand(shape, generator=gen).to(device)
    return _Patch((mixing, "_draw", draw),
                  (mixing, "_bind_generator", lambda *a: None))


def _run_steps(torch, sim, step, cap, device, t0, patches):
    """TRAJ_STEPS plain steps of ``step`` (``driver.make_step`` or
    ``make_shard_step``, with a comm carry) through the host runner, from
    the params, optimizer and comm state ``cap`` captured at step ``t0``
    (copied to ``device``), the private batches drawn as ``_same_draws``
    draws them, under ``patches``; returns (params, comm)."""
    import contextlib

    import repro_torch.core.driver as drv
    parts = drv.pad_partitions(sim.parts, device)
    sample = drv.make_classification_sampler(
        parts, sim.train_x.to(device), sim.train_y.to(device),
        sim.mcfg.num_classes, sim.tcfg.batch_size)
    run = drv.make_host_runner(step, sample, sim.lr_fn)
    s = _tree_to({k: cap[k] for k in ("params", "opt_state", "comm")},
                 device)
    with contextlib.ExitStack() as stack:
        for p in (_same_draws(torch, 7), *patches):
            stack.enter_context(p)
        out = run(s["params"], s["opt_state"], None, t0, TRAJ_STEPS,
                  comm=s["comm"])
    return out[0], out[4]


def _steps_scale(cap):
    """TRAJ_RTOL's and the card-vs-CPU checks' scale: max(1, max |x|)
    over the captured params."""
    return max(1.0, max(float(v.abs().max()) for v in cap["params"].values()))


def _gossip_steps_card_vs_cpu(torch, sim, cap, key):
    """TRAJ_STEPS plain steps of the run's own step (the simulator's
    prebuilt stateful mixer) from the state ``cap`` captured at the
    round, on the card and on the CPU (the same step built there), from
    the same batches and random-k uniforms. The CPU run takes the card's
    ReLU branches (``_relu_replay``) and top-k payloads
    (``_topk_replay``) where the two differ by a near-tie only. Returns
    (params error, error of the comm's ``key`` (x̂ or prev), top-k rows
    taken over, ReLU inputs taken over)."""
    import repro_torch.core.driver as drv
    from repro_torch.core.mixing import make_mixer
    cpu_step = drv.make_step(
        sim.model, sim.algo,
        make_mixer(sim.gossip_topo, "dense", wire_dtype=sim.wire_dtype,
                   device="cpu", compression=sim.compression,
                   gossip=sim.gossip),
        drv.classification_adapter)
    tape, masks, calls, flips = [], [], [], []
    out = {}
    for dev, step, pats in (
            ("cuda", sim.steps["plain"],
             [_topk_record(tape), _relu_record(masks)]),
            ("cpu", cpu_step,
             [_topk_replay(torch, tape, calls),
              _relu_replay(torch, masks, flips)])):
        if sim.compression is not None and sim.compression[0] == "randk":
            pats.append(_uniform_replay(torch, 11))
        p, comm = _run_steps(torch, sim, step, cap, dev, GOSSIP_ROUND, pats)
        out[dev] = [{k: v.cpu() for k, v in t.items()}
                    for t in (p, comm[key])]
        del p, comm
    check(sum(r for r, _ in calls) == sum(t.shape[0] for t in tape)
          and len(flips) == len(masks),
          f"the CPU steps made {len(calls)} top-k and {len(flips)} ReLU "
          f"calls, the card's {len(tape)} and {len(masks)}")
    return (_max_diff(torch, out["cuda"][0], out["cpu"][0]),
            _max_diff(torch, out["cuda"][1], out["cpu"][1]),
            sum(t for _, t in calls), sum(flips))


def phase_gossip(torch):
    """GOSSIP: compressed, delayed and straggler gossip on the ResNet main
    path at full width (``mainpath.grid_sim``'s qg-idkd, 16 ring nodes,
    cut to GOSSIP_STEPS steps, the round at GOSSIP_ROUND): the plain
    sync run, then (a) top-k 1% sync, (b) random-k 1%, (c) top-k 1%
    delayed, (d) uncompressed delayed, (e) two stale stragglers over
    GOSSIP_STALE on sync gossip, one run each; each run's accuracy, NLL,
    wall time a step, peak, ledger bytes and EF residual at the round.
    Gates: the ledger's bytes to the byte against the payload formula
    (stale senders at 0), no run's final accuracy more than
    GOSSIP_ACC_BAND below the plain run's, the straggler's x̂ (prev) rows
    unchanged over its window, every head_select launch simt; then, on
    the plain run's params at the round, (f) the gather mixer on the
    15-node Florentine graph, and roll and auto on the ring, against
    dense within GOSSIP_MIX_ATOL on every leaf, top-k at frac 1 and γ 1
    against the dense mix within f32 rounding, the stateful
    uncompressed sync mixer bitwise the plain one; and one mixer step
    of (a)'s and (b)'s captured state on the card against the CPU:
    payload indices torch.equal, x̂ within GOSSIP_MIX_ATOL. Each run
    with a stateful step, (a) to (d), is then held exactly over
    TRAJ_STEPS steps from its state at the round
    (``_gossip_steps_card_vs_cpu``: the comm carried through the host
    runner, card vs CPU, params and x̂ or prev within TRAJ_RTOL).

    The whole runs are not held to CPU twins: a top-k whose k-th and
    (k+1)-th magnitudes differ by less than the card's and the CPU's
    float differences takes another coordinate, and the momentum grows
    the difference step after step; over TRAJ_STEPS steps the CPU takes
    the card's payload at such a near-tie (and fails on any other
    difference), end to end the accuracy band against the uncompressed
    run catches a run that breaks."""
    from repro_torch.core import mixing
    from repro_torch.core.topology import Topology
    runs, launches, variants = {}, 0, {}
    for case in GOSSIP_CASES:
        name, comp, gossip, stale = case
        r = _gossip_run(torch, case)
        res = r["res"]
        led = res.ledger["gossip_bytes"]
        want = _gossip_bytes(torch, r["sim"], case)
        check(led == want, f"GOSSIP {name}: ledger {led} gossip bytes, the "
                           f"payload formula {want}")
        check(r["launches"] > 0
              and r["variants"].get("simt", 0) == r["launches"],
              f"GOSSIP {name}: head_select launches {r['variants']}; all "
              f"must be simt")
        check(all(math.isfinite(x) for x in res.loss_history),
              f"GOSSIP {name}: eval NLL {res.loss_history}")
        launches += r["launches"]
        for v, c in r["variants"].items():
            variants[v] = variants.get(v, 0) + c
        if stale:
            nodes, lo, hi = GOSSIP_STALE
            at = dict(r["rows"])
            check(lo in at and hi in at and all(
                torch.equal(at[lo][k], at[hi][k]) for k in at[lo]),
                f"GOSSIP {name}: the stragglers' rows moved over "
                f"[{lo}, {hi})")
            check(not all(torch.equal(at[hi][k], at[GOSSIP_STEPS][k])
                          for k in at[hi]),
                  f"GOSSIP {name}: the stragglers' rows never moved after "
                  f"{hi}")
        ef = r["ef"]
        runs[name] = r
        traj = ""
        if r["sim"]._prebuilt_stateful:
            key = "prev" if comp is None else "hat"
            scale = _steps_scale(r["captured"])
            dp, dh, taken, flips = _gossip_steps_card_vs_cpu(
                torch, r["sim"], r["captured"], key)
            check(dp <= TRAJ_RTOL * scale and dh <= TRAJ_RTOL * scale,
                  f"GOSSIP {name}: {TRAJ_STEPS} steps from the round's state "
                  f"on the card and on the CPU: params within {dp:.3g}, "
                  f"{key} within {dh:.3g} > {TRAJ_RTOL} x {scale:.4g}")
            traj = (f"; {TRAJ_STEPS} steps from the round's state, card vs "
                    f"CPU: params within {dp:.3g}, {key} within {dh:.3g} "
                    f"(tol {TRAJ_RTOL} x {scale:.4g}; near-ties taken "
                    f"over: {taken} top-k rows, {flips} ReLU inputs)")
        print(f"GOSSIP {name} (16 ring nodes, {GOSSIP_STEPS} steps, the "
              f"round at {GOSSIP_ROUND}): accuracy {res.acc_history}, NLL "
              f"{[round(x, 4) for x in res.loss_history]}; "
              f"{r['wall_s'] / GOSSIP_STEPS * 1e3:.2f} ms a step "
              f"({r['wall_s']:.2f} s), peak {r['peak_gib']:.3f} GiB; ledger "
              f"gossip {led:.0f} B (the formula's to the byte), "
              f"{res.comm_bytes_per_iter:.0f} B a node and step; EF "
              f"residual at the round "
              f"{'none' if ef is None else f'{float(ef.mean()):.4g} mean, {float(ef.max()):.4g} max'}"
              f"; head_select launches {r['variants']}{traj}")
        del r["sim"]
    plain = runs[GOSSIP_CASES[0][0]]
    base_acc = plain["res"].final_acc
    for name, r in runs.items():
        d = base_acc - r["res"].final_acc       # one-sided: a run below
        check(d <= GOSSIP_ACC_BAND,
              f"GOSSIP {name}: final accuracy {r['res'].final_acc} is "
              f"{d:.4f} below the plain run's {base_acc} > "
              f"{GOSSIP_ACC_BAND}")
    ratio = {name: plain["res"].ledger["gossip_bytes"]
             / r["res"].ledger["gossip_bytes"] for name, r in runs.items()}
    print(f"GOSSIP: uncompressed over each run's ledger bytes "
          f"{ {k: round(v, 3) for k, v in ratio.items()} }; final "
          f"accuracy at most {GOSSIP_ACC_BAND} below the plain run's "
          f"{base_acc}")

    # (f) and the oracles, on the plain run's params at the round
    x = {k: v for k, v in plain["captured"]["params"].items()}
    ring = Topology.make("ring", 16)
    dense = mixing.make_mixer(ring, "dense", device="cuda")(x)
    worst = {}
    for backend in ("roll", "auto"):
        y = mixing.make_mixer(ring, backend, device="cuda")(x)
        worst[backend] = max(float((y[k] - dense[k]).abs().max())
                             for k in x)
    flor = Topology.make("social", 15)
    x15 = {k: v[:15] for k, v in x.items()}
    yd = mixing.make_mixer(flor, "dense", device="cuda")(x15)
    yg = mixing.make_mixer(flor, "gather", device="cuda")(x15)
    worst["gather (Florentine 15)"] = max(float((yg[k] - yd[k]).abs().max())
                                          for k in x)
    for what, w in worst.items():
        check(w <= GOSSIP_MIX_ATOL, f"GOSSIP (f): {what} against dense: "
                                    f"{w:.3g} > {GOSSIP_MIX_ATOL}")
    full = mixing.make_mixer(ring, "dense", device="cuda",
                             compression=("topk", 1.0))
    b = full.bind(full.init_state(x))
    yf = b(x)
    b.finalize()
    scale = max(1.0, max(float(v.abs().max()) for v in x.values()))
    dfull = max(float((yf[k] - dense[k]).abs().max()) for k in x)
    check(dfull <= GOSSIP_MIX_ATOL * scale,
          f"GOSSIP: top-k at frac 1, γ 1 against the dense mix: {dfull:.3g}"
          f" > {GOSSIP_MIX_ATOL} x {scale:.3g}")
    st = mixing.make_mixer(ring, "dense", device="cuda", stateful=True)
    b = st.bind(st.init_state(x))
    ys = b(x)
    b.finalize()
    check(all(torch.equal(ys[k], dense[k]) for k in x),
          "GOSSIP: the stateful uncompressed sync mixer is not bitwise the "
          "plain one")
    print(f"GOSSIP (f): roll, auto (ring 16) and gather (Florentine 15) "
          f"against dense on every leaf: "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (tol "
          f"{GOSSIP_MIX_ATOL}); top-k at frac 1, γ 1 within {dfull:.3g} of "
          f"the dense mix; the stateful uncompressed sync mixer bitwise "
          f"the plain one")
    for name, comp, gossip, _ in GOSSIP_CASES:
        if comp is None or "hat" not in runs[name]["captured"].get("comm",
                                                                    {}):
            continue
        cap = runs[name]["captured"]
        same, dhat = _mixer_card_vs_cpu(torch, cap["params"], cap["comm"],
                                        comp, gossip)
        check(same and dhat <= GOSSIP_MIX_ATOL,
              f"GOSSIP {name}: a mixer step on the card against the CPU: "
              f"indices equal {same}, x̂ within {dhat:.3g}")
        print(f"GOSSIP {name}: one mixer step on the card and on the CPU "
              f"from the captured state: payload indices torch.equal, x̂ "
              f"within {dhat:.3g} (tol {GOSSIP_MIX_ATOL})")
    return {"head_select": launches}, {"head_select": variants}


def phase_lm_gossip(torch):
    """LM-14: compressed, delayed gossip at full width. ``run_training``
    on ``lmpath.TRAIN``'s setting (Hymba-1.5B, 4 ring nodes, 2 sequences
    of 2048 tokens a node, lr 0.1, every layer recomputed) with top-k 1%
    deltas, delayed gossip and the default ``auto`` backend (the roll
    mixer on the ring), LM14_STEPS plain QG-DSGDm-N steps (the memory
    reckoning in PERF.md leaves no room for the round and the KD steps
    beside the f32 estimates), with the metrics bus on for the EF
    residual: each step's seconds and loss, the peak, the ledger's gossip
    bytes against the uncompressed bytes, the EF residual. Fails unless
    every loss is finite, the ledger's bytes are the payload formula's,
    the EF residual is finite and non-zero and the peak stays within
    TRAIN_PEAK_GIB. Then a reduced Hymba (f32) trained with the same wire
    (2 plain steps, the round, 2 KD steps) on the card and on the CPU
    with the same draws (``_train_card_vs_cpu``), held as LM-4's plain
    run is: consensus params within TRAIN_PARAM_ATOL, losses within
    TRAIN_LOSS_RTOL, label bytes equal. A top-k near-tie that the two
    devices' f32 sums break differently would move one payload
    coordinate and part the runs, so the CPU run takes the card's
    payload there, and fails on any other difference."""
    import tempfile

    import repro_torch.core.driver as drv
    from repro_torch import lmpath
    from repro_torch.core.mixing import payload_elem_count
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.launch.train import run_training
    from repro_torch.obs import Telemetry, read_events
    from repro_torch.sched import wire_elem_bytes
    cfg = lmpath.CONFIG
    comp = ("topk", 0.01)
    tcfg = dataclasses.replace(lmpath.TRAIN, steps=LM14_STEPS, idkd=None,
                               compression=comp[0],
                               compression_frac=comp[1], gossip="delayed")
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd}
    _zero_counts(flash_attention, flash_attention_bwd, ssd_scan,
                 ssd_scan_bwd)
    steps = []
    make_step = drv.make_step

    def timed_make_step(*a, **kw):
        real = make_step(*a, **kw)

        def step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args)
            torch.cuda.synchronize()
            steps.append(dict(s=time.perf_counter() - t0,
                              loss=float(out[2])))
            return out
        for f in ("comm", "metrics", "guard", "init_comm", "init_opt"):
            if hasattr(real, f):
                setattr(step, f, getattr(real, f))
        return step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lm14_") as tel_dir:
        tel = Telemetry(tel_dir)
        try:
            with _Patch((drv, "make_step", timed_make_step)):
                out = run_training(cfg, tcfg, seq_len=lmpath.SEQ_LEN,
                                   n_seqs=lmpath.N_PRIVATE,
                                   n_public=lmpath.N_PUBLIC, log_every=1,
                                   verbose=False, driver_mode="host",
                                   telemetry=tel, device="cuda")
        finally:
            tel.close()
        flushes = [e for e in read_events(f"{tel_dir}/run.jsonl")
                   if e["ev"] == "metrics"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: f.launches for k, f in counters.items()}
    launches.update(_serve_mode_counts(flash_attention, ssd_scan))
    variants = {k: dict(counters[k].launches_by_variant)
                for k in ("flash_attention", "flash_attention_bwd")}
    by_dim = {k: dict(counters[k].launches_by_head_dim)
              for k in ("flash_attention", "flash_attention_bwd")}
    hist, led = out["loss_history"], out["ledger"]
    # the consensus params carry each leaf's per-node shape
    elems = payload_elem_count(out["params"], comp, node_stacked=False)
    del out
    torch.cuda.empty_cache()
    n = tcfg.num_nodes
    nparams = led["meta"]["param_count"]
    eb = wire_elem_bytes("native", cfg.dtype)      # bf16: 2
    dense_bytes = n * 2 * nparams * eb * LM14_STEPS
    ef = [max(f["ef_residual"]) for f in flushes]
    print(f"LM-14: {cfg.name}, {n} ring nodes, top-k 1% delayed gossip "
          f"(auto: the roll mixer), {LM14_STEPS} plain steps: "
          f"{wall:.1f} s wall with set-up, peak {peak:.2f} GiB; steps "
          f"{[round(st['s'], 2) for st in steps]} s, losses {hist}; ledger "
          f"gossip {led['gossip_bytes']:.0f} B against {dense_bytes} B "
          f"uncompressed: "
          f"{dense_bytes / led['gossip_bytes']:.2f}x fewer ({elems} of "
          f"{nparams} elements a node a send); EF residual "
          f"(max over nodes, each flush) {ef}")
    check(len(steps) == LM14_STEPS and len(hist) == LM14_STEPS
          and all(math.isfinite(x) for x in hist),
          f"LM-14: losses {hist} over {len(steps)} steps")
    want = n * 2 * elems * (eb + 4) * LM14_STEPS
    check(led["gossip_bytes"] == want,
          f"LM-14: ledger {led['gossip_bytes']} gossip bytes, the payload "
          f"formula {want}")
    check(ef and all(math.isfinite(v) and v > 0 for v in ef),
          f"LM-14: EF residual {ef}")
    check(peak <= TRAIN_PEAK_GIB, f"LM-14: peak memory {peak:.1f} GiB > "
                                  f"{TRAIN_PEAK_GIB} GiB")
    for name, by in variants.items():
        check(launches[name] > 0 and by == {"tc": launches[name], "simt": 0},
              f"LM-14: {name}: {by} of {launches[name]} launches; all tc")
    check(launches["ssd_scan"] > 0 and launches["ssd_scan_bwd"] > 0,
          f"LM-14: ssd_scan launches {launches}")

    small = cfg.reduced().replace(num_layers=3, num_kv_heads=2, remat=True)
    tsmall = dataclasses.replace(lmpath.TRAIN, compression=comp[0],
                                 compression_frac=comp[1], gossip="delayed",
                                 idkd=dataclasses.replace(
                                     lmpath.TRAIN.idkd, stream_microbatch=5))
    calls = []
    dp, dl = _train_card_vs_cpu(torch, "LM-14 reduced Hymba", small, tsmall,
                                calls=calls, seq_len=120, n_private=256,
                                n_public=12)
    print(f"LM-14 reduced Hymba (f32), top-k 1% delayed, 2 plain steps, "
          f"the round, 2 KD steps on the card and on the CPU with the same "
          f"draws: consensus params within {dp:.3g} (tol "
          f"{TRAIN_PARAM_ATOL}), losses within {dl:.3g} relative (tol "
          f"{TRAIN_LOSS_RTOL}), label and gossip bytes equal; top-k rows "
          f"whose near-tie took the card's payload on the CPU: "
          f"{sum(t for _, t in calls)} of {sum(r for r, _ in calls)}")
    return dict(launches=launches, variants=variants, by_head_dim=by_dim,
                steps=steps, peak_gib=peak, hist=hist)


# ------------------------------------------------------------ serving
def _serve_params(torch, cfg, seed):
    """One model's params on the card, drawn from ``seed``."""
    from repro_torch.models.transformer import DecoderModel
    model = DecoderModel(cfg)
    return model, model.init(seed, "cuda")


def _serve_server(torch):
    """SERVE (a): ``launch.serve.BatchedServer`` on Qwen3-1.7B at full
    width in its config dtype (bf16): SERVE_REQUESTS requests drawn as
    the reference's ``main`` draws them (``np.random.default_rng(0)``),
    SERVE_SLOTS slots, prompts of SERVE_PROMPT tokens, SERVE_NEW new
    tokens, a cache of SERVE_CONTEXT; then request 0's prompt alone,
    twice. Every kernel's launches are counted from just before the
    first submission to just after the last: the serving path, plain
    torch as in the reference, launches none. Returns the server (its
    last wave's caches feed (c)), its figures and those counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.head_select import head_select
    from repro_torch.kernels.msp_select import msp_select
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.launch.serve import BatchedServer, Request
    kernels = (flash_attention, flash_attention_bwd, head_select, msp_select,
               ssd_scan, ssd_scan_bwd)
    cfg = get_config("qwen3-1.7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(cfg, batch_slots=SERVE_SLOTS,
                           context=SERVE_CONTEXT, seed=0)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, SERVE_PROMPT
                                    ).astype(np.int32), SERVE_NEW)
            for i in range(SERVE_REQUESTS)]
    _zero_counts(*kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.submit_all(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    waves = -(-SERVE_REQUESTS // SERVE_SLOTS)
    steps = waves * (SERVE_PROMPT + SERVE_NEW)
    ntok = sum(len(v) for v in out.values())
    check(set(out) == set(range(SERVE_REQUESTS)) and all(
        len(v) == SERVE_NEW and all(0 <= x < cfg.vocab_size for x in v)
        for v in out.values()),
        f"SERVE (a): {len(out)} answers, lengths "
        f"{sorted(len(v) for v in out.values())}")
    alone = [server.submit_all([Request(0, reqs[0].prompt.copy(),
                                        SERVE_NEW)])[0] for _ in range(2)]
    check(alone[0] == alone[1], "SERVE (a): greedy decode of request 0's "
                                "prompt alone differs between two runs")
    launches = {f.__name__: f.launches for f in kernels}
    launches.update(_serve_mode_counts(flash_attention, ssd_scan))
    check(not any(launches.values()), f"SERVE (a): the serving path "
                                      f"launched kernels {launches}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wbytes = sum(t.numel() * t.element_size() for t in server.params.values())
    kv = server.state[0]["kv"]
    cache_bytes = kv.k.numel() * kv.k.element_size() * 2
    bound = (wbytes + cache_bytes) / H100_BYTES_PER_S * 1e3
    ms = wall / steps * 1e3
    print(f"SERVE (a): BatchedServer, {cfg.name} ({wbytes / 1e9:.3f} GB of "
          f"bf16 weights), {SERVE_REQUESTS} requests on {SERVE_SLOTS} slots, "
          f"prompt {SERVE_PROMPT}, {SERVE_NEW} new tokens, context "
          f"{SERVE_CONTEXT}: {wall:.2f} s for {waves} waves x "
          f"{SERVE_PROMPT + SERVE_NEW} decode steps, {ms:.3f} ms a step, "
          f"{ntok / wall:.1f} new tokens/s, peak {peak:.2f} GiB; a step's "
          f"bytes bound {bound:.3f} ms (weights + a full cache at "
          f"{H100_BYTES_PER_S / 1e12:.2f} TB/s): {ms / bound:.1f}x it; "
          f"request 0 alone twice: the same {SERVE_NEW} tokens "
          f"({alone[0][:6]} ...); kernel launches {launches}")
    return server, dict(ms_per_step=ms, tok_per_s=ntok / wall,
                        peak_gib=peak, bound_ms=bound), launches


def _serve_state_err(got, want):
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _serve_vs_forward(torch, label, cfg, B, S, tol, seed, ssd_states=False,
                      graph=True):
    """SERVE (b) for one model: ``decode_step`` token by token (through
    ``launch.steps.make_decode_step``) against ``forward`` on the same
    tokens, the max |logit difference| within ``tol`` (the reference's
    test's); returns {kernel: launches} of the forward (its flash and
    ssd_scan kernels), the flash variants and the error. With ``graph``
    the first step runs as it is and steps 2 to S replay it from a CUDA
    graph captured here, the tokens copied into its input (the same
    kernels on the same state, which the step updates in place; host
    dispatch, ~50 ms a step at full width, would otherwise take most of
    SERVE's time). With ``ssd_states`` each SSM layer's decode state
    after the S tokens is held to the final state that the forward's
    ``ssd_chunked`` returns through the kernel's state mode
    (SERVE_STATE_RTOL of max(1, max |h|)); ``ssm_forward`` asks for none,
    so the forward's calls are made to ask for it here. A MoE model (B
    1) runs without the graph, and the forward must drop no assignment
    past capacity (decode, a token at a time, never drops)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import ssm as ssm_mod
    t0 = time.perf_counter()
    model, params = _serve_params(torch, cfg, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K = cfg.num_codebooks
    shape = (B, S, K) if K > 1 else (B, S)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    batch = {"tokens": tokens[None]}
    memory = None
    if cfg.cross_attention:
        memory = torch.randn((B, cfg.cross_attn_len, cfg.d_model),
                             generator=gen, device="cuda")
        batch["conditioning"] = memory[None]
    finals = []
    real = ssm_mod.ssd_chunked

    def recorded(*a, **kw):
        out = real(*a, **{**kw, "return_final_state": True})
        finals.append(out[1])
        return out
    moe = cfg.moe.enabled
    _zero_counts(flash_attention, ssd_scan)
    torch.cuda.reset_peak_memory_stats()
    patches = [(ssm_mod, "ssd_chunked", recorded)] if ssd_states else []
    with torch.no_grad(), _Patch(*patches), _DropCount(torch) as drops:
        full, _ = model.forward({k: v[None] for k, v in params.items()},
                                batch)
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches_by_mode["y"],
                "ssd_scan_state": ssd_scan.launches_by_mode["state"]}
    variants = dict(flash_attention.launches_by_variant)
    dims = {d: n for d, n in flash_attention.launches_by_head_dim.items()
            if n}
    full = full[0]
    state = model.init_decode_state(B, S)
    step = make_decode_step(model)
    extras = () if memory is None else (memory,)
    errs = torch.zeros((S,), device="cuda")

    def run(tok):
        return step(params, tok, state, *extras)[0]
    graph = graph and not moe
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # the first step, and warm-up
        errs[0] = (run(tokens[:, :1])[:, 0].float()
                   - full[:, 0].float()).abs().max()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        tok = tokens[:, 1:2].clone()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = run(tok)
    for i in range(1, S):
        if graph:
            tok.copy_(tokens[:, i:i + 1])
            g.replay()
        else:
            out = run(tokens[:, i:i + 1])
        errs[i] = (out[:, 0].float() - full[:, i].float()).abs().max()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / S * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if moe:
        print(f"SERVE (b) {label}: the forward's MoE assignments dropped "
              f"past capacity {drops.share():.4f}")
        check(drops.share() == 0, f"SERVE (b) {label}: the forward dropped "
                                  f"{drops.share():.4f} of its assignments")
    err = float(errs.max())
    check(math.isfinite(err) and err < tol,
          f"SERVE (b) {label}: decode against forward max |logit diff| "
          f"{err:.3g} (tol {tol}); by position {errs.tolist()}")
    serr = None
    if ssd_states:
        got = state[0]["ssm"].ssm
        check(len(finals) == got.shape[0], f"SERVE (b) {label}: "
              f"{len(finals)} ssd_chunked calls for {got.shape[0]} layers")
        serr = max(_serve_state_err(got[li], f)
                   for li, f in enumerate(finals))
        check(serr <= SERVE_STATE_RTOL,
              f"SERVE (b) {label}: decode SSM states against the forward's "
              f"ssd_scan final states {serr:.3g} of max(1, max |h|) (tol "
              f"{SERVE_STATE_RTOL})")
    print(f"SERVE (b) {label}: B {B}, S {S}, f32: decode vs forward max "
          f"|logit diff| {err:.3g} (tol {tol}); "
          + (f"each layer's decode SSM state vs the forward's ssd_scan final "
             f"state {serr:.3g} of max(1, max |h|) (tol "
             f"{SERVE_STATE_RTOL}); " if serr is not None else "")
          + f"decode {ms:.2f} ms a step "
          f"({'a CUDA graph replayed' if graph else 'as it is'}); forward "
          f"launches {launches} (flash {variants}); peak {peak:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s")
    del params, full, state, finals, model
    torch.cuda.empty_cache()
    return launches, variants, dims


def _offset_visible(torch, B, Sq, Sk, window, q_offset, valid):
    """(B, Sq, Sk) mask of the keys each row sees in the offset mode."""
    pos = q_offset + torch.arange(Sq, device="cuda")
    kp = torch.arange(Sk, device="cuda")
    lim = torch.full((B,), Sk, device="cuda") if valid is None else valid
    allow = (kp[None, None] <= pos[None, :, None]) \
        & (kp[None, None] < lim[:, None, None])
    if window:
        allow &= pos[None, :, None] - kp[None, None] < window
    return allow


def _offset_row(torch, gen, label, B, Sq, Sk, H, KVH, D, window, q_offset,
                valid, dtype, timing=True):
    """SERVE (c): the flash offset mode (q_offset, kv_valid_len) against
    its plain version by FLASH_ATOL (every row of these shapes sees a
    key); timed beside its bound (the visible pairs of these inputs, and
    of K and V only the keys some row sees), the plain version and SDPA
    with the same boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    dname = str(dtype).split(".")[-1]
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KVH, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KVH, D), generator=gen, device="cuda").to(dtype)
    kv = None if valid is None else torch.tensor(valid, device="cuda",
                                                 dtype=torch.int32)
    kw = dict(window=window, q_offset=q_offset, kv_valid_len=kv)
    tag = (f"flash_attention offset {label}B={B} Sq={Sq} Sk={Sk} "
           f"{H}/{KVH}x{D} window={window} q_offset={q_offset} "
           f"kv_valid_len={valid} {dname}")
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    allow = _offset_visible(torch, B, Sq, Sk, window, q_offset, kv)
    check(bool(allow.any(-1).all()), f"{tag}: a row sees no key")
    err = float((out.float() - ref.float()).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= FLASH_ATOL[dname],
          f"{tag}: max error {err:.3g} > {FLASH_ATOL[dname]}")
    row = dict(window=window, dtype=dname, err=err,
               shape=f"B {B} Sq {Sq} Sk {Sk} H {H}/{KVH} D {D} "
                     f"q_offset {q_offset} valid {valid}")
    if not timing:
        print(f"{tag}: variant {flash_ops._variant(dtype, D)}, max_abs_err "
              f"{err:.3g} (tol {FLASH_ATOL[dname]})")
        return row
    pairs = float(allow.sum())
    keys = float(allow.any(1).sum())          # (b, key) read at all
    nbytes = (2 * B * Sq * H * D + 2 * keys * KVH * D) * q.element_size()
    flops = 4.0 * D * H * pairs
    bnd, by = bound_ms(nbytes, flops, dname)
    ms = timed(lambda: flash_attention(q, k, v, **kw), 10, torch)
    pms = timed(lambda: flash_attention_plain(q, k, v, **kw), 2, torch)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = allow[:, None]

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - ref.float()
                     ).abs().max())
    lms = timed(lib, 10, torch)
    row.update(ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
               library_ms=lms)
    print(f"{tag}: variant {flash_ops._variant(dtype, D)}, max_abs_err "
          f"{err:.3g} (tol {FLASH_ATOL[dname]}); {ms:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}, {bnd / ms:.2%} of it), plain {pms:.3f} ms, "
          f"sdpa with the boolean mask {lms:.4f} ms (its max diff from the "
          f"plain version {lib_err:.3g})")
    return row


def _serve_decode_vs_kernel(torch, server):
    """SERVE (c): for full-cache layers of (a)'s last wave, one more
    ``attention_decode`` step (its output before ``wo``: ``wo`` set to
    the identity, which rounds nothing) against the offset mode on the
    cache it wrote: ``chunked_attention(q_t, k_cache, v_cache,
    q_offset=t, kv_valid_len=t + 1)``, the kernel, by FLASH_ATOL."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_rope, sub
    cfg = server.cfg
    kv = server.state[0]["kv"]
    L, B = kv.k.shape[0], kv.k.shape[1]
    t = int(kv.length[0, 0])
    check(bool((kv.length == t).all()), "SERVE (c): cache lengths differ")
    gen = torch.Generator(device="cuda").manual_seed(31)
    dtype = kv.k.dtype
    HD = cfg.num_heads * cfg.resolved_head_dim
    eye = torch.eye(HD, device="cuda", dtype=dtype)
    errs = []
    for li in (0, L // 2, L - 1):
        p = {k: v[li] for k, v in sub(server.params,
                                      "layers_0/attn/").items()}
        p["wo"] = eye
        cache = attn.KVCache(*(x[li].clone() for x in kv))
        x = torch.randn((B, 1, cfg.d_model), generator=gen,
                        device="cuda").to(dtype)
        with torch.no_grad():
            o, cache = attn.attention_decode(p, x, cfg, cache)
            q, _, _ = attn._project_qkv(p, x, cfg)
            pos = torch.full((B, 1), t, device="cuda")
            q = apply_rope(q, pos, cfg.rope_theta)
            got = attn.chunked_attention(
                q, cache.k, cache.v, q_offset=t,
                kv_valid_len=torch.full((B,), t + 1, device="cuda",
                                        dtype=torch.int32))
        err = float((got.reshape(o.shape).float() - o.float()).abs().max())
        check(err <= FLASH_ATOL["bfloat16"],
              f"SERVE (c): layer {li}: attention_decode at step {t} against "
              f"the offset kernel, max error {err:.3g} > "
              f"{FLASH_ATOL['bfloat16']}")
        errs.append(err)
    print(f"SERVE (c): attention_decode at step {t} (cache capacity "
          f"{kv.k.shape[2]}, {B} slots) against chunked_attention(q_t, "
          f"k_cache, v_cache, q_offset={t}, kv_valid_len={t + 1}) through "
          f"the tc kernel, layers 0, {L // 2}, {L - 1}: max errors "
          f"{[f'{e:.3g}' for e in errs]} (tol {FLASH_ATOL['bfloat16']})")
    return [dict(window=0, dtype="bfloat16", err=e) for e in errs]


def _ssd_state_row(torch, gen, label, B, S, H, P, G, N, split,
                   timing=True):
    """SERVE (d): ssd_scan from a random initial state with its final
    state, y and h_T, and the continuation (split at ``split``, the
    second part from the first's h_T), each against the plain version in
    float64 by the SSD_VS_F32 rule; timed beside its bound and the plain
    version."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    x = torch.randn((B, S, H, P), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda") - 2)
    a = -torch.exp(torch.linspace(0, 4, H, device="cuda"))
    ins = ((x * dt[..., None]).contiguous(), (dt * a).contiguous(),
           torch.randn((B, S, G, N), generator=gen, device="cuda"),
           torch.randn((B, S, G, N), generator=gen, device="cuda"))
    h0 = torch.randn((B, H, P, N), generator=gen, device="cuda")
    kw = dict(chunk=256, initial_state=h0, return_final_state=True)
    y, h = ssd_scan(*ins, **kw)
    y1, h1 = ssd_scan(*(t[:, :split].contiguous() for t in ins), chunk=256,
                      initial_state=h0, return_final_state=True)
    y2, h2 = ssd_scan(*(t[:, split:].contiguous() for t in ins), chunk=256,
                      initial_state=h1, return_final_state=True)
    py, ph = ssd_scan_plain(*ins, **kw)
    ey, eh = ssd_scan_plain(*(t.double() for t in ins), chunk=256,
                            initial_state=h0.double(),
                            return_final_state=True)
    tag = f"ssd_scan state {label}(B {B}, S {S}, H {H}, P {P}, N {N})"
    errs = []
    for what, got, plain, exact in (
            ("y", y, py, ey), ("h_T", h, ph, eh),
            ("continued y", torch.cat([y1, y2], 1), py, ey),
            ("continued h_T", h2, ph, eh)):
        e_k = float((got.double() - exact).abs().max())
        e_p = float((plain.double() - exact).abs().max())
        check(bool(torch.isfinite(got).all())
              and e_k <= SSD_VS_F32 * e_p + SSD_ATOL,
              f"{tag} {what}: max error against float64 {e_k:.3g}, the "
              f"plain f32 version's {e_p:.3g}")
        errs.append((what, e_k, e_p))
    del ey, eh
    print(f"{tag}, split at {split}: max error against the float64 plain "
          f"version (kernel, plain f32): " + "; ".join(
              f"{w} {a:.3g}, {b:.3g}" for w, a, b in errs))
    row = dict(err=max(float((y - py).abs().max()),
                       float((h - ph).abs().max())),
               shape=f"B {B} S {S} H {H} P {P} G {G} N {N}")
    if not timing:
        return row
    nbytes, flops = _ssd_work(B, S, H, P, G, N)
    nbytes += 2 * B * H * P * N * 4              # h0 read, h_T written
    bnd, by = bound_ms(nbytes, flops, "float32")
    ms = timed(lambda: ssd_scan(*ins, **kw), 10, torch)
    ms_plain_y = timed(lambda: ssd_scan(*ins, chunk=256), 10, torch)
    pms = timed(lambda: ssd_scan_plain(*ins, **kw), 2, torch)
    row.update(ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
               library_ms=None, ms_without_state=ms_plain_y)
    print(f"{tag}: {ms:.4f} ms (y alone from zeros {ms_plain_y:.4f} ms), "
          f"bound {bnd:.4f} ms ({by}, {bnd / ms:.2%} of it), plain "
          f"{pms:.3f} ms")
    return row


def phase_serve(torch):
    """SERVE: the serving path at full width (``launch.serve``,
    ``DecoderModel.decode_step``), TF32 off. (a) ``BatchedServer`` on
    Qwen3-1.7B in bf16 (``_serve_server``). (b) decode against forward in
    f32, token by token, at the reference test's tolerances
    (``tests/test_decode_consistency.py``: 2e-2 dense, 5e-2 MLA, SSM,
    MusicGen), the forward through the f32 SIMT ``flash_attention`` and
    the ``ssd_scan`` kernels: Qwen3-1.7B (B 2, S 64), Mamba-2-780M (B 2,
    S 64; each layer's decode SSM state against the forward's
    ``ssd_scan`` final state), MusicGen-medium (B 2, S 64, 4 codebooks,
    a random (B, 64, d) memory), DeepSeek-V3 at
    ``lmpath.DEEPSEEK_ROUND_CONFIG``'s depth cut (2 layers, all 256
    experts) with capacity factor SERVE_DEEPSEEK_CF (B 1, S 32),
    Mistral-Nemo-12B's
    sw4096 variant cut to SERVE_MISTRAL_LAYERS layers (B 1, S
    SERVE_MISTRAL_S: the ring of 4096 wraps), Hymba-1.5B with its meta
    tokens cut to 0 (decode reads none) (B 1, S SERVE_HYMBA_S, past the
    1024 window). Depth, the meta tokens and the time cuts named above
    SERVE_PROMPT are the only cuts. (c)
    ``flash_attention``'s offset mode against its plain version (Qwen3's
    chunked prefill, a decode-shaped call, Hymba's windowed layer) and
    against ``attention_decode`` on (a)'s caches. (d) ``ssd_scan``'s
    initial / final state mode at Hymba's and Mamba-2's shapes with the
    continuation identity. Returns the kernels' rows, (a)'s launches
    (the ``serve`` path's), those of (b)'s forwards and (c)'s checks, and
    the server's figures."""
    from repro_torch import lmpath
    from repro_torch.configs import get_config
    from repro_torch.configs.mistral_nemo_12b import LONG_CONFIG
    from repro_torch.kernels.flash_attention import flash_attention
    t0 = time.perf_counter()
    server, figures, serve_launches = _serve_server(torch)
    print(f"SERVE (a) took {time.perf_counter() - t0:.1f} s")
    rows = {"flash_attention_offset": [], "ssd_scan_state": []}
    _zero_counts(flash_attention)
    rows["flash_attention_offset"] += _serve_decode_vs_kernel(torch, server)
    offset_launches = flash_attention.launches_by_mode["offset"]
    check(flash_attention.launches == offset_launches["tc"] == len(
        rows["flash_attention_offset"]), f"SERVE (c): flash launches "
        f"{flash_attention.launches_by_mode}; want one tc offset launch a "
        f"layer checked")
    del server
    torch.cuda.empty_cache()
    f32 = dict(dtype="float32")
    ds = lmpath.DEEPSEEK_ROUND_CONFIG
    cases = (
        ("Qwen3-1.7B", get_config("qwen3-1.7b").replace(**f32), 2, 64,
         2e-2, False),
        ("Mamba-2-780M", get_config("mamba2-780m").replace(**f32), 2, 64,
         5e-2, True),
        ("MusicGen-medium", get_config("musicgen-medium").replace(**f32), 2,
         64, 5e-2, False),
        (f"DeepSeek-V3 (2 layers, 256 experts, capacity factor "
         f"{SERVE_DEEPSEEK_CF:g})", ds.replace(moe=dataclasses.replace(
             ds.moe, capacity_factor=SERVE_DEEPSEEK_CF), **f32), 1, 32, 5e-2,
         False),
        (f"Mistral-Nemo-12B sw4096 ({SERVE_MISTRAL_LAYERS} layers)",
         LONG_CONFIG.replace(num_layers=SERVE_MISTRAL_LAYERS, **f32), 1,
         SERVE_MISTRAL_S, 2e-2, False),
        ("Hymba-1.5B (no meta tokens)", get_config("hymba-1.5b").replace(
            num_prefix_tokens=0, **f32), 1, SERVE_HYMBA_S, 5e-2, False))
    launches = {"flash_attention": 0, "ssd_scan": 0, "ssd_scan_state": 0}
    variants = {"tc": 0, "simt": 0}
    by_dim = {}
    t1 = time.perf_counter()
    for i, (label, cfg, B, S, tol, states) in enumerate(cases):
        n, var, dims = _serve_vs_forward(torch, label, cfg, B, S, tol,
                                         40 + i, ssd_states=states)
        for k in launches:
            launches[k] += n[k]
        for k in variants:
            variants[k] += var[k]
        for d, c in dims.items():
            by_dim[d] = by_dim.get(d, 0) + c
    print(f"SERVE (b) took {time.perf_counter() - t1:.1f} s")
    check(launches["flash_attention"] > 0 and launches["ssd_scan"] > 0
          and launches["ssd_scan_state"] > 0
          and variants == {"tc": 0, "simt": launches["flash_attention"]},
          f"SERVE (b): the f32 forwards' launches {launches}, flash "
          f"{variants}")
    t2 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(37)
    q3 = get_config("qwen3-1.7b")
    H, KVH, D = q3.num_heads, q3.num_kv_heads, q3.resolved_head_dim
    for dtype in (torch.bfloat16, torch.float32):
        rows["flash_attention_offset"].append(_offset_row(
            torch, gen, "Qwen3 chunked prefill ", 4, 512, 2048, H, KVH, D, 0,
            1536, None, dtype))
        rows["flash_attention_offset"].append(_offset_row(
            torch, gen, "Qwen3 decode ", 4, 1, 2048, H, KVH, D, 0, 2047,
            [1, 700, 1500, 2048], dtype, timing=dtype == torch.bfloat16))
    hy = get_config("hymba-1.5b")
    for dtype in (torch.bfloat16, torch.float32):
        rows["flash_attention_offset"].append(_offset_row(
            torch, gen, "Hymba windowed ", 2, 64, 1164, hy.num_heads,
            hy.num_kv_heads, hy.resolved_head_dim, hy.sliding_window, 1100,
            None, dtype, timing=False))
    torch.cuda.empty_cache()
    rows["ssd_scan_state"].append(_ssd_state_row(
        torch, gen, "Hymba ", 2, 2176, 50, 64, 1, 16, 1000))
    rows["ssd_scan_state"].append(_ssd_state_row(
        torch, gen, "Mamba-2 ", 2, 2176, 48, 64, 1, 128, 1000,
        timing=False))
    torch.cuda.empty_cache()
    print(f"SERVE (c), (d) took {time.perf_counter() - t2:.1f} s")
    return dict(rows=rows, launches=serve_launches,
                variants={"flash_attention": {"tc": 0, "simt": 0}},
                by_head_dim={"flash_attention": {}},
                check_launches=dict(
                    launches,
                    flash_attention_offset=sum(offset_launches.values())),
                figures=figures)


# ---------------------------------------------- remat "dots", the dry run
def _policy_steps(torch, policy, nodes):
    """LM_DOTS_STEPS plain steps of Hymba-1.5B at full width
    (``lmpath.train_steps``) under ``policy``, the kernel counts set to 0
    before and read after: (the run's steps and peak, launches,
    variants, launches by head_dim)."""
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    fns = (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd)
    _zero_counts(*fns)
    tcfg = dataclasses.replace(lmpath.TRAIN, num_nodes=nodes, idkd=None)
    out = lmpath.train_steps(lmpath.CONFIG.replace(remat_policy=policy),
                             tcfg, seq_len=lmpath.SEQ_LEN,
                             steps=LM_DOTS_STEPS)
    del out["params"]
    launches = {f.__name__: f.launches for f in fns}
    variants = {f.__name__: dict(f.launches_by_variant)
                for f in fns[:2]}
    by_dim = {f.__name__: dict(f.launches_by_head_dim) for f in fns[:2]}
    return out, launches, variants, by_dim


def _ulp(x, mantissa):
    """One unit in the last place at |x| for a float with ``mantissa``
    fraction bits (7 for bf16, 23 for f32); 0 at 0."""
    x = abs(x)
    return 2.0 ** (math.floor(math.log2(x)) - mantissa) if x > 0 else 0.0


def _dots_grads(torch):
    """One Hymba-1.5B node's loss and gradient on every leaf at full width
    (bf16, one batch of 2 x 2048 tokens from ``lmpath.train_batch``):
    under per-layer recompute twice, then under "dots" with the kernel
    counts set to 0 before and read after. Returns the losses and the
    gradients by run, and the "dots" run's launches."""
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.models.transformer import DecoderModel
    fns = (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd)
    params = lmpath.node_params(DecoderModel(lmpath.CONFIG), [0], "cuda")
    gen = torch.Generator(device="cuda").manual_seed(lmpath.DATA_SEED)
    batch = lmpath.train_batch(lmpath.CONFIG, 1, lmpath.TRAIN.batch_size,
                               lmpath.SEQ_LEN, gen)
    keys = list(params)
    losses, grads, launches = {}, {}, None
    for run in ("nothing", "repeat", "dots"):
        model = DecoderModel(lmpath.CONFIG.replace(
            remat_policy="dots" if run == "dots" else "nothing"))
        ps = [params[k].detach().requires_grad_(True) for k in keys]
        if run == "dots":
            _zero_counts(*fns)
        loss, _ = model.loss(dict(zip(keys, ps)), batch)
        g = torch.autograd.grad(loss.sum(), ps, materialize_grads=True)
        torch.cuda.synchronize()
        if run == "dots":
            launches = {f.__name__: f.launches for f in fns}
        losses[run] = float(loss.detach().sum())
        grads[run] = dict(zip(keys, g))
        del loss, g, ps
    return losses, grads, launches


def _dots_grads_check(torch):
    """LM-4 dots' gradient check (:func:`_dots_grads`): on every leaf,
    "dots"' largest distance from per-layer recompute's gradient within
    DOTS_NOISE_MULT x the two per-layer recompute runs' distance, or
    within one bf16 ulp of the leaf's largest gradient where those two
    agree bitwise; every gradient finite; the loss by the same rule (one
    f32 ulp); every flash and SSD kernel, forward and backward, launched
    under "dots"."""
    from repro_torch import lmpath
    t0 = time.perf_counter()
    losses, grads, launches = _dots_grads(torch)
    ref, rep, dots = grads["nothing"], grads["repeat"], grads["dots"]
    bad, worst, exact, noisy = [], (0.0, None), 0, 0
    for k, r in ref.items():
        r = r.float()
        check(bool(r.isfinite().all()) and bool(dots[k].isfinite().all()),
              f"LM-4 dots: a non-finite gradient of {k}")
        noise = float((rep[k].float() - r).abs().max())
        d = float((dots[k].float() - r).abs().max())
        tol = max(DOTS_NOISE_MULT * noise, _ulp(float(r.abs().max()), 7))
        exact += d == 0
        noisy += noise > 0
        if d > tol:
            bad.append((k, d, noise, tol))
        if tol > 0 and d / tol >= worst[0]:
            worst = (d / tol, k)
    n_leaves = len(ref)
    del grads, ref, rep, dots
    torch.cuda.empty_cache()
    lr, lp, ld = losses["nothing"], losses["repeat"], losses["dots"]
    ltol = max(DOTS_NOISE_MULT * abs(lp - lr), _ulp(lr, 23))
    check(not bad, f"LM-4 dots: gradients past the run-to-run bound "
                   f"(leaf, distance, noise, tol): {bad[:8]}")
    check(abs(ld - lr) <= ltol, f"LM-4 dots: one node's loss {ld} against "
                                f"per-layer recompute's {lr} (repeat {lp})")
    for name, n in launches.items():
        check(n > 0, f"LM-4 dots: {name} was not launched in the gradient "
                     f"check")
    print(f"LM-4 dots gradients (one Hymba-1.5B node, bf16, 2 x "
          f"{lmpath.SEQ_LEN} tokens; {time.perf_counter() - t0:.1f} s): "
          f"loss {ld} against per-layer recompute's {lr} (repeat {lp}); "
          f"{n_leaves} leaves: {exact} bitwise equal to per-layer "
          f"recompute's, {noisy} differ between the two per-layer "
          f"recompute runs; every leaf within max({DOTS_NOISE_MULT} x that "
          f"noise, one bf16 ulp of its largest gradient), the closest to "
          f"its bound {worst[1]} at {worst[0]:.3g} of it; launches "
          f"{launches}")


def phase_lm_dots(torch):
    """LM-4 under remat_policy "dots" (each layer's projections saved,
    the rest recomputed): first one node's gradients against per-layer
    recompute's, leaf by leaf, within the card's run-to-run noise
    (:func:`_dots_grads_check`); then Hymba-1.5B at full width,
    LM_DOTS_STEPS plain QG-DSGDm-N steps (``lmpath.train_steps``, 2 x
    2048 tokens a node) at the first node count of LM_DOTS_NODES whose
    "dots" run fits under TRAIN_PEAK_GIB, then per-layer recompute
    ("nothing") at the same count: each step's time and the peak of
    both; the losses equal to bf16 rounding (BF16_LOSS_RTOL); every
    flash and SSD kernel, forward and backward, launched in the "dots"
    run, every flash launch tc."""
    from repro_torch import lmpath
    _dots_grads_check(torch)
    dots = None
    for nodes in LM_DOTS_NODES:
        torch.cuda.empty_cache()
        try:
            dots = _policy_steps(torch, "dots", nodes)
        except torch.cuda.OutOfMemoryError:
            print(f"LM-4 dots: {nodes} nodes run out of memory")
            dots = None
        if dots is not None and dots[0]["peak_gib"] <= TRAIN_PEAK_GIB:
            break
        if dots is not None:
            print(f"LM-4 dots: {nodes} nodes peak at "
                  f"{dots[0]['peak_gib']:.2f} GiB > {TRAIN_PEAK_GIB}")
            dots = None
    check(dots is not None, f"LM-4 dots: no node count of {LM_DOTS_NODES} "
                            f"fits under {TRAIN_PEAK_GIB} GiB")
    torch.cuda.empty_cache()
    full = _policy_steps(torch, "nothing", nodes)
    torch.cuda.empty_cache()
    run, launches, variants, by_dim = dots
    d_loss = [st["loss"] for st in run["steps"]]
    f_loss = [st["loss"] for st in full[0]["steps"]]
    check(all(math.isfinite(x) for x in d_loss)
          and all(abs(a - b) <= BF16_LOSS_RTOL * abs(b)
                  for a, b in zip(d_loss, f_loss)),
          f"LM-4 dots: losses {d_loss} against per-layer recompute's "
          f"{f_loss}")
    for name, n in launches.items():
        check(n > 0, f"LM-4 dots: {name} was not launched")
    for name, by in variants.items():
        check(by.get("tc") == launches[name],
              f"LM-4 dots: {name} launches {by} of {launches[name]}; all "
              f"must be tc")
    print(f"LM-4 dots (Hymba-1.5B, {nodes} ring nodes, {LM_DOTS_STEPS} "
          f"plain steps of 2 x {lmpath.SEQ_LEN} tokens a node): step "
          f"{[round(st['s'], 3) for st in run['steps']]} s, peak "
          f"{run['peak_gib']:.2f} GiB; per-layer recompute at {nodes} "
          f"nodes: step {[round(st['s'], 3) for st in full[0]['steps']]} s,"
          f" peak {full[0]['peak_gib']:.2f} GiB; losses {d_loss} vs "
          f"{f_loss}; launches {launches} (recompute: {full[1]})")
    return dict(launches=launches, variants=variants, by_head_dim=by_dim,
                nodes=nodes, peak_gib=run["peak_gib"],
                full_peak_gib=full[0]["peak_gib"])


def _card_shape():
    """DRYRUN's card check: Qwen3-1.7B (bf16) and one node's train shape
    of DRYRUN_HOST_TOKENS tokens on a one-rank ``make_host_mesh(1, 1)``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    return (get_config("qwen3-1.7b"),
            ShapeConfig("card", DRYRUN_HOST_TOKENS, 1, "train"),
            make_host_mesh(1, 1))


def dryrun_traces():
    """DRYRUN's work on the meta device, which needs no card and no
    kernel (``main`` runs it while ``nvcc`` builds the kernels): the dry
    run (``launch.dryrun.run_one``) on the single-pod production mesh for
    DRYRUN_ARCHS at DRYRUN_SHAPE, and the card check's trace
    (``dryrun.analyze`` of :func:`_card_shape`). Returns each record
    with its seconds; prints nothing."""
    from repro_torch.launch import dryrun
    rows = []
    for arch in DRYRUN_ARCHS:
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, DRYRUN_SHAPE, False, verbose=False)
        rows.append((arch, rec, time.perf_counter() - t0))
    t0 = time.perf_counter()
    card = dryrun.analyze(*_card_shape())
    return dict(rows=rows, card=(card, time.perf_counter() - t0))


def _dryrun_vs_card(torch, traced):
    """The dry run's estimate held to the card: one Qwen3-1.7B (bf16)
    train step of one node, DRYRUN_HOST_TOKENS tokens, on a one-rank
    ``make_host_mesh(1, 1)`` (``traced``: its record from
    :func:`dryrun_traces`, and the trace's seconds): its argument_bytes
    equal the summed bytes of the step's inputs (the lr as one f32) and
    lie within DRYRUN_ARG_RTOL of the allocator's rise when they are
    made; the step's peak over them within DRYRUN_PEAK_BAND of argument
    plus temp bytes."""
    from repro_torch import lmpath
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import DecoderModel
    rec, secs = traced
    cfg, shape, mesh = _card_shape()
    arg = rec["memory_analysis"]["argument_bytes"]
    temp = rec["memory_analysis"]["temp_bytes"]
    model = DecoderModel(cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = lmpath.node_params(model, [0], "cuda")
    step = dryrun._train_step(model, dryrun.setup(cfg, shape, mesh).tcfg)
    opt = step.init_opt(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: v.contiguous() for k, v in
             lmpath.train_batch(cfg, 1, 1, DRYRUN_HOST_TOKENS, gen).items()}
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    nbytes = sum(t.nbytes for tree in (params, opt["m"], batch)
                 for t in tree.values()) + dryrun.LR_BYTES
    check(nbytes == arg, f"DRYRUN: argument_bytes {arg} != the step's "
                         f"inputs' {nbytes} B")
    check(abs(rise - arg) <= DRYRUN_ARG_RTOL * arg,
          f"DRYRUN: argument_bytes {arg} against the allocator's rise "
          f"{rise}")
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, batch, 0.1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ratio = peak / (arg + temp)
    del params, opt, batch, step
    torch.cuda.empty_cache()
    check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
          f"DRYRUN: the step's peak {peak / 2 ** 30:.2f} GiB is {ratio:.3f}"
          f" x argument + temp ({(arg + temp) / 2 ** 30:.2f} GiB)")
    print(f"DRYRUN on the card (Qwen3-1.7B bf16, one node, 1 x "
          f"{DRYRUN_HOST_TOKENS} tokens, make_host_mesh(1, 1); traced in "
          f"{secs:.1f} s during the kernel build): argument "
          f"{arg / 2 ** 30:.3f} GiB = the inputs' bytes, the allocator rose "
          f"{rise / 2 ** 30:.3f} GiB; temp estimate {temp / 2 ** 30:.3f} "
          f"GiB; the step's peak {peak / 2 ** 30:.3f} GiB = {ratio:.3f} x "
          f"(argument + temp)")
    return ratio


def phase_dryrun(torch, traced):
    """DRYRUN: the dry run's records from :func:`dryrun_traces` (traced
    on the meta device during the kernel build), one line each: argument
    and temp GiB a device and the dominant term; then the estimate held
    to the card with a train step (:func:`_dryrun_vs_card`). Launches no
    kernel."""
    rows = []
    for arch, rec, secs in traced["rows"]:
        check(rec["status"] == "ok", f"DRYRUN {arch} {DRYRUN_SHAPE}: {rec}")
        ma = rec["memory_analysis"]
        rows.append(rec)
        print(f"DRYRUN {arch} {DRYRUN_SHAPE} single (256 devices): argument "
              f"{ma['argument_bytes'] / 2 ** 30:.3f} GiB, temp "
              f"{ma['temp_bytes'] / 2 ** 30:.3f} GiB a device; compute "
              f"{rec['compute_s'] * 1e3:.2f} ms, memory "
              f"{rec['memory_s'] * 1e3:.2f} ms, collective "
              f"{rec['collective_s'] * 1e3:.2f} ms: {rec['dominant']} "
              f"({secs:.1f} s, during the kernel build)")
    return dict(rows=rows, card_ratio=_dryrun_vs_card(torch, traced["card"]))


class _Background:
    """``fn(*args, **kwargs)`` on a thread of its own; :meth:`join` waits
    and returns its result, or raises what it raised."""

    def __init__(self, fn, *args, **kwargs):
        import threading
        self._out = {}

        def target():
            try:
                self._out["value"] = fn(*args, **kwargs)
            except BaseException as e:      # re-raised by join
                self._out["error"] = e
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


# ----------------------------------------------------- the sharded driver
def _shard_sim(case, driver_mode="shard"):
    """SHARD's simulator for ``case`` (a row of SHARD_CASES): the main
    path (``mainpath.grid_sim``'s qg-idkd: ResNet-20, 16 nodes,
    QG-DSGDm-N, the streaming sparse round) cut to the case's depth, an
    eval at 0, at the round and at the end, on the case's gossip wire."""
    from repro_torch.mainpath import grid_sim
    _, topo, mp, steps, rnd, comp, gossip = case
    return grid_sim("qg-idkd", steps, rnd, rnd, "cuda", topology=topo,
                    driver_mode=driver_mode,
                    model_parallel=mp if driver_mode == "shard" else 1,
                    compression=comp, gossip=gossip)


def _shard_ref_key(case):
    """The node-stacked run a SHARD case is held to: same graph, depth
    and wire."""
    return (case[1], case[3], case[5], case[6])


def _recorded_run(torch, sim, case):
    """Run ``sim`` with the round's inputs captured (``capture_at`` the
    round step) and its output recorded, the head_select counts set to 0
    before and read after; returns what SHARD compares."""
    from repro_torch.kernels.head_select import head_select
    from repro_torch.launch.sharding import gather_nodes
    rounds = []
    homogenize = sim.homogenize

    def record(*a, **kw):
        hom = homogenize(*a, **kw)
        rounds.append(gather_nodes(tuple(hom), sim.node_mesh)
                      if sim.driver_mode == "shard" else tuple(hom))
        return hom
    sim.homogenize = record
    head_select.launches = 0
    head_select.launches_by_variant = dict.fromkeys(
        head_select.launches_by_variant, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sim.run(capture_at=case[4])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sim.homogenize = homogenize
    glob = sim.global_params
    return dict(wall_s=wall, steps=case[3], raw_captured=res.captured,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=head_select.launches,
                variants=dict(head_select.launches_by_variant),
                acc=list(res.acc_history), nll=list(res.loss_history),
                params={k: v.cpu() for k, v in glob(res.params).items()},
                captured={k: v.cpu() for k, v in
                          glob(res.captured["params"]).items()},
                id_masks=rounds[0][2].cpu(), thresholds=rounds[0][3].cpu())


def _shard_mix_step(torch, sim, cap, case):
    """One step of the sharded compressed mixer (the run's, through the
    model-sharded adapter on the 2-D mesh) on the state captured at the
    round, this rank's block: the global x̂ before it, and the global
    mixed params and x̂ after it."""
    from repro_torch.core.mixing import (make_model_sharded_mixer,
                                         make_shard_mixer)
    from repro_torch.launch.sharding import gather_nodes
    _, _, mp, _, _, comp, gossip = case
    mesh = sim.node_mesh
    mix = make_shard_mixer(sim.gossip_topo, mesh.node,
                           local_nodes=sim.tcfg.num_nodes // mesh.node.size,
                           compression=comp, gossip=gossip)
    if mp > 1:
        mix = make_model_sharded_mixer(
            mix, {k: s.model_dim for k, s in sim.specs.items()}, mesh)
    comm = {name: {k: v.clone() for k, v in sub.items()}
            if isinstance(sub, dict) else sub.clone()
            for name, sub in cap["comm"].items()}
    hat0 = gather_nodes(cap["comm"]["hat"], mesh)
    bound = mix.bind(comm)
    y = sim.global_params(bound(dict(cap["params"])))
    hat1 = gather_nodes(bound.finalize()["hat"], mesh)
    return {name: {k: v.cpu() for k, v in t.items()}
            for name, t in (("hat0", hat0), ("y", y), ("hat1", hat1))}


def _shard_steps(torch, sim, cap, case):
    """TRAJ_STEPS plain steps of the sharded step (``make_shard_step``,
    as the run builds it) from this rank's block of the state captured
    at the round (``_run_steps``), its top-k payloads and ReLU branches
    recorded (the masks bit-packed): what the parent needs to run the
    node-stacked steps from the same global state (the global momentum
    before) and to hold them to these (the global params and x̂ after)."""
    import numpy as np

    import repro_torch.core.driver as drv
    from repro_torch.launch.sharding import gather_nodes
    mesh = sim.node_mesh
    step = drv.make_shard_step(
        sim.model, sim.algo, drv.classification_adapter, mesh=mesh,
        topology=sim.gossip_topo, specs=sim.specs,
        compression=sim.compression, gossip=sim.gossip)
    m0 = sim.global_params(cap["opt_state"]["m"])
    tape, masks = [], []
    p, comm = _run_steps(torch, sim, step, cap, "cuda", case[4],
                         [_topk_record(tape), _relu_record(masks)])
    return dict(node=mesh.node.index, model=mesh.model.index, tape=tape,
                masks=[(np.packbits(m.numpy()), tuple(m.shape))
                       for m in masks],
                m0={k: v.cpu() for k, v in m0.items()},
                params={k: v.cpu() for k, v in sim.global_params(p).items()},
                hat={k: v.cpu() for k, v in
                     gather_nodes(comm["hat"], mesh).items()})


def _shard_steps_vs_stacked(torch, ranks, name, sim, got, rnd):
    """The node-stacked steps (``sim``'s prebuilt step) from the sharded
    run's global state at the round, taking the ranks' top-k payloads
    and ReLU branches where the two differ by a near-tie only, held to
    the sharded steps (``_shard_steps``). Returns (params error, x̂
    error, scale, top-k rows taken over, ReLU inputs taken over)."""
    import numpy as np
    trs = sorted((r[name]["traj"] for r in ranks
                  if r[name]["traj"]["model"] == 0),
                 key=lambda t: t["node"])
    L = sim.tcfg.num_nodes // len(trs)
    check(len({len(t["tape"]) for t in trs}) == 1
          and len({len(t["masks"]) for t in trs}) == 1,
          f"SHARD {name}: the ranks recorded different call counts")
    tape = [torch.cat([t["tape"][j] for t in trs])
            for j in range(len(trs[0]["tape"]))]
    masks = []
    for j in range(len(trs[0]["masks"])):
        blocks = []
        for t in trs:
            bits, shape = t["masks"][j]
            m = np.unpackbits(bits, count=math.prod(shape)).astype(bool)
            # ResNet's activations are (B, nodes x C, H, W)
            blocks.append(torch.from_numpy(m).reshape(
                shape[0], L, shape[1] // L, *shape[2:]))
        m = torch.cat(blocks, dim=1)
        masks.append(m.reshape(m.shape[0], -1, *m.shape[3:]))
    mine = ranks[0][name]["traj"]
    cap = {"params": got["captured"], "opt_state": {"m": mine["m0"]},
           "comm": {"hat": got["mix"]["hat0"]}}
    calls, flips = [], []
    with _deterministic(torch):
        p, comm = _run_steps(torch, sim, sim.steps["plain"], cap, "cuda",
                             rnd, [_topk_replay(torch, tape, calls),
                                   _relu_replay(torch, masks, flips)])
    check(sum(r for r, _ in calls) == sum(t.shape[0] for t in tape)
          and len(flips) == len(masks),
          f"SHARD {name}: the node-stacked steps made {len(calls)} top-k "
          f"and {len(flips)} ReLU calls, the sharded {len(tape)} and "
          f"{len(masks)}")
    dp = _max_diff(torch, {k: v.cpu() for k, v in p.items()},
                   mine["params"])
    dh = _max_diff(torch, {k: v.cpu() for k, v in comm["hat"].items()},
                   mine["hat"])
    return dp, dh, _steps_scale(cap), sum(t for _, t in calls), sum(flips)


def _shard_schedule(sim, crash=None):
    """A SHARD simulator's own schedule, with a crash at ``crash``."""
    from repro_torch import sched
    base = sim.default_schedule()
    events = (sched.FaultEvent(crash, "crash"),) if crash else ()
    return sched.compile_schedule(sim.tcfg.steps, sim.eval_every,
                                  round_steps=base.round_steps,
                                  events=events, gossip=sim.gossip)


def _shard_snapshot(torch, sim, case, params, snap_dir):
    """SHARD (a)'s durable snapshots on this rank: the run snapshotted at
    every boundary (rank 0 writes the whole federation), crashed
    SHARD_SNAP_CRASH steps past the round and resumed from the newest
    snapshot; the resumed run's global params against ``params`` (the
    uninterrupted run's). The directory as the crash left it is copied
    to ``<snap_dir>-mid`` for the parent's node-stacked resume. The
    head_select counts are set to 0 before and read after."""
    import shutil

    from repro_torch.kernels.head_select import head_select
    from repro_torch.launch import dist
    from repro_torch.resil import Resilience, SimulatedCrash
    schedule = _shard_schedule(sim, case[4] + SHARD_SNAP_CRASH)
    res = Resilience(snapshot_dir=snap_dir, snapshot_every=0)
    _zero_counts(head_select)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    crashed = False
    try:
        sim.run(schedule, resil=res)
    except SimulatedCrash:
        crashed = True
    dist.barrier()
    t1 = time.perf_counter()
    if dist.world()[0] == 0:
        shutil.copytree(snap_dir, snap_dir + "-mid")
    dist.barrier()
    t2 = time.perf_counter()
    resumed = sim.run(schedule, resil=res)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    got = {k: v.cpu() for k, v in sim.global_params(resumed.params).items()}
    return dict(crashed=crashed, crash_s=t1 - t0, resume_s=t3 - t2,
                evals=len(resumed.acc_history),
                diff=_max_diff(torch, got, params), mid=snap_dir + "-mid",
                launches=head_select.launches,
                variants=dict(head_select.launches_by_variant))


def shard_rank(rank, world, cases, snap_dir=None):
    """One rank of SHARD: every case's sharded run, in deterministic
    mode (the parent's node-stacked runs too), TF32 off; for a top-k
    case also one mixer step and TRAJ_STEPS steps (``_shard_steps``)
    from the state captured at the round; for the first case also the
    snapshot, crash and resume run (``_shard_snapshot``) when given a
    ``snap_dir``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for case in cases:
        sim = _shard_sim(case)
        got = _recorded_run(torch, sim, case)
        cap = got.pop("raw_captured")
        if case[5] is not None:
            got["mix"] = _shard_mix_step(torch, sim, cap, case)
            got["traj"] = _shard_steps(torch, sim, cap, case)
        if case is cases[0] and snap_dir is not None:
            got["snap"] = _shard_snapshot(torch, sim, case, got["params"],
                                          snap_dir)
        if rank != 0:                      # rank 0 returns the tensors
            for k in ("params", "captured", "id_masks", "thresholds", "mix"):
                got.pop(k, None)
            for k in ("params", "hat", "m0"):
                got.get("traj", {}).pop(k, None)
        out[case[0]] = got
    return out


def phase_shard(torch):
    """SHARD: the sharded driver on SHARD_RANKS ranks sharing the card
    (gloo; CUDA tensors staged through the host, so no wire numbers):
    the main path at full width (16 ring nodes, QG-DSGDm-N, the
    streaming sparse round, KD) cut to SHARD_STEPS steps, the round at
    SHARD_ROUND, (a) on a 1-D node mesh (4 nodes a rank) and (b) on the
    2 x 2 federation mesh (model_parallel 2: the model shards gathered
    for the forward, the vocab-sharded round through head_select's SIMT
    raw_stats mode); (c) on the complete graph (exact averaging: the
    node group's all_reduce), cut to SHARD_SHORT_STEPS; and with top-k
    1% gossip (the stateful sharded mixer: payload rows into the
    neighbours' replicas), cut to SHARD_SHORT_STEPS, (d) on the 1-D
    ring, (e) delayed on the complete graph (the payloads all-gathered
    into the replicated sum) and (f) on the 2 x 2 mesh (through the
    model-sharded adapter, full delta rows). Each against the
    node-stacked run on the card from the same params, draws and wire,
    both in deterministic mode, and the sharded round held to the
    node-stacked round on the same (captured) params: thresholds within
    THRESH_ATOL, D_ID masks equal outside MASK_BAND. (a) to (c): params
    at the round within SHARD_CAP_ATOL, final params within
    SHARD_PARAM_ATOL, the consensus accuracy within SHARD_ACC_ATOL at
    every eval. The top-k runs are not held to the node-stacked params
    end to end: the two runs' deltas differ by float rounding (the sums
    run in another order), a top-k whose k-th and (k+1)-th magnitudes
    are that close takes another coordinate (on the CPU, from the third
    step), and QG-DSGDm-N's momentum, which carries the CHOCO correction
    step after step, grows the difference (the reference's dynamics;
    PERF.md §6). They are held instead, exactly, from the state captured
    at the round: one sharded mixer step against the node-stacked mixer
    on the same state (x̂ within GOSSIP_MIX_ATOL, so the payloads are the
    same, the mixed params within SHARD_MIX_YTOL), and TRAJ_STEPS full
    sharded steps against the node-stacked steps from the same global
    state (the comm carried through the host runner; the node-stacked
    run takes the ranks' payloads and ReLU branches at near-ties only;
    params and x̂ within TRAJ_RTOL); end to end by the accuracy band
    GOSSIP_ACC_BAND. Every head_select launch of (b) and (f) is a SIMT
    raw launch, of the others a SIMT one. RelaySGD, churn and wire
    faults refused before any run. Prints each run's wall time per step
    and each rank's peak."""
    from repro_torch import sched
    from repro_torch.core import driver, labeling
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.topology import Topology
    from repro_torch.launch import dist
    from repro_torch.launch.mesh import make_node_mesh
    from repro_torch.models.resnet import build_model
    from repro_torch.mainpath import CONFIG
    n = 16
    # refusals, before any training (one rank: the parent)
    try:
        driver.make_shard_step(
            build_model(CONFIG), make_algorithm(
                "relaysgd", topology=Topology.make("chain", n)),
            driver.classification_adapter, mesh=make_node_mesh(n),
            topology=Topology.make("ring", n))
        fail("SHARD: RelaySGD was not refused by make_shard_step")
    except ValueError as e:
        check("per-edge state" in str(e), f"SHARD: RelaySGD refused with {e}")
    ring = SHARD_CASES[0]
    at = ring[4] // 2
    for ev, what in ((sched.ChurnEvent(at, down=(3,)), "churn"),
                     (sched.FaultEvent(at, "corrupt", (3,), "nan"),
                      "wire fault")):
        sim = _shard_sim(ring)
        try:
            sim.run(sched.compile_schedule(ring[3], ring[4],
                                           round_steps=(ring[4],),
                                           events=(ev,)))
            fail(f"SHARD: a schedule with {what} was not refused")
        except ValueError as e:
            check(what in str(e), f"SHARD: {what} refused with {e}")
    print("SHARD: RelaySGD, churn and wire faults refused before the run")

    with _deterministic(torch):
        refs, sims = {}, {}
        for case in SHARD_CASES:
            key = _shard_ref_key(case)
            if key in refs:
                continue
            sims[key] = _shard_sim(case, "auto")
            refs[key] = _recorded_run(torch, sims[key], case)
            r = refs[key]
            print(f"SHARD node-stacked {key} reference: "
                  f"{r['wall_s']:.2f} s, {r['wall_s'] / case[3] * 1e3:.1f} "
                  f"ms a step, acc {r['acc']}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        snap_dir = tempfile.mkdtemp(prefix="shard_snapshots_")
        ranks = dist.spawn(shard_rank, SHARD_RANKS, SHARD_CASES,
                           os.path.join(snap_dir, "run"), device="cuda")
        print(f"SHARD: {SHARD_RANKS} ranks spawned and joined in "
              f"{time.perf_counter() - t0:.1f} s")
    launches, variants = {}, {}
    for case in SHARD_CASES:
        name, topo, mp, steps, rnd, comp, gossip = case
        got, ref = ranks[0][name], refs[_shard_ref_key(case)]
        walls = [r[name]["wall_s"] for r in ranks]
        peaks = [r[name]["peak_gib"] for r in ranks]
        dp = _max_diff(torch, got["params"], ref["params"])
        dcap = _max_diff(torch, got["captured"], ref["captured"])
        dacc = max(abs(a - b) for a, b in zip(got["acc"], ref["acc"]))
        check(len(got["acc"]) == len(ref["acc"]),
              f"SHARD {name}: accuracy {got['acc']} vs {ref['acc']}")
        mixed = ""
        if comp is None:
            check(dcap <= SHARD_CAP_ATOL,
                  f"SHARD {name}: params at the round differ from the "
                  f"node-stacked run by {dcap:.3g} > {SHARD_CAP_ATOL}")
            check(dp <= SHARD_PARAM_ATOL,
                  f"SHARD {name}: params differ from the node-stacked run "
                  f"by {dp:.3g} > {SHARD_PARAM_ATOL}")
            check(dacc <= SHARD_ACC_ATOL,
                  f"SHARD {name}: accuracy {got['acc']} vs {ref['acc']}")
        else:
            check(dacc <= GOSSIP_ACC_BAND and all(
                math.isfinite(x) for x in got["nll"]),
                f"SHARD {name}: accuracy {got['acc']} vs {ref['acc']}, "
                f"NLL {got['nll']}")
            from repro_torch.core.mixing import make_mixer
            from repro_torch.core.topology import Topology
            mx = make_mixer(Topology.make(topo, n), "dense", device="cuda",
                            compression=comp, gossip=gossip)
            bound = mx.bind({"hat": {k: v.cuda() for k, v in
                                     got["mix"]["hat0"].items()}})
            y = bound({k: v.cuda() for k, v in got["captured"].items()})
            hat1 = bound.finalize()["hat"]
            dy = _max_diff(torch, {k: v.cpu() for k, v in y.items()},
                           got["mix"]["y"])
            dh = _max_diff(torch, {k: v.cpu() for k, v in hat1.items()},
                           got["mix"]["hat1"])
            check(dh <= GOSSIP_MIX_ATOL and dy <= SHARD_MIX_YTOL,
                  f"SHARD {name}: a sharded mixer step against the "
                  f"node-stacked one on the same state: x̂ within {dh:.3g} "
                  f"(tol {GOSSIP_MIX_ATOL}), params within {dy:.3g} (tol "
                  f"{SHARD_MIX_YTOL})")
            del y, hat1, bound
            sp, sh, scale, taken, flips = _shard_steps_vs_stacked(
                torch, ranks, name, sims[_shard_ref_key(case)], got, rnd)
            check(sp <= TRAJ_RTOL * scale and sh <= TRAJ_RTOL * scale,
                  f"SHARD {name}: {TRAJ_STEPS} steps from the round's "
                  f"state, sharded vs node-stacked: params within {sp:.3g}, "
                  f"x̂ within {sh:.3g} > {TRAJ_RTOL} x {scale:.4g}")
            mixed = (f"; one mixer step on the round's state: x̂ within "
                     f"{dh:.3g}, params within {dy:.3g} of the node-stacked "
                     f"mixer's; {TRAJ_STEPS} steps from it: params within "
                     f"{sp:.3g}, x̂ within {sh:.3g} (tol {TRAJ_RTOL} x "
                     f"{scale:.4g}; near-ties taken over: {taken} top-k "
                     f"rows, {flips} ReLU inputs)")
        # the round on the same params: the node-stacked streaming round
        # on the sharded run's captured params
        sim = sims[_shard_ref_key(case)]
        p = {k: v.cuda() for k, v in got["captured"].items()}
        icfg = sim.tcfg.idkd
        chunks, P, _ = labeling._chunk_public(sim.public_x,
                                              icfg.stream_microbatch)
        conf = labeling._stream_public(sim.model, p, chunks, P, icfg, 8)[0]
        hom = labeling.streaming_label_round(
            sim.model, p, sim.public_x, sim._per_node_val_inputs(),
            sim.topology, icfg)
        conf, thr_ref = conf.cpu(), hom.thresholds.cpu()
        dthr = float((got["thresholds"] - thr_ref).abs().max())
        check(dthr <= THRESH_ATOL, f"SHARD {name}: round thresholds differ "
                                   f"by {dthr:.3g} > {THRESH_ATOL}")
        band = (conf - thr_ref[:, None]).abs() <= MASK_BAND
        off = (got["id_masks"] != hom.id_masks.cpu()) & ~band
        check(not bool(off.any()), f"SHARD {name}: {int(off.sum())} D_ID "
                                   f"mask entries differ outside the band")
        del p, hom
        lc = sum(r[name]["launches"] for r in ranks)
        by = {}
        for r in ranks:
            for v, c in r[name]["variants"].items():
                by[v] = by.get(v, 0) + c
        want = "simt_raw" if mp > 1 else "simt"
        check(lc > 0 and by.get(want, 0) == lc,
              f"SHARD {name}: head_select launches {by} of {lc}; all must "
              f"be {want}")
        key = "head_select_raw_simt" if mp > 1 else "head_select"
        launches[key] = launches.get(key, 0) + lc
        variants.setdefault("head_select", {})
        for v, c in by.items():
            variants["head_select"][v] = variants["head_select"].get(v, 0) + c
        print(f"SHARD {name} ({SHARD_RANKS} ranks, {n // (SHARD_RANKS // mp)}"
              f" nodes a rank{', model_parallel ' + str(mp) if mp > 1 else ''}"
              f"; {steps} steps, the round at {rnd}): wall "
              f"{max(walls):.2f} s, {max(walls) / steps * 1e3:.1f} ms a step "
              f"(node-stacked {ref['wall_s'] / steps * 1e3:.1f}); peak per "
              f"rank {[round(x, 3) for x in peaks]} GiB (node-stacked "
              f"{ref['peak_gib']:.3f}); params within {dp:.3g} of the "
              f"node-stacked run (tol {SHARD_PARAM_ATOL}; {dcap:.3g} at the "
              f"round, tol {SHARD_CAP_ATOL}), accuracy "
              f"{got['acc']} vs {ref['acc']} (within {dacc:.3g}); round "
              f"thresholds within {dthr:.3g}, masks equal outside the band "
              f"({int(band.sum())} entries within {MASK_BAND}); head_select "
              f"launches {by}{mixed}")
    snap = _shard_snapshot_vs_stacked(torch, ranks, refs, sims, snap_dir)
    return launches, variants, snap


def _shard_snapshot_vs_stacked(torch, ranks, refs, sims, snap_dir):
    """SHARD (a)'s durable snapshots: the sharded run snapshotted,
    crashed and resumed equals the uninterrupted sharded run within
    SHARD_PARAM_ATOL (every rank), and the node-stacked run resumed from
    the sharded run's snapshot (the directory as the crash left it)
    equals the node-stacked run within SHARD_PARAM_ATOL. Returns the
    head_select launches and variants of the snapshot runs (the round
    runs before the crash)."""
    import shutil

    from repro_torch.resil import Resilience
    case = SHARD_CASES[0]
    name, key = case[0], _shard_ref_key(case)
    snaps = [r[name]["snap"] for r in ranks]
    snap = snaps[0]
    check(all(s["crashed"] for s in snaps),
          f"SHARD {name} snapshots: the crash at "
          f"{case[4] + SHARD_SNAP_CRASH} did not fire on every rank")
    worst = max(s["diff"] for s in snaps)
    check(worst <= SHARD_PARAM_ATOL,
          f"SHARD {name} snapshots: resumed params differ from the "
          f"uninterrupted sharded run by {worst:.3g} > {SHARD_PARAM_ATOL}")
    sim, ref = sims[key], refs[key]
    with _deterministic(torch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.run(_shard_schedule(sim, case[4] + SHARD_SNAP_CRASH),
                      resil=Resilience(snapshot_dir=snap["mid"],
                                       snapshot_every=0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dp = _max_diff(torch, {k: v.cpu() for k, v in out.params.items()},
                   ref["params"])
    check(len(out.acc_history) < len(ref["acc"]),
          f"SHARD {name} snapshots: the node-stacked run did not resume "
          f"({len(out.acc_history)} evals, the whole run {len(ref['acc'])})")
    check(dp <= SHARD_PARAM_ATOL,
          f"SHARD {name} snapshots: the node-stacked run resumed from the "
          f"sharded run's snapshot ends {dp:.3g} from the node-stacked run "
          f"> {SHARD_PARAM_ATOL}")
    shutil.rmtree(snap_dir, ignore_errors=True)
    print(f"SHARD {name} snapshots ({SHARD_RANKS} ranks, a snapshot at "
          f"every boundary, rank 0 writing): crashed at step "
          f"{case[4] + SHARD_SNAP_CRASH} after {snap['crash_s']:.2f} s, "
          f"resumed in {snap['resume_s']:.2f} s ({snap['evals']} evals); "
          f"resumed params within {worst:.3g} of the uninterrupted sharded "
          f"run (tol {SHARD_PARAM_ATOL}); the node-stacked run resumed from "
          f"that snapshot in {wall:.2f} s ends within {dp:.3g} of the "
          f"node-stacked run (tol {SHARD_PARAM_ATOL}); head_select launches "
          f"{snap['launches']} on rank 0")
    launches = {"head_select": sum(s["launches"] for s in snaps)}
    variants = {"head_select": {}}
    for s in snaps:
        for v, c in s["variants"].items():
            variants["head_select"][v] = variants["head_select"].get(v, 0) + c
    return launches, variants


def shard_fault_rank(rank, world, case):
    """One rank of ``--shard-norm-fault``: SHARD's run of ``case`` as it
    is, then again with a planted fault in QG-DSGDm-N's global norm:
    every leaf summed over the model group too, so each model-replicated
    leaf counts model_size times (the split ``ShardReduce.tree_sum``
    exists to avoid)."""
    import torch
    from repro_torch.launch import dist, sharding
    sound = shard_rank(rank, world, (case,))[case[0]]

    def double_count(self, sq):
        total = torch.stack([sq[k] for k in sorted(sq)]).sum()
        return dist.all_reduce(dist.all_reduce(total, self.mesh.node),
                               self.mesh.model)
    sharding.ShardReduce.tree_sum = double_count
    return {"sound": sound,
            "fault": shard_rank(rank, world, (case,))[case[0]]}


def phase_shard_fault(torch):
    """``--shard-norm-fault``: how far SHARD (b)'s checks see a norm that
    double-counts the replicated leaves. The node-stacked run, then on
    SHARD_RANKS ranks the sharded run sound and with the fault planted
    (:func:`shard_fault_rank`), all in deterministic mode; prints each
    one's distance from the node-stacked run (params at the round, at
    the end, accuracy) and fails unless the sound run passes SHARD's
    bounds and the faulted one breaks at least one of them."""
    from repro_torch.launch import dist
    case = SHARD_CASES[1]
    with _deterministic(torch):
        ref = _recorded_run(torch, _shard_sim(case, "auto"), case)
        torch.cuda.empty_cache()
        ranks = dist.spawn(shard_fault_rank, SHARD_RANKS, case,
                           device="cuda")
    out = {}
    for which in ("sound", "fault"):
        got = ranks[0][which]
        out[which] = {
            "round": _max_diff(torch, got["captured"], ref["captured"]),
            "params": _max_diff(torch, got["params"], ref["params"]),
            "acc": max(abs(a - b) for a, b in zip(got["acc"], ref["acc"]))}
    print(f"SHARD {case[0]} against the node-stacked run, sound and with "
          f"the replicated leaves double-counted in the norm: "
          f"{json.dumps(out)}")

    def broken(d):
        return [name for name, key, tol in (
            ("SHARD_CAP_ATOL", "round", SHARD_CAP_ATOL),
            ("SHARD_PARAM_ATOL", "params", SHARD_PARAM_ATOL),
            ("SHARD_ACC_ATOL", "acc", SHARD_ACC_ATOL)) if d[key] > tol]
    check(not broken(out["sound"]),
          f"SHARD norm fault: the sound run breaks {broken(out['sound'])}")
    check(bool(broken(out["fault"])),
          "SHARD norm fault: the planted fault passes every SHARD bound")
    print(f"SHARD norm fault caught by {broken(out['fault'])}")
    return out


def lm_shard_rank(rank, world):
    """One rank of LM-13: Hymba-1.5B's 4 nodes, this rank's model shard
    of each leaf, the vocab-sharded round."""
    import torch

    import repro_torch.core.labeling as lab
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.head_select import head_select
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.mesh import make_federation_mesh
    from repro_torch.launch.sharding import federation_specs, local_block
    from repro_torch.launch.train import idkd_label_round
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lm = lmpath.setup(n_public=LM13_PUBLIC, device="cuda")
    n = lm.private.shape[0]
    mesh = make_federation_mesh(n, 2)
    specs = federation_specs(lm.params, n, mesh)
    local = local_block(lm.params, specs, mesh)
    lm.params = None
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    confs = []
    stream = lab._stream_public

    def record(*a, **kw):
        out = stream(*a, **kw)
        confs.append(out[0])
        return out
    lab._stream_public = record
    counters = (flash_attention, ssd_scan, head_select)
    for f in counters:
        f.launches = 0
    _zero_serve_modes(flash_attention, ssd_scan)
    for f in (flash_attention, head_select):
        f.launches_by_variant = dict.fromkeys(f.launches_by_variant, 0)
    flash_attention.launches_by_head_dim = dict.fromkeys(
        flash_attention.launches_by_head_dim, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = idkd_label_round(lm.model, local, lm.public, lm.private, lm.icfg,
                           lm.topology, backend=lm.icfg.label_backend,
                           mesh=mesh, specs=specs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lab._stream_public = stream
    labels, w, mask, thr = out
    return dict(wall_s=wall, setup_s=setup_s,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches={**{f.__name__: f.launches for f in counters},
                          **_serve_mode_counts(flash_attention, ssd_scan)},
                variants=dict(head_select.launches_by_variant),
                flash_variants=dict(flash_attention.launches_by_variant),
                flash_dims={d: c for d, c in
                            flash_attention.launches_by_head_dim.items()
                            if c},
                local_gib=sum(v.numel() * v.element_size()
                              for v in local.values()) / 2 ** 30,
                out=None if rank else (labels.values.cpu(),
                                       labels.indices.cpu(), w.cpu(),
                                       mask.cpu(), thr.cpu(),
                                       confs[0].cpu()))


def phase_lm_shard(torch):
    """LM-13: the LM round at Hymba-1.5B's width (``lmpath.setup``: 4
    ring nodes, 2048-token sequences, the public set cut to LM13_PUBLIC
    sequences) with model_parallel 2 on 2 ranks sharing the card (gloo):
    each rank holds one model shard of every node's weights, gathers its
    nodes to full width for the forward, and scores one of the two
    vocabulary slices with head_select's tensor-core raw_stats mode; the
    slices' carries merge across the ranks. Held to the unsharded round
    on the same params: public confidences within ATOL + RTOL|ref|,
    thresholds within THRESH_ATOL, D_ID masks equal outside MASK_BAND,
    weights equal, merged labels within ATOL + RTOL|ref| with indices
    equal except near-ties (values within IDX_TIE). Every head_select
    launch is a tc raw launch. Prints wall time, launches and each
    rank's peak."""
    import repro_torch.core.labeling as lab
    from repro_torch import lmpath
    from repro_torch.launch import dist
    t0 = time.perf_counter()
    lm = lmpath.setup(n_public=LM13_PUBLIC, device="cuda")
    confs = []
    stream = lab._stream_public

    def record(*a, **kw):
        out = stream(*a, **kw)
        confs.append(out[0])
        return out
    lab._stream_public = record
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    labels, w, mask, thr = lm.run()
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t1
    lab._stream_public = stream
    ref = (labels.values.cpu(), labels.indices.cpu(), w.cpu(), mask.cpu(),
           thr.cpu(), confs[0].cpu())
    vocab = lm.model.cfg.vocab_size
    del lm, labels, w, mask, thr, confs
    torch.cuda.empty_cache()
    print(f"LM-13 unsharded reference round: {ref_wall:.2f} s "
          f"({time.perf_counter() - t0:.1f} s with its setup)")
    t0 = time.perf_counter()
    ranks = dist.spawn(lm_shard_rank, 2, device="cuda")
    spawn_s = time.perf_counter() - t0
    wire = dist.choose_backend("cuda", 2)
    wire += " through the host" if wire == "gloo" else ""
    got = ranks[0]["out"]
    for r in ranks:
        check(r["launches"]["head_select"] > 0 and r["variants"].get(
            "tc_raw", 0) == r["launches"]["head_select"],
              f"LM-13: head_select launches {r['variants']}; all must be "
              f"tc_raw")
    v, i, wt, m, th, conf = got
    vr, ir, wr, mr, thr_r, conf_r = ref
    # the sharded payload's contributor blocks come self, prev, next; the
    # node-stacked round's self, then the neighbours in adjacency order:
    # the same blocks, permuted along k
    from repro_torch.core.topology import Topology
    n = v.shape[0]
    nbr = Topology.make("ring", n).neighbor_arrays()[0]
    kb = v.shape[-1] // 3
    order = [[[i, (i - 1) % n, (i + 1) % n].index(int(j)) for j in nbr[i]]
             for i in range(n)]
    v = torch.stack([torch.cat([v[a, ..., b * kb:(b + 1) * kb]
                                for b in order[a]], -1) for a in range(n)])
    i = torch.stack([torch.cat([i[a, ..., b * kb:(b + 1) * kb]
                                for b in order[a]], -1) for a in range(n)])
    dconf = (conf - conf_r).abs()
    check(bool((dconf <= ATOL + RTOL * conf_r.abs()).all()),
          f"LM-13: public confidences differ by {float(dconf.max()):.3g}")
    dthr = float((th - thr_r).abs().max())
    check(dthr <= THRESH_ATOL, f"LM-13: thresholds differ by {dthr:.3g}")
    band = (conf_r - thr_r[:, None]).abs() <= MASK_BAND
    check(not bool(((m != mr) & ~band).any()),
          "LM-13: D_ID masks differ outside the band")
    agree = (m == mr).all(0)                    # samples every node agrees on
    check(bool((wt[:, agree] == wr[:, agree]).all()),
          "LM-13: weights differ where the masks agree")
    dv = (v[:, agree] - vr[:, agree]).abs()
    check(bool((dv <= ATOL + RTOL * vr[:, agree].abs()).all()),
          f"LM-13: merged labels differ by {float(dv.max()):.3g}")
    swap = i[:, agree] != ir[:, agree]
    check(bool((~swap | (dv <= IDX_TIE)).all()),
          "LM-13: label indices differ outside near-ties")
    check(bool(((i >= 0) & (i < vocab)).all()), "LM-13: indices outside "
                                                 "the vocabulary")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    print(f"LM-13 (Hymba-1.5B x 4 nodes, {LM13_PUBLIC} public x 2048 "
          f"tokens, model_parallel 2 on 2 ranks, {wire}): "
          f"round {max(r['wall_s'] for r in ranks):.2f} s wall (unsharded "
          f"{ref_wall:.2f} s), rank setup "
          f"{max(r['setup_s'] for r in ranks):.1f} s, spawn to join "
          f"{spawn_s:.1f} s; peak per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB (shards "
          f"{ranks[0]['local_gib']:.2f} GiB a rank); launches {launches}, "
          f"head_select by variant {[r['variants'] for r in ranks]}; conf "
          f"within {float(dconf.max()):.3g}, thresholds within {dthr:.3g}, "
          f"masks equal outside the band ({int((m != mr).sum())} differ, "
          f"{int(band.sum())} entries within {MASK_BAND}), labels within "
          f"{float(dv.max()):.3g}, {int(swap.sum())} near-tie index swaps; "
          f"kept {float(m.float().mean()):.4f}")
    flash_by, dims = {}, {}
    for r in ranks:
        for v, c in r["flash_variants"].items():
            flash_by[v] = flash_by.get(v, 0) + c
        for d, c in r["flash_dims"].items():
            dims[d] = dims.get(d, 0) + c
    return ({"head_select_raw_tc": launches["head_select"],
             "flash_attention": launches["flash_attention"],
             "ssd_scan": launches["ssd_scan"],
             "flash_attention_offset": launches["flash_attention_offset"],
             "ssd_scan_state": launches["ssd_scan_state"]},
            {"head_select": {"tc_raw": launches["head_select"]},
             "flash_attention": flash_by},
            {"flash_attention": dims})


def kernel_line(kres, lm_rows, paths, variants, head_dims, checks):
    """The ``kernels`` JSON line: one entry per kernel, timed at the
    shape of the path where it does the most work (Hymba's round, and its
    one-shot branch for msp_select; Hymba's training step for the two
    backward kernels; for the three kernels with a tensor-core variant,
    that variant's bf16 time, the SIMT time being on an earlier line);
    ``max_abs_err`` is the largest over every shape checked; ``launches``
    sums the paths that ran it (``paths``: {path: {kernel: launches}},
    each counted from 0 over that path's run), ``launches_by_path``
    splits them and ``launches_by_variant`` splits them by kernel
    (``source`` is the tensor-core variant's file where there is one;
    the two ``ssd_scan`` kernels have one variant each, on the tensor
    cores, and ``msp_select`` one, on the SIMT units). The two flash
    entries also split their launches by head_dim (``head_dims``: {path:
    {kernel: {head_dim: launches}}}) and carry their bf16 times at
    head_dim 96 (Phi-3-mini's round and training shapes) under
    ``at_head_dim_96``; ``head_select`` carries its times at the dense
    heads (Qwen3-1.7B's tied, Phi-3-mini's) under ``dense_heads``. The
    backward kernels replace no Pallas kernel of their own (the JAX
    package differentiates its jnp forms): ``replaces`` names the Pallas
    kernel whose backward they are. ``flash_attention_cross`` and
    ``flash_attention_bwd_cross`` are the same two kernels' non-causal
    mode (the Pallas kernel's causal=False), counted and timed apart:
    their launches are LM-7's cross-attention ones, their times the bf16
    tc kernels' at MusicGen's layer (B 2, Sq 1500, Sk 64); the causal
    entries carry their times at MusicGen's self-attention under
    ``at_musicgen``. ``flash_attention_prefix`` and
    ``flash_attention_bwd_prefix`` are the prefix-LM mode (PaliGemma's,
    head_dim 256): their launches are LM-8's (its train steps' and its
    prefill's), their times the bf16 tc
    kernels' at PaliGemma's training layer (B 2, S 512, prefix 256, 8/1
    x 256); the causal entries carry their times at that shape without
    the prefix under ``at_head_dim_256``. ``flash_attention_offset`` and
    ``ssd_scan_state`` are the serving modes (q_offset / kv_valid_len;
    an initial state in, the final state out); ``ssd_scan`` counts the
    other launches of that kernel. No path calls either mode (the
    serving path, ``serve``, launches no kernel, as the reference's);
    ``check_launches`` gives, apart from ``launches``, those made by
    SERVE's checks (``checks``: {kernel: launches}): (b)'s forwards and
    (c)'s comparison with decode."""
    src = "src/repro_torch/csrc/{}.cu"
    ref = "src/repro/kernels/{}/kernel.py:{}"
    tc = {"head_select", "flash_attention", "flash_attention_bwd"}
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def bf16(rows, window):
        return next(r for r in rows if r.get("window") == window
                    and r.get("dtype") == "bfloat16" and "ms" in r)
    flash = bf16(lm_rows["flash_attention"], 1024)
    flash_bwd = bf16(lm_rows["flash_attention_bwd"], 1024)
    picks = {"head_select": (lm_rows["head_select"][0], "head_select", 131),
             "msp_select": (lm_rows["msp_select"][0], "msp_select", 67),
             "flash_attention": (flash, "flash_attention", 69),
             "ssd_scan": (lm_rows["ssd_scan"][0], "ssd_scan", 60),
             "flash_attention_bwd": (flash_bwd, "flash_attention", 69),
             "ssd_scan_bwd": (lm_rows["ssd_scan_bwd"][0], "ssd_scan", 60),
             "flash_attention_cross": (
                 bf16(lm_rows["flash_attention_cross"], 0),
                 "flash_attention", 69),
             "flash_attention_bwd_cross": (
                 bf16(lm_rows["flash_attention_bwd_cross"], 0),
                 "flash_attention", 69),
             "flash_attention_prefix": (
                 bf16(lm_rows["flash_attention_prefix"], 0),
                 "flash_attention", 69),
             "flash_attention_bwd_prefix": (
                 bf16(lm_rows["flash_attention_bwd_prefix"], 0),
                 "flash_attention", 69),
             "flash_attention_mla": (
                 bf16(lm_rows["flash_attention_mla"], 0),
                 "flash_attention", 69),
             "flash_attention_bwd_mla": (
                 bf16(lm_rows["flash_attention_bwd_mla"], 0),
                 "flash_attention", 69)}
    errs = {"head_select": (kres["head_select"] + lm_rows["head_select"]
                            + lm_rows["head_select_dense"]
                            + lm_rows["head_select_deepseek"]),
            "msp_select": kres["msp_select"] + lm_rows["msp_select"],
            "flash_attention": (lm_rows["flash_attention"]
                                + lm_rows["flash_attention_d96"]
                                + lm_rows["flash_attention_qwen3"]
                                + lm_rows["flash_attention_musicgen"]
                                + lm_rows["flash_attention_d256"]),
            "flash_attention_bwd": (lm_rows["flash_attention_bwd"]
                                    + lm_rows["flash_attention_bwd_d96"]
                                    + lm_rows["flash_attention_bwd_qwen3"]
                                    + lm_rows["flash_attention_bwd_musicgen"]
                                    + lm_rows["flash_attention_bwd_d256"])}
    line = []
    for name, (row, pallas, at) in picks.items():
        base = name.removesuffix("_cross").removesuffix(
            "_prefix").removesuffix("_mla")
        by_path = {path: counts.get(name, 0)
                   - (counts.get("ssd_scan_state", 0) if name == "ssd_scan"
                      else 0) for path, counts in paths.items()}
        by_variant = {"tc": 0, "simt": 0} if base in tc else {
            ("simt" if name == "msp_select" else "tc"):
                sum(by_path.values())}
        if base in tc:
            for path in variants.values():
                for v, n in path.get(name, {}).items():
                    if not v.endswith("_raw"):
                        by_variant[v] += n
        entry = {"name": name, "route": "cuda",
                 "source": src.format(base + ("_tc" if base in tc else "")),
                 "replaces": ref.format(pallas, at),
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "launches_by_variant": by_variant,
                 "max_abs_err": max(r["err"] for r in
                                    errs.get(name, lm_rows.get(name))),
                 **{k: row.get(k) for k in timing}}
        if name in checks:
            entry["check_launches"] = {"serve": checks[name]}
        if name.startswith("flash"):
            by_dim = {}
            for path in head_dims.values():
                for d, n in path.get(name, {}).items():
                    d = d if isinstance(d, int) else "x".join(map(str, d))
                    by_dim[d] = by_dim.get(d, 0) + n
            entry["launches_by_head_dim"] = by_dim
            if name.endswith("_mla"):
                entry["f32_simt"] = [
                    {"shape": r["shape"], **{k: r.get(k) for k in timing}}
                    for r in lm_rows[name] if r.get("dtype") == "float32"
                    and "ms" in r]
            if name != base:
                line.append(entry)
                continue
            mg = lm_rows[name + "_musicgen"][0]
            entry["at_musicgen"] = {k: mg.get(k) for k in timing}
            d96 = bf16(lm_rows[name + "_d96"], 0)
            entry["at_head_dim_96"] = {k: d96.get(k) for k in timing}
            qwen3 = bf16(lm_rows[name + "_qwen3"], 0)
            entry["at_qwen3"] = {k: qwen3.get(k) for k in timing}
            d256 = bf16(lm_rows[name + "_d256"], 0)
            entry["at_head_dim_256"] = {k: d256.get(k) for k in timing}
        if name == "head_select":
            entry["dense_heads"] = [{"shape": r["shape"],
                                     **{k: r.get(k) for k in timing}}
                                    for r in lm_rows["head_select_dense"]]
            ds = lm_rows["head_select_deepseek"][0]
            entry["deepseek_head"] = {k: ds.get(k) for k in timing}
        line.append(entry)
    # the serving path's two kernel modes: flash's offset mode (q_offset,
    # kv_valid_len), timed at Qwen3's chunked prefill (bf16, tc) with the
    # decode-shaped call and the f32 SIMT kernel beside it; ssd_scan's
    # initial / final state, timed at Hymba's shape
    for name, source, pallas, at in (
            ("flash_attention_offset", "flash_attention_tc",
             "flash_attention", 69),
            ("ssd_scan_state", "ssd_scan", "ssd_scan", 60)):
        rows = lm_rows[name]
        timed_rows = [r for r in rows if "ms" in r]
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        entry = {"name": name, "route": "cuda", "source": src.format(source),
                 "replaces": ref.format(pallas, at),
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "check_launches": {"serve": checks[name]},
                 "max_abs_err": max(r["err"] for r in rows),
                 **{k: timed_rows[0].get(k) for k in timing}}
        if len(timed_rows) > 1:
            entry["other_shapes"] = [
                {"shape": r["shape"], "dtype": r.get("dtype"),
                 **{k: r.get(k) for k in timing}} for r in timed_rows[1:]]
        if name == "ssd_scan_state":
            entry["ms_without_state"] = timed_rows[0]["ms_without_state"]
        line.append(entry)
    # head_select's raw_stats mode (the vocab-sharded round's per-slice
    # carry): SIMT at SHARD (b)'s slice, tc at LM-13's
    for name, rows, source in (
            ("head_select_raw_simt", kres["head_select_raw_simt"],
             "head_select"),
            ("head_select_raw_tc", lm_rows["head_select_raw_tc"],
             "head_select_tc")):
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        line.append({"name": name, "route": "cuda",
                     "source": src.format(source),
                     "replaces": ref.format("head_select", 131),
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": max(r["err"] for r in rows),
                     **{k: rows[0].get(k) for k in timing}})
    return line


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    # LM-5 holds ~63 GiB of the card's 79: in fixed-size segments the
    # KD step's vocabulary-wide blocks can leave 18 GiB reserved but
    # unusable and run out of memory; growable segments do not fragment
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    args = sys.argv[1:]
    if args not in ([], ["--shard-norm-fault"]):
        print("usage: chip_smoke.py [--shard-norm-fault]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.kernels import build
    from repro_torch.kernels.head_select import head_select, head_select_plain
    from repro_torch.kernels.msp_select import msp_select, msp_select_plain

    ops = (head_select, head_select_plain, msp_select, msp_select_plain)

    def run(name, fn, *args):
        """One phase, its seconds printed after it."""
        t0 = time.perf_counter()
        out = fn(torch, *args)
        torch.cuda.empty_cache()
        print(f"chip_smoke: phase {name} took "
              f"{time.perf_counter() - t0:.1f} s")
        return out

    # DRYRUN's meta traces need no card and no kernel: they run while
    # nvcc builds (the module imported here, before the thread starts)
    from repro_torch.launch import dryrun  # noqa: F401
    traces = None if args else _Background(dryrun_traces)
    run("device", phase_device, build)
    if args:
        run("SHARD norm fault", phase_shard_fault)
        return 0
    traced = traces.join()
    kres = run("kernels", phase_kernels, ops)
    sim, result, launches, variants = run("main path", phase_main_path, ops)
    launches["msp_select"] = run("fused round", phase_fused_round, sim,
                                 result, ops)
    run("quickstart", phase_quickstart)
    del sim, result
    grid_launches, grid_variants, _ = run("GRID", phase_grid, ops)
    run("GRID card vs CPU", phase_grid_card_vs_cpu)
    paper_launches, paper_variants = run("PAPER", phase_paper, ops)
    resil_launches, resil_variants = run("RESIL", phase_resil, ops)
    gossip_launches, gossip_variants = run("GOSSIP", phase_gossip)
    shard_launches, shard_variants, (snap_launches, snap_variants) = run(
        "SHARD", phase_shard)

    lm_rows = run("LM-1", phase_lm_kernels)
    run("LM-1 dense", phase_lm_dense_kernels, lm_rows)
    run("LM-1 MusicGen", phase_lm_musicgen_kernels, lm_rows)
    run("LM-1 PaliGemma", phase_lm_paligemma_kernels, lm_rows)
    run("LM-1 MLA", phase_lm_mla_kernels, lm_rows)
    lm, lm_launches, lm_variants, lm_dims = run("LM-2", phase_lm_round)
    lm_launches["msp_select"], msp_row = run("LM-3", phase_lm_oneshot, lm)
    lm_rows["msp_select"] = [msp_row]
    del lm
    train = run("LM-4", phase_lm_train)
    lm_dots = run("LM-4 dots", phase_lm_dots)
    qwen3, phi3 = run("LM-5, LM-6", phase_lm_dense)
    musicgen = run("LM-7", phase_lm_musicgen)
    paligemma = run("LM-8", phase_lm_paligemma)
    baselines = run("LM-9", phase_lm_baselines)
    deepseek = run("LM-10", phase_lm_deepseek)
    deepseek_train = run("LM-11", phase_lm_deepseek_train)
    arctic = run("LM-12", phase_lm_arctic)
    lm_shard_launches, lm_shard_variants, lm_shard_dims = run(
        "LM-13", phase_lm_shard)
    lm_gossip = run("LM-14", phase_lm_gossip)
    serve = run("SERVE", phase_serve)
    lm_rows.update(serve["rows"])
    run("DRYRUN", phase_dryrun, traced)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    trains = {"lm_train_path": train, "lm_qwen3": qwen3, "lm_phi3": phi3,
              "musicgen-train": musicgen, "paligemma-train": paligemma,
              "lm_baselines": baselines, "deepseek-round": deepseek,
              "deepseek-train": deepseek_train, "arctic-prefill": arctic,
              "lm_gossip": lm_gossip, "lm_dots": lm_dots}
    print(json.dumps({"kernels": kernel_line(
        kres, lm_rows,
        {"resnet_path": launches, "grid": grid_launches,
         "paper": paper_launches, "resil": resil_launches,
         "gossip": gossip_launches,
         "shard": shard_launches, "shard_snapshot": snap_launches,
         "lm_path": lm_launches,
         "lm_shard": lm_shard_launches, "serve": serve["launches"],
         **{k: v["launches"] for k, v in trains.items()}},
        {"resnet_path": variants, "grid": grid_variants,
         "paper": paper_variants, "resil": resil_variants,
         "gossip": gossip_variants,
         "shard": shard_variants, "shard_snapshot": snap_variants,
         "lm_shard": lm_shard_variants,
         "lm_path": lm_variants, "serve": serve["variants"],
         **{k: v["variants"] for k, v in trains.items()}},
        {"lm_path": lm_dims, "lm_shard": lm_shard_dims,
         "serve": serve["by_head_dim"],
         **{k: v["by_head_dim"] for k, v in trains.items()}},
        serve["check_launches"])}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
