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
   clears a floor);
4. the one-shot ``fused`` round (``msp_select``) on the final params,
   held against the streaming round;
5. the quickstart twin, held to an accuracy floor;
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

It then prints one ``{"kernels": [...]}`` line and, last, one line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
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
TRAIN_PEAK_GIB = 72.0        # LM-4's, LM-5's and LM-6's peak device
                             # memory budget
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
    return results


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
    t0 = time.perf_counter()
    result = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    print(f"main path: {wall:.1f} s wall, acc {result.acc_history}, "
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
def _flash_work(B, S, H, KVH, D, window, elem, Sk=None, prefix=0):
    """(bytes, flops) of one attention call, causal (windowed, or with a
    prefix-LM mask of ``prefix`` positions: the causal triangle and the
    prefix square's upper part, P(P - 1)/2 pairs more) or, with ``Sk``,
    non-causal over Sk keys: q, k, v read and o written once; 4·D flops
    per visible (q, k) pair and head."""
    if Sk is None:
        Sk, pc = S, min(prefix, S)
        pairs = sum(min(q + 1, window) if window else max(q + 1, pc)
                    if q < pc else q + 1 for q in range(S))
    else:
        pairs = S * Sk
    return ((2 * B * S * H * D + 2 * B * Sk * KVH * D) * elem,
            4.0 * D * H * B * pairs)


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


def _flash_bwd_work(B, S, H, KVH, D, window, elem, Sk=None, prefix=0):
    """(bytes, flops) of one attention backward: q, o, dO (S rows), k, v
    (Sk, S without ``Sk``) and the f32 lse read, dq, dk, dv written once;
    five products of the (causal, windowed, prefix-LM) score matrix's
    size (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q), 2.5 times the forward's
    two."""
    _, flops = _flash_work(B, S, H, KVH, D, window, elem, Sk, prefix)
    Sk = S if Sk is None else Sk
    return ((4 * B * S * H * D + 4 * B * Sk * KVH * D) * elem
            + 4 * B * H * S, 2.5 * flops)


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
                   Sk=None, prefix=0):
    """One forward case on fresh random q, k, v: the kernel against its
    plain version (FLASH_ATOL), its time beside its bound, the plain
    version's and SDPA's; in bf16 the SIMT and tc variants in turns.
    With ``Sk`` the call is non-causal over Sk keys (cross-attention);
    ``prefix`` > 0 gives the prefix-LM mask."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    dev = "cuda"
    dname = str(dtype).split(".")[-1]
    causal = Sk is None
    kw = dict(window=window, causal=causal, prefix_len=prefix)
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S if causal else Sk, KVH, D), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn(k.shape, generator=gen, device=dev).to(dtype)
    tag = (f"flash_attention {label}S={S}{'' if causal else f' Sk={Sk}'} "
           f"B={B} {_mode_tag(window, causal, prefix)} {dname}")
    err = _check_flash(torch, q, k, v, window, tag, causal, prefix)
    nbytes, flops = _flash_work(B, S, H, KVH, D, window, q.element_size(),
                                Sk, prefix)
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
               bound_ms=bnd, bound_by=by, library_ms=lms)
    print(f"{tag}: variant {flash_ops._variant(q.dtype, D)}, "
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
                   timing=True, Sk=None, prefix=0):
    """One backward case on fresh random q, k, v, dO: the training
    forward's o and lse held to their plain versions (_flash_saved), then
    the backward kernel of the forward's variant against the plain
    version (the SIMT kernel by the element-wise rule, the tc kernel by
    _check_flash_bwd_tc's); with ``timing``, its time beside its bound,
    the plain version's and SDPA's backward, and in bf16 both variants
    in turns. With ``Sk`` the call is non-causal over Sk keys; ``prefix``
    > 0 gives the prefix-LM mask."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    dev = "cuda"
    dname = str(dtype).split(".")[-1]
    causal = Sk is None
    kw = dict(window=window, causal=causal, prefix_len=prefix)
    q, do = (torch.randn((B, S, H, D), generator=gen,
                         device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S if causal else Sk, KVH, D), generator=gen,
                        device=dev).to(dtype) for _ in range(2))
    variant = flash_ops._variant(dtype, D)
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
    row = dict(window=window, dtype=dname, err=err)
    if not timing:
        print(f"{tag}: variant {variant}, max_abs_err {err:.3g}")
        return row
    nbytes, flops = _flash_bwd_work(B, S, H, KVH, D, window,
                                    q.element_size(), Sk, prefix)
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
                                 Sk, prefix), dname)[0]
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
    take the same steps: weights made on the CPU and moved, and every
    index draw (private rows, public sub-batches) from one CPU generator
    seeded here (a CUDA and a CPU torch.Generator give different numbers
    from one seed)."""
    import repro_torch.core.driver as drv
    from repro_torch.models.transformer import DecoderModel
    gen = torch.Generator().manual_seed(seed)
    sample, draw, init = drv.sample_partition, drv.draw_public, \
        DecoderModel.init

    def sample_partition(parts, _gen, batch_size):
        cpu = drv.PaddedParts(parts.idx.cpu(), parts.size.cpu())
        return sample(cpu, gen, batch_size).to(parts.idx.device)

    def draw_public(_gen, n, pub_batch, n_public, device):
        return draw(gen, n, pub_batch, n_public, "cpu").to(device)

    def init_on_cpu(self, seed, device="cuda"):
        return {k: v.to(device) for k, v in init(self, seed, "cpu").items()}

    return _Patch((drv, "sample_partition", sample_partition),
                  (drv, "draw_public", draw_public),
                  (DecoderModel, "init", init_on_cpu))


def _grad_checked(torch, make_algorithm, bad):
    """``make_algorithm`` whose step first records in ``bad`` each leaf
    of a node without a finite gradient that is non-zero somewhere, as
    (step, leaf, per-node norms), steps counted from 0 over every
    algorithm it makes."""
    calls = [0]

    def checked_algorithm(*a, **kw):
        algo = make_algorithm(*a, **kw)
        real = algo.step

        def step(params, grads, state, lr, mix):
            for k, g in grads.items():
                norm = torch.linalg.vector_norm(
                    g.reshape(g.shape[0], -1), dim=1, dtype=torch.float32)
                ok = torch.isfinite(norm) & (norm > 0)
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
    that per KD step (the KD adapter's second forward), every bf16 flash
    and head_select launch goes through the tc variant, every flash
    launch runs at the config's head_dim, and the peak stays within
    TRAIN_PEAK_GIB. Launches are counted from 0 over this run."""
    import repro_torch.core.driver as drv
    import repro_torch.launch.train as train_mod
    from repro_torch import lmpath
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.head_select import head_select
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd,
                "head_select": head_select}
    steps, rounds, bad = [], [], []
    make_step, make_algorithm = drv.make_step, train_mod.make_algorithm
    label_round = train_mod.idkd_label_round

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
                (train_mod, "idkd_label_round", timed_round)):
        out = lmpath.train(cfg, tcfg, pub_batch=pub_batch, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    variants = {k: dict(counters[k].launches_by_variant)
                for k in with_variants}
    by_dim = {k: dict(counters[k].launches_by_head_dim)
              for k in ("flash_attention", "flash_attention_bwd")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist, pub = out["loss_history"], out["pub_batch"]
    del out
    torch.cuda.empty_cache()
    n, L, hd = tcfg.num_nodes, cfg.num_layers, cfg.resolved_head_dim
    print(f"{label}: LM training ({cfg.name}, {n} ring nodes, {L} layers, "
          f"head_dim {hd}, batch {tcfg.batch_size} x 2048 tokens, KD "
          f"public {pub} x 2048, lr {tcfg.lr}): {wall:.1f} s wall with "
          f"set-up, peak memory {peak:.2f} GiB; round {rounds} s; losses "
          f"{hist}")
    for i, st in enumerate(steps):
        print(f"  step {i} ({st['kind']}): {st['s']:.2f} s, loss "
              f"{st['loss']:.4f}, launches {st['launches']}")
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
            check(got == (want if ssm or name.startswith("flash") else 0),
                  f"{label}: {st['kind']} step: {got} {name} launches, the "
                  f"schedule implies {n} nodes x {L} layers"
                  f"{' x 2 (the KD forward)' if st['kind'] == 'kd' else ''}"
                  f" = {want}{'' if ssm else ' (no SSM: 0 for ssd_scan)'}")
        for name in ("flash_attention", "ssd_scan"):
            got = st["launches"][name]
            check(got == (2 * want if ssm or name.startswith("flash")
                          else 0),
                  f"{label}: {st['kind']} step: {got} {name} launches; "
                  f"with per-layer recompute, {2 * want}")
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


def _train_card_vs_cpu(torch, label, cfg, tcfg, pub_batch=None, **kw):
    """``lmpath.train`` of a reduced f32 config on the card and on the
    CPU with the same weights and index draws: consensus params within
    TRAIN_PARAM_ATOL, losses within TRAIN_LOSS_RTOL, label bytes equal.
    Returns (param error, loss error)."""
    from repro_torch import lmpath
    runs = {}
    for device in ("cuda", "cpu"):
        with _same_draws(torch, 7):
            runs[device] = lmpath.train(cfg, tcfg, pub_batch=pub_batch,
                                        device=device, **kw)
    gpu, cpu = runs["cuda"], runs["cpu"]
    dp = max(float((gpu["params"][k].cpu() - v).abs().max())
             for k, v in cpu["params"].items())
    dl = max(abs(a - b) / abs(b) for a, b in zip(gpu["loss_history"],
                                                 cpu["loss_history"]))
    check(gpu["ledger"]["label_bytes"] == cpu["ledger"]["label_bytes"],
          f"{label}: label bytes {gpu['ledger']['label_bytes']} on the "
          f"card, {cpu['ledger']['label_bytes']} on the CPU")
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
                w = 0 if mode == "prefix" else want[name]
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
            w = 0 if mode == "prefix" else per * ns * ls
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
    return dict(steps=steps, peak_gib=peak, prefill_s=prefill_s,
                launches=launches, variants=variants, by_head_dim=dims)


def kernel_line(kres, lm_rows, paths, variants, head_dims):
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
    the prefix under ``at_head_dim_256``."""
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
                 "flash_attention", 69)}
    errs = {"head_select": (kres["head_select"] + lm_rows["head_select"]
                            + lm_rows["head_select_dense"]),
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
        base = name.removesuffix("_cross").removesuffix("_prefix")
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        by_variant = {"tc": 0, "simt": 0} if base in tc else {
            ("simt" if name == "msp_select" else "tc"):
                sum(by_path.values())}
        if base in tc:
            for path in variants.values():
                for v, n in path.get(name, {}).items():
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
        if name.startswith("flash"):
            by_dim = {}
            for path in head_dims.values():
                for d, n in path.get(name, {}).items():
                    by_dim[d] = by_dim.get(d, 0) + n
            entry["launches_by_head_dim"] = by_dim
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
        line.append(entry)
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
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.kernels import build
    from repro_torch.kernels.head_select import head_select, head_select_plain
    from repro_torch.kernels.msp_select import msp_select, msp_select_plain

    ops = (head_select, head_select_plain, msp_select, msp_select_plain)
    phase_device(torch, build)
    kres = phase_kernels(torch, ops)
    sim, result, launches, variants = phase_main_path(torch, ops)
    launches["msp_select"] = phase_fused_round(torch, sim, result, ops)
    phase_quickstart(torch)
    del sim, result
    torch.cuda.empty_cache()

    lm_rows = phase_lm_kernels(torch)
    phase_lm_dense_kernels(torch, lm_rows)
    phase_lm_musicgen_kernels(torch, lm_rows)
    phase_lm_paligemma_kernels(torch, lm_rows)
    lm, lm_launches, lm_variants, lm_dims = phase_lm_round(torch)
    lm_launches["msp_select"], msp_row = phase_lm_oneshot(torch, lm)
    lm_rows["msp_select"] = [msp_row]
    del lm
    torch.cuda.empty_cache()
    train = phase_lm_train(torch)
    qwen3, phi3 = phase_lm_dense(torch)
    musicgen = phase_lm_musicgen(torch)
    paligemma = phase_lm_paligemma(torch)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    trains = {"lm_train_path": train, "lm_qwen3": qwen3, "lm_phi3": phi3,
              "musicgen-train": musicgen, "paligemma-train": paligemma}
    print(json.dumps({"kernels": kernel_line(
        kres, lm_rows,
        {"resnet_path": launches, "lm_path": lm_launches,
         **{k: v["launches"] for k, v in trains.items()}},
        {"resnet_path": variants, "lm_path": lm_variants,
         **{k: v["variants"] for k, v in trains.items()}},
        {"lm_path": lm_dims,
         **{k: v["by_head_dim"] for k, v in trains.items()}})}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
