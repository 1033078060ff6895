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
   an LM head shape (Qwen3-1.7B's head: D = 2048, C = 151,936) — with
   their times beside the card's bound;
3. main path: ResNet-20 at full width on 16 ring nodes with QG-DSGDm-N,
   120 plain steps, one streaming IDKD round on the sparse backend
   (``head_select``), 120 KD steps; the consensus model must learn (its
   eval NLL falls over the run and over the KD phase, its accuracy
   clears a floor);
4. the one-shot ``fused`` round (``msp_select``) on the final params,
   held against the streaming round;
5. the quickstart twin, held to an accuracy floor.

It then prints one ``{"kernels": [...]}`` line and, last, one line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
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
                if "registers" in line or "spill" in line:
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
    msp_select.launches = 0
    t0 = time.perf_counter()
    result = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"head_select": head_select.launches,
                "msp_select": msp_select.launches}

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
          f"{post:.4f}, launches {launches}")
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
    return sim, result, launches


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


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    sim, result, launches = phase_main_path(torch, ops)
    launches["msp_select"] = phase_fused_round(torch, sim, result, ops)
    phase_quickstart(torch)

    sources = {"head_select": ("src/repro_torch/csrc/head_select.cu",
                               "src/repro/kernels/head_select/kernel.py:131"),
               "msp_select": ("src/repro_torch/csrc/msp_select.cu",
                              "src/repro/kernels/msp_select/kernel.py:67")}
    line = []
    for name, rows in kres.items():
        main = next(r for r in rows if r["shape"] == "main"
                    and r["dtype"] == "float32" and r["detector"] == "msp")
        line.append({"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": launches[name],
                     "max_abs_err": max(r["err"] for r in rows),
                     "ms": main["ms"], "plain_ms": main["plain_ms"],
                     "bound_ms": main["bound_ms"],
                     "bound_by": main["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
