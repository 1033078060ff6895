"""What a kernel's time goes to, on the card: copies of a CUDA source with
one part cut out, timed against the source as it is.

Each variant is ``csrc/<kernel>.cu`` with one edit, built with the same
flags under ``build/ablate/`` and launched through the same C entry point
on the same inputs, all variants in turns (two rounds; the faster round
is kept). A variant with a part cut out computes a wrong result by
design: it measures, it does not compute the kernel's function.
``ssd_scan`` also gets its three passes' device times from the profiler.

    python -m repro_torch.kernels.ablate          # on a machine with an H100

``--forward`` instead times the LM forward kernels as the label round
calls them (no grad, at Hymba-1.5B's round shape): ``flash_attention``
global and windowed in bf16, and ``ssd_scan``. Run by path with another
checkout's package first on ``PYTHONPATH``, it times that checkout's
kernels through the same calls, so two versions can be timed in turns
within one machine:

    PYTHONPATH=<checkout>/src python src/repro_torch/kernels/ablate.py --forward

``--flash`` times the tensor-core ``flash_attention`` kernels, forward
as the round calls them (B 8, no log-sum-exp) and backward at the
training batch ``chip_smoke.py``'s rows take (B 2; B 8 at DeepSeek-V3's
MLA layer), at the shapes the LM paths run (Hymba-1.5B global and
windowed, Qwen3-1.7B, Phi-3-mini, MusicGen-medium's self- and
cross-attention, PaliGemma-3B's layer at head_dim 256 causal and with its
prefix-LM mask, DeepSeek-V3's MLA layer), through the same calls for
whichever checkout is first on ``PYTHONPATH``, as ``--forward``.

``--backward`` splits the two backward calls into their kernels' device
times (the profiler): the tensor-core attention backward's three at
Hymba-1.5B's training shape (window 0 and 1024), Phi-3-mini's (head_dim
96), Qwen3-1.7B's, MusicGen-medium's self- and cross-attention and
DeepSeek-V3's MLA layer, each beside copies of
``flash_attention_bwd_tc.cu`` in turns: with its dQ reductions into the
f32 accumulator cut out, and four that still compute the function
(a Q / dO ring of depth 3 at head_dim 96 and 128; the blocks in the
head-fastest order; chunks of heads with a short last one; chunks sized
by the dQ rows alone); and the SSD backward's four, timing
``ssd_scan_bwd.cu`` with groups of its tile kernel's products cut out,
and with its products accumulated inside the ``mma`` as the forward's
are, that variant's and the committed kernel's max errors against the
plain version in float64 printed beside the plain f32 version's.

``--rounding`` holds the tensor-core attention backward's gradients at
``ROUNDING_CASES`` against the float64 statement of its function and
against the plain f32 version, beside SDPA's backward and the plain
version itself (``bwd_rounding``). ``--dots-noise`` repeats the
statistic of ``chip_smoke.py``'s LM-4 dots check (one Hymba-1.5B node's
gradients under per-layer recompute twice and "dots"), six rounds, and
compares runs back to back with runs of other rounds (``dots_noise``):
how far that check's one noise sample spreads.

It prints the card's name and power limit first. It imports nothing the
kernels' wrappers do not; the variants are never used by the port.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import build

OUT = build.BUILD_DIR.parent / "ablate"

# (variant, [(text in the source, its replacement), ...])
ABLATIONS = {
    "msp_select": [
        ("as committed", []),
        ("no top-k", [("  if (vm > thr && vm > thr_w) {",
                       "  if (false) {")]),
        ("no warp bar (per-thread threshold only)",
         [("      thr_w = fmaxf(thr_w, warp_bar(tv[0], k));", "      ;")]),
    ],
    "ssd_scan": [
        ("as committed", []),
        ("1xTF32 products", [("  mma_tf32(d, a.lo, b.hi);\n"
                              "  mma_tf32(d, a.hi, b.lo);\n", "")]),
        ("no intra-tile products",
         [("for (int ks = 0; ks <= 2 * tt + 1; ++ks) {",
           "for (int ks = 0; ks < 0; ++ks) {")]),
        ("no inter-tile products", [("    if (ci > 0) {", "    if (ci < 0) {")]),
        ("no pass-3 products",
         [("for (int ks = 0; ks <= 2 * tt + 1; ++ks) {",
           "for (int ks = 0; ks < 0; ++ks) {"),
          ("    if (ci > 0) {", "    if (ci < 0) {")]),
    ],
    "ssd_scan_bwd": [
        ("as committed", []),
        ("1xTF32 products", [("  mma_tf32(d, a.lo, b.hi);\n"
                              "  mma_tf32(d, a.hi, b.lo);\n", "")]),
        ("products accumulated in the mma (mma3, as the forward)",
         [("        mma3_rn(acc[j], a, bf);", "        mma3(acc[j], a, bf);"),
          ("              mma3_rn(acc[i], fa, fb);",
           "              mma3(acc[i], fa, fb);")]),
        ("no R product", [("acc, nj, 16 * tt, 0, P, 8 * cg, 4,",
                           "acc, nj, 16 * tt, 0, 0, 8 * cg, 4,")]),
        ("no y< / dx> products",
         [("acc, pj, 16 * tt, 0, 16 * tt + 16, 8 * cg, 4,",
           "acc, pj, 16 * tt, 0, 0, 8 * cg, 4,"),
          ("acc, pj, 16 * tt, 16 * tt, SSD_Q, 8 * cg, 4,",
           "acc, pj, 16 * tt, 16 * tt, 16 * tt, 8 * cg, 4,"),
          ("acc, pj, 16 * tt, 0, NS, 8 * cg, 4,",
           "acc, pj, 16 * tt, 0, 0, 8 * cg, 4,")]),
        ("no dc / db products",
         [("acc, NJ, 16 * tt, 0, 16 * tt + 16, nc0, 2,",
           "acc, NJ, 16 * tt, 0, 0, nc0, 2,"),
          ("acc, NJ, 16 * tt, 16 * tt, SSD_Q, nc0, 2,",
           "acc, NJ, 16 * tt, 16 * tt, 16 * tt, nc0, 2,"),
          ("acc, NJ, 16 * tt, 0, P, nc0, 2,",
           "acc, NJ, 16 * tt, 0, 0, nc0, 2,")]),
    ],
}


_FBT_CHUNK = "const int chunk = (int)((bh + n_chunks - 1) / n_chunks);"
ABLATIONS["flash_attention_bwd_tc"] = [
    ("as committed", []),
    ("no dQ reductions",        # the row-wise bulk ones and the tensor ones
     [('#include "hopper.cuh"\n',
       '#include "hopper.cuh"\n#define bulk_reduce_add_f32(...) ((void)0)\n'),
      ("tma_reduce_add_2d(tdq, ", "if (false) tma_reduce_add_2d(tdq, ")]),
    # the next four compute the whole function: a design choice each
    ("Q / dO ring depth 3 at head_dim 96 and 128",
     [("static constexpr int NST = D == 64 ? 4 : 2;",
       "static constexpr int NST = D == 64 ? 4 : 3;")]),
    ("head-fastest grid (every head one chunk: key block 0 of each head "
     "first)", [(_FBT_CHUNK, "const int chunk = (int)bh;")]),
    ("chunks of as many heads as FBT_L2_BUDGET holds, the last one short",
     [(_FBT_CHUNK, "const int chunk = (int)std::max(\n"
       "        1LL, std::min(bh, FBT_L2_BUDGET / per_head));")]),
    ("chunks of equal size by the dQ rows alone, 40 MiB",
     [("(bh * per_head + FBT_L2_BUDGET - 1) /\n"
       "                               FBT_L2_BUDGET;",
       "(bh * Sp * D * 4 + (40ll << 20) - 1) / (40ll << 20);")]),
]


# the ssd_scan_bwd variants that still compute the whole function, whose
# errors --backward prints beside their times
EXACT_BWD = ("as committed",
             "products accumulated in the mma (mma3, as the forward)")


def _inline_headers(src: str) -> str:
    """The source with its ``ssd_common.cuh`` include written out, so that
    an edit can reach the code the forward and backward share."""
    inc = '#include "ssd_common.cuh"'
    if inc not in src:
        return src
    head = (build.CSRC / "ssd_common.cuh").read_text()
    return src.replace(inc, head.replace("#pragma once\n", ""))


def _sources(kernel: str):
    src = _inline_headers((build.CSRC / f"{kernel}.cu").read_text())
    out = []
    for i, (name, edits) in enumerate(ABLATIONS[kernel]):
        s = src
        for old, new in edits:
            if old not in s:
                raise RuntimeError(f"{kernel} ablation {name!r}: {old!r} is "
                                   f"not in csrc/{kernel}.cu or its "
                                   f"ssd_common.cuh")
            s = s.replace(old, new)
        out.append((name, OUT / f"{kernel}_{i}.cu", s))
    return out


def _build(kernel: str):
    """{variant: the C entry point}, all variants compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path, s in _sources(kernel):
        path.write_text(s)
        lib = path.with_suffix(".so")
        cmd = [build._nvcc(), *build.FLAGS, "-I", str(build.CSRC), "-o",
               str(lib), str(path)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{kernel} ablation {name!r} failed to "
                               f"build:\n{log}")
        fns[name] = getattr(ctypes.CDLL(str(lib)), f"{kernel}_launch")
    return fns


def _in_turns(calls, reps: int):
    """{variant: device ms per call}, the faster of two rounds."""
    best = {}
    for _ in range(2):
        for name, call in calls.items():
            rc = call()
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                call()
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b) / reps
            best[name] = min(best.get(name, ms), ms)
    return best


def ablate_msp(gen):
    fns = _build("msp_select")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in fns.values():
        fn.argtypes = [i, p, i, i, i, ctypes.c_float, i, p, p, p, p]
        fn.restype = i
    stream = torch.cuda.current_stream().cuda_stream
    for N, C, dtype in ((65536, 32001, torch.bfloat16),
                        (512, 151936, torch.bfloat16),
                        (512, 151936, torch.float32),
                        (32768, 10, torch.float32)):
        x = (torch.randn((N, C), generator=gen, device="cuda") * 4).to(dtype)
        conf = torch.empty(N, device="cuda")
        vals = torch.empty((N, 8), device="cuda")
        idx = torch.empty((N, 8), device="cuda", dtype=torch.int32)
        code = 0 if dtype == torch.float32 else 1
        calls = {name: (lambda fn=fn: fn(
            code, x.data_ptr(), N, C, 8, 10.0, 0, conf.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), stream))
            for name, fn in fns.items()}
        gb = N * C * x.element_size() / 1e9
        res = _in_turns(calls, 5)
        print(f"msp_select {N} x {C} {str(dtype)[6:]}, k 8: " + "; ".join(
            f"{n} {ms:.3f} ms ({gb / ms * 1e3:.0f} GB/s)"
            for n, ms in res.items()),
            flush=True)
        del x


def ablate_ssd(gen):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan import ops
    fns = _build("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in fns.values():
        fn.argtypes = [p] * 8 + [i] * 7 + [p]
        fn.restype = i
    stream = torch.cuda.current_stream().cuda_stream
    for label, (B, S, H, P, G, N) in (("hymba", (8, 2176, 50, 64, 1, 16)),
                                      ("mamba2-780m",
                                       (8, 2048, 48, 64, 1, 128))):
        xdt = torch.randn((B, S, H, P), generator=gen, device="cuda")
        dta = -3 * torch.rand((B, S, H), generator=gen, device="cuda")
        b = torch.randn((B, S, G, N), generator=gen, device="cuda")
        c = torch.randn((B, S, G, N), generator=gen, device="cuda")
        nt = -(-S // ops.TILE) - 1
        y = torch.empty_like(xdt)
        st = torch.empty((B, nt, H, P, N), device="cuda")
        ce = torch.empty((B, nt, H), device="cuda")
        calls = {name: (lambda fn=fn: fn(
            xdt.data_ptr(), dta.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), st.data_ptr(), ce.data_ptr(), None, B, S, H, P,
            G, N, 0, stream)) for name, fn in fns.items()}
        res = _in_turns(calls, 10)
        print(f"ssd_scan {label} (B {B}, S {S}, H {H}, P {P}, G {G}, N {N}): "
              + "; ".join(f"{n} {ms:.4f} ms" for n, ms in res.items()),
              flush=True)
        full = calls["as committed"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                full()
            torch.cuda.synchronize()
        passes = {}
        for e in prof.key_averages():
            for kname in ("ssd_chunk_states", "ssd_state_passing",
                          "ssd_chunk_scan"):
                if kname in e.key:
                    us = getattr(e, "self_device_time_total", None)
                    if us is None:
                        us = e.self_cuda_time_total
                    passes[kname] = passes.get(kname, 0.0) + us / 10 / 1e3
        print(f"ssd_scan {label} passes (profiler, ms per call): " + ", ".join(
            f"{k} {v:.4f}" for k, v in passes.items()), flush=True)
        del xdt, dta, b, c, y, st, ce


def _device_ms_by_kernel(fn, reps: int):
    """{kernel name: device ms per call} of fn() from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us:
            name = e.key.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out


def flash_bwd_ablations(gen):
    """Device ms of each kernel of ``flash_attention``'s tensor-core
    backward (bf16) at Hymba-1.5B's training shape (B 2, S 2048 + 128 meta
    tokens, window 0 and 1024), Phi-3-mini's (B 2, S 2048, 32/32 x 96),
    Qwen3-1.7B's (16/8 x 128), MusicGen-medium's self- and
    cross-attention (B 2, Sq 1500, Sk 1500 or 64, 24/24 x 64) and
    DeepSeek-V3's MLA layer (B 8, 128/128 x (192, 128)), and the same
    calls through the ablation copies of its source, in turns."""
    import repro_torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    print(f"package: {repro_torch.__file__}")
    flash_fns = _build("flash_attention_bwd_tc")
    for fn in flash_fns.values():
        fn.argtypes = flash_ops._fn("bwd_tc").argtypes
        fn.restype = ctypes.c_int
    for label, B, S, Sk, H, KVH, D, Dv, window in (
            ("hymba-1.5b", 2, 2176, None, 25, 5, 64, 64, 0),
            ("hymba-1.5b", 2, 2176, None, 25, 5, 64, 64, 1024),
            ("phi3-mini-3.8b", 2, 2048, None, 32, 32, 96, 96, 0),
            ("qwen3-1.7b", 2, 2048, None, 16, 8, 128, 128, 0),
            ("musicgen-medium self", 2, 1500, None, 24, 24, 64, 64, 0),
            ("musicgen-medium cross", 2, 1500, 64, 24, 24, 64, 64, 0),
            ("deepseek-v3 mla", 8, 2048, None, 128, 128, 192, 128, 0)):
        causal, Sk = Sk is None, Sk or S
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        do, o = (torch.randn((B, S, H, Dv), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        k = torch.randn((B, Sk, KVH, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((B, Sk, KVH, Dv), generator=gen, device="cuda").to(
            torch.bfloat16)
        lse = 4 + torch.rand((B, H, S), generator=gen, device="cuda")
        tag = (f"flash_attention backward tc {label} (B {B}, S {S}"
               f"{'' if causal else f', Sk {Sk}'}, {H}/{KVH} x {D}/{Dv}, "
               f"window {window})")
        res = _device_ms_by_kernel(lambda: flash_ops._bwd_launch(
            "tc", q, k, v, o, lse, do, window, causal), 10)
        print(f"{tag} (ms per call): " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in res.items()), flush=True)
        res = _in_turns({n: (lambda fn=fn: flash_ops._bwd_tc_run(
            fn, q, k, v, o, lse, do, window, causal)[0])
            for n, fn in flash_fns.items()}, 10)
        print(f"{tag} ablations: " + "; ".join(
            f"{n} {ms:.4f} ms" for n, ms in res.items()), flush=True)
        del q, do, o, k, v, lse
    torch.cuda.empty_cache()


def backward_passes(gen):
    """Device ms of each kernel of the two backward calls:
    :func:`flash_bwd_ablations`, then ``ssd_scan``'s four passes (N 16;
    and Mamba-2-780M's N 128, S 2048) and its ablations."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops, ssd_scan_bwd
    flash_bwd_ablations(gen)
    torch.cuda.empty_cache()
    B, S = 2, 2176
    fns = _build("ssd_scan_bwd")
    for label, (S_, H, N) in (("hymba", (S, 50, 16)),
                              ("mamba2-780m", (2048, 48, 128))):
        xdt, dy = (torch.randn((B, S_, H, 64), generator=gen, device="cuda")
                   for _ in range(2))
        dta = -3 * torch.rand((B, S_, H), generator=gen, device="cuda")
        b, c = (torch.randn((B, S_, 1, N), generator=gen, device="cuda")
                for _ in range(2))
        res = _device_ms_by_kernel(lambda: ssd_scan_bwd(xdt, dta, b, c, dy),
                                   10)
        print(f"ssd_scan backward {label} (B {B}, S {S_}, H {H}, N {N}; ms "
              f"per call): " + ", ".join(f"{n} {ms:.4f}"
                                         for n, ms in res.items()),
              flush=True)

        def run(fn):
            ssd_ops._bwd_run(fn, xdt, dta, b, c, dy)   # raises on an error
            return 0
        calls = {name: (lambda fn=fn: run(fn)) for name, fn in fns.items()}
        res = _in_turns(calls, 10)
        print(f"ssd_scan backward {label} ablations: " + "; ".join(
            f"{n} {ms:.4f} ms" for n, ms in res.items()), flush=True)
        ins = (xdt, dta, b, c, dy)
        exact = ssd_ops.ssd_scan_bwd_plain(*(t.double() for t in ins))
        outs = {"plain f32": ssd_ops.ssd_scan_bwd_plain(*ins)}
        outs.update((n, ssd_ops._bwd_run(fns[n], *ins)) for n in EXACT_BWD)
        for i, g in enumerate(("dxdt", "ddta", "db", "dc")):
            print(f"ssd_scan backward {label} {g} max error against float64 "
                  f"(max |{g}| {float(exact[i].abs().max()):.4g}): "
                  + "; ".join(f"{n} {float((o[i] - exact[i]).abs().max()):.4g}"
                              for n, o in outs.items()), flush=True)
        del xdt, dy, dta, b, c, ins, exact, outs


def forward_times(gen):
    """Device ms of the LM forward kernels at the round's shape (B 8,
    S 2048 + 128 meta tokens; 25/5 heads x 64, window 0 and 1024; SSD
    50 heads x 64, N 16), as ``flash_attention`` and ``ssd_scan`` run
    them under ``torch.no_grad``."""
    import repro_torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    print(f"package: {repro_torch.__file__}")
    B, S = 8, 2176
    q = torch.randn((B, S, 25, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, 5, 64), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    xdt = torch.randn((B, S, 50, 64), generator=gen, device="cuda")
    dta = -3 * torch.rand((B, S, 50), generator=gen, device="cuda")
    b, c = (torch.randn((B, S, 1, 16), generator=gen, device="cuda")
            for _ in range(2))
    calls = {"flash_attention window 0":
             lambda: flash_attention(q, k, v, window=0),
             "flash_attention window 1024":
             lambda: flash_attention(q, k, v, window=1024),
             "ssd_scan": lambda: ssd_scan(xdt, dta, b, c, chunk=256)}
    with torch.no_grad():
        res = _in_turns({n: (lambda f=f: (f(), 0)[1]) for n, f in
                         calls.items()}, 20)
    print("forward kernels, round shape: " + "; ".join(
        f"{n} {ms:.4f} ms" for n, ms in res.items()), flush=True)


def flash_times(gen):
    """Device ms of the tc flash forward (B 8, no lse) and backward (B 2;
    B 8 at the MLA layer) at the LM paths' shapes, in turns, through
    ``_launch`` and ``_bwd_launch`` of the package on the path: the causal
    layers of Hymba, Qwen3, Phi-3 and MusicGen, MusicGen's
    cross-attention, PaliGemma's layer at head_dim 256 causal and with its
    prefix-LM mask, and DeepSeek-V3's MLA layer (each skipped for a
    package whose kernels do not take its head dims)."""
    import repro_torch
    from repro_torch.kernels.flash_attention import ops
    print(f"package: {repro_torch.__file__}")

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    for label, S, Sk, H, KVH, D, Dv, window, prefix, Bb in (
            ("hymba-1.5b global", 2176, None, 25, 5, 64, 64, 0, 0, 2),
            ("hymba-1.5b window 1024", 2176, None, 25, 5, 64, 64, 1024, 0,
             2),
            ("qwen3-1.7b", 2048, None, 16, 8, 128, 128, 0, 0, 2),
            ("phi3-mini-3.8b", 2048, None, 32, 32, 96, 96, 0, 0, 2),
            ("musicgen-medium self", 1500, None, 24, 24, 64, 64, 0, 0, 2),
            ("musicgen-medium cross", 1500, 64, 24, 24, 64, 64, 0, 0, 2),
            ("paligemma-3b causal", 512, None, 8, 1, 256, 256, 0, 0, 2),
            ("paligemma-3b prefix 256", 512, None, 8, 1, 256, 256, 0, 256,
             2),
            ("deepseek-v3 mla", 2048, None, 128, 128, 192, 128, 0, 0, 8)):
        if ops._dims(D, Dv) not in ops.HEAD_DIMS + ops.TC_MLA_HEAD_DIMS:
            print(f"flash_attention tc {label}: head_dim {D} not taken by "
                  f"this package", flush=True)
            continue
        causal, Sk = Sk is None, Sk or S
        kw = {"prefix_len": prefix} if prefix else {}
        q8, k8, v8 = bf16(8, S, H, D), bf16(8, Sk, KVH, D), bf16(8, Sk, KVH,
                                                                 Dv)
        q, o, do = bf16(Bb, S, H, D), bf16(Bb, S, H, Dv), bf16(Bb, S, H, Dv)
        k, v = bf16(Bb, Sk, KVH, D), bf16(Bb, Sk, KVH, Dv)
        lse = 4 + torch.rand((Bb, H, S), generator=gen, device="cuda")
        res = _in_turns({
            "forward B 8": lambda: (ops._launch(
                "tc", q8, k8, v8, window, causal, **kw), 0)[1],
            f"backward B {Bb}": lambda: (ops._bwd_launch(
                "tc", q, k, v, o, lse, do, window, causal, **kw), 0)[1]}, 20)
        print(f"flash_attention tc {label}: " + "; ".join(
            f"{n} {ms:.4f} ms" for n, ms in res.items()), flush=True)
        del q8, k8, v8, q, o, do, k, v, lse
    torch.cuda.empty_cache()


# (B, Sq, Sk, H, KVH, D, DV, window, causal) of --rounding: the card
# tests' two cases whose dQ broke the tc backward's rule (a) against the
# plain version, and cases beside them that kept it
ROUNDING_CASES = (
    (1, 150, 200, 8, 2, 128, 128, 0, False),
    (1, 200, 200, 4, 2, 192, 128, 64, True),
    (2, 200, 200, 4, 2, 192, 128, 64, True),
    (1, 150, 200, 8, 8, 128, 128, 0, False),
    (1, 333, 333, 4, 4, 192, 128, 100, True),
    (2, 517, 517, 6, 3, 128, 128, 0, True),
)


def bwd_rounding():
    """The tc backward's rounding at ROUNDING_CASES, on the card tests'
    inputs (the same generator and seed). Per gradient, the worst
    element-wise excess (|a - r| over 1e-4 max |r| + two bf16 ulps of r):
    of the kernel against the plain version with bf16 operands in f32,
    and of that plain version with lse moved by one ulp (a yardstick that
    misses flips the kernel's own f32 errors make); then of the kernel,
    that plain version and SDPA's backward against the float64
    statement, as they are and less ``flash_attention_bwd_flip_bound`` at
    n = 1, 4, 16 and the head_dim D (the card tests' rule (a))."""
    import math
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention import ops

    def excess(a, r, off=None):
        r = r.double()
        d = (a.double() - r).abs()
        if off is not None:
            d = (d - off).clamp_min(0.0)
        return d / (1e-4 * r.abs().max() + 2.0 * ops._bf16_ulp(r))
    bf = torch.bfloat16
    for B, Sq, Sk, H, KVH, D, DV, window, causal in ROUNDING_CASES:
        g = torch.Generator(device="cuda").manual_seed(3)
        q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(bf)
        k = torch.randn((B, Sk, KVH, D), generator=g, device="cuda").to(bf)
        v = torch.randn((B, Sk, KVH, DV), generator=g, device="cuda").to(bf)
        do = torch.randn((B, Sq, H, DV), generator=g, device="cuda").to(bf)
        kw = dict(window=window, causal=causal)
        allow = ops._allow(torch.arange(Sq, device="cuda"),
                           torch.arange(Sk, device="cuda"), causal, window)
        qr = q.clone().requires_grad_(True)
        out = FlashAttentionFn.apply(qr, k, v, window, causal, 0)
        o, lse = (t.detach() for t in out.grad_fn.saved_tensors[3:])
        ins = (q, k, v, o, lse, do)
        got = flash_attention_bwd(*ins, **kw)
        ref_b = flash_attention_bwd_plain(*ins, **kw, operands="bf16")
        moved = [flash_attention_bwd_plain(
            q, k, v, o, torch.nextafter(lse, torch.full_like(lse, to)), do,
            **kw, operands="bf16") for to in (math.inf, -math.inf)]
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        sd = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allow if window else None,
            is_causal=causal and not window, enable_gqa=True)
        lib = [t.transpose(1, 2) for t in torch.autograd.grad(
            sd, (qt, kt, vt), do.transpose(1, 2))]
        exact = flash_attention_bwd_plain(*(t.double() for t in ins), **kw,
                                          operands="bf16")
        bounds = {n: ops.flash_attention_bwd_flip_bound(*ins, **kw, n=n)
                  for n in (1, 4, 16, D)}
        tag = (f"B {B} Sq {Sq} Sk {Sk} {H}/{KVH} x {D}/{DV} window "
               f"{window} {'causal' if causal else 'cross'}")
        for i, name in enumerate(("dq", "dk", "dv")):
            e_rule = excess(got[i], ref_b[i])
            worst = int(e_rule.argmax())
            line = {"case": tag, "grad": name,
                    "vs_plain_f32": float(e_rule.max()),
                    "lse_moved_vs_plain_f32": max(
                        float(excess(m[i], ref_b[i]).max()) for m in moved)}
            for who, a in (("kernel", got[i]), ("plain_f32", ref_b[i]),
                           ("sdpa", lib[i])):
                line[f"{who}_vs_f64"] = float(excess(a, exact[i]).max())
                for n, bnd in bounds.items():
                    line[f"{who}_vs_f64_less_bound_n{n}"] = float(
                        excess(a, exact[i], bnd[i]).max())
            line["worst_vs_plain_f32"] = {
                "kernel": float(got[i].flatten()[worst]),
                "plain_f32": float(ref_b[i].flatten()[worst]),
                "f64": float(exact[i].flatten()[worst]),
                "tol": float((1e-4 * exact[i].abs().max() + 2.0
                              * ops._bf16_ulp(exact[i])).flatten()[worst]),
                **{f"bound_n{n}": float(b[i].flatten()[worst])
                   for n, b in bounds.items()}}
            print("rounding " + json.dumps(line), flush=True)
        del ins, got, ref_b, moved, lib, exact, bounds


def dots_noise(rounds: int = 6, small: int = 4096):
    """The run-to-run spread behind ``chip_smoke.py``'s LM-4 dots check:
    one Hymba-1.5B node's gradient (bf16, one batch of 2 x 2048 tokens,
    as the check takes it) ``rounds`` times under per-layer recompute
    twice and "dots" once, in that order, as the check runs them. For
    every leaf of at most ``small`` elements, the largest |difference|
    between each pair of runs: the check's own ratio (dots against the
    first recompute run, over the two recompute runs' distance) by round,
    and the median distance between two recompute runs that ran back to
    back, between recompute runs of different rounds, and between a dots
    run and a recompute run of another round."""
    import statistics
    from repro_torch import lmpath
    from repro_torch.models.transformer import DecoderModel
    params = lmpath.node_params(DecoderModel(lmpath.CONFIG), [0], "cuda")
    gen = torch.Generator(device="cuda").manual_seed(lmpath.DATA_SEED)
    batch = lmpath.train_batch(lmpath.CONFIG, 1, lmpath.TRAIN.batch_size,
                               lmpath.SEQ_LEN, gen)
    keys = [k for k in params if params[k].numel() <= small]
    runs = []                       # (round, policy, {leaf: grad})
    for r in range(rounds):
        for run in ("nothing", "repeat", "dots"):
            model = DecoderModel(lmpath.CONFIG.replace(
                remat_policy="dots" if run == "dots" else "nothing"))
            ps = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
            loss, _ = model.loss(ps, batch)
            g = torch.autograd.grad(loss.sum(), [ps[k] for k in keys],
                                    materialize_grads=True)
            runs.append((r, run, {k: x.float() for k, x in zip(keys, g)}))
            del loss, g, ps
    def dist(a, b, k):
        return float((a[k] - b[k]).abs().max())
    print(f"dots_noise: {len(keys)} leaves of at most {small} elements, "
          f"{rounds} rounds", flush=True)
    for k in keys:
        ratio, adjacent, across, dots = [], [], [], []
        for i, (ri, pi, gi) in enumerate(runs):
            for rj, pj, gj in runs[i + 1:]:
                d = dist(gi, gj, k)
                if pi != "dots" and pj != "dots":
                    (adjacent if ri == rj else across).append(d)
                elif (pi == "dots") != (pj == "dots") and ri != rj:
                    dots.append(d)
        for r in range(rounds):
            n, rep, dt = (runs[3 * r + i][2] for i in range(3))
            noise = dist(n, rep, k)
            ratio.append(dist(dt, n, k) / noise if noise else float("inf"))
        med = lambda x: statistics.median(x) if x else 0.0
        if max(across + dots + [0.0]) == 0.0:
            continue
        print("dots_noise " + json.dumps({
            "leaf": k, "numel": params[k].numel(),
            "check_ratio_by_round": [round(x, 3) for x in ratio],
            "median_recompute_back_to_back": med(adjacent),
            "median_recompute_across_rounds": med(across),
            "median_dots_vs_recompute_across_rounds": med(dots)}),
            flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--forward" in sys.argv[1:]:
        forward_times(gen)
        return 0
    if "--backward" in sys.argv[1:]:
        backward_passes(gen)
        return 0
    if "--flash" in sys.argv[1:]:
        flash_times(gen)
        return 0
    if "--rounding" in sys.argv[1:]:
        bwd_rounding()
        return 0
    if "--dots-noise" in sys.argv[1:]:
        dots_noise()
        return 0
    ablate_msp(gen)
    ablate_ssd(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
