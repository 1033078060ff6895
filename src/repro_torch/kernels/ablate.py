"""What a kernel's time goes to, on the card: copies of a CUDA source with
one part cut out, timed against the source as it is.

Each variant is ``csrc/<kernel>.cu`` with one edit, built with the same
flags under ``build/ablate/`` and launched through the same C entry point
on the same inputs, all variants in turns (two rounds; the faster round
is kept). A variant's outputs are wrong by design: it measures, it does
not compute the kernel's function. ``ssd_scan`` also gets its three
passes' device times from the profiler.

    python -m repro_torch.kernels.ablate          # on a machine with an H100

``--forward`` instead times the LM forward kernels as the label round
calls them (no grad, at Hymba-1.5B's round shape): ``flash_attention``
global and windowed in bf16, and ``ssd_scan``. Run by path with another
checkout's package first on ``PYTHONPATH``, it times that checkout's
kernels through the same calls, so two versions can be timed in turns
within one machine:

    PYTHONPATH=<checkout>/src python src/repro_torch/kernels/ablate.py --forward

``--backward`` splits the two backward calls at Hymba-1.5B's training
shape into their kernels' device times (the profiler): the tensor-core
attention backward's three and the SSD backward's four; and times
``ssd_scan_bwd.cu`` with groups of its tile kernel's products cut out,
and with its products accumulated inside the ``mma`` as the forward's
are, that variant's and the committed kernel's max errors against the
plain version in float64 printed beside the plain f32 version's.

It prints the card's name and power limit first. It imports nothing the
kernels' wrappers do not; the variants are never used by the port.
"""
from __future__ import annotations

import ctypes
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
        fn.argtypes = [p] * 7 + [i] * 6 + [p]
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
            y.data_ptr(), st.data_ptr(), ce.data_ptr(), B, S, H, P, G, N,
            stream)) for name, fn in fns.items()}
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


def backward_passes(gen):
    """Device ms of each kernel of the two backward calls at Hymba-1.5B's
    training shape (B 2, S 2048 + 128 meta tokens): ``flash_attention``'s
    tensor-core backward (bf16, window 0 and 1024) and ``ssd_scan``'s
    four passes (N 16; and Mamba-2-780M's N 128, S 2048)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops, ssd_scan_bwd
    B, S = 2, 2176
    q, do, o = (torch.randn((B, S, 25, 64), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    k, v = (torch.randn((B, S, 5, 64), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    lse = 4 + torch.rand((B, 25, S), generator=gen, device="cuda")
    for window in (0, 1024):
        res = _device_ms_by_kernel(lambda: flash_ops._bwd_launch(
            "tc", q, k, v, o, lse, do, window), 10)
        print(f"flash_attention backward tc, window {window} (ms per call): "
              + ", ".join(f"{n} {ms:.4f}" for n, ms in res.items()),
              flush=True)
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
    ablate_msp(gen)
    ablate_ssd(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
