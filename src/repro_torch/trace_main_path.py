"""Where the main paths' device time goes. ``--path resnet`` (default):
the full-width configuration of :mod:`repro_torch.mainpath`, run once
untraced (warm-up: cuDNN's algorithm choice, the kernels' build), then
two windows under ``torch.profiler``: 10 plain train steps, and one
streaming homogenization round. ``--path lm``: the full-width Hymba-1.5B
round of :mod:`repro_torch.lmpath`, one streaming public microbatch (the
4 nodes' forward over 8 sequences and the ``head_select`` pass, 1/9 of
the round's work) after one untraced warm-up microbatch.

    PYTHONPATH=src python -m repro_torch.trace_main_path [--path lm] [--top 12]

For each window it prints the wall time, the time the device spent in
kernels (the union of kernel intervals), the device's idle share
(1 − kernel time / wall time), kernel time by family, and the kernels
with the most device time. Needs a GPU.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import driver
from repro_torch.mainpath import full_width_sim

FAMILIES = (("cuDNN layout transposes", ("genericTranspose", "nchwToNhwc",
                                         "nhwcToNchw")),
            ("convolutions", ("conv", "xmma", "wgrad", "dgrad", "sgemm",
                              "scaleTensor", "cudnn")),
            ("idkd kernels", ("idkd::",)),
            ("GEMMs", ("gemm", "gemv")),
            ("elementwise + reductions", ("at::native",)))


LM_FAMILIES = (("flash_attention", ("flash_attention_kernel",
                                     "flash_attention_tc_kernel")),
               ("ssd_scan", ("ssd_chunk_states", "ssd_state_passing",
                             "ssd_chunk_scan")),
               ("head_select", ("head_select_kernel", "head_select_tc_kernel",
                                "head_select_merge_kernel")),
               ("GEMMs", ("gemm", "xmma", "nvjet", "cutlass")),
               ("elementwise + reductions", ("at::native",)))


LM_TRAIN_FAMILIES = (
    ("flash_attention forward", ("flash_attention_kernel",
                                 "flash_attention_tc_kernel")),
    ("flash_attention backward", ("fab_delta", "fab_dkdv", "fab_dq")),
    ("ssd_scan forward", ("ssd_chunk_states", "ssd_state_passing",
                          "ssd_chunk_scan")),
    ("ssd_scan backward", ("ssd_bwd_scan", "ssd_bwd_group_sum")),
    ("head_select", ("head_select_kernel", "head_select_tc_kernel",
                     "head_select_merge_kernel")),
    ("GEMMs", ("gemm", "xmma", "nvjet", "cutlass")),
    ("elementwise + reductions", ("at::native",)))


def _family(name: str, families) -> str:
    for fam, keys in families:
        if any(k in name for k in keys):
            return fam
    return "other"


def _window(label: str, fn, top: int, per: int = 1, families=FAMILIES):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, None
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    print(f"{label}: {wall_us / 1e3 / per:.2f} ms wall per call, "
          f"{busy / 1e3 / per:.2f} ms in kernels, device idle share "
          f"{1 - busy / wall_us:.3f}, {len(kernels) / per:.0f} kernels "
          f"per call")
    fams, names = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for k in kernels:
        d = k.time_range.end - k.time_range.start
        fams[_family(k.name, families)] += d
        names[k.name][0] += d
        names[k.name][1] += 1
    total = sum(fams.values())
    for fam, d in sorted(fams.items(), key=lambda x: -x[1]):
        print(f"  {fam:28s} {d / 1e3 / per:8.2f} ms  {d / total:6.1%}")
    for name, (d, n) in sorted(names.items(), key=lambda x: -x[1][0])[:top]:
        print(f"    {d / 1e3 / per:8.3f} ms {n / per:7.1f}x  {name[:80]}")
    return wall_us, busy, fams


def trace_lm(top: int):
    from repro_torch import lmpath
    from repro_torch.core.labeling import _head_pass
    lm = lmpath.setup(device="cuda")
    n = lm.private.shape[0]
    x = torch.as_tensor(lm.public[:lm.icfg.stream_microbatch],
                        device="cuda")[None].expand(
        (n, lm.icfg.stream_microbatch, lm.public.shape[1]))

    def microbatch():
        with torch.no_grad():
            _head_pass(lm.model, lm.params, x, lm.icfg, lm.icfg.label_topk)

    microbatch()                               # warm-up
    _window(f"LM round, one public microbatch ({n} nodes x "
            f"{lm.icfg.stream_microbatch} sequences of "
            f"{lm.public.shape[1]} tokens)", microbatch, top,
            families=LM_FAMILIES)


def trace_lmtrain(top: int):
    import numpy as np
    from repro_torch import lmpath
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.mixing import make_mixer
    from repro_torch.core.topology import Topology
    from repro_torch.data.dirichlet import dirichlet_partition
    from repro_torch.data.synthetic import make_lm_data
    from repro_torch.launch.steps import stack_params
    from repro_torch.models.transformer import DecoderModel
    cfg, tcfg = lmpath.CONFIG, lmpath.TRAIN
    icfg, n, S = tcfg.idkd, tcfg.num_nodes, lmpath.SEQ_LEN
    model = DecoderModel(cfg)
    params = stack_params(model.init(tcfg.seed, "cuda"), n)
    algo = make_algorithm(tcfg.algorithm, momentum=tcfg.momentum,
                          weight_decay=tcfg.weight_decay)
    mixer = make_mixer(Topology.make(tcfg.topology, n), device="cuda")
    opt = algo.init(params)
    tokens, topics = make_lm_data(cfg.vocab_size, S + 1, lmpath.N_PRIVATE,
                                  seed=tcfg.seed)
    parts = dirichlet_partition(topics, n, tcfg.alpha,
                                np.random.default_rng(tcfg.seed))
    public, _ = make_lm_data(cfg.vocab_size, S, lmpath.N_PUBLIC,
                             num_topics=10, seed=tcfg.seed + 99)
    # a KD payload of the round's shape: (deg + 1) x top-k labels per
    # token (the step's cost does not depend on the values)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k_out = 3 * icfg.label_topk
    vals = torch.rand((n, len(public), S, k_out), generator=gen,
                      device="cuda")
    vals /= vals.sum(-1, keepdim=True)
    idx = torch.randint(0, cfg.vocab_size, vals.shape, generator=gen,
                        device="cuda", dtype=torch.int32)
    sample = driver.make_lm_kd_sampler(
        driver.pad_partitions(parts, "cuda"), tokens, tcfg.batch_size,
        public, vals, idx, torch.ones((n, len(public)), device="cuda"),
        pub_batch=min(4, len(public)))
    step = driver.make_step(model, algo, mixer,
                            driver.lm_sparse_kd_adapter(icfg))
    batch = sample(gen, 0)
    params, opt, _ = step(params, opt, batch, tcfg.lr)       # warm-up
    state = {}

    def grads():
        state["g"], _ = step.grads(params, batch)

    def update():
        algo.step(params, state.pop("g"), opt, tcfg.lr, mixer)

    what = (f"{n} Hymba-1.5B nodes x ({tcfg.batch_size} private + "
            f"{min(4, len(public))} public sequences of {S} tokens)")
    w1, b1, f1 = _window(f"KD step gradients, {what}", grads, top,
                         families=LM_TRAIN_FAMILIES)
    w2, b2, _ = _window("KD step update (QG-DSGDm-N, in place, and the "
                        "gossip mix)", update, top,
                        families=LM_TRAIN_FAMILIES)
    fams = dict(f1)
    fams["optimizer + gossip"] = b2
    total = sum(fams.values())
    print(f"KD step as a whole: {(w1 + w2) / 1e3:.2f} ms wall, "
          f"{(b1 + b2) / 1e3:.2f} ms in kernels, device idle share "
          f"{1 - (b1 + b2) / (w1 + w2):.3f}")
    for fam, d in sorted(fams.items(), key=lambda x: -x[1]):
        print(f"  {fam:28s} {d / 1e3:8.2f} ms  {d / total:6.1%}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("resnet", "lm", "lmtrain"),
                    default="resnet")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.path == "lm":
        trace_lm(args.top)
        return
    if args.path == "lmtrain":
        trace_lmtrain(args.top)
        return
    sim = full_width_sim("cuda")
    params = sim.run().params                  # warm-up
    cfg = sim.tcfg
    sample = driver.make_classification_sampler(
        driver.pad_partitions(sim.parts, sim.device), sim.train_x,
        sim.train_y, sim.mcfg.num_classes, cfg.batch_size)
    gen = torch.Generator(device=sim.device).manual_seed(0)
    state = {"p": params, "o": sim.algo.init(params)}

    def steps(n):
        for t in range(n):
            state["p"], state["o"], _ = sim.steps["plain"](
                state["p"], state["o"], sample(gen, t), sim.lr_fn(t))

    steps(3)
    _window("plain train step (16 nodes x batch 32)", lambda: steps(10),
            args.top, per=10)
    sim.homogenize(state["p"], cfg.idkd)
    _window("homogenization round (streaming, head_select)",
            lambda: sim.homogenize(state["p"], cfg.idkd), args.top)


if __name__ == "__main__":
    main()
