"""Batched serving driver: continuous-batching decode over the consensus
model (the paper's deployment artifact is the node-averaged model),
``src/repro/launch/serve.py``'s twin.

The server runs its requests in waves of ``batch_slots``: each wave
starts from an empty decode state, feeds its prompts through decode
steps in lockstep, then decodes greedily (argmax, the first index on a
tie) for the wave's longest ``max_new``. Two faults of the reference are
kept, as it has them (ROADMAP.md §3): a short prompt is padded with
token 0 through the model while the wave's longer prompts are fed, so a
request's output depends on the other prompts of its wave; and a
full-attention cache of capacity ``context`` wraps past its end. The
reference's ``_feed_prompt`` (a prompt fed on one slot), which nothing
calls, its ``active`` slots, which nothing fills, and ``submit_all``'s
``greedy``, which nothing reads, are left out.

Usage (the card by default; ``--device cpu`` on the CPU; ``--full`` for
the full-width config, else ``reduced()``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 8 --gen-len 16
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import build_model
from repro_torch.obs import log as obs_log
from repro_torch.runtime import resolve_device


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Static-batch server with slot reuse (continuous batching lite):
    each wave of up to ``batch_slots`` requests starts from a fresh decode
    state of capacity ``context``. The params are one model's, drawn
    from ``seed`` on ``device`` (``DecoderModel.init``); replace
    ``params`` to serve others."""

    def __init__(self, cfg: ModelConfig, batch_slots: int = 4,
                 context: int = 128, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.params = self.model.init(seed, self.device)
        self.slots = batch_slots
        self.context = context
        self.state = self.model.init_decode_state(batch_slots, context,
                                                  self.device)
        self._decode = make_decode_step(self.model)

    def _step(self, tokens: np.ndarray):
        logits, self.state = self._decode(
            self.params, torch.from_numpy(tokens).to(self.device),
            self.state)
        return logits

    def submit_all(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve every request, a wave of ``batch_slots`` at a time; returns
        {rid: generated tokens}."""
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        while queue:
            wave = [queue.pop(0) if queue else None
                    for _ in range(self.slots)]
            self.state = self.model.init_decode_state(self.slots,
                                                      self.context,
                                                      self.device)
            # batched prefill: the prompts in lockstep, padded with zeros
            max_p = max((len(r.prompt) for r in wave if r), default=0)
            logits = None
            for i in range(max_p):
                t = np.zeros((self.slots, 1), np.int32)
                for s, r in enumerate(wave):
                    if r is not None and i < len(r.prompt):
                        t[s, 0] = r.prompt[i]
                logits = self._step(t)
            max_new = max((r.max_new for r in wave if r), default=0)
            cur = (torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
                   if logits is not None
                   else np.zeros(self.slots, np.int64))
            for step in range(max_new):
                t = cur.reshape(self.slots, 1).astype(np.int32)
                for s, r in enumerate(wave):
                    if r is not None and step < r.max_new:
                        r.generated.append(int(cur[s]))
                logits = self._step(t)
                cur = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for r in wave:
                if r is not None:
                    r.done = True
                    results[r.rid] = r.generated
        return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Batched greedy decoding over a decoder (the "
                    "reference's serving CLI).")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: reduced())")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if cfg.num_codebooks > 1 or cfg.arch_type in ("vlm",):
        raise SystemExit("serve driver demo targets token-only archs")
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len
                                    ).astype(np.int32), args.gen_len)
            for i in range(args.requests)]
    t0 = time.time()
    server = BatchedServer(cfg, batch_slots=args.slots, device=args.device)
    out = server.submit_all(reqs)
    dt = time.time() - t0
    total_toks = sum(len(v) for v in out.values())
    obs_log.info("serve.done", requests=len(out), tokens=total_toks,
                 elapsed_s=round(dt, 1),
                 tok_per_s=round(total_toks / dt, 1))
    for rid in sorted(out)[:3]:
        obs_log.info("serve.req", rid=rid, head=list(out[rid][:10]))
    return out


if __name__ == "__main__":
    main()
