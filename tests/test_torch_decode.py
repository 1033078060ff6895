"""Decode against the reference on the CPU: ``DecoderModel.decode_step``
and its caches for every family the reference decodes, at tiny widths.

One tiny f32 config a family (1–3 layers, d_model 64, vocabulary 128):
Qwen3 (GQA 4/2, qk-norm), Mistral with window 6 over 14 tokens (a ring of
capacity 6 that wraps), Hymba (per-layer windows beside the SSM, meta
tokens on: decode reads none, so it is held to the reference's decode
only), Mamba-2, DeepSeek-V3 (MLA's absorbed decode, MoE at capacity
factor 8) and MusicGen (K codebooks, cross-attention over a memory).
The reference's ``decode_step`` is jitted once a config and replayed
token by token beside the port's on the same weights (the port's
``init``, perturbed from numpy seeds, carried over with
``convert.to_jax_lm_params``): the logits and every carried state
(through ``convert.to_jax_decode_state``) within 1e-5 of max(1, max
|x|) at every step (f32, sums reordered). Halfway, the port's state is
replaced by the reference's own, carried over with
``convert.from_jax_decode_state``, and the run goes on from there.
DeepSeek-V3's reference run uses a cache two tokens short, so its last
two writes fall past the end and are dropped on both sides. Then the
port's decode against the port's forward on the same tokens, at the
reference test's own tolerances (2e-2 dense; 5e-2 MLA, SSM, MusicGen).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as j_build
import repro_torch.configs as tconfigs
from repro_torch.launch.steps import make_decode_step
from repro_torch.models.convert import (from_jax_decode_state,
                                        to_jax_decode_state,
                                        to_jax_lm_params)
from repro_torch.models.transformer import DecoderModel

torch.set_num_threads(1)

RTOL = 1e-5                       # of max(1, max |x|): f32, sums reordered
B = 2


def _tiny(arch, get):
    cfg = get(arch).reduced().replace(d_model=64, vocab_size=128,
                                      dtype="float32", attn_chunk=4)
    if arch == "mistral-nemo-12b":
        cfg = cfg.replace(num_layers=1, sliding_window=6, head_dim=16)
    elif arch == "hymba-1.5b":
        cfg = cfg.replace(num_layers=3, num_kv_heads=2, head_dim=16,
                          sliding_window=4)
    elif arch == "deepseek-v3-671b":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    elif arch == "mamba2-780m":
        cfg = cfg.replace(num_layers=1)
    else:
        cfg = cfg.replace(num_layers=1, head_dim=16, num_kv_heads=2)
    return cfg


# (arch, tokens S, reference cache context, decode-vs-forward tolerance)
CASES = [("qwen3-1.7b", 8, 8, 2e-2),
         ("mistral-nemo-12b", 14, 14, 2e-2),
         ("hymba-1.5b", 10, 10, None),
         ("mamba2-780m", 8, 8, 5e-2),
         ("deepseek-v3-671b", 8, 6, 5e-2),
         ("musicgen-medium", 6, 6, 5e-2)]


def _perturbed(model, seed):
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor(0.05 * rng.normal(size=v.shape),
                                   dtype=v.dtype)
            for k, v in model.init(seed, "cpu").items()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: {err:.3g} > {RTOL} x {scale:.3g}"


def _close_states(port, ref, what):
    for si, (ps, rs) in enumerate(zip(to_jax_decode_state(port), ref)):
        assert set(ps) == set(rs)
        for name in ps:
            assert ps[name]._fields == rs[name]._fields
            for f, a, b in zip(ps[name]._fields, ps[name], rs[name]):
                _close(a, b, f"{what} segment {si} {name}.{f}")


@pytest.mark.parametrize("arch,S,ctx,fwd_tol", CASES)
def test_decode_matches_reference_and_forward(arch, S, ctx, fwd_tol):
    cfg, jcfg = _tiny(arch, tconfigs.get_config), _tiny(arch,
                                                        jconfigs.get_config)
    model, jmodel = DecoderModel(cfg), j_build(jcfg)
    params = _perturbed(model, 3)
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(params))
    rng = np.random.default_rng(4)
    K = cfg.num_codebooks
    shape = (B, S, K) if K > 1 else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    memory = None
    if cfg.cross_attention:
        memory = rng.normal(size=(B, cfg.cross_attn_len, cfg.d_model)
                            ).astype(np.float32)
    jdecode = jax.jit(lambda p, t, s, m: jmodel.decode_step(p, t, s,
                                                            memory=m))
    jmem = None if memory is None else jnp.asarray(memory)
    jst = jmodel.init_decode_state(B, ctx)
    st = model.init_decode_state(B, ctx, device="cpu")
    if arch == "mistral-nemo-12b":        # a ring of the window's length
        assert st[0]["kv"].k.shape[2] == 6
    step = make_decode_step(model)
    for i in range(S):
        if i == S // 2:                   # go on from the reference's state
            st = from_jax_decode_state(jax.device_get(jst), device="cpu")
        jlog, jst = jdecode(jparams, jnp.asarray(tokens[:, i:i + 1]), jst,
                            jmem)
        extras = () if memory is None else (torch.from_numpy(memory),)
        log, st = step(params, torch.from_numpy(tokens[:, i:i + 1]), st,
                       *extras)
        _close(log.numpy(), jlog, f"{arch} step {i} logits")
        _close_states(st, jax.device_get(jst), f"{arch} step {i}")
    if fwd_tol is None:
        return
    # the port's decode against its own forward on the same tokens
    st = model.init_decode_state(B, S, device="cpu")
    dec = torch.cat([step(params, torch.from_numpy(tokens[:, i:i + 1]), st,
                          *extras)[0] for i in range(S)], dim=1)
    batch = {"tokens": torch.from_numpy(tokens)[None]}
    if memory is not None:
        batch["conditioning"] = torch.from_numpy(memory)[None]
    with torch.no_grad():
        full, _ = model.forward({k: v[None] for k, v in params.items()},
                                batch)
    err = float((dec - full[0]).abs().max())
    assert err < fwd_tol, f"{arch}: decode/forward mismatch {err}"
