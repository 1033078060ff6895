"""Mamba-2 (SSD — state-space duality) mixer [arXiv:2405.21060], the
prefill path of ``src/repro/models/ssm.py``.

Per head h with state size N and head dim P:

    h_t = exp(a_t) * h_{t-1} + b_t ⊗ (x_t * dt_t)
    y_t = c_t · h_t + D * x_t

with input-dependent dt (softplus), B/C shared across head groups, and a
short causal depthwise conv on (x, B, C). :func:`ssd_chunked` computes
the chunked dual form through the ``ssd_scan`` kernel on the card (its
plain version on the CPU); decode and an initial state are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import dense_init, normal_init


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.state_size
    return d_inner, nheads, conv_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype):
    """The reference's fused layout (``w_in`` emits [z, x, B, C, dt]) or,
    with ``split_proj``, one projection per stream. ``a_log``,
    ``dt_bias`` and ``d_skip`` are f32 whatever ``dtype`` is."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    gn = s.ngroups * s.state_size
    dev = gen.device
    p = {
        "a_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": torch.zeros((nheads,), device=dev),
        "d_skip": torch.ones((nheads,), device=dev),
        "w_out": dense_init(gen, d_inner, d, dtype),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
    }
    W = s.conv_width
    if s.split_proj:
        p.update({
            "w_z": dense_init(gen, d, d_inner, dtype),
            "w_x": dense_init(gen, d, d_inner, dtype),
            "w_b": dense_init(gen, d, gn, dtype),
            "w_c": dense_init(gen, d, gn, dtype),
            "w_dt": dense_init(gen, d, nheads, dtype),
            "conv_wx": normal_init(gen, (W, d_inner), 0.1, dtype),
            "conv_wb": normal_init(gen, (W, gn), 0.1, dtype),
            "conv_wc": normal_init(gen, (W, gn), 0.1, dtype),
            "conv_bx": torch.zeros((d_inner,), dtype=dtype, device=dev),
            "conv_bb": torch.zeros((gn,), dtype=dtype, device=dev),
            "conv_bc": torch.zeros((gn,), dtype=dtype, device=dev),
        })
    else:
        p.update({
            "w_in": dense_init(gen, d, 2 * d_inner + 2 * gn + nheads, dtype),
            "conv_w": normal_init(gen, (W, conv_dim), 0.1, dtype),
            "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        })
    return p


def _split_in(proj, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, _, _ = ssm_dims(cfg)
    gn = s.ngroups * s.state_size
    z, xbc, dt = torch.split(
        proj, [d_inner, d_inner + 2 * gn, proj.shape[-1] - 2 * d_inner
               - 2 * gn], dim=-1)
    return z, xbc, dt


def _gated_norm(y, z, scale, eps: float = 1e-6):
    """Mamba2's RMSNorm(y * silu(z)) output gate."""
    gf = (y * F.silu(z)).float()
    ms = (gf * gf).mean(dim=-1, keepdim=True)
    return (gf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv along time. xbc: (B, S, C); conv_w: (W, C)."""
    W, S = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * conv_w[i] for i in range(W))
    return F.silu(out + conv_b)


def ssd_chunked(x, dt, a_log, b, c, chunk: int, initial_state=None):
    """Chunked SSD scan. x (B, S, H, P), dt (B, S, H) post-softplus,
    a_log (H,), b/c (B, S, G, N) -> y (B, S, H, P) f32. The reference's
    prologue (``A = −exp(a_log)``, ``dta = dt·A``, ``xdt = x·dt``) runs
    here in plain torch; the scan is ``ssd_scan``: on the card its three
    kernels (tile states and tile outputs in parallel over tiles and
    heads, the state passing sequential over tiles), on the CPU its
    plain version at ``chunk``. With gradients wanted, the card's call
    goes through ``SSDScanFn`` (a kernel backward), and autograd carries
    the prologue. The reference also returns the final state; decode
    needs it and is not ported, so only y is returned."""
    a = -torch.exp(a_log)
    dta = dt * a
    xdt = x * dt[..., None]
    return ssd_scan(xdt.contiguous(), dta.contiguous(), b.contiguous(),
                    c.contiguous(), chunk=chunk, initial_state=initial_state)


def ssm_forward(params, x, cfg: ModelConfig):
    """Full-sequence SSD forward. x: (B, S, d_model) -> (B, S, d_model)."""
    s = cfg.ssm
    B, S, _ = x.shape
    d_inner, nheads, _ = ssm_dims(cfg)
    gn = s.ngroups * s.state_size
    if s.split_proj:
        z = x @ params["w_z"]
        xin = _causal_conv(x @ params["w_x"], params["conv_wx"],
                           params["conv_bx"])
        b = _causal_conv(x @ params["w_b"], params["conv_wb"],
                         params["conv_bb"])
        c = _causal_conv(x @ params["w_c"], params["conv_wc"],
                         params["conv_bc"])
        dt_raw = x @ params["w_dt"]
    else:
        z, xbc, dt_raw = _split_in(x @ params["w_in"], cfg)
        xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        xin, b, c = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    v = dt_raw.float() + params["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))           # softplus
    xh = xin.reshape(B, S, nheads, s.head_dim)
    bh = b.reshape(B, S, s.ngroups, s.state_size)
    ch = c.reshape(B, S, s.ngroups, s.state_size)
    y = ssd_chunked(xh.float(), dt, params["a_log"], bh.float(), ch.float(),
                    chunk=min(s.chunk_size, S))
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    return y @ params["w_out"]
