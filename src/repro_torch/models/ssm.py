"""Mamba-2 (SSD — state-space duality) mixer [arXiv:2405.21060]
(``src/repro/models/ssm.py``): the prefill path and the decode step.

Per head h with state size N and head dim P:

    h_t = exp(a_t) * h_{t-1} + b_t ⊗ (x_t * dt_t)
    y_t = c_t · h_t + D * x_t

with input-dependent dt (softplus), B/C shared across head groups, and a
short causal depthwise conv on (x, B, C). :func:`ssd_chunked` computes
the chunked dual form through the ``ssd_scan`` kernel on the card (its
plain version on the CPU), from an initial state and to the final one.
:func:`ssm_decode` is the reference's one-token recurrent step, plain
``jnp`` there and plain torch here: a rolling conv buffer, the state
update and its readout; it updates the :class:`SSMState` in place and
returns it, as the reference returns the new one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import dense_init, normal_init


class SSMState(NamedTuple):
    """Decode-time recurrent state (O(1) in context length). In a decode
    state each field carries a leading layer axis."""
    conv: torch.Tensor       # (B, conv_width - 1, conv_dim) model dtype
    ssm: torch.Tensor        # (B, nheads, head_dim, state) f32
    length: torch.Tensor     # (B,)


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


def ssd_chunked(x, dt, a_log, b, c, chunk: int, initial_state=None,
                return_final_state: bool = True):
    """Chunked SSD scan. x (B, S, H, P), dt (B, S, H) post-softplus,
    a_log (H,), b/c (B, S, G, N), ``initial_state`` (B, H, P, N) (None:
    zeros) -> (y (B, S, H, P) f32, final_state (B, H, P, N) f32), as the
    reference's; with ``return_final_state`` False, (y, None), and the
    kernels skip the final state's work (:func:`ssm_forward`, which
    discards it, as the reference's does). Its prologue (``A =
    −exp(a_log)``, ``dta = dt·A``, ``xdt = x·dt``) runs here in plain
    torch; the scan is ``ssd_scan``:
    on the card its three kernels (tile states and tile outputs in
    parallel over tiles and heads, the state passing sequential over
    tiles), on the CPU its plain version at ``chunk``. With gradients
    wanted, the card's call goes through ``SSDScanFn`` (a kernel
    backward; the final state carries no gradient, and an initial state
    raises), and autograd carries the prologue."""
    a = -torch.exp(a_log)
    dta = dt * a
    xdt = x * dt[..., None]
    if initial_state is not None:
        initial_state = initial_state.float().contiguous()
    out = ssd_scan(xdt.contiguous(), dta.contiguous(), b.contiguous(),
                   c.contiguous(), chunk=chunk, initial_state=initial_state,
                   return_final_state=return_final_state)
    return out if return_final_state else (out, None)


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
    y, _ = ssd_chunked(xh.float(), dt, params["a_log"], bh.float(),
                       ch.float(), chunk=min(s.chunk_size, S),
                       return_final_state=False)
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    return y @ params["w_out"]


def make_ssm_state(cfg: ModelConfig, batch: int, dtype,
                   device="cuda") -> SSMState:
    """Zeros: the conv history in ``dtype``, the SSM state in f32."""
    s = cfg.ssm
    _, nheads, conv_dim = ssm_dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nheads, s.head_dim, s.state_size),
                        device=device),
        length=torch.zeros((batch,), dtype=torch.long, device=device))


def _fused_weights(params, cfg: ModelConfig):
    """The fused in-proj / conv layout, reassembled from split params
    (decode runs the fused code path; the same arithmetic)."""
    if "w_in" in params:
        return params["w_in"], params["conv_w"], params["conv_b"]
    w_in = torch.cat([params["w_z"], params["w_x"], params["w_b"],
                      params["w_c"], params["w_dt"]], dim=-1)
    conv_w = torch.cat([params["conv_wx"], params["conv_wb"],
                        params["conv_wc"]], dim=-1)
    conv_b = torch.cat([params["conv_bx"], params["conv_bb"],
                        params["conv_bc"]], dim=-1)
    return w_in, conv_w, conv_b


def ssm_decode(params, x, cfg: ModelConfig, state: SSMState):
    """One token x (B, 1, d_model) -> (out (B, 1, d_model), state): the
    conv over the history and this token in f32, ``decay = exp(dt·A)``,
    h <- decay·h + (dt·x) ⊗ b, y = c·h + D·x, the gated norm; the conv
    history, the state and ``length`` updated in place."""
    s = cfg.ssm
    B = x.shape[0]
    d_inner, nheads, _ = ssm_dims(cfg)
    w_in, conv_w, conv_b = _fused_weights(params, cfg)
    z, xbc, dt_raw = _split_in(x[:, 0] @ w_in, cfg)      # (B, .)
    hist = torch.cat([state.conv, xbc[:, None, :]], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", hist.float(), conv_w.float())
    xbc = F.silu(conv_out + conv_b.float())
    state.conv.copy_(hist[:, 1:])
    gn = s.ngroups * s.state_size
    xin, b, c = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    v = dt_raw.float() + params["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))           # softplus
    decay = torch.exp(dt * -torch.exp(params["a_log"]))    # (B, H)
    xh = xin.reshape(B, nheads, s.head_dim)
    rep = nheads // s.ngroups
    bh = b.reshape(B, s.ngroups, s.state_size).repeat_interleave(rep, dim=1)
    ch = c.reshape(B, s.ngroups, s.state_size).repeat_interleave(rep, dim=1)
    upd = (dt[..., None] * xh)[..., :, None] * bh[..., None, :]
    state.ssm.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", state.ssm, ch)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = _gated_norm(y, z[:, None, :], params["norm_scale"], cfg.norm_eps)
    state.length.add_(1)
    return y @ params["w_out"], state
