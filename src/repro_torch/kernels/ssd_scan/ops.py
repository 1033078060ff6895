"""ssd_scan: the Mamba-2 SSD chunked scan (state-space duality), y only.

Replaces the Pallas TPU kernel ``ssd_scan_pallas`` (body ``_ssd_kernel``)
of ``src/repro/kernels/ssd_scan/kernel.py``, and computes the y of the
model's ``ssd_chunked`` from its prologue's outputs: ``xdt`` (B, S, H, P)
= x · dt, ``dta`` (B, S, H) = dt · −exp(a_log), and ``b``/``c``
(B, S, G, N) shared by the H // G heads of a group. f32 throughout; the
sequence is cut in ``chunk``-long pieces, the last one ragged.

The CUDA kernel (``csrc/ssd_scan.cu``, whose header note gives the
design and what bounds it on the H100) walks the chunks of one (b, h)
in one block with the (P, N) state in shared memory. :func:`ssd_scan`
runs it on CUDA tensors and :func:`ssd_scan_plain` — the reference's
chunked dual form in plain PyTorch — on CPU tensors only; a CUDA call
that the kernel cannot take raises. Neither takes an initial state or
returns the final one (decode is not ported).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 8192       # P · N entries a block's threads hold


def ssd_scan_plain(xdt, dta, b, c, *, chunk: int):
    """The plain PyTorch version: ``ssd_chunked``'s intra-chunk quadratic
    term, chunk states and inter-chunk recurrence, in the inputs' dtype
    (float64 inputs give the exact-arithmetic yardstick the card's
    checks measure both f32 versions against)."""
    B, S, H, P = xdt.shape
    G = b.shape[2]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dta = F.pad(dta, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))

    def chunks(t):
        return t.reshape((B, nc, chunk) + t.shape[2:])

    xc, dtac, bc, cc = map(chunks, (xdt, dta, b, c))
    cum = torch.cumsum(dtac, dim=2)                          # (B,nc,ck,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,t,u,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xdt.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(tri, seg, torch.tensor(
        -1e30, dtype=seg.dtype, device=xdt.device)))
    if G != H:
        bc = bc.repeat_interleave(H // G, dim=3)             # (B,nc,ck,H,N)
        cc = cc.repeat_interleave(H // G, dim=3)
    cb = torch.einsum("bntHN,bnuHN->bntuH", cc, bc)
    y_intra = torch.einsum("bntuH,bnuHp->bntHp", cb * decay, xc)
    end_decay = torch.exp(cum[:, :, -1:, :] - cum)           # (B,nc,ck,H)
    chunk_state = torch.einsum("bnuH,bnuHN,bnuHp->bnHpN", end_decay, bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,nc,H)
    state = torch.zeros((B, H, P, b.shape[-1]), dtype=xdt.dtype,
                        device=xdt.device)
    prev = []
    for n in range(nc):                          # state before each chunk
        prev.append(state)
        state = state * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
    prev = torch.stack(prev, dim=1)                          # (B,nc,H,P,N)
    y_inter = torch.einsum("bntH,bntHN,bnHpN->bntHp", torch.exp(cum), cc,
                           prev)
    return (y_intra + y_inter).reshape(B, nc * chunk, H, P)[:, :S]


def _fn():
    fn = build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def ssd_scan(xdt, dta, b, c, *, chunk: int, initial_state=None):
    """y (B, S, H, P) f32 of the chunked SSD scan; see the module note."""
    if initial_state is not None:
        raise NotImplementedError(
            "ssd_scan: an initial state (decode, chunked prefill) is not "
            "ported (ROADMAP.md item 10b)")
    if xdt.device.type == "cpu":
        return ssd_scan_plain(xdt, dta, b, c, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xdt.device}")
    B, S, H, P = xdt.shape
    G, N = b.shape[2], b.shape[3]
    if dta.shape != (B, S, H) or b.shape != (B, S, G, N) \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan: xdt {tuple(xdt.shape)}, dta "
                         f"{tuple(dta.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not match")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: {H} heads over {G} groups")
    if P not in HEAD_DIMS or N % 4 or not 4 <= N or P * N > MAX_STATE:
        raise ValueError(f"ssd_scan kernel takes head_dim in {HEAD_DIMS} "
                         f"and a state size that is a multiple of 4 with "
                         f"P·N <= {MAX_STATE}, got P={P}, N={N}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes 1 <= chunk <= {MAX_CHUNK}, "
                         f"got {chunk}")
    for name, t in (("xdt", xdt), ("dta", dta), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan kernel takes float32, {name} is "
                            f"{t.dtype}")
        if t.device != xdt.device or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous on "
                             f"{xdt.device}")
    y = torch.empty_like(xdt)
    with torch.cuda.device(xdt.device):
        rc = _fn()(xdt.data_ptr(), dta.data_ptr(), b.data_ptr(),
                   c.data_ptr(), y.data_ptr(), B, S, H, P, G, N, int(chunk),
                   torch.cuda.current_stream(xdt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
