"""ssd_scan: the Mamba-2 SSD chunked scan (state-space duality): y, and,
when asked, the final state, from an initial state or from zeros.

Replaces the Pallas TPU kernel ``ssd_scan_pallas`` (body ``_ssd_kernel``)
of ``src/repro/kernels/ssd_scan/kernel.py``, and computes the y of the
model's ``ssd_chunked`` from its prologue's outputs: ``xdt`` (B, S, H, P)
= x · dt, ``dta`` (B, S, H) = dt · −exp(a_log), and ``b``/``c``
(B, S, G, N) shared by the H // G heads of a group. f32 throughout; the
sequence is cut in ``chunk``-long pieces, the last one ragged.

The CUDA kernels (``csrc/ssd_scan.cu``, whose header note gives the
design and what bounds it on the H100) tile the sequence by their own
:data:`TILE` positions, whatever ``chunk`` is (y does not depend on it in
exact arithmetic), and run three passes: the tiles' states, parallel over
(b, tile, head tile); the state passing, sequential over tiles; and each
tile's output, parallel again, with C·Bᵀ formed once per group and the
products on the tensor cores in 3xTF32. :func:`ssd_scan` issues them on
CUDA tensors (one launch counted per call in ``launches``, and in
``launches_by_mode`` under "state" when it takes h0 or returns h_T, else
"y") and :func:`ssd_scan_plain` —
the reference's chunked dual form in plain PyTorch — runs on CPU tensors
only; a CUDA call that the kernels cannot take raises.
:func:`ssd_scan_passes_plain` states the kernels' three passes in plain
PyTorch. Each takes an ``initial_state`` h0 (B, H, P, N) f32, the state
entering position 0 (``None``: zeros), and with ``return_final_state``
returns ``(y, h_T)``, h_T (B, H, P, N) f32 the state after position S −
1, as the reference's ``ssd_scan_ref(..., initial_state)`` and
``ssd_chunked`` do: decode's state after a prompt, and a chunked prefill
that goes on from where the last chunk stopped. On the card h0 enters
the kernels' state passing and tile 0's inter-tile term, and h_T is the
state passing's value after the last tile (pass 1 then covers the ragged
last tile too). The reference's Pallas kernel takes no initial state:
this is a mode of the port's kernel.

The backward pass. With grad enabled and an input that requires grad,
:func:`ssd_scan` on CUDA tensors goes through :class:`SSDScanFn`, whose
backward is :func:`ssd_scan_bwd`: (dxdt, ddta, db, dc) given dy, from
the kernels of ``csrc/ssd_scan_bwd.cu`` (four passes over the forward's
tiles, two of them parallel over tiles; header note there) on CUDA
tensors and from :func:`ssd_scan_bwd_plain` (the recurrence walked one
position at a time) on CPU tensors; :func:`ssd_scan_bwd_passes_plain`
states the kernels' passes in plain PyTorch. The JAX package has no
backward kernel (its training differentiates ``ssd_chunked``); the
forward's own kernels run under ``torch.no_grad`` as before. Nothing
trains through an initial state or a final state: with grad on, an
initial state raises (ROADMAP.md item 10b.1 leaves its backward out), and
the final state is returned without a gradient.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 8192       # P · N entries of a head's state
TILE = 64              # the kernels' own tile of positions
BWD_STATES = (4, 8, 12, 16, 32, 64, 128)   # N the backward kernel takes


def ssd_scan_plain(xdt, dta, b, c, *, chunk: int, initial_state=None,
                   return_final_state: bool = False):
    """The plain PyTorch version: ``ssd_chunked``'s intra-chunk quadratic
    term, chunk states and inter-chunk recurrence from ``initial_state``
    (zeros by default), in the inputs' dtype (float64 inputs give the
    exact-arithmetic yardstick the card's checks measure both f32
    versions against); with ``return_final_state``, ``(y, h_T)``."""
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
                        device=xdt.device) if initial_state is None \
        else initial_state.to(xdt.dtype)
    prev = []
    for n in range(nc):                          # state before each chunk
        prev.append(state)
        state = state * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
    prev = torch.stack(prev, dim=1)                          # (B,nc,H,P,N)
    y_inter = torch.einsum("bntH,bntHN,bnHpN->bntHp", torch.exp(cum), cc,
                           prev)
    y = (y_intra + y_inter).reshape(B, nc * chunk, H, P)[:, :S]
    return (y, state) if return_final_state else y


def _tiles(t, tile: int):
    """(B, S, ...) -> (B, nc, tile, ...), zero-padded to nc·tile."""
    B, S = t.shape[:2]
    nc = -(-S // tile)
    pad = nc * tile - S
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape((B, nc, tile) + t.shape[2:])


def ssd_chunk_states_plain(xdt, dta, b, *, tile: int):
    """Pass 1 of the kernel's decomposition: per tile of ``tile``
    positions, its state S = Σ_u exp(cum_end − cum_u) xdt_u ⊗ b_u
    (B, nc, H, P, N) and its total log-decay cum_end (B, nc, H)."""
    B, S, H, P = xdt.shape
    G = b.shape[2]
    xc = _tiles(xdt, tile)                                   # (B,nc,Q,H,P)
    xc = xc.reshape(xc.shape[:3] + (G, H // G, P))
    cum = torch.cumsum(_tiles(dta, tile), dim=2)             # (B,nc,Q,H)
    cum_end = cum[:, :, -1]
    w = torch.exp(cum_end[:, :, None] - cum)
    w = w.reshape(w.shape[:3] + (G, H // G))
    states = torch.einsum("bnugr,bnugrp,bnugN->bngrpN", w, xc,
                          _tiles(b, tile))
    return states.reshape(B, -1, H, P, b.shape[-1]), cum_end


def ssd_state_passing_plain(states, cum_end, initial_state=None):
    """Pass 2: the state entering each tile, sequential over tiles:
    state_in[0] = h0 (``initial_state``, zeros by default), state_in[c] =
    exp(cum_end[c−1]) state_in[c−1] + S[c−1]."""
    state_in = torch.empty_like(states)
    run = torch.zeros_like(states[:, 0]) if initial_state is None \
        else initial_state.to(states.dtype)
    for n in range(states.shape[1]):
        state_in[:, n] = run
        run = run * torch.exp(cum_end[:, n])[..., None, None] + states[:, n]
    return state_in


def ssd_chunk_scan_plain(xdt, dta, b, c, state_in, *, tile: int):
    """Pass 3: per tile, CB = C·Bᵀ once per group, then per head
    y = (CB ∘ L_h)·xdt_h + (exp(cum_t) ∘ C)·state_inᵀ, with
    L_h[t, u] = exp(cum_t − cum_u) for u ≤ t and 0 above."""
    B, S, H, P = xdt.shape
    G = b.shape[2]
    R = H // G
    xc = _tiles(xdt, tile)
    xc = xc.reshape(xc.shape[:3] + (G, R, P))                # (B,nc,Q,G,R,P)
    cum = torch.cumsum(_tiles(dta, tile), dim=2)
    cum = cum.reshape(cum.shape[:3] + (G, R))                # (B,nc,Q,G,R)
    bc, cc = _tiles(b, tile), _tiles(c, tile)                # (B,nc,Q,G,N)
    cb = torch.einsum("bntgN,bnugN->bngtu", cc, bc)          # once per group
    seg = cum[:, :, :, None] - cum[:, :, None, :]            # (B,nc,t,u,G,R)
    tri = torch.tril(torch.ones((tile, tile), dtype=torch.bool,
                                device=xdt.device))[:, :, None, None]
    decay = torch.exp(torch.where(tri, seg, torch.tensor(
        -1e30, dtype=seg.dtype, device=xdt.device)))
    y = torch.einsum("bngtu,bntugr,bnugrp->bntgrp", cb, decay, xc)
    st = state_in.reshape(state_in.shape[:2] + (G, R) + state_in.shape[3:])
    y = y + torch.einsum("bntgr,bntgN,bngrpN->bntgrp", torch.exp(cum), cc,
                         st)
    return y.reshape(B, -1, H, P)[:, :S]


def ssd_scan_passes_plain(xdt, dta, b, c, *, tile: int = TILE,
                          initial_state=None,
                          return_final_state: bool = False):
    """The CUDA kernel's three passes in plain PyTorch, at its internal
    tile length: equal to :func:`ssd_scan_plain` at any ``chunk`` in exact
    arithmetic, from ``initial_state``; the final state is the state
    passing's value after the last (ragged) tile."""
    states, cum_end = ssd_chunk_states_plain(xdt, dta, b, tile=tile)
    state_in = ssd_state_passing_plain(states, cum_end, initial_state)
    y = ssd_chunk_scan_plain(xdt, dta, b, c, state_in, tile=tile)
    if not return_final_state:
        return y
    final = state_in[:, -1] * torch.exp(cum_end[:, -1])[..., None, None] \
        + states[:, -1]
    return y, final


def ssd_scan_bwd_plain(xdt, dta, b, c, dy):
    """The plain PyTorch version of the backward pass: (dxdt, ddta, db,
    dc) of ``ssd_scan``'s y given dy, in the inputs' dtype, as the
    kernel computes them (``csrc/ssd_scan_bwd.cu``): the forward state
    h_t = a_t h_{t-1} + xdt_t ⊗ b_t and the reverse state
    g_s = a_{s+1} g_{s+1} + dy_s ⊗ c_s (a = exp(dta)) walked one position
    at a time; dxdt_s = g_s b_s, dc_t = Σ_h h_tᵀ dy_t, db_s = Σ_h g_sᵀ
    xdt_s; ddta the reverse cumulative sum (in double) of
    dcum_t = dy_t·(a_t h_{t-1} c_t) − xdt_t·(a_{t+1} g_{t+1} b_t), which
    is dy_t·y_t − xdt_t·dxdt_t without the diagonal term the two share."""
    B, S, H, P = xdt.shape
    G, N = b.shape[2], b.shape[3]
    R = H // G
    bh = b.repeat_interleave(R, dim=2)                       # (B,S,H,N)
    ch = c.repeat_interleave(R, dim=2)
    a = torch.exp(dta)                                       # (B,S,H)
    opts = dict(dtype=xdt.dtype, device=xdt.device)
    dxdt = torch.empty((B, S, H, P), **opts)
    dbh = torch.empty((B, S, H, N), **opts)
    dch = torch.empty((B, S, H, N), **opts)
    dcum = torch.empty((B, S, H), **opts)
    st = torch.zeros((B, H, P, N), **opts)
    for t in range(S):
        hd = a[:, t, :, None, None] * st
        dcum[:, t] = torch.einsum("bhp,bhpn,bhn->bh", dy[:, t], hd, ch[:, t])
        st = hd + xdt[:, t, :, :, None] * bh[:, t, :, None, :]
        dch[:, t] = torch.einsum("bhpn,bhp->bhn", st, dy[:, t])
    st = torch.zeros((B, H, P, N), **opts)
    a_next = torch.zeros((B, H), **opts)
    for s in reversed(range(S)):
        gd = a_next[..., None, None] * st
        dcum[:, s] -= torch.einsum("bhp,bhpn,bhn->bh", xdt[:, s], gd,
                                   bh[:, s])
        st = gd + dy[:, s, :, :, None] * ch[:, s, :, None, :]
        dxdt[:, s] = torch.einsum("bhpn,bhn->bhp", st, bh[:, s])
        dbh[:, s] = torch.einsum("bhpn,bhp->bhn", st, xdt[:, s])
        a_next = a[:, s]
    # the reverse cumulative sum in double, as the kernel runs it
    ddta = torch.flip(torch.cumsum(torch.flip(dcum, [1]).double(), dim=1),
                      [1]).to(dcum.dtype)
    db = dbh.reshape(B, S, G, R, N).sum(dim=3)
    dc = dch.reshape(B, S, G, R, N).sum(dim=3)
    return dxdt, ddta, db, dc


def ssd_scan_bwd_passes_plain(xdt, dta, b, c, dy, *, tile: int = TILE):
    """The backward kernels' passes in plain PyTorch, at their tile
    length: equal to :func:`ssd_scan_bwd_plain` in exact arithmetic.
    Within a tile, with cum its inclusive cumulative sum of dta (in
    double, as the kernels take it), L[t, u] = exp(cum_t − cum_u) for
    u ≤ t and M = (C·Bᵀ)∘L the forward's intra-tile matrix:

    1. per tile, its forward state S = Σ_u exp(cum_end − cum_u) xdt_u ⊗
       b_u and its reverse state R = Σ_t exp(cum_t) dy_t ⊗ c_t;
    2. the state entering each tile from the left, and G_next, the
       reverse state entering it from the right: G_next[i] = R[i+1] +
       exp(cum_end[i+1]) G_next[i+1];
    3. per tile and head, with M' the strictly lower part of M,
       y< = M'·X + exp(cum)∘(C·state_inᵀ) and dx> = M'ᵀ·dY +
       w∘(B·G_nextᵀ) (w = exp(cum_end − cum)), the parts of y and dxdt
       from strictly earlier and strictly later positions; then
       dxdt = dx> + (c_t·b_t) dy_t, Rm = L∘(dY·Xᵀ),
       dc = Σ_h Rm·B + exp(cum)∘(dY·state_in),
       db = Σ_h Rmᵀ·C + w∘(X·G_next),
       dcum_t = dy_t·y<_t − xdt_t·dx>_t (no diagonal term to cancel);
    4. ddta, the reverse cumulative sum of dcum over S, in double.

    No decay is factored as exp(cum_t)·exp(−cum_u)."""
    B, S, H, P = xdt.shape
    G, N = b.shape[2], b.shape[3]
    R = H // G
    wd = xdt.dtype
    xc, dyc = _tiles(xdt, tile), _tiles(dy, tile)            # (B,nc,Q,H,P)
    bh = _tiles(b, tile).repeat_interleave(R, dim=3)         # (B,nc,Q,H,N)
    ch = _tiles(c, tile).repeat_interleave(R, dim=3)
    cum = torch.cumsum(_tiles(dta, tile).double(), dim=2)    # (B,nc,Q,H)
    cum_end = cum[:, :, -1]                                  # (B,nc,H)
    w = torch.exp(cum_end[:, :, None] - cum).to(wd)
    ecum = torch.exp(cum).to(wd)
    # pass 1: the tiles' forward and reverse states
    fwd = torch.einsum("bnuh,bnuhp,bnuhm->bnhpm", w, xc, bh)
    rev = torch.einsum("bnth,bnthp,bnthm->bnhpm", ecum, dyc, ch)
    # pass 2: the states entering each tile from the left and the right
    nc = xc.shape[1]
    decay = torch.exp(cum_end).to(wd)[..., None, None]       # (B,nc,H,1,1)
    state_in = torch.zeros_like(fwd)
    g_next = torch.zeros_like(rev)
    for i in range(1, nc):
        state_in[:, i] = decay[:, i - 1] * state_in[:, i - 1] + fwd[:, i - 1]
    for i in range(nc - 2, -1, -1):
        g_next[:, i] = rev[:, i + 1] + decay[:, i + 1] * g_next[:, i + 1]
    # pass 3: per tile and head
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,t,u,H)
    tri = torch.tril(torch.ones((tile, tile), dtype=torch.bool,
                                device=xdt.device))[:, :, None]
    lmat = torch.exp(torch.where(tri, seg, torch.tensor(
        -torch.inf, dtype=seg.dtype, device=xdt.device))).to(wd)
    strict = torch.tril(torch.ones((tile, tile), dtype=wd,
                                   device=xdt.device), -1)[:, :, None]
    cb = torch.einsum("bnthm,bnuhm->bntuh", ch, bh)
    m_lt = cb * lmat * strict
    y_lt = torch.einsum("bntuh,bnuhp->bnthp", m_lt, xc) + ecum[..., None] \
        * torch.einsum("bnthm,bnhpm->bnthp", ch, state_in)
    dx_gt = torch.einsum("bntuh,bnthp->bnuhp", m_lt, dyc) + w[..., None] \
        * torch.einsum("bnuhm,bnhpm->bnuhp", bh, g_next)
    diag = torch.einsum("bnthm,bnthm->bnth", ch, bh)
    dxdt = dx_gt + diag[..., None] * dyc
    rm = lmat * torch.einsum("bnthp,bnuhp->bntuh", dyc, xc)
    dch = torch.einsum("bntuh,bnuhm->bnthm", rm, bh) + ecum[..., None] \
        * torch.einsum("bnthp,bnhpm->bnthm", dyc, state_in)
    dbh = torch.einsum("bntuh,bnthm->bnuhm", rm, ch) + w[..., None] \
        * torch.einsum("bnuhp,bnhpm->bnuhm", xc, g_next)
    dcum = (dyc * y_lt).sum(-1).double() - (xc * dx_gt).sum(-1).double()
    # pass 4: the reverse cumulative sum over S, in double; group sums
    dcum = dcum.reshape(B, -1, H)[:, :S]
    ddta = torch.flip(torch.cumsum(torch.flip(dcum, [1]), dim=1), [1])

    def seq(t):
        return t.reshape((B, -1) + t.shape[3:])[:, :S]
    db = seq(dbh).reshape(B, S, G, R, N).sum(dim=3)
    dc = seq(dch).reshape(B, S, G, R, N).sum(dim=3)
    return seq(dxdt), ddta.to(wd), db, dc


def _fn():
    fn = build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 7 + [p]
        fn.restype = i
    return fn


def _check(xdt, dta, b, c, chunk: int):
    """Raise on what the CUDA kernels do not take."""
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
        if name != "dta" and t.data_ptr() % 16:
            raise ValueError(f"ssd_scan kernel takes 16-byte aligned "
                             f"{name}")


def _check_state(h0, xdt, b):
    """Raise on an initial state the kernels do not take."""
    want = (xdt.shape[0], xdt.shape[2], xdt.shape[3], b.shape[3])
    if tuple(h0.shape) != want or h0.dtype != torch.float32 \
            or h0.device != xdt.device or not h0.is_contiguous():
        raise ValueError(f"ssd_scan: initial_state must be a contiguous "
                         f"float32 {want} tensor on {xdt.device}, got "
                         f"{h0.dtype} {tuple(h0.shape)} on {h0.device}")


def _launch(xdt, dta, b, c, h0=None, final: bool = False):
    """The forward passes on checked CUDA tensors from ``h0`` (None:
    zeros): y, or with ``final`` (y, h_T); counts the launch."""
    B, S, H, P = xdt.shape
    G, N = b.shape[2], b.shape[3]
    nt = -(-S // TILE) - (0 if final else 1)
    dev = xdt.device
    y = torch.empty_like(xdt)
    states = torch.empty((B, nt, H, P, N), device=dev)
    cum_end = torch.empty((B, nt, H), device=dev)
    with torch.cuda.device(dev):
        rc = _fn()(xdt.data_ptr(), dta.data_ptr(), b.data_ptr(),
                   c.data_ptr(), y.data_ptr(), states.data_ptr(),
                   cum_end.data_ptr(), None if h0 is None else h0.data_ptr(),
                   B, S, H, P, G, N, int(final),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    ssd_scan.launches_by_mode["y" if h0 is None and not final
                              else "state"] += 1
    return (y, states[:, -1].clone()) if final else y


def ssd_scan_bwd(xdt, dta, b, c, dy):
    """(dxdt, ddta, db, dc) of ``ssd_scan``'s y given dy: on CUDA tensors
    the four passes of ``csrc/ssd_scan_bwd.cu`` over :data:`TILE`-long
    tiles (one launch counted per call), on CPU tensors
    :func:`ssd_scan_bwd_plain`."""
    if xdt.device.type == "cpu":
        return ssd_scan_bwd_plain(xdt, dta, b, c, dy)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {xdt.device}")
    _check(xdt, dta, b, c, 1)
    B, S, H, P = xdt.shape
    G, N = b.shape[2], b.shape[3]
    if N not in BWD_STATES:
        raise ValueError(f"ssd_scan backward kernel takes N in "
                         f"{BWD_STATES}, got {N}")
    if dy.shape != xdt.shape or dy.dtype != torch.float32 \
            or dy.device != xdt.device or not dy.is_contiguous() \
            or dy.data_ptr() % 16:
        raise ValueError(f"ssd_scan_bwd: dy must be a contiguous, 16-byte "
                         f"aligned float32 {tuple(xdt.shape)} tensor on "
                         f"{xdt.device}")
    out = _bwd_run(build.load("ssd_scan_bwd").ssd_scan_bwd_launch, xdt, dta,
                   b, c, dy)
    ssd_scan_bwd.launches += 1
    return out


def _bwd_run(fn, xdt, dta, b, c, dy):
    """(dxdt, ddta, db, dc) from ``fn``, a build of
    ``csrc/ssd_scan_bwd.cu``'s C entry point, on checked CUDA tensors:
    its outputs and scratch allocated, its argument types set."""
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 16 + [i] * 6 + [p]
        fn.restype = i
    B, S, H, P = xdt.shape
    G, N = b.shape[2], b.shape[3]
    dev = xdt.device
    T = -(-S // TILE)
    dxdt = torch.empty_like(xdt)
    ddta = torch.empty_like(dta)
    db = torch.empty_like(b)
    dc = torch.empty_like(c)
    dbh = torch.empty((B, S, H, N), device=dev)
    dch = torch.empty((B, S, H, N), device=dev)
    fwd = torch.empty((B, T - 1, H, P, N), device=dev)
    rev = torch.empty((B, T - 1, H, P, N), device=dev)
    cum_end = torch.empty((B, T - 1, H), device=dev)
    dcum = torch.empty((B, S, H), device=dev, dtype=torch.float64)
    tot = torch.empty((B, T, H), device=dev, dtype=torch.float64)
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in (
            xdt, dta, b, c, dy, dxdt, ddta, db, dc, dbh, dch, fwd, rev,
            cum_end, dcum, tot)), B, S, H, P, G, N,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {rc}")
    return dxdt, ddta, db, dc


ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` on CUDA tensors with a kernel backward: the forward
    launches ``csrc/ssd_scan.cu``, the backward ``csrc/ssd_scan_bwd.cu``
    through :func:`ssd_scan_bwd`. Saves the inputs, not y. With ``final``
    the forward also returns h_T, marked as having no gradient."""

    @staticmethod
    def forward(ctx, xdt, dta, b, c, final: bool = False):
        ctx.save_for_backward(xdt, dta, b, c)
        out = _launch(xdt, dta, b, c, final=final)
        if final:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, dy, *_):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy.contiguous()), None)


def ssd_scan(xdt, dta, b, c, *, chunk: int, initial_state=None,
             return_final_state: bool = False):
    """y (B, S, H, P) f32 of the chunked SSD scan from ``initial_state``
    (B, H, P, N) f32 (None: zeros), or with ``return_final_state`` (y,
    h_T); see the module note. On CUDA tensors ``chunk`` is checked but
    the kernels tile by their own :data:`TILE`; one call issues the three
    passes (one kernel when S <= TILE and no final state is wanted) and
    counts one launch. With grad enabled and an input that requires grad
    the call goes through :class:`SSDScanFn`, whose backward is a kernel
    too (an initial state then raises); under ``torch.no_grad`` nothing
    else runs."""
    # meta tensors (the dry run's shapes) take the plain version too
    if xdt.device.type in ("cpu", "meta"):
        return ssd_scan_plain(xdt, dta, b, c, chunk=chunk,
                              initial_state=initial_state,
                              return_final_state=return_final_state)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xdt.device}")
    _check(xdt, dta, b, c, chunk)
    if initial_state is not None:
        _check_state(initial_state, xdt, b)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xdt, dta, b, c, initial_state)):
        if initial_state is not None:
            raise NotImplementedError(
                "ssd_scan: the backward through an initial state is not "
                "ported (ROADMAP.md item 10b.1: nothing trains through "
                "decode)")
        return SSDScanFn.apply(xdt, dta, b, c, bool(return_final_state))
    return _launch(xdt, dta, b, c, initial_state, return_final_state)


ssd_scan.launches = 0
ssd_scan.launches_by_mode = {"y": 0, "state": 0}
