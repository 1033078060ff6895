"""head_select: fused classifier head + OoD detector + top-k soft label.

Replaces the Pallas TPU kernel ``head_select_pallas`` (body
``_head_kernel``) of ``src/repro/kernels/head_select/kernel.py``. From
pre-head activations ``hidden`` (L, N, D), per-node heads ``w`` (L, D, C)
and ``bias`` (L, C) it returns, per node and row:

* ``conf`` (L, N) f32 — detector confidence at T=1: MSP ``max softmax``
  or energy ``logsumexp``;
* ``vals`` (L, N, k) f32 — the top-k of ``softmax(logits / T)``,
  renormalized over the top-k;
* ``idx`` (L, N, k) int32 — their class indices, ties to the lowest.

``raw_stats=True`` is ``head_select_pallas(raw_stats=True)``: the
pre-finalizer carry ``(m (L, N), z (L, N), tv (L, N, k), ti (L, N, k))``
of one vocabulary slice — the online-softmax stats and the top-k raw
logits with their indices within the slice — which the vocab-sharded
round (``core.labeling``) merges across slices with
:func:`merge_head_stats_plain`. Both kernels have this mode; its
launches are counted under ``"simt_raw"`` / ``"tc_raw"``. Slots the
slice cannot fill with a real logit (every column NEG-biased padding)
hold NEG and index 0 in the kernels, as in the Pallas kernel's carry,
and the slice's first indices in the plain version, as in
``head_select_stats_ref``; they never win the merge.

Two CUDA kernels compute it, neither writing the (N, C) logits to
memory, one launch for all L nodes; their header notes give each design
and what bounds it on the H100: ``csrc/head_select_tc.cu`` (``tc``: bf16,
on the tensor cores, splitting C over blocks when the rows cannot fill
the card) and ``csrc/head_select.cu`` (``simt``: f32). :func:`_variant`
picks one from the dtype alone; :func:`head_select` runs it on CUDA
tensors and counts the launch in ``launches`` and
``launches_by_variant``, and :func:`head_select_plain` — the same
function in plain PyTorch — runs on CPU tensors only; a CUDA call that no
kernel takes raises. :func:`head_select_split_plain` is the column split
and its merge (``merge_head_stats``' math) in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distill import top_k
from repro_torch.kernels import build, forbid_grad

DETECTORS = ("msp", "energy")
KMAX = 16            # largest k the kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_ROWS, TC_COLS = 128, 256   # the tc kernel's row tile and column tile
L2_BYTES = 50 * 2 ** 20       # the H100's L2 cache


def head_select_plain(hidden, w, bias=None, *, temperature: float, k: int,
                      detector: str = "msp"):
    """The plain PyTorch version: materializes the logits in f32."""
    logits = torch.matmul(hidden.float(), w.float())
    if bias is not None:
        logits = logits + bias.float().unsqueeze(-2)
    if detector == "energy":
        conf = torch.logsumexp(logits, dim=-1)
    else:
        conf = torch.softmax(logits, dim=-1).max(dim=-1).values
    vals, idx = top_k(logits, k)
    return conf, torch.softmax(vals / temperature, dim=-1), idx.to(torch.int32)


def head_select_stats_plain(hidden, w, bias=None, *, k: int, col0: int = 0):
    """One vocabulary slice's raw stats, as the tc kernel's column slices
    write them: the online-softmax (m, z) over the slice's logits and its
    top-min(k, C_slice) logits with their global indices (``col0`` is the
    slice's first column), ties to the lowest index."""
    logits = torch.matmul(hidden.float(), w.float())
    if bias is not None:
        logits = logits + bias.float().unsqueeze(-2)
    m = logits.amax(dim=-1)
    z = torch.exp(logits - m.unsqueeze(-1)).sum(dim=-1)
    tv, ti = top_k(logits, min(k, logits.shape[-1]))
    return m, z, tv, (ti + col0).to(torch.int32)


def merge_head_stats_plain(ms, zs, tvs, tis, *, temperature: float, k: int,
                           detector: str = "msp"):
    """Merge per-slice stats (lists over slices in column order) into
    (conf, vals, idx), as ``merge_head_stats`` and the tc kernel's merge
    do: m = max m_i, z = sum z_i exp(m_i - m), the top-k of the union of
    the slices' candidates (ties to the lowest index), then the
    finalizer."""
    m = torch.stack(ms).amax(dim=0)
    z = torch.clamp(sum(zi * torch.exp(mi - m) for mi, zi in zip(ms, zs)),
                    min=1e-30)
    conf = m + torch.log(z) if detector == "energy" else 1.0 / z
    vals, pos = top_k(torch.cat(tvs, dim=-1), k)
    idx = torch.gather(torch.cat(tis, dim=-1), -1, pos)
    return conf, torch.softmax(vals / temperature, dim=-1), idx


def head_select_split_plain(hidden, w, bias=None, *, temperature: float,
                            k: int, detector: str = "msp",
                            slice_w: int = TC_COLS):
    """The column split in plain PyTorch: C cut into ``slice_w``-wide
    slices, each reduced to its raw stats, merged. Equal to
    :func:`head_select_plain`."""
    C = w.shape[-1]
    stats = [head_select_stats_plain(
        hidden, w[..., c0:c0 + slice_w],
        None if bias is None else bias[..., c0:c0 + slice_w], k=k, col0=c0)
        for c0 in range(0, C, slice_w)]
    return merge_head_stats_plain(*zip(*stats), temperature=temperature, k=k,
                                  detector=detector)


def _variant(dtype) -> str:
    """The kernel that takes the dtype: ``"tc"`` (tensor cores) for bf16,
    ``"simt"`` for f32; anything else raises."""
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"head_select kernel takes float32 or bfloat16 hidden "
                    f"and w, got {dtype}")


def _column_splits(L: int, N: int, C: int, D: int, sms: int):
    """(slice_w, nsplit) for the tc kernel: C cut into 256-column-aligned
    slices so that the L x ceil(N / 128) row tiles times the slices come
    near twice the card's SMs. Where the row tiles alone fill the card, C
    is still cut in two when one wave's hidden tiles (re-read once per
    column tile) would fill more than half the L2: the blocks that run
    together then share row tiles (measured at Hymba's head, PERF.md)."""
    tiles = L * -(-N // TC_ROWS)
    col_tiles = -(-C // TC_COLS)
    want = max(1, min(-(-2 * sms // tiles), col_tiles))
    if want == 1 and col_tiles > 1 and sms * TC_ROWS * D * 2 > L2_BYTES / 2:
        want = 2
    slice_w = -(-col_tiles // want) * TC_COLS
    return slice_w, -(-C // slice_w)


def _tc_operands(hidden, w):
    """hidden (L, N, D) and the K-major head wt (L, C, D), both with D
    padded with zeros to a multiple of 8 (16-byte rows for TMA) and
    contiguous. A tied head — a transposed view of a contiguous (L, C, D)
    table — is passed as it is when D needs no padding; an untied (L, D,
    C) head is copied once per call. Rows past C need no padding: TMA
    reads zeros there and the kernel masks those columns."""
    D = hidden.shape[-1]
    pad = -D % 8
    wt = w.transpose(-1, -2)
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, pad))
        wt = torch.nn.functional.pad(wt, (0, pad))
    return hidden.contiguous(), wt.contiguous()


def _fn(variant: str):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if variant == "tc":
        fn = build.load("head_select_tc").head_select_tc_launch
        args = [p, p, p, i, i, i, i, i, i, i, f, i, i, p, p, p, p, p, p, p,
                p, p]
    else:
        fn = build.load("head_select").head_select_launch
        args = [i, p, p, p, i, i, i, i, i, f, i, i, p, p, p, p, p]
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = i
    return fn


_SMS = {}


def _launch(variant: str, hidden, w, bias, *, temperature: float, k: int,
            detector: str, raw: bool = False):
    """Run one kernel on checked CUDA tensors (bias f32 or None) and count
    the launch. ``raw``: write the carry (m into ``conf``, z, the top-k
    raw logits into ``vals``) instead of the finalized label."""
    L, N, D = hidden.shape
    C = w.shape[-1]
    dev = hidden.device
    conf = torch.empty((L, N), device=dev)
    vals = torch.empty((L, N, k), device=dev)
    idx = torch.empty((L, N, k), device=dev, dtype=torch.int32)
    z = torch.empty((L, N), device=dev) if raw else None
    energy = int(detector == "energy")
    bptr = None if bias is None else bias.data_ptr()
    outs = (conf.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            None if z is None else z.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if variant == "tc":
            h, wt = _tc_operands(hidden, w)
            if h.data_ptr() % 16 or wt.data_ptr() % 16:
                raise ValueError("head_select: hidden and w must start on "
                                 "a 16-byte boundary (TMA)")
            if dev not in _SMS:
                _SMS[dev] = torch.cuda.get_device_properties(
                    dev).multi_processor_count
            slice_w, nsplit = _column_splits(L, N, C, h.shape[-1],
                                             _SMS[dev])
            scratch = [None] * 4
            if nsplit > 1:
                scratch = [t.data_ptr() for t in (
                    torch.empty((L, N, nsplit), device=dev),
                    torch.empty((L, N, nsplit), device=dev),
                    torch.empty((L, N, nsplit, k), device=dev),
                    torch.empty((L, N, nsplit, k), device=dev,
                                dtype=torch.int32))]
            rc = _fn("tc")(h.data_ptr(), wt.data_ptr(), bptr, L, N,
                           h.shape[-1], C, k, slice_w, nsplit,
                           float(temperature), energy, int(raw), *outs,
                           *scratch, stream)
        else:
            wc = w.contiguous()
            rc = _fn("simt")(_DTYPES[hidden.dtype], hidden.data_ptr(),
                             wc.data_ptr(), bptr, L, N, D, C, k,
                             float(temperature), energy, int(raw), *outs,
                             stream)
    if rc != 0:
        raise RuntimeError(f"head_select {variant} kernel launch failed: "
                           f"CUDA error {rc}")
    tag = f"{variant}_raw" if raw else variant
    head_select.launches += 1
    head_select.launches_by_variant[tag] = (
        head_select.launches_by_variant.get(tag, 0) + 1)
    return (conf, z, vals, idx) if raw else (conf, vals, idx)


def head_select(hidden, w, bias=None, *, temperature: float = 10.0,
                k: int = 8, detector: str = "msp", raw_stats: bool = False):
    if detector not in DETECTORS:
        raise ValueError(f"unknown detector {detector!r}")
    forbid_grad("head_select", hidden, w, bias)
    if hidden.device.type == "cpu":
        if raw_stats:
            return head_select_stats_plain(hidden, w, bias, k=k)
        return head_select_plain(hidden, w, bias, temperature=temperature,
                                 k=k, detector=detector)
    if hidden.device.type != "cuda":
        raise ValueError(f"head_select: unsupported device {hidden.device}")
    L, N, D = hidden.shape
    C = w.shape[-1]
    if w.shape != (L, D, C):
        raise ValueError(f"head_select: w {tuple(w.shape)} does not match "
                         f"hidden {tuple(hidden.shape)}")
    if w.dtype != hidden.dtype:
        raise TypeError(f"head_select kernel takes hidden and w of one "
                        f"dtype, got {hidden.dtype}, {w.dtype}")
    variant = _variant(hidden.dtype)
    if not 1 <= k <= min(KMAX, C):
        raise ValueError(f"head_select kernel takes 1 <= k <= min(16, C), "
                         f"got k={k}, C={C}")
    if bias is not None:
        if bias.shape != (L, C):
            raise ValueError(f"head_select: bias {tuple(bias.shape)} is "
                             f"not ({L}, {C})")
        bias = bias.float().contiguous()
    if w.device != hidden.device:
        raise ValueError(f"head_select: w must be on {hidden.device}")
    for name, t in (("hidden", hidden), ("bias", bias)):
        if t is not None and (t.device != hidden.device
                              or not t.is_contiguous()):
            raise ValueError(f"head_select: {name} must be contiguous on "
                             f"{hidden.device}")
    return _launch(variant, hidden, w, bias, temperature=temperature, k=k,
                   detector=detector, raw=raw_stats)


head_select.launches = 0
head_select.launches_by_variant = {"tc": 0, "simt": 0, "tc_raw": 0,
                                   "simt_raw": 0}
