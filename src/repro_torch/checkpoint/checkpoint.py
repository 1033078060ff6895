"""Tree ⇄ flat-npz checkpoints with a structure manifest, in the
reference's on-disk format (``repro.checkpoint``).

Leaves are flattened under ``/``-joined key paths into one ``.npz``
(dict keys as they are, list and tuple positions as ``#i``), next to a
``.meta.json`` holding the schema version, the step, the sorted keys,
the CRC32 checksum of the arrays and free-form ``extra``. The port's
flat params (``"s1b0/conv1"``) and the reference's nested ones
(``{"s1b0": {"conv1": ...}}``) flatten to the same keys, so a file
written by either package loads into the other: through
:mod:`repro_torch.models.convert` where layouts differ (the ResNet's
OIHW convolutions), as they are elsewhere. Tensors are read from any
device; bf16 is stored as f32 (exact), as the reference stores
``ml_dtypes`` types. Loading restores each leaf into the dtype, shape
and device of the matching leaf of ``like``.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

# the reference's layout version: a file of another version (or of none)
# is refused
SCHEMA_VERSION = 1


def checkpoint_checksum(flat: Dict[str, np.ndarray]) -> int:
    """CRC32 over every array's dtype, shape and raw bytes, in sorted
    key order."""
    crc = 0
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        head = f"{key}:{arr.dtype.str}:{arr.shape}".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(head, crc))
    return crc & 0xFFFFFFFF


def to_numpy(leaf) -> np.ndarray:
    """A host numpy copy of a tensor (any device; bf16 as f32), an array
    or a Python scalar."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":       # ml_dtypes extension types (bfloat16)
        arr = arr.astype(np.float32)
    return arr


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs; dict keys sorted as the reference's tree
    flattening visits them; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}#{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def flatten(tree) -> Dict[str, np.ndarray]:
    return {path: to_numpy(leaf) for path, leaf in _leaves(tree)}


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    return (path[:-4] if path.endswith(".npz") else path) + ".meta.json"


def save_checkpoint(path: str, params: Any, step: int = 0,
                    extra: Dict[str, Any] | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = flatten(params)
    meta = {"version": SCHEMA_VERSION, "step": step, "keys": sorted(flat),
            "checksum": checkpoint_checksum(flat), "extra": extra or {}}
    np.savez(_npz_path(path), **flat)
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def _restore(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=like.device, dtype=like.dtype).reshape(
            like.shape)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return np.asarray(arr).astype(np.asarray(like).dtype).reshape(
        np.shape(like))


def _rebuild(like, values: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, values, f"{prefix}#{i}/")
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, list) else tuple(out)
    if like is None:
        return None
    return values[prefix[:-1]]


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like``. Raises ``ValueError`` on
    a missing or other schema version, a checksum mismatch (a corrupt or
    truncated file) or keys that differ from ``like``'s."""
    npz = np.load(_npz_path(path))
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    if meta.get("version") != SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint {path!r} schema version "
            f"{meta.get('version')!r} != supported {SCHEMA_VERSION}; "
            "refusing to load a version-skewed or pre-versioning file")
    stored = {k: npz[k] for k in npz.files}
    crc = checkpoint_checksum(stored)
    if meta.get("checksum") != crc:
        raise ValueError(
            f"checkpoint {path!r} checksum mismatch: meta records "
            f"{meta.get('checksum')!r}, arrays hash to {crc} — the npz "
            "is corrupt or was modified after save")
    like_leaves = dict(_leaves(like))
    if sorted(like_leaves) != meta["keys"]:
        missing = set(meta["keys"]) ^ set(like_leaves)
        raise ValueError(
            f"checkpoint structure mismatch: {sorted(missing)[:5]}")
    values = {k: _restore(stored[k], leaf) for k, leaf in like_leaves.items()}
    return _rebuild(like, values), meta["step"]
