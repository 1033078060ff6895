"""Device resolution shared by the port's entry points.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. Asking for ``cuda`` on a machine without a card raises:
nothing drops silently to the CPU. The dry run builds its inputs on the
``meta`` device (:func:`resolve_or_meta`), where nothing is allocated or
computed.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def resolve_or_meta(device="cuda") -> torch.device:
    """:func:`resolve_device`, or the meta device when asked for."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta, for initialisers that draw on
    ``gen.device``: a draw on a meta tensor takes no numbers."""

    @property
    def device(self):
        return torch.device("meta")
