"""Ranks and collectives of the sharded driver on ``torch.distributed``.

The reference runs its sharded driver under one controller with
``shard_map``; the port runs it SPMD: one process per mesh device, each
holding its contiguous block of nodes (and, on the 2-D federation mesh,
its model shard of each leaf). This module is the mechanism that stands
in for ``shard_map``:

* :func:`spawn` starts ``world`` ranks on this machine
  (``torch.multiprocessing``, start method ``spawn``) that meet through
  a ``file://`` store; a rank that raises fails the whole spawn, and
  each rank's return value comes back to the caller;
* :func:`choose_backend`: ``nccl`` when each rank has a card of its own,
  ``gloo`` when ranks share a card (NCCL refuses two ranks on one
  device) or run on the CPU;
* :class:`Group` and the few collectives the slice uses:
  :func:`all_reduce`, :func:`all_gather`, :func:`all_gather_many` and
  :func:`ring_neighbors_many` (the boundary rows of a ring, one
  ``all_gather``: blocking send/recv pairs deadlock when every rank
  sends first). The ``_many`` forms move many tensors of any dtypes as
  one byte buffer: a train step's gossip is one collective, not one a
  leaf (each staged collective waits for the card);
* :func:`barrier` and :func:`broadcast_object` over the whole world
  (durable snapshots: rank 0 chooses, every rank follows);
* a byte counter per collective kind (:data:`SENT`,
  :func:`zero_sent`, :func:`sent`): the payload this rank hands to each
  ``all_reduce`` (its tensor, kind ``"all-reduce"``), each
  ``all_gather*`` call (its piece, ``"all-gather"``) and each
  :func:`ring_neighbors_many` (the boundary rows it sends its two ring
  neighbours, ``"collective-permute"``), counted once whatever algorithm
  the backend runs underneath, and nothing on a group of one rank. The
  dry run (``launch.dryrun``) counts a step's collectives the same way.

**Host staging.** Gloo takes some collectives on CUDA tensors and not
others, by op and by version. On a gloo group every collective on a
CUDA tensor therefore goes through the host: the tensor is copied to
the CPU, reduced or gathered there, and copied back. This is the wire of
ranks that share one card, not a fallback: compute stays on the card.
:func:`init_rank` prints the backend and whether it stages, once a run.

A group of one rank (no process group at all) is legal: every
collective is then the identity, so the sharded code runs in one
process too.
"""
from __future__ import annotations

import os
import tempfile
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """An ordered set of ranks: ``ranks`` in axis order, this rank's
    ``index`` among them, and the process group (None for one rank)."""
    ranks: Tuple[int, ...]
    index: int
    pg: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is running."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend() -> Optional[str]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def staged() -> bool:
    """Whether CUDA tensors go through the host: on a gloo group."""
    return backend() == "gloo"


def choose_backend(device: str, world_size: int) -> str:
    """``nccl`` when ``device`` is cuda and every rank has a card of its
    own; ``gloo`` when ranks share a card or run on the CPU."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def new_group(ranks: Sequence[int]) -> Group:
    """A :class:`Group` over ``ranks``. Collective: every rank of the
    world calls it with the same ranks, in the same order, member or
    not; a non-member gets a Group whose ``index`` is -1."""
    ranks = tuple(int(r) for r in ranks)
    rank, size = world()
    pg = None
    if size > 1:
        pg = dist.new_group(list(ranks))
        if len(ranks) == 1:
            pg = None
    return Group(ranks, ranks.index(rank) if rank in ranks else -1, pg)


# ------------------------------------------------------------ collectives
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
SENT = {k: 0 for k in KINDS}          # bytes this rank handed to each kind
CALLS = {k: 0 for k in KINDS}         # and the calls


def zero_sent() -> None:
    """Set the collective byte counters to 0."""
    for k in KINDS:
        SENT[k] = CALLS[k] = 0


def sent() -> dict:
    """The counters: ``{kind: bytes, ..., "count": calls, "total":
    bytes}``, the dry run's ``collectives`` record."""
    out = dict(SENT)
    out["count"] = sum(CALLS.values())
    out["total"] = sum(SENT.values())
    return out


def _count(kind: str, nbytes: int) -> None:
    SENT[kind] += int(nbytes)
    CALLS[kind] += 1


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _host(t: torch.Tensor) -> torch.Tensor:
    """The tensor the wire takes: on a gloo group a CUDA tensor is staged
    through the host (see the module docstring); bools travel as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if staged() and t.is_cuda:
        t = t.cpu()
    return t.contiguous()


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over the group, as a new tensor on ``x``'s
    device (``x`` itself unchanged)."""
    if group.size == 1:
        return x.clone()
    _count("all-reduce", _nbytes(x))
    w = _host(x)
    if w.data_ptr() == x.data_ptr():
        w = w.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group.pg)
    return w.to(device=x.device, dtype=x.dtype)


def all_gather(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on all), in group order,
    on ``x``'s device."""
    if group.size == 1:
        return [x]
    _count("all-gather", _nbytes(x))
    return _gather(x, group)


def _gather(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    w = _host(x)
    outs = [torch.empty_like(w) for _ in range(group.size)]
    dist.all_gather(outs, w, group=group.pg)
    return [o.to(device=x.device, dtype=x.dtype) for o in outs]


def all_gather_cat(x: torch.Tensor, group: Group, dim: int = 0
                   ) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` (a tiled
    ``all_gather``)."""
    if group.size == 1:
        return x
    return torch.cat(all_gather(x, group), dim=dim)


def all_gather_many(xs: List[torch.Tensor], group: Group
                    ) -> List[List[torch.Tensor]]:
    """:func:`all_gather` of every tensor of ``xs`` in one collective:
    their bytes concatenated into one buffer, gathered, cut back. Returns
    ``out[i][r]``, rank r's ``xs[i]``."""
    if group.size == 1:
        return [[x] for x in xs]
    _count("all-gather", sum(_nbytes(x) for x in xs))
    return _gather_many(xs, group)


def _gather_many(xs: List[torch.Tensor], group: Group
                 ) -> List[List[torch.Tensor]]:
    flat = []
    for x in xs:                  # each piece 16-byte aligned in the buffer
        f = x.contiguous().reshape(-1).view(torch.uint8)
        flat += [f, f.new_zeros(-f.numel() % 16)]
    sizes = [f.numel() for f in flat]
    parts = _gather(torch.cat(flat), group)
    out = [[] for _ in xs]
    for part in parts:
        pieces = torch.split(part, sizes)[::2]
        for i, piece in enumerate(pieces):
            out[i].append(piece.view(xs[i].dtype).reshape(xs[i].shape))
    return out


def ring_neighbors_many(xs: List[torch.Tensor], group: Group
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """For each block ``x`` of a ring's node axis in ``xs`` (rows ``j·L
    .. j·L+L-1`` on the group's rank j): the row before the block (the
    last row of rank j-1) and the row after it (the first row of rank
    j+1), each (1, ...). One ``all_gather`` of the boundary rows."""
    if group.size == 1:
        return [(x[-1:], x[:1]) for x in xs]
    rows = [torch.cat([x[:1], x[-1:]]) for x in xs]
    _count("collective-permute", sum(_nbytes(r) for r in rows))
    gathered = _gather_many(rows, group)
    j, s = group.index, group.size
    return [(parts[(j - 1) % s][1:], parts[(j + 1) % s][:1])
            for parts in gathered]


def barrier() -> None:
    """Wait for every rank of the world (nothing with one rank)."""
    if world()[1] > 1:
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank of the world (the
    object itself with one rank)."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ------------------------------------------------------------------ spawn
def init_rank(rank: int, world_size: int, store: str, backend_name: str,
              device: str = "cuda") -> None:
    """Join the process group of a spawn: ``file://`` store at
    ``store``; under NCCL the rank takes card ``rank``. Rank 0 prints
    the backend, and whether gloo stages CUDA tensors through the host,
    once."""
    if backend_name == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend_name, init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    if rank == 0:
        stage = (backend_name == "gloo"
                 and torch.device(device).type == "cuda")
        print(f"dist: {world_size} ranks, backend {backend_name}"
              + (", CUDA tensors staged through the host (gloo)"
                 if stage else ""), flush=True)


def _entry(rank: int, fn: Callable, world_size: int, store: str,
           backend_name: str, device: str, out_dir: str, args: tuple
           ) -> None:
    try:
        init_rank(rank, world_size, store, backend_name, device)
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, device: str = "cuda",
          store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new
    processes joined in one process group (backend by
    :func:`choose_backend`), and return their results in rank order.
    ``fn`` must be importable (a module-level function);
    ``store_dir`` holds the ``file://`` store and the results (a new
    temporary directory when None). A rank that raises makes this raise
    once every process has stopped. Build CUDA kernels before calling:
    ranks that start together would each run ``nvcc``."""
    import torch.multiprocessing as mp

    backend_name = choose_backend(device, world_size)
    tmp = None
    if store_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="repro_dist_")
        store_dir = tmp.name
    try:
        Path(store_dir).mkdir(parents=True, exist_ok=True)
        store = os.path.join(store_dir, "store")
        if os.path.exists(store):
            os.remove(store)
        mp.start_processes(_entry, args=(fn, world_size, store, backend_name,
                                         device, store_dir, args),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        if tmp is not None:
            tmp.cleanup()
