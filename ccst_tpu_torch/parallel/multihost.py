"""Multi-process runs on ``torch.distributed``: one process a rank.

Counterpart of ``ccst_tpu/parallel/multihost.py``. The reference's only
distributed training is the DDP loop of reconstruct_img/imagenet_reconstruct.py
:141-175 (``mp.spawn`` + ``dist.init_process_group('nccl')`` +
DistributedSampler); JAX forms a cluster with ``jax.distributed.initialize``
and lets XLA insert the collectives. Here each rank is a process with one
device, and the collectives are explicit calls on process groups.

The backend rule, logged by :func:`initialize`: ``nccl`` when every rank on
the host has a card of its own (ranks on the host <= cards, and the device is
CUDA); ``gloo`` when ranks share a card (NCCL refuses two ranks on one device)
or run on the CPU. The ranks on the host are ``LOCAL_WORLD_SIZE`` when a
launcher sets it, else all of them (one host). A rank's device is
``cuda:{rank % device_count}`` unless the caller asks for the CPU.

gloo runs some collectives on CUDA tensors and refuses others: every
collective here asks :func:`_staged`, which sends a CUDA tensor through a CPU
copy on gloo. The training step itself stays on the card.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def choose_backend(device: Any, num_procs: int) -> Tuple[str, str]:
    """(backend, the reason): the module docstring's rule."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", "ranks on the CPU"
    local = _env_int("LOCAL_WORLD_SIZE") or num_procs
    cards = torch.cuda.device_count()
    if local > cards:
        return "gloo", f"{local} ranks share {cards} card(s); NCCL refuses two ranks on one device"
    return "nccl", f"{local} ranks, each with a card of its own"


def rank_device(device: Any) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` for a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank() % max(torch.cuda.device_count(), 1))


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: Any = "cuda") -> torch.device:
    """Join (or form) the process group; returns this rank's device.

    Arguments default to the ``CCST_COORDINATOR`` / ``CCST_NUM_PROCS`` /
    ``CCST_PROC_ID`` environment variables. The coordinator is ``host:port``
    (a TCP store on rank 0's host) or any ``init_method`` URL, such as
    ``file:///shared/path``."""
    coordinator_address = coordinator_address or os.environ.get("CCST_COORDINATOR", "")
    if num_processes is None:
        num_processes = _env_int("CCST_NUM_PROCS")
    if process_id is None:
        process_id = _env_int("CCST_PROC_ID")
    if not coordinator_address or num_processes is None or process_id is None:
        raise SystemExit("a multi-process run needs a coordinator, the number of processes and "
                         "this process's id (--coordinator / --num-procs / --proc-id, or "
                         "CCST_COORDINATOR / CCST_NUM_PROCS / CCST_PROC_ID)")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    backend, why = choose_backend(device, num_processes)
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"[multihost] rank {process_id} of {num_processes}: backend {backend} ({why}), "
          f"device {dev}", flush=True)
    return dev


def _staged(t: torch.Tensor, group=None) -> torch.Tensor:
    """The tensor a collective runs on: on gloo a CUDA tensor goes through a
    CPU copy (gloo refuses CUDA tensors for some collectives). Every
    collective of this module asks here, so the rule lives in one place."""
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, in place; returns ``t``."""
    x = _staged(t, group)
    dist.all_reduce(x, group=group)
    return t if x is t else t.copy_(x)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place from global rank ``src``; returns ``t``."""
    x = _staged(t, group)
    dist.broadcast(x, src, group=group)
    return t if x is t else t.copy_(x)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every group rank's ``t``, in group rank order (equal shapes)."""
    x = _staged(t.contiguous(), group)
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return [o.to(t.device) for o in out]


def exchange(sends: Dict[int, torch.Tensor], recv_like: Dict[int, torch.Tensor],
             group=None) -> Dict[int, torch.Tensor]:
    """Point to point: send ``sends[p]`` to group rank ``p`` and receive from
    each group rank ``p`` of ``recv_like`` a tensor of the shape and dtype of
    ``recv_like[p]``; returns the received tensors on their devices. Every
    send and receive is posted before any is waited on, so no order of the
    pairs can deadlock; CUDA tensors go through the host on gloo."""
    peer = (lambda p: p) if group is None else (lambda p: dist.get_global_rank(group, p))
    outgoing = {p: _staged(t.contiguous(), group) for p, t in sends.items()}
    incoming = {p: torch.empty_like(_staged(t, group), memory_format=torch.contiguous_format)
                for p, t in recv_like.items()}
    works = [dist.isend(t, peer(p), group=group) for p, t in outgoing.items()]
    works += [dist.irecv(t, peer(p), group=group) for p, t in incoming.items()]
    for w in works:
        w.wait()
    return {p: t.to(recv_like[p].device) for p, t in incoming.items()}


def _flat_groups(tree: Tree) -> Dict[torch.dtype, List[str]]:
    groups: Dict[torch.dtype, List[str]] = {}
    for k, v in tree.items():
        groups.setdefault(v.dtype, []).append(k)
    return groups


def all_gather_tree(tree: Tree, group=None) -> List[Tree]:
    """Every group rank's tree, in group rank order: one collective a dtype
    over the flattened leaves."""
    n = dist.get_world_size(group)
    out: List[Tree] = [{} for _ in range(n)]
    for _, keys in _flat_groups(tree).items():
        flat = torch.cat([tree[k].reshape(-1) for k in keys])
        for r, got in enumerate(all_gather(flat, group)):
            for k, part in zip(keys, torch.split(got, [tree[k].numel() for k in keys])):
                out[r][k] = part.view(tree[k].shape)
    return [{k: o[k] for k in tree} for o in out]


def replicate_tree(tree: Tree, src: int = 0, group=None) -> Tree:
    """Rank ``src``'s tree on every rank (a broadcast a dtype); the input is
    left as it was."""
    out = {}
    for _, keys in _flat_groups(tree).items():
        flat = broadcast(torch.cat([tree[k].reshape(-1) for k in keys]), src, group)
        for k, part in zip(keys, torch.split(flat, [tree[k].numel() for k in keys])):
            out[k] = part.view(tree[k].shape)
    return {k: out[k] for k in tree}


def process_clients(n_clients: int, n_shards: Optional[int] = None,
                    shard: Optional[int] = None) -> Sequence[int]:
    """The stacked-client indices a client shard owns: contiguous blocks, in
    rank order (by default every rank is a client shard)."""
    n_shards = world_size() if n_shards is None else n_shards
    shard = rank() if shard is None else shard
    per = n_clients // n_shards
    return range(shard * per, (shard + 1) * per)


def shard_stacked_tree(tree: Tree, clients: Sequence[int]) -> Tree:
    """This rank's block of a stacked tree (leading client axis) that every
    rank holds."""
    sel = list(clients)
    return {k: v[sel[0]:sel[-1] + 1] for k, v in tree.items()}


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The tensors (one dtype) averaged over the group: one collective over
    their concatenation, the sum divided by the group's size."""
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
    flat = flat / dist.get_world_size(group)
    return [part.view(t.shape) for t, part in zip(tensors, torch.split(
        flat, [t.numel() for t in tensors]))]


def group_rows(b: int, group=None) -> slice:
    """This rank's rows of a ``b``-row batch split over the group."""
    n = dist.get_world_size(group)
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} ranks")
    per = b // n
    i = dist.get_rank(group)
    return slice(i * per, (i + 1) * per)
