"""Federated aggregation over per-client state dicts.

Counterpart of ``ccst_tpu/federated/aggregate.py`` (the reference's
``communication()``, federated/fed_run.py:385-455). A client state is the
model's state dict (parameters and buffers under the JAX tree's names); the
server is the float32 weighted sum ``sum_k w_k * x_k`` of every entry.

Modes:
  - ``fedavg`` / ``fedprox`` / ``deepall``: every client gets the server;
  - ``fedbn``: entries under a module whose name starts with ``bn`` (scale,
    bias and running statistics) stay each client's own, the rest come from
    the server (:388-399);
  - ``adafea``: like fedavg, then every ``bn3``'s weight := sqrt(server
    running_var + 1e-5) and bias := server running_mean (:415-453; unreachable
    in the reference, implemented as written, like the JAX package).

``num_batches_tracked`` exists only in torch: as in the reference
(aggregate.py:22-23 there), the server takes client 0's count and never an
average of them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

State = Dict[str, torch.Tensor]

_BN_PREFIXES = ("bn", "BatchNorm", "TorchBatchNorm")


def is_bn_key(key: str) -> bool:
    """True if a state-dict key belongs to a BatchNorm module: a path
    component starts with ``bn`` (the reference's rule is the substring
    ``bn`` in torch state-dict keys, fed_run.py:398)."""
    return any(part.startswith(_BN_PREFIXES) for part in key.split(".")[:-1])


def weighted_average(states: Sequence[State], weights: Sequence[float]) -> State:
    """Server state: float32 ``sum_k w_k * x_k`` of every floating entry;
    integer entries (``num_batches_tracked``) are client 0's."""
    server: State = {}
    for key, first in states[0].items():
        if not first.is_floating_point():
            server[key] = first.clone()
            continue
        acc = first.float() * float(weights[0])
        for w, s in zip(weights[1:], states[1:]):
            acc = acc + s[key].float() * float(w)
        server[key] = acc.to(first.dtype)
    return server


def aggregate(mode: str, client_states: Sequence[State], weights: Sequence[float]
              ) -> Tuple[State, List[State]]:
    """Returns (server state, new client states)."""
    mode = mode.lower()
    server = weighted_average(client_states, weights)
    if mode in ("fedavg", "fedprox", "deepall"):
        return server, [{k: v.clone() for k, v in server.items()} for _ in client_states]
    if mode == "fedbn":
        return server, [{k: (c[k] if is_bn_key(k) else server[k].clone()) for k in server}
                        for c in client_states]
    if mode == "adafea":
        coupled = dict(server)
        for key in server:
            path, leaf = key.rsplit(".", 1)
            if "bn3" not in path.split(".") or f"{path}.running_var" not in server:
                continue
            if leaf == "weight":
                coupled[key] = torch.sqrt(server[f"{path}.running_var"] + 1e-5).to(server[key].dtype)
            elif leaf == "bias":
                coupled[key] = server[f"{path}.running_mean"].to(server[key].dtype)
        return server, [{k: v.clone() for k, v in coupled.items()} for _ in client_states]
    raise ValueError(f"unknown aggregation mode {mode!r}")
