"""Multi-process federated training: ``fed-train`` over ``torch.distributed``.

Counterpart of ``ccst_tpu/federated/multihost_runtime.py``. The reference's
distributed entry point is an ``mp.spawn`` + ``dist.init_process_group``
script (reconstruct_img/imagenet_reconstruct.py:141-175). Here each rank is a
process with one device on a (client, data) grid of ranks
(``parallel/fed_mesh.py::FedMesh``): the client axis lies on the rank
boundary, each client shard owns a contiguous block of clients (the clients
must divide evenly over the shards) and iterates only its clients' loaders
(the DistributedSampler analogue), stepping them with ``ParallelFedTrainer``.
Ranks of a data group split each of their clients' batches and sum
gradients, BatchNorm batch statistics and row counts inside the step; RSC's
batch percentile and MixStyle's permutation see the gathered whole batch.

Every round runs exactly the global maximum number of local steps
(``stack_step_batches(..., n_steps)``); a client whose epoch has ended
contributes masked no-op steps. Each client draws from
its own generator (``fed_mesh.client_seed``), the same numbers a
single-process ``--parallel-clients`` run draws for it.

Aggregation: every rank gathers the stacked client states of the client
group (``all_gather``) and runs the sequential runner's ``aggregate`` on them
in client order, so every rank holds the same server bits, the bits a single
process computes from the same client states (a weighted ``all_reduce``
would sum in the backend's order).

Duties: every rank evaluates its clients' val splits (the first rank of each
data group), and the accuracies are gathered; rank 0 alone evaluates the
target test set, writes the JSONL log and the checkpoints (single writer);
``--resume`` reads the shared checkpoint on every rank; ``--trace-dir`` takes
a trace of each rank into its ``rank{K}`` folder. Every rank returns
(and the CLI prints) the best record with its final server's sha256.

Launch (three ranks, one a source client):
  ccst-tpu-torch fed-train --coordinator host0:1357 --num-procs 3 --proc-id 0 ...
  ccst-tpu-torch fed-train --coordinator host0:1357 --num-procs 3 --proc-id 1 ...
  ccst-tpu-torch fed-train --coordinator host0:1357 --num-procs 3 --proc-id 2 ...
or the CCST_COORDINATOR / CCST_NUM_PROCS / CCST_PROC_ID environment variables.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ccst_tpu_torch.config import FedConfig
from ccst_tpu_torch.federated.aggregate import aggregate
from ccst_tpu_torch.federated.data import build_client_data
from ccst_tpu_torch.federated.runtime import FederatedRunner
from ccst_tpu_torch.parallel import multihost
from ccst_tpu_torch.parallel.fed_mesh import (
    DataGroup,
    FedMesh,
    ParallelFedTrainer,
    client_generators,
    stack_step_batches,
    stack_trees,
    unstack_states,
    with_data_group,
)
from ccst_tpu_torch.utils.metrics import MetricsLogger


def state_digest(state: Dict[str, torch.Tensor]) -> str:
    """sha256 over a state's names and bytes, in name order: ranks that hold
    the same bits print the same digest."""
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class MultihostFedRunner(FederatedRunner):
    """The round loop over a process group (``multihost.initialize`` first):
    ``FederatedRunner``'s, with the training, the evaluation and the writes
    of this rank. Every rank holds every client's state and the server."""

    def __init__(self, cfg: FedConfig, amp_bank: Optional[np.ndarray] = None,
                 device: Any = "cuda", deterministic: bool = True):
        if cfg.mode.lower() == "deepall":
            raise SystemExit("--mode deepall pools every source into ONE pseudo-client and "
                             "cannot be split across processes; run it in one process")
        world, rank = multihost.world_size(), multihost.rank()
        n_clients = len(cfg.source_domains)
        data_shards = max(cfg.data_shards, 1)
        if world % data_shards:
            raise ValueError(f"{world} ranks do not split into data shards of {data_shards}")
        client_shards = world // data_shards
        if cfg.client_shards > 1 and cfg.client_shards != client_shards:
            raise ValueError(f"--client-shards {cfg.client_shards} with --data-shards "
                             f"{data_shards} needs {cfg.client_shards * data_shards} ranks, "
                             f"have {world}")
        if n_clients % client_shards:
            raise ValueError(f"{n_clients} source clients not divisible by {client_shards} "
                             f"client shards (PACS/OfficeHome have 3: launch 1 or 3 ranks a "
                             f"data shard)")
        self.rank = rank
        self.mesh = FedMesh(client_shards, data_shards)
        self.my_clients = list(multihost.process_clients(n_clients, client_shards,
                                                         self.mesh.client_index))
        # loaders exist for every client on every rank (path lists only); a
        # rank iterates its own clients' train and val loaders, rank 0 the test
        clients, test_loader = build_client_data(cfg)
        self.global_steps = max(len(c.train) for c in clients)
        # the mesh is this class's: the host-local runner sees one process
        super().__init__(
            dataclasses.replace(cfg, parallel_clients=False, client_shards=1, data_shards=1),
            clients=clients, test_loader=test_loader, amp_bank=amp_bank,
            logger=None if rank == 0 else MetricsLogger(None, echo=False),
            device=multihost.rank_device(device), deterministic=deterministic)
        if self.trace_dir:
            self.trace_dir = os.path.join(self.trace_dir, f"rank{rank}")
        # rank 0's initial state on every rank, whatever each rank's init drew
        self.server = multihost.replicate_tree(self.server)
        self.client_states = [self._copy(self.server) for _ in range(self.n_clients)]
        self.data = None
        step = self._train_step
        if data_shards > 1:
            self.data = DataGroup(self.mesh.data_group)
            step = self.make_step(with_data_group(self.model, self.data),
                                  data_reduce=self.data.reduce, data_gather=self.data.gather,
                                  data_size=data_shards)
        self.trainer = ParallelFedTrainer(step, cfg.mode, self.weights,
                                          n_clients=len(self.my_clients))

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        bd = self.batch_dict(batch)
        if self.data is not None:
            rows = self.data.rows(bd["images"].shape[0])
            bd = {k: v[rows] for k, v in bd.items()}
        return bd

    def _gather_clients(self, local: torch.Tensor) -> torch.Tensor:
        """(..., C_local) per-client numbers of this client shard -> (..., C)
        in client order."""
        return torch.cat(multihost.all_gather(local, self.mesh.client_group), dim=-1)

    def train_round(self, round_idx: int) -> Tuple[Dict[str, Dict[str, float]], float]:
        """This rank's clients' epochs, held to the longest client's; every
        client's state gathered to every rank, then the sequential
        aggregation."""
        cfg = self.cfg
        stacked = multihost.shard_stacked_tree(stack_trees(self.client_states), self.my_clients)
        gens = client_generators(cfg.seed, round_idx, self.my_clients)
        wait = 0.0
        for _ in range(cfg.wk_iters):
            batches = stack_step_batches([self.clients[i].train for i in self.my_clients],
                                         self._batch, self.global_steps)
            if self.amp_bank is not None:
                batches = ({**b, "amp_bank": self.amp_bank} for b in batches)
            stacked, pm = self.trainer.run_epoch(stacked, self.server, batches, gens,
                                                 n_steps=self.global_steps, data=self.data)
            wait += pm["loader_wait_seconds"]
        local = torch.tensor(np.stack([pm["loss_sum"], pm["correct"], pm["count"],
                                       pm["active"]]), dtype=torch.float64, device=self.device)
        loss, correct, count, active = self._gather_clients(local).cpu().numpy()

        gathered = multihost.all_gather_tree(stacked, self.mesh.client_group)
        everyone = [c for block in gathered for c in unstack_states(block, len(self.my_clients))]
        self.server, self.client_states = aggregate(cfg.mode, everyone, self.weights)
        metrics = {n: {"train_loss": float(v / max(a, 1.0)), "train_acc": float(c / max(k, 1.0))}
                   for n, v, a, c, k in zip(self.client_names, loss, active, correct, count)}
        return metrics, wait

    def evaluate_round(self) -> Tuple[float, float]:
        """Each client's val split on the first rank of its data group, the
        accuracies summed over the ranks; the test set on rank 0 alone."""
        eval_state = self.server_eval_state()
        val_acc = torch.zeros(self.n_clients, dtype=torch.float64, device=self.device)
        if self.mesh.data_index == 0:
            for i in self.my_clients:
                val_acc[i] = self.evaluate(eval_state, self.clients[i].val)[1]
        val_acc = multihost.all_reduce_sum(val_acc).cpu().numpy()
        test = torch.zeros(1, dtype=torch.float64, device=self.device)
        if self.rank == 0:
            test[0] = self.evaluate(eval_state, self.test_loader)[1]
        return float(val_acc.mean()), float(multihost.all_reduce_sum(test)[0])

    def save(self, round_idx: int, best: bool = False) -> None:
        if self.rank == 0:  # the single writer
            super().save(round_idx, best)

    def run(self) -> Dict[str, Any]:
        # every rank reads the same checkpoint on --resume; every rank reports
        # its server's digest: equal digests, equal bits
        return {**super().run(), "server_sha256": state_digest(self.server)}
