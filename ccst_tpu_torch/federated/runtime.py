"""Federated training runtime: round loop, evaluation, checkpoints.

Counterpart of ``ccst_tpu/federated/runtime.py`` (the reference's main loop,
federated/fed_run.py:649-766):

  round r in [resume, rounds):
    - each client trains ``wk_iters`` local epochs from its current state
      (fresh plain SGD each round, fed_run.py:657): one client after another,
      or, with ``parallel_clients``, every client at once in one vmapped step
      (``parallel/fed_mesh.py``);
    - aggregate (fedavg / fedbn / fedprox / adafea / deepall) -> server and
      refreshed clients;
    - validate the server on every source client's val split, test it on the
      held-out target domain;
    - checkpoint ``latest`` every ``save_freq`` rounds; track ``best`` by mean
      source-val accuracy with its target-test accuracy (fed_run.py:734-766).

The state is seeded from ``cfg.seed``. In sequence, every round draws from
one ``torch.Generator`` seeded ``cfg.seed * 100003 + round_idx``, as the JAX
runtime seeds its PRNG key; in parallel, each client draws from its own
(``fed_mesh.client_seed``), so a multi-process run
(``federated/multihost_runtime.py``) draws what one process draws. The
streams differ from JAX's, so runs of the two packages agree in
distribution, not bit for bit; with the random transform taken out they agree
round for round (``tests/test_torch_runtime.py``). Float32 throughout, with
TF32 off on the card for the runner's calls, and by default cuDNN's
deterministic algorithms, so that a step gives the same bits from run to run
(``deterministic=False`` trades that for a faster step; ``PERF.md`` has the
cost).

Kept gaps of the reference: ``resume`` restores ``best`` twice; ``momentum``
and ``random_horiz_flip`` are not read. A mesh of ``client_shards *
data_shards`` > 1 ranks needs a multi-process launch; asked for in one
process it raises ``SystemExit`` naming the launch.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ccst_tpu_torch.config import FedConfig
from ccst_tpu_torch.data.loader import Batch, ImageBatchLoader
from ccst_tpu_torch.federated.aggregate import aggregate
from ccst_tpu_torch.federated.data import ClientData, build_client_data
from ccst_tpu_torch.federated.train_ops import make_eval_step, make_train_step
from ccst_tpu_torch.parallel.fed_mesh import (
    FedMesh,
    ParallelFedTrainer,
    client_generators,
    stack_step_batches,
    stack_trees,
)
from ccst_tpu_torch.models.classifiers import get_network, init_weights
from ccst_tpu_torch.models.convert_resnet import from_jax
from ccst_tpu_torch.utils.checkpoint import checkpoint_paths, load_checkpoint, save_checkpoint
from ccst_tpu_torch.utils.metrics import MetricsLogger
from ccst_tpu_torch.utils import profiling
from ccst_tpu_torch.utils.profiling import span
from ccst_tpu_torch.utils.precision import no_tf32

State = Dict[str, torch.Tensor]


def _as_state(tree: Dict[str, Any], device: torch.device) -> State:
    """A checkpoint's state on ``device``: this package's state dict, or a
    ``ccst-tpu`` {"params", "batch_stats"} tree."""
    if "params" in tree:
        tree = from_jax(tree["params"], tree.get("batch_stats", {}))
    return {k: torch.as_tensor(v).to(device) for k, v in tree.items()}


def _to_cpu(state: State) -> State:
    return {k: v.detach().cpu() for k, v in state.items()}


def batch_dict(batch: Batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch on ``dev``: uint8 images become ``x / 255`` there (u8
    transport: a quarter of the bytes; divided by a device scalar, the same
    bits as JAX's division, where a Python divisor would become a product
    with its reciprocal on the card), labels and the padding mask."""
    mask = (np.arange(batch.images.shape[0]) < batch.valid).astype(np.float32)
    imgs = torch.from_numpy(np.ascontiguousarray(batch.images)).to(dev, non_blocking=True)
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() / torch.full((), 255.0, device=dev)
    return {
        "images": imgs,
        "labels": torch.from_numpy(batch.labels.astype(np.int64)).to(dev, non_blocking=True),
        "mask": torch.from_numpy(mask).to(dev, non_blocking=True),
    }


class FederatedRunner:
    def __init__(
        self,
        cfg: FedConfig,
        model: Optional[torch.nn.Module] = None,
        clients: Optional[List[ClientData]] = None,
        test_loader: Optional[ImageBatchLoader] = None,
        amp_bank: Optional[np.ndarray] = None,
        logger: Optional[MetricsLogger] = None,
        device: Any = "cuda",
        deterministic: bool = True,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        # cuDNN's deterministic algorithms: a step gives the same bits from run
        # to run and across a --resume (its default backward does not)
        self.deterministic = deterministic
        spec = cfg.spec
        gen = torch.Generator().manual_seed(cfg.seed)
        if model is None:
            model = init_weights(get_network(cfg.network, classes=spec.num_classes,
                                             dg_method=cfg.dg_method), gen)
        self.model = model.to(self.device)
        if clients is None or test_loader is None:
            clients, test_loader = build_client_data(cfg)
        self.clients = clients
        self.test_loader = test_loader
        # deepall trains one pooled pseudo-client (clients[0]); the others
        # only supply per-domain val splits
        self.n_clients = 1 if cfg.mode.lower() == "deepall" else len(self.clients)
        self.weights = [1.0 / self.n_clients] * self.n_clients  # fed_run.py:577
        self.amp_bank = (None if amp_bank is None
                         else torch.as_tensor(np.asarray(amp_bank, np.float32)).to(self.device))

        self.run_name = (f"{cfg.dataset}_{cfg.target}_{cfg.mode}_{cfg.fusion_mode}_"
                         f"{cfg.dg_method}_{cfg.network}_seed{cfg.seed}")
        self.logger = logger or MetricsLogger(os.path.join(cfg.log_path, self.run_name + ".jsonl"))
        self.ckpt = checkpoint_paths(cfg.save_path, self.run_name)

        # the server, replicated to the clients (fed_run.py:579)
        self.server: State = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.client_states: List[State] = [self._copy(self.server) for _ in range(self.n_clients)]

        self._train_step = self.make_step(self.model)
        self._ptrainer = None
        if cfg.client_shards * cfg.data_shards > 1:
            FedMesh(cfg.client_shards, cfg.data_shards)  # raises in one process
        if cfg.parallel_clients:
            self._ptrainer = ParallelFedTrainer(self._train_step, cfg.mode, self.weights)
        # --in-test: every BatchNorm becomes an affine InstanceNorm that reuses
        # the BN weight / bias under the same names (fed_run.py:218-232)
        eval_model = self.model
        if cfg.in_test:
            if not hasattr(self.model, "with_norm"):
                raise ValueError(f"--IN_test unsupported for {cfg.network}")
            eval_model = self.model.with_norm("in").to(self.device)
        self.eval_model = eval_model
        self._eval_step = make_eval_step(eval_model, image_size=cfg.image_size)
        self.start_round = 0
        self.best: Dict[str, Any] = {"val_acc_mean": -1.0, "round": -1, "test_acc": None}
        self.trace_dir = cfg.trace_dir or None
        self.eval_loader_wait_seconds = 0.0  # evaluate()'s loader waits, reset a round

    def make_step(self, model: torch.nn.Module, **kw):
        """The configured local step of ``model`` (``train_ops.make_train_step``)."""
        cfg = self.cfg
        return make_train_step(
            model, n_classes=cfg.spec.num_classes, image_size=cfg.image_size, lr=cfg.lr,
            dg_method=cfg.dg_method, mode=cfg.mode, mu=cfg.mu, jig_weight=cfg.jig_weight,
            jigsaw_n_classes=cfg.jigsaw_n_classes, bias_whole_image=cfg.bias_whole_image,
            meta_step_size=cfg.meta_step_size, clip_value=cfg.clip_value,
            min_scale=cfg.min_scale, max_scale=cfg.max_scale, **kw)

    @staticmethod
    def _copy(state: State) -> State:
        return {k: v.clone() for k, v in state.items()}

    @property
    def client_names(self) -> List[str]:
        return [c.name for c in self.clients]

    def batch_dict(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """:func:`batch_dict` on the runner's device."""
        return batch_dict(batch, self.device)

    # ------------------------------------------------------------------
    # local training
    # ------------------------------------------------------------------

    def train_client_epoch(self, ci: int, state: State, generator: torch.Generator
                           ) -> Tuple[State, Dict[str, float]]:
        """One local epoch; the metrics stay on the device until its end.
        ``loader_wait_seconds`` is the host's time blocked on the loader."""
        with span("fed.client_epoch"):
            metrics = []
            wait = 0.0
            batches = iter(self.clients[ci].train)
            while True:
                t0 = time.perf_counter()
                with span("fed.loader_wait"):
                    batch = next(batches, None)
                wait += time.perf_counter() - t0
                if batch is None:
                    break
                with span("fed.h2d"):
                    bd = self.batch_dict(batch)
                if self.amp_bank is not None:
                    bd["amp_bank"] = self.amp_bank
                with span("fed.step"):
                    state, m = self._train_step(state, self.server, bd, generator, len(metrics))
                metrics.append(torch.stack([m.loss, m.correct, m.count]))
            n_steps = len(metrics)
            loss_sum, correct, count = (torch.stack(metrics).double().sum(0).tolist()
                                        if metrics else (0.0, 0.0, 0.0))
        return state, {"train_loss": loss_sum / max(n_steps, 1),
                       "train_acc": correct / max(count, 1.0),
                       "loader_wait_seconds": wait}

    def stacked_batches(self, loaders) -> Iterator[Dict[str, torch.Tensor]]:
        """The clients' batches stacked a local step (``fed_mesh.
        stack_step_batches``), with the FedDG bank beside them, unstacked."""
        for bd in stack_step_batches(loaders, self.batch_dict):
            if self.amp_bank is not None:
                bd["amp_bank"] = self.amp_bank
            yield bd

    def train_parallel(self, round_idx: int) -> Tuple[Dict[str, Dict[str, float]], float]:
        """``wk_iters`` local epochs of every client at once, then the
        aggregation: (train metrics a client, the host's seconds blocked on
        the loaders)."""
        stacked = stack_trees(self.client_states)
        gens = client_generators(self.cfg.seed, round_idx, range(self.n_clients))
        wait = 0.0
        for _ in range(self.cfg.wk_iters):
            batches = self.stacked_batches([self.clients[ci].train
                                            for ci in range(self.n_clients)])
            stacked, pm = self._ptrainer.run_epoch(stacked, self.server, batches, gens)
            wait += pm["loader_wait_seconds"]
        self.server, self.client_states = self._ptrainer.communicate(stacked)
        metrics = {self.clients[ci].name: {"train_loss": float(pm["train_loss"][ci]),
                                           "train_acc": float(pm["train_acc"][ci])}
                   for ci in range(self.n_clients)}
        return metrics, wait

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def evaluate(self, state: State, loader: ImageBatchLoader) -> Tuple[float, float]:
        """(mean loss, accuracy): ``test()`` (fed_run.py:214-259), one wait for
        the device at the end. Adds the host's time blocked on ``loader`` to
        ``eval_loader_wait_seconds``."""
        with span("fed.evaluate"):
            sums = []
            batches = iter(loader)
            while True:
                t0 = time.perf_counter()
                with span("fed.eval_loader_wait"):
                    b = next(batches, None)
                self.eval_loader_wait_seconds += time.perf_counter() - t0
                if b is None:
                    break
                sums.append(torch.stack(self._eval_step(state, self.batch_dict(b))))
            if not sums:
                return 0.0, 0.0
            loss_sum, correct, count = torch.stack(sums).double().sum(0).tolist()
        if count == 0:
            return 0.0, 0.0
        return loss_sum / count, correct / count

    def server_eval_state(self) -> State:
        """For fedbn the reference re-averages the clients' BN statistics into
        the server to test it (test_fedbn, fed_run.py:350-381): ``aggregate``
        already did, so this is the server."""
        return self.server

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def resume(self) -> None:
        if not os.path.exists(self.ckpt["latest"]):
            return
        payload = load_checkpoint(self.ckpt["latest"])
        self.server = _as_state(payload["server"], self.device)
        if self.cfg.mode.lower() == "fedbn" and "clients" in payload:
            self.client_states = [_as_state(c, self.device) for c in payload["clients"]]
        else:
            # fedavg-family resume restarts the clients from the server
            # (fed_run.py:627-640)
            self.client_states = [self._copy(self.server) for _ in range(self.n_clients)]
        if payload.get("best"):
            self.best = dict(payload["best"])
        self.start_round = int(payload["round"]) + 1
        self.best = payload.get("best", self.best)  # the reference's second restore, kept
        self.logger.log("resume", round=self.start_round)

    def save(self, round_idx: int, best: bool = False) -> None:
        payload: Dict[str, Any] = {"server": _to_cpu(self.server), "round": round_idx,
                                   "best": dict(self.best)}
        if self.cfg.mode.lower() == "fedbn":
            payload["clients"] = [_to_cpu(c) for c in self.client_states]
        path = self.ckpt["best" if best else "latest"]
        with span("fed.save"):
            save_checkpoint(path, payload)
        if profiling.active():
            profiling.count("fed.save_bytes", os.path.getsize(path))

    # ------------------------------------------------------------------
    # round loop
    # ------------------------------------------------------------------

    def train_round(self, round_idx: int) -> Tuple[Dict[str, Dict[str, float]], float]:
        """Every client's ``wk_iters`` local epochs, then the aggregation into
        ``server`` and ``client_states``: (train metrics a client, the host's
        seconds blocked on the loaders)."""
        cfg = self.cfg
        if self._ptrainer is not None:
            return self.train_parallel(round_idx)
        train_metrics: Dict[str, Dict[str, float]] = {}
        gen = torch.Generator().manual_seed(cfg.seed * 100003 + round_idx)
        for _ in range(cfg.wk_iters):
            for ci in range(self.n_clients):
                self.client_states[ci], m = self.train_client_epoch(
                    ci, self.client_states[ci], gen)
                train_metrics[self.clients[ci].name] = m
        wait = sum(m["loader_wait_seconds"] for m in train_metrics.values())
        with span("fed.aggregate"):
            self.server, self.client_states = aggregate(cfg.mode, self.client_states,
                                                        self.weights)
        return train_metrics, wait

    def evaluate_round(self) -> Tuple[float, float]:
        """(mean val accuracy over the source clients, target test accuracy)
        of the server."""
        eval_state = self.server_eval_state()
        val_clients = self.clients if self.cfg.mode.lower() != "deepall" else self.clients[1:]
        val_accs = [self.evaluate(eval_state, c.val)[1] for c in val_clients]
        _, test_acc = self.evaluate(eval_state, self.test_loader)
        return (float(np.mean(val_accs)) if val_accs else 0.0), test_acc

    def run_round(self, round_idx: int) -> Dict[str, Any]:
        cfg = self.cfg
        t0 = time.perf_counter()
        train_metrics, wait = self.train_round(round_idx)
        self.eval_loader_wait_seconds = 0.0
        val_acc_mean, test_acc = self.evaluate_round()
        record = {
            "round": round_idx,
            "val_acc_mean": val_acc_mean,
            "test_acc": test_acc,
            "seconds": time.perf_counter() - t0,
            "loader_wait_seconds": wait,
            "eval_loader_wait_seconds": self.eval_loader_wait_seconds,
            **{f"train_acc/{k}": v["train_acc"] for k, v in train_metrics.items()},
            **{f"train_loss/{k}": v["train_loss"] for k, v in train_metrics.items()},
        }
        self.logger.log("round", **record)

        # the best record is updated before save(latest), which embeds it
        is_best = val_acc_mean > self.best["val_acc_mean"]
        if is_best:
            self.best = {"val_acc_mean": val_acc_mean, "round": round_idx, "test_acc": test_acc}
        if round_idx % cfg.save_freq == 0 or round_idx == cfg.rounds - 1:
            self.save(round_idx)
        if is_best:
            self.save(round_idx, best=True)
            self.logger.log("best", **self.best)
        return record

    def run(self) -> Dict[str, Any]:
        from ccst_tpu_torch.utils.profiling import maybe_trace

        with no_tf32(self.deterministic):
            if self.cfg.resume:
                self.resume()
            with maybe_trace(self.trace_dir):
                for r in range(self.start_round, self.cfg.rounds):
                    self.run_round(r)
        self.logger.log("done", **self.best)
        return dict(self.best)

    # ------------------------------------------------------------------
    # test-only entry (fed_run.py:582-595)
    # ------------------------------------------------------------------

    def load_server(self, which: str = "best") -> State:
        """The server state of checkpoint ``which`` (this package's, or a
        ``ccst-tpu`` msgpack one) on the device."""
        return _as_state(load_checkpoint(self.ckpt[which])["server"], self.device)

    def test_only(self, which: str = "best") -> float:
        self.server = self.load_server(which)
        with no_tf32(self.deterministic):
            _, acc = self.evaluate(self.server_eval_state(), self.test_loader)
        self.logger.log("test_only", checkpoint=which, test_acc=acc)
        return acc
