"""The federated driver: whole FedAvg rounds of the port's ``FederatedRunner``
(``federated/runtime.py``) on a seeded JPEG tree, read by the port's loader.

Configuration keys: ``network``, ``classes``, ``target`` (the held-out test
domain), ``clients`` ({domain: train-list images}), ``test_images``,
``jpeg_side``, ``image_size``, ``batch``, ``lr``, ``save_freq``, ``val_size``.
Traffic keys: ``check_steps`` (local steps of the first client that the check
follows), ``check_round_within`` (the window round whose aggregate and
evaluation the check recomputes is drawn from the seed among the first so
many), ``ref_block``.

Set-up writes the tree under ``TMPDIR`` (images drawn on the device from the
seed, labels from the seed), makes the ResNet-50 state on the device from the
seed, builds the runner around it and runs round 0 through ``run_round``: it
warms every shape of a round (steps, the padded last batch, evaluation,
aggregation, a checkpoint) and is where the check records the first client's
first steps. The window runs rounds 1, 2, ... and closes at the first round
end after ``--seconds``.
"""
from __future__ import annotations

import concurrent.futures as cf
import gc
import os
import random
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from gpubench.harness import Run
from gpubench.reference import matmul_precision
from gpubench.reference import resnet as ref
from gpubench.reference.images import blocky_noise


def write_tree(r: Run, root: str, gen: torch.Generator) -> Dict[str, int]:
    """JPEGs ``PACS/kfold/{domain}/img{i}.jpg`` and their lists
    ``txt_lists/pacs/{domain}_train.txt`` (the clients) and
    ``{target}_test.txt``; labels drawn from the seed. Returns path -> label."""
    from PIL import Image

    counts = dict(r.param("clients"))
    counts[r.param("target")] = r.param("test_images")
    side = r.param("jpeg_side")
    rng = np.random.default_rng(r.seed)
    labels: Dict[str, int] = {}
    jobs = []
    for domain, n in counts.items():
        imgs = blocky_noise(gen, n, side).cpu().numpy()
        ys = rng.integers(0, r.param("classes"), n)
        rels = [f"PACS/kfold/{domain}/img{i}.jpg" for i in range(n)]
        os.makedirs(os.path.join(root, "PACS", "kfold", domain), exist_ok=True)
        kind = "test" if domain == r.param("target") else "train"
        lists = os.path.join(root, "txt_lists", "pacs")
        os.makedirs(lists, exist_ok=True)
        with open(os.path.join(lists, f"{domain}_{kind}.txt"), "w") as f:
            f.writelines(f"{rel} {y}\n" for rel, y in zip(rels, ys))
        for rel, img, y in zip(rels, imgs, ys):
            labels[os.path.join(root, rel)] = int(y)
            jobs.append((os.path.join(root, rel), img))
    with cf.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda j: Image.fromarray(j[1]).save(j[0], quality=90), jobs))
    return labels


class Recorder:
    """Wraps the runner's calls to keep what the check compares: the first
    client's first steps of round 0 (the state after each, the loss, the
    batch's paths), and of one window round the client states, the server
    and each evaluation's (loss, accuracy)."""

    def __init__(self, runner, steps: int):
        self.runner, self.steps = runner, steps
        self.step_states: List[Dict[str, torch.Tensor]] = []
        self.step_losses: List[torch.Tensor] = []
        self.step_batches: List[Tuple[List[str], np.ndarray, int]] = []
        self.client_states: List[Dict[str, torch.Tensor]] = []
        self.evals: List[Tuple[float, float]] = []
        self.capture_clients = False
        self._step, self._batch = runner._train_step, runner.batch_dict
        self._epoch = runner.train_client_epoch
        runner._train_step, runner.batch_dict = self.train_step, self.batch_dict
        runner.train_client_epoch = self.client_epoch
        self._evaluate = runner.evaluate
        runner.evaluate = self.evaluate

    def train_step(self, state, server, batch, generator, step_idx):
        new, m = self._step(state, server, batch, generator, step_idx)
        if len(self.step_states) < self.steps:
            self.step_states.append(new)
            self.step_losses.append(m.loss)
        return new, m

    def batch_dict(self, batch):
        if len(self.step_batches) < self.steps:
            self.step_batches.append((list(batch.paths), np.array(batch.labels), batch.valid))
        return self._batch(batch)

    def client_epoch(self, ci, state, generator):
        new, m = self._epoch(ci, state, generator)
        if self.capture_clients:
            self.client_states.append(new)
        return new, m

    def evaluate(self, state, loader):
        result = self._evaluate(state, loader)
        if self.capture_clients:
            self.evals.append(result)
        return result

    def stop_steps(self) -> None:
        self.runner._train_step, self.runner.batch_dict = self._step, self._batch


class PhaseClock:
    """Host seconds in each phase of the runner's rounds (its epochs and
    evaluations end in a read of their sums, so the host waits for the card
    there)."""

    def __init__(self, runner):
        self.seconds = {"client_epochs_s": 0.0, "evaluation_s": 0.0, "checkpoints_s": 0.0}
        for attr, key in (("train_client_epoch", "client_epochs_s"),
                          ("evaluate_round", "evaluation_s"), ("save", "checkpoints_s")):
            setattr(runner, attr, self._timed(getattr(runner, attr), key))

    def _timed(self, fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[key] += time.perf_counter() - t0
        return call


def _spans(runner) -> None:
    """``gpubench::`` spans around the runner's phases, for the trace."""
    from torch.profiler import record_function

    def spanned(name, fn):
        def call(*a, **kw):
            with record_function(f"gpubench::{name}"):
                return fn(*a, **kw)
        return call

    runner.train_client_epoch = spanned("client_epoch", runner.train_client_epoch)
    runner.evaluate_round = spanned("evaluate", runner.evaluate_round)
    runner.save = spanned("checkpoint", runner.save)
    runner.train_round = spanned("train_round", runner.train_round)


def run(r: Run) -> None:
    with tempfile.TemporaryDirectory(prefix="gpubench_fedavg_") as root:
        _run(r, root)


def _run(r: Run, root: str) -> None:
    from ccst_tpu_torch.config import FedConfig
    from ccst_tpu_torch.federated.runtime import FederatedRunner
    from ccst_tpu_torch.models.classifiers import get_network
    from ccst_tpu_torch.utils.metrics import MetricsLogger
    from ccst_tpu_torch.utils.precision import no_tf32

    gen = torch.Generator(device=r.device).manual_seed(r.seed)
    labels = write_tree(r, root, gen)
    state0 = ref.make_state(gen, r.param("classes"))
    model = get_network(r.param("network"), r.param("classes")).to(r.device)
    full = {k: state0.get(k, v) for k, v in model.state_dict().items()}
    missing = set(state0) - set(full)
    if missing:
        raise ValueError(f"leaves the port's model lacks: {sorted(missing)[:5]}")
    model.load_state_dict(full)
    cfg = FedConfig(dataset="pacs", target=r.param("target"), mode="fedavg",
                    network=r.param("network"), rounds=10 ** 9, wk_iters=1, lr=r.param("lr"),
                    batch_size=r.param("batch"), image_size=r.param("image_size"),
                    val_size=r.param("val_size"), seed=r.seed, data_root=root, list_root=root,
                    save_path=os.path.join(root, "ckpt"), log_path=os.path.join(root, "logs"),
                    save_freq=r.param("save_freq"))
    logger = MetricsLogger(os.path.join(root, "logs", "rounds.jsonl"), echo=False)
    runner = FederatedRunner(cfg, model=model, logger=logger, device=r.device,
                             deterministic=True)
    rec = Recorder(runner, r.param("check_steps"))
    n_train = sum(c.n_train for c in runner.clients)
    n_eval = sum(c.n_val for c in runner.clients) + len(runner.test_loader.paths)
    check_round = 1 + random.Random(r.seed ^ 0x5EED).randrange(r.param("check_round_within"))
    judged = {}
    with no_tf32(deterministic=True):
        runner.run_round(0)
        if r.device.type == "cuda":
            torch.cuda.synchronize()
        rec.stop_steps()
        clock = PhaseClock(runner)
        setup_s = time.perf_counter() - r.t_start

        t0 = time.perf_counter()
        rounds, wait, idx, round_s = 0, 0.0, 1, []
        rec.capture_clients = True
        while rounds == 0 or time.perf_counter() - t0 < r.seconds:
            rec.client_states, rec.evals = [], []
            record = runner.run_round(idx)
            last = {"round": idx, "server": runner.server, "record": record,
                    "clients": rec.client_states, "evals": rec.evals}
            if idx == check_round:
                judged = last
            wait += record["loader_wait_seconds"]
            round_s.append(record["seconds"])
            rounds += 1
            idx += 1
        if r.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        r.attempted, r.failed = rounds, 0
        r.end_to_end = {"train_img_s": n_train * rounds / window_s, "setup_s": setup_s}
        r.counters = {"window_s": window_s, "rounds": rounds, "loader_wait_s": wait,
                      "train_images": n_train * rounds, "eval_images": n_eval * rounds,
                      "round_s": round_s, **clock.seconds}
        judged = judged or last  # a window shorter than the drawn round: judge its last
        rec.capture_clients = False
        if r.trace:
            _trace(r, runner, idx)
    if r.device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
    val_sets = [(list(c.val.paths), np.array(c.val.labels)) for c in runner.clients]
    test_set = (list(runner.test_loader.paths), np.array(runner.test_loader.labels))
    steps = (rec.step_losses, rec.step_states, rec.step_batches)
    del rec, clock, runner, model  # the reference runs with the port's memory freed
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    check(r, state0, steps, judged, val_sets, test_set, labels)


def _trace(r: Run, runner, idx: int) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench.trace import WINDOW, reduce_profile

    _spans(runner)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if r.device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            runner.run_round(idx)
            if r.device.type == "cuda":
                torch.cuda.synchronize()
    r.counters["traced_train_steps"] = sum(len(c.train) for c in runner.clients)
    r.counters["traced_eval_steps"] = (sum(len(c.val) for c in runner.clients)
                                       + len(runner.test_loader))
    r.traced = reduce_profile(prof)


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------


def decode(paths: List[str], side: int) -> torch.Tensor:
    """(N, side, side, 3) uint8: each file decoded and resized (bilinear)
    with PIL."""
    from PIL import Image

    def one(p):
        with Image.open(p) as im:
            im = im.convert("RGB")
            if im.size != (side, side):
                im = im.resize((side, side), Image.BILINEAR)
            return np.asarray(im, dtype=np.uint8)

    with cf.ThreadPoolExecutor(8) as pool:
        return torch.from_numpy(np.stack(list(pool.map(one, paths))))


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keys) -> List[float]:
    """Each leaf's |norm of the program - norm of the reference|, over the
    larger of that leaf's reference norm and the median leaf's."""
    ref_norms = {k: float(reference[k].double().norm()) for k in keys}
    median = float(np.median(list(ref_norms.values())))
    return [abs(float(program[k].double().norm()) - ref_norms[k]) / max(ref_norms[k], median)
            for k in keys]


def follow_steps(r: Run, state0, batches, labels, dtype=torch.float64, tf32=False,
                 half_batch=False):
    """The reference's first steps from the seed's state: (the loss of each,
    the first step's gradients, the state after each)."""
    side = r.param("image_size")
    state = {k: v.to(dtype) for k, v in state0.items()}
    gen = torch.Generator().manual_seed(r.seed * 100003)
    losses, states, first = [], [], None
    with matmul_precision(tf32):
        for paths, _, _ in batches:
            images = decode(paths, side).to(r.device, dtype) / 255.0
            boxes, flips = ref.draw_crops(gen, len(paths), side)
            y = torch.tensor([labels[p] for p in paths], device=r.device)
            state, loss, grad = ref.sgd_step(state, images, y, boxes, flips, r.param("lr"), side,
                                             half_batch)
            losses.append(loss)
            states.append(state)
            first = grad if first is None else first
    return losses, first, states


def step_gaps(r: Run, state0, losses_p, states_p, reference) -> Dict[str, float]:
    """The step numbers of a program (its losses and the state after each
    step) against the reference's :func:`follow_steps`: the first step's
    loss, the first gradient by the worst leaf, and the change over the
    steps by the median leaf. Float32 alone parts the later steps' losses and
    the change of a few early BatchNorm leaves from float64 by a tenth and
    more (``PERF.md``), so those two are read where they are steady. Leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out: they move by round-off alone."""
    losses_r, grad_r, states_r = reference
    keys = ref.parameter_keys(grad_r)
    norms = {k: float(grad_r[k].norm()) for k in keys}
    median = float(np.median(list(norms.values())))
    moved = [k for k in keys if norms[k] >= 1e-3 * median]
    lr = r.param("lr")
    grad_p = {k: (state0[k].double() - states_p[0][k].double()) / lr for k in moved}
    change_p = {k: states_p[-1][k].double() - state0[k].double() for k in moved}
    change_r = {k: states_r[-1][k].double() - state0[k].double() for k in moved}
    return {
        "loss_gap": abs(losses_p[0] - losses_r[0]) / abs(losses_r[0]),
        "grad_gap": max(leaf_gaps(grad_p, grad_r, moved)),
        "update_gap_median": float(np.median(leaf_gaps(change_p, change_r, moved))),
    }


def eval_results(r: Run, server, sets, dtype=torch.float64) -> List[Tuple[float, float]]:
    """(mean loss, accuracy) of ``server`` on each (paths, labels) set, by the
    reference."""
    block, side = r.param("ref_block"), r.param("image_size")
    with matmul_precision(False):
        return [ref.evaluate(server, decode(paths, side), torch.from_numpy(labels.astype(np.int64)),
                             block, dtype) for paths, labels in sets]


def aggregate_gap(server, avg) -> float:
    """The worst leaf's |server - the mean of the clients| over |the mean|."""
    return max(float((server[k].double() - avg[k]).norm()) / max(float(avg[k].norm()), 1e-30)
               for k in avg)


def check(r: Run, state0, steps, judged, val_sets, test_set, labels) -> None:
    """The first client's first steps (their losses, the states after them,
    their batches), the judged round's aggregate and evaluations, against the
    reference."""
    step_losses, step_states, step_batches = steps
    paths = [p for b in step_batches for p in b[0]]
    for ps, ys, _ in step_batches:
        if [labels[p] for p in ps] != ys[:len(ps)].tolist():
            raise AssertionError("a recorded batch's labels are not its files' labels")
    if len(set(paths)) != len(paths):
        raise AssertionError("the checked steps' rows are not all different")
    losses_p = [float(x) for x in step_losses]
    reference = follow_steps(r, state0, step_batches, labels)
    for name, value in step_gaps(r, state0, losses_p, step_states, reference).items():
        r.check(name, value)
    server = {k: v for k, v in judged["server"].items() if v.is_floating_point()}
    avg = ref.fedavg(judged["clients"])
    r.check("aggregate_gap", aggregate_gap(server, avg))
    program = judged["evals"]  # (loss, accuracy) of each val split, then the test set
    reference = eval_results(r, server, val_sets + [test_set])
    # the loss of the target's 1,670 test images: the val splits' 51-98 images a
    # client swing more on the same rounding
    (loss_p, _), (loss_r, _) = program[-1], reference[-1]
    r.check("eval_loss_gap", abs(loss_p - loss_r) / abs(loss_r))
    r.check("eval_acc_gap", max(abs(p[1] - q[1]) for p, q in zip(program, reference)))
