"""A whole ``FederatedRunner`` run of the port against ``ccst_tpu``'s: 2 rounds
of resnet4 at 36 px on one synthetic PACS tree (4 domains x 12 images, 7
classes), in fedavg, fedbn and deepall, from the same initial state (JAX's,
carried across by ``from_jax``), on the same loader batches.

The random train transform is taken out in the test, in both packages
(``train_transform`` patched to ``eval_transform``; neither package is
edited), so the two runs are the same computation. Each round starts from the
same states: after a round the port takes the JAX runner's server and client
states (``from_jax``). Without that the runs drift apart by chaos, not by a
fault: after a step the states differ at float32's rounding (sums in another
order), a pre-activation that close to 0 flips its ReLU in one package only,
and BN over the 16 values a channel of a 2 x 2 layer4 amplifies it (from the
same state every step agrees, ``tests/test_torch_train_ops.py``). Per round:
val and test accuracy equal, train losses within 1e-4 relative. The port then reads the JAX run's msgpack checkpoint and gives
``test_only``'s accuracy, and resumes its own run at the next round with its
fedbn clients restored.
"""
import os

import numpy as np
import pytest
import torch

import ccst_tpu.federated.train_ops as jops
import ccst_tpu.ops.image as jimg
import ccst_tpu_torch.federated.train_ops as tops
import ccst_tpu_torch.ops.image as timg
from ccst_tpu.config import FedConfig as JFedConfig
from ccst_tpu.data.lists import write_list
from ccst_tpu.data.loader import save_image_u8
from ccst_tpu.federated.runtime import FederatedRunner as JRunner
from ccst_tpu.utils.metrics import read_rounds
from ccst_tpu_torch.config import FedConfig
from ccst_tpu_torch.federated.runtime import FederatedRunner
from ccst_tpu_torch.models.convert_resnet import from_jax

DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in several
    workers at once, and each torch's default of a thread a core oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fedtree"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names, labels = [], []
        for i in range(12):
            c = i % 7
            rel = f"PACS/kfold/{d}/c{c}/img{i}.png"
            img = rng.random((36, 36, 3), np.float32) * 0.6 + 0.05 * c
            save_image_u8(img.astype(np.float32), os.path.join(root, rel))
            names.append(rel)
            labels.append(c)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, labels)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_test.txt"), names, labels)
    return root


def _cfg(cls, tree, out, mode, **kw):
    return cls(dataset="pacs", target="photo", mode=mode, network="resnet4", rounds=2,
               batch_size=4, image_size=36, lr=0.01, list_root=tree, data_root=tree,
               save_path=os.path.join(out, "ckpt"), log_path=os.path.join(out, "logs"),
               save_freq=1, **kw)


def _no_random_transform(monkeypatch):
    monkeypatch.setattr(jops, "train_transform",
                        lambda key, images, size, *a, **k: jimg.eval_transform(images, size))
    monkeypatch.setattr(tops, "train_transform",
                        lambda gen, images, size, *a, **k: timg.eval_transform(images, size))


def _rounds(runner):
    return [r for r in read_rounds(runner.logger.path) if r["event"] == "round"]


@pytest.mark.parametrize("mode", ["fedavg", "fedbn", "deepall"])
def test_runner_matches_jax_round_for_round(tree, tmp_path, monkeypatch, mode):
    _no_random_transform(monkeypatch)
    jr = JRunner(_cfg(JFedConfig, tree, str(tmp_path / "jax"), mode))
    tr = FederatedRunner(_cfg(FedConfig, tree, str(tmp_path / "torch"), mode), device="cpu")
    tr.server = from_jax(jr.server["params"], jr.server["batch_stats"])
    tr.client_states = [dict(tr.server) for _ in range(tr.n_clients)]
    assert tr.client_names == jr.client_names and tr.n_clients == jr.n_clients
    for r in range(2):
        b, a = jr.run_round(r), tr.run_round(r)
        assert a["val_acc_mean"] == b["val_acc_mean"] and a["test_acc"] == b["test_acc"], (a, b)
        losses = [k for k in b if k.startswith("train_loss/")]
        assert losses and sorted(losses) == sorted(k for k in a if k.startswith("train_loss/"))
        for k in losses:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"round {r} {k}")
        tr.server = from_jax(jr.server["params"], jr.server["batch_stats"])
        tr.client_states = [from_jax(c["params"], c["batch_stats"]) for c in jr.client_states]
    assert [r["round"] for r in _rounds(tr)] == [r["round"] for r in _rounds(jr)] == [0, 1]
    assert tr.best == jr.best and jr.best["round"] >= 0
    if mode == "fedavg":
        # the port reads the JAX run's msgpack checkpoint and tests it alike
        reader = FederatedRunner(_cfg(FedConfig, tree, str(tmp_path / "jax"), mode), device="cpu")
        assert reader.test_only("best") == jr.test_only("best") == jr.best["test_acc"]


def test_resume_restores_round_best_and_fedbn_clients(tree, tmp_path):
    cfg = _cfg(FedConfig, tree, str(tmp_path), "fedbn")
    first = FederatedRunner(cfg, device="cpu")
    best = first.run()
    cfg3 = _cfg(FedConfig, tree, str(tmp_path), "fedbn", resume=True)
    cfg3.rounds = 3
    second = FederatedRunner(cfg3, device="cpu")
    second.resume()
    assert second.start_round == 2 and second.best == best
    for a, b in zip(second.client_states, first.client_states):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(second.client_states[0]["bn1.weight"],
                           second.client_states[1]["bn1.weight"])
    second.run()
    rounds = _rounds(second)
    assert [r["round"] for r in rounds] == [0, 1, 2]  # one log: two rounds, then the resumed one
    events = [r["event"] for r in read_rounds(second.logger.path)]
    assert events.count("resume") == 2  # the explicit call and run()'s
    assert all(np.isfinite(r[k]) for r in rounds for k in r if k.startswith("train_loss/"))


def test_parallel_flags_are_refused(tree, tmp_path):
    """The flags of a mesh of more than one rank are refused in one process,
    naming the launch that provides the ranks."""
    for kw in ({"client_shards": 2}, {"data_shards": 2},
               {"parallel_clients": True, "client_shards": 3}):
        with pytest.raises(SystemExit, match="--num-procs"):
            FederatedRunner(_cfg(FedConfig, tree, str(tmp_path), "fedavg", **kw), device="cpu")


def test_parallel_clients_build_a_vmapped_trainer(tree, tmp_path):
    runner = FederatedRunner(_cfg(FedConfig, tree, str(tmp_path), "fedavg",
                                  parallel_clients=True), device="cpu")
    assert runner._ptrainer is not None and runner._ptrainer.n_local == runner.n_clients


@pytest.mark.parametrize("deterministic", [True, False])
def test_runner_asks_cudnn_for_deterministic_algorithms(tree, tmp_path, monkeypatch,
                                                        deterministic):
    """F3: the runner's calls run under cuDNN's deterministic mode unless
    asked not to; the mode is restored afterwards."""
    from contextlib import contextmanager

    import ccst_tpu_torch.federated.runtime as rt

    seen, real = [], rt.no_tf32

    @contextmanager
    def spy(det=False):
        with real(det):
            seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32))
            yield

    monkeypatch.setattr(rt, "no_tf32", spy)
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    cfg = _cfg(FedConfig, tree, str(tmp_path), "fedavg")
    cfg.rounds = 1
    FederatedRunner(cfg, device="cpu", deterministic=deterministic).run()
    assert seen and set(seen) == {(deterministic or before[0], False)}
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == before
