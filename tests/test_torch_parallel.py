"""Client-parallel training of the port (``ccst_tpu_torch/parallel/fed_mesh.py``
and the runner's ``parallel_clients`` branch) in one process, on the CPU.

- the vmapped step of C = 3 clients against each client's sequential step,
  from the same states with the same draws, for every DG method x {fedavg,
  fedprox}: every leaf within rtol 1e-5, atol 1e-6 (``ccst_tpu``'s own bar for
  its vmapped step, tests/test_parallel.py) and the loss within 1e-5. resnet4
  at 36 px, batch 4; FedDG at 33 px, batch 6 with the bank of
  ``tests/test_torch_train_ops.py``: at 36 px its outer gradient moves by
  percents when a weight moves by 1e-9 (ties in the frozen-phase view), in
  both the vmapped and the sequential step alike;
- ``ParallelFedTrainer.run_epoch`` + ``communicate`` against ``ccst_tpu``'s
  on ``from_jax`` weights, with the random transform taken out on both sides
  (JAX's ``transform_on_device=False``, the port's ``train_transform``
  patched to the identity), clients of 3 and 2 batches (the masked no-op
  steps): per-client losses within 1e-4 relative, every server leaf within
  rtol 1e-4, atol 1e-5 (three SGD steps at lr 0.05 from the same state; the
  single step of ``test_torch_train_ops.py`` holds 1e-4 / 1e-6);
- the runner's ``parallel_clients`` round against its sequential round with
  the transform taken out (no draw then differs): the same round record
  fields, losses within 1e-5, the server within rtol 1e-5, atol 1e-5 (a round
  of up to three steps, each ~1e-3 of update: the grouped convs of the
  vmapped step sum in another order, ~1e-7 a step);
- the padding of exhausted clients, the per-client seeds, the backend rule,
  and a mesh asked for in one process.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccst_tpu.federated.train_ops as jops
import ccst_tpu_torch.federated.train_ops as tops
import ccst_tpu_torch.ops.image as timg
from ccst_tpu.federated.aggregate import unstack_clients
from ccst_tpu.models.classifiers import get_network as jnet
from ccst_tpu.parallel.fed_mesh import ParallelFedTrainer as JTrainer
from ccst_tpu.parallel.fed_mesh import stack_step_batches as j_stack
from ccst_tpu_torch.config import FedConfig
from ccst_tpu_torch.data.lists import write_list
from ccst_tpu_torch.data.loader import save_image_u8
from ccst_tpu_torch.federated.runtime import FederatedRunner
from ccst_tpu_torch.models.classifiers import get_network, init_weights
from ccst_tpu_torch.models.convert_resnet import from_jax
from ccst_tpu_torch.parallel import fed_mesh, multihost
from ccst_tpu_torch.parallel.fed_mesh import (
    ParallelFedTrainer,
    client_generators,
    client_seed,
    stack_step_batches,
    stack_trees,
)
from tests.torch_parity import one_torch_thread  # noqa: F401

C = 3
DG_METHODS = ["no_DG", "RSC", "Jigsaw", "MixStyle", "feddg"]


def _states(model, n, seed=0):
    base = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    return base, [{k: (v + 0.01 * torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)))
                   if v.is_floating_point() else v.clone() for k, v in base.items()}
                  for _ in range(n)]


@pytest.mark.parametrize("mode", ["fedavg", "fedprox"])
@pytest.mark.parametrize("dg", DG_METHODS)
def test_vmapped_step_equals_sequential_steps(dg, mode):
    size, b = (33, 6) if dg == "feddg" else (36, 4)
    model = init_weights(get_network("resnet4", 4, dg), torch.Generator().manual_seed(0))
    server, states = _states(model, C)
    step = tops.make_train_step(model, n_classes=4, image_size=size, lr=0.05, dg_method=dg,
                                mode=mode, mu=0.5)
    rng = np.random.default_rng(1)
    batch = {"images": torch.from_numpy(rng.random((C, b, size, size, 3), np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 4, (C, b))),
             "mask": torch.ones(C, b)}
    batch["mask"][2, b // 2:] = 0  # padding rows in one client
    if dg == "feddg":
        batch["amp_bank"] = torch.from_numpy(
            (np.abs(np.random.default_rng(3).normal(size=(4, 3, size, size))) * 300)
            .astype(np.float32))
    trainer = ParallelFedTrainer(step, mode, [1 / C] * C)
    draws = trainer.draw(client_generators(1, 0, range(C)), batch, torch.device("cpu"))
    got, m = trainer.step(stack_trees(states), server, batch, draws, 1)
    for ci, gen in enumerate(client_generators(1, 0, range(C))):
        one = {k: (v if k == "amp_bank" else v[ci]) for k, v in batch.items()}
        want, wm = step(states[ci], server, one, gen, 1)
        np.testing.assert_allclose(float(m.loss[ci]), float(wm.loss), rtol=1e-5)
        assert float(m.correct[ci]) == float(wm.correct) and float(m.count[ci]) == float(wm.count)
        for k, v in want.items():
            if v.is_floating_point():
                np.testing.assert_allclose(got[k][ci].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=f"client {ci} {k}")
            else:
                assert torch.equal(got[k][ci], v), k


def _jax_batches(rng, n, b=4, size=36, classes=4):
    return [{"images": rng.random((b, size, size, 3), np.float32),
             "labels": rng.integers(0, classes, b).astype(np.int32),
             "mask": np.ones((b,), np.float32)} for _ in range(n)]


@pytest.mark.parametrize("mode", ["fedavg", "fedbn"])
def test_parallel_epoch_and_aggregation_match_jax(mode, monkeypatch):
    monkeypatch.setattr(tops, "train_transform", lambda draws, images, *a, **k: images)
    jmodel = jnet("resnet4", 4)
    v = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 36, 36, 3)), train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jstates = [{"params": jax.tree.map(
        lambda a: a + 0.01 * jnp.asarray(rng.normal(size=a.shape), a.dtype), v["params"]),
        "batch_stats": v["batch_stats"]} for _ in range(2)]
    stacked_j = jax.tree.map(lambda *xs: jnp.stack(xs), *jstates)
    clients = [_jax_batches(rng, 3), _jax_batches(rng, 2)]  # 3 and 2 batches: masked steps
    w = [0.5, 0.5]

    jstep = jops.make_train_step(jmodel, n_classes=4, image_size=36, lr=0.05, mode=mode,
                                 transform_on_device=False)
    jtr = JTrainer(jstep, mode, jnp.asarray(w))
    jb = j_stack([[{k: jnp.asarray(x) for k, x in b.items()} for b in c] for c in clients],
                 lambda b: b)
    jnew, jm = jtr.run_epoch(stacked_j, v["params"], jb, jax.random.PRNGKey(0))
    sp, ss, ncp, ncs = jtr.communicate(jnew["params"], jnew["batch_stats"])

    tmodel = get_network("resnet4", 4)
    tstates = [from_jax(s["params"], s["batch_stats"]) for s in jstates]
    tstep = tops.make_train_step(tmodel, n_classes=4, image_size=36, lr=0.05, mode=mode)
    ttr = ParallelFedTrainer(tstep, mode, w)
    to_t = lambda b: {"images": torch.from_numpy(b["images"]),  # noqa: E731
                      "labels": torch.from_numpy(b["labels"].astype(np.int64)),
                      "mask": torch.from_numpy(b["mask"])}
    tb = stack_step_batches(clients, to_t)
    tnew, tm = ttr.run_epoch(stack_trees(tstates), from_jax(v["params"], v["batch_stats"]), tb,
                             client_generators(1, 0, range(2)))
    assert tm["steps"] == 3 and list(tm["active"]) == [3.0, 2.0]
    np.testing.assert_allclose(tm["train_loss"], np.asarray(jm["train_loss"]), rtol=1e-4)
    np.testing.assert_allclose(tm["train_acc"], np.asarray(jm["train_acc"]), rtol=0)
    server, new_clients = ttr.communicate(tnew)
    want = from_jax(sp, ss)
    for k, v_ in want.items():
        if k.endswith("num_batches_tracked"):  # torch's own count: 3 steps of client 0
            assert int(server[k]) == 3, k
            continue
        np.testing.assert_allclose(server[k].numpy(), v_.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for ci, (p, s) in enumerate(zip(unstack_clients(ncp, 2), unstack_clients(ncs, 2))):
        want_c = from_jax(p, s)
        for k, v_ in want_c.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(new_clients[ci][k].numpy(), v_.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"client {ci} {k}")
    if mode == "fedbn":  # BN leaves stay each client's own
        assert not torch.equal(new_clients[0]["bn1.weight"], new_clients[1]["bn1.weight"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    for d, n in (("art_painting", 12), ("cartoon", 8), ("photo", 8), ("sketch", 10)):
        names, labels = [], []
        for i in range(n):
            c = i % 7
            rel = f"PACS/kfold/{d}/c{c}/img{i}.png"
            save_image_u8((rng.random((36, 36, 3), np.float32) * 0.6 + 0.05 * c),
                          os.path.join(root, rel))
            names.append(rel)
            labels.append(c)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, labels)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_test.txt"), names, labels)
    return root


def test_runner_parallel_round_matches_sequential_round(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(tops, "train_transform",
                        lambda draws, images, size, *a, **k: timg.eval_transform(images, size))
    runs = {}
    for par in (False, True):
        cfg = FedConfig(dataset="pacs", target="photo", network="resnet4", rounds=1,
                        batch_size=4, image_size=36, lr=0.05, list_root=tree, data_root=tree,
                        save_path=str(tmp_path / f"ckpt{par}"), log_path=str(tmp_path / f"l{par}"),
                        parallel_clients=par)
        runner = FederatedRunner(cfg, device="cpu")
        runs[par] = (runner.run_round(0), runner.server)
    (seq, s_server), (par, p_server) = runs[False], runs[True]
    assert sorted(seq) == sorted(par)
    assert seq["val_acc_mean"] == par["val_acc_mean"] and seq["test_acc"] == par["test_acc"]
    for k in seq:
        if k.startswith("train_"):
            np.testing.assert_allclose(par[k], seq[k], rtol=1e-5, err_msg=k)
    for k, v in s_server.items():
        np.testing.assert_allclose(p_server[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_stack_step_batches_pads_exhausted_clients():
    make = lambda i: {"images": torch.full((2, 3, 3, 3), float(i)),  # noqa: E731
                      "mask": torch.ones(2)}
    out = list(stack_step_batches([[1, 2, 3], [4]], make))
    assert len(out) == 3 and out[0]["images"].shape == (2, 2, 3, 3, 3)
    assert [float(b["images"][1, 0, 0, 0, 0]) for b in out] == [4.0, 4.0, 4.0]
    assert [float(b["mask"][1].sum()) for b in out] == [2.0, 0.0, 0.0]
    assert [float(b["mask"][0].sum()) for b in out] == [2.0, 2.0, 2.0]
    with pytest.raises(ValueError, match="no batches"):
        list(stack_step_batches([[1], []], make))
    # a fixed step count (every rank of a launch): padded past every epoch, or cut short
    fixed = list(stack_step_batches([[1, 2, 3], [4]], make, n_steps=5))
    assert [float(b["mask"].sum()) for b in fixed] == [4.0, 2.0, 2.0, 0.0, 0.0]
    assert len(list(stack_step_batches([[1, 2, 3], [4]], make, n_steps=2))) == 2


def test_client_seeds_and_draw_order():
    assert client_seed(1, 0, 2) == (1 * 100003 + 0) * 1000 + 2
    seeds = {client_seed(s, r, c) for s in (1, 2) for r in range(5) for c in range(5)}
    assert len(seeds) == 50
    # a client's draws depend on its own stream only: drawing for clients
    # {1} alone gives client 1's draws of a run over {0, 1, 2}
    model = get_network("resnet4", 4, "Jigsaw")
    step = tops.make_train_step(model, n_classes=4, image_size=36, lr=0.05, dg_method="Jigsaw")
    tr = ParallelFedTrainer(step, "fedavg", [1 / 3] * 3)
    batch = {"images": torch.zeros(3, 4, 36, 36, 3), "mask": torch.ones(3, 4)}
    all3 = tr.draw(client_generators(1, 4, range(3)), batch, torch.device("cpu"))
    one = tr.draw(client_generators(1, 4, [1]), {k: v[1:2] for k, v in batch.items()},
                  torch.device("cpu"))
    assert torch.equal(all3["orders"][1], one["orders"][0])
    assert torch.equal(all3["crop"][0][1], one["crop"][0][0])


def test_backend_rule_and_single_process_mesh(monkeypatch):
    assert multihost.choose_backend("cpu", 3)[0] == "gloo"
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.choose_backend("cuda", 3)[0] == "gloo"  # three ranks share one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.choose_backend("cuda", 3)[0] == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert multihost.choose_backend("cuda", 16)[0] == "gloo"
    mesh = fed_mesh.FedMesh(1, 1)
    assert (mesh.client_shards, mesh.data_shards, mesh.client_group) == (1, 1, None)
    with pytest.raises(SystemExit, match="--num-procs 3"):
        fed_mesh.FedMesh(3, 1)
    with pytest.raises(SystemExit, match="needs a coordinator"):
        multihost.initialize(None, 2, 0, device="cpu")
