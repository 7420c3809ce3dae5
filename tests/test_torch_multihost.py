"""Multi-process runs of the port on ``torch.distributed``, on the CPU.

Each test spawns its ranks as processes (``tests/torch_multihost_worker.py``,
which imports only the port, or the port's CLI) with the gloo backend, a
``file://`` store under ``tmp_path`` (no TCP port for pytest's workers to race
for) and one thread a rank:

- ``fed-train``'s multi-process runner, three ranks (one source client each)
  for a round against the single-process ``--parallel-clients`` runner of
  the same config, random transform on: server and clients bit-equal on
  every rank; against the single process, per leaf the median |d_ranks -
  d_single| of the round's update at most 1e-3 of its largest |d_single|
  (the ReLU-tie rule of chip_smoke.py's phase 7), the round's losses within
  1e-4, the same val accuracy. A leaf-wise bar does not hold at this size: a
  rank steps its one client through the plain conv, the single process all
  three through one grouped conv, and on the client whose batch repeats its
  rows the two float32 gradients differ by 2% of the update in one step
  (float64 sides with the grouped one), which later steps amplify; only
  rank 0 writes the log and the checkpoints; ``--trace-dir`` gets a trace of
  every rank;
- the CLI launch of three ranks for two rounds, the uneven client split,
  ``deepall``'s refusal, and ``invert-train``'s launch of two ranks (each its
  strided shard);
- ``data_shards = 2``: two ranks splitting every client's batch (GroupBatchNorm
  and the summed gradients) against ``ccst_tpu``'s runner over a (client 1,
  data 2) mesh from the same state, the random transform taken out on both
  sides, one step a client: every server leaf within the one-step bar of
  ``tests/test_torch_train_ops.py`` (rtol 1e-4, atol 1e-6; running
  statistics 1e-5); and two steps of fedprox (its term from the second)
  against ccst_tpu's single-device parallel run by that bar and its mesh by
  medians (the test's docstring);
- ``welford_psum`` over two ranks against ``ccst_tpu``'s under ``shard_map``
  on two of the eight CPU devices of ``tests/conftest.py``;
- ``train_decoder`` and ``train_inverter`` with ``mesh`` a group of two ranks
  against ``ccst_tpu``'s with ``mesh=Mesh(2 CPU devices, ("data",))``, by the
  Adam rule of ``tests/test_torch_invert.py`` (a first Adam update is +-lr
  wherever |g| >> eps: per leaf the median difference at most 1e-3 lr a step,
  the largest 2 lr a step) and the losses within 1e-3; then one step of each
  trainer over the group: bit-equal on both ranks, and within the same rule
  of a single-process step on the two ranks' rows joined; and
  ``adain_train_step(..., group)`` against JAX's with ``axis_name`` under
  ``shard_map`` by ``tests/test_torch_adain_net.py``'s SGD bar.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccst_tpu.federated.train_ops as jops
import ccst_tpu.ops.image as jimg
from ccst_tpu.config import FedConfig as JFedConfig
from ccst_tpu.federated.runtime import FederatedRunner as JRunner
from ccst_tpu_torch.cli import main as torch_cli
from ccst_tpu_torch.config import FedConfig
from ccst_tpu_torch.data.lists import write_list
from ccst_tpu_torch.data.loader import save_image_u8
from ccst_tpu_torch.federated.runtime import FederatedRunner
from ccst_tpu_torch.models.convert_resnet import from_jax
from ccst_tpu_torch.utils.metrics import read_rounds
from tests.torch_parity import one_torch_thread, pinned_io_tier  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]
RANK_ENV = {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _tree(root, counts, side=36):
    rng = np.random.default_rng(0)
    for d, n in zip(DOMAINS, counts):
        names, labels = [], []
        for i in range(n):
            c = i % 7
            rel = f"PACS/kfold/{d}/c{c}/img{i}.png"
            save_image_u8((rng.random((side, side, 3), np.float32) * 0.6 + 0.05 * c),
                          os.path.join(root, rel))
            names.append(rel)
            labels.append(c)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, labels)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_test.txt"), names, labels)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Source clients of 11, 8 and 12 train images after the val split: 3, 2
    and 3 batches of 4, so the second client pads its third step. No batch
    holds a single real image: its padding repeats that image, and BatchNorm
    over copies of one image (the 2 x 2 planes of layer4 at 36 px) turns the
    1e-7 by which a vmapped step differs from another into 1e-3 in a step,
    whichever way the clients are stacked."""
    return _tree(str(tmp_path_factory.mktemp("pacs")), (12, 8, 8, 13))


def _spawn(argv_of, world, timeout=300):
    procs = [subprocess.Popen(argv_of(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=RANK_ENV, text=True) for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        outs.append((p.returncode, out, err))
    return outs


def _ranks(case, world, out, args):
    os.makedirs(out, exist_ok=True)
    init = f"file://{os.path.join(out, 'store')}"
    outs = _spawn(lambda r: [sys.executable, WORKER, case, init, str(world), str(r), out,
                             json.dumps(args)], world)
    for rc, stdout, err in outs:
        assert rc == 0, f"rank failed:\n{stdout[-2000:]}\n{err[-4000:]}"
        assert "backend gloo (ranks on the CPU)" in stdout
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _fed_args(tree, out, rounds=2, **kw):
    return dict(dataset="pacs", target="photo", network="resnet4", rounds=rounds, batch_size=4,
                image_size=36, lr=0.05, list_root=tree, data_root=tree,
                save_path=os.path.join(out, "ckpt"), log_path=os.path.join(out, "logs"),
                save_freq=1, **kw)


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_three_ranks_equal_the_single_process_parallel_run(tree, tmp_path):
    trace = tmp_path / "mh" / "trace"
    ranks = _ranks("fed", 3, str(tmp_path / "mh"), _fed_args(tree, str(tmp_path / "mh"),
                                                              rounds=1, trace_dir=str(trace)))
    assert [r["my_clients"] for r in ranks] == [[0], [1], [2]]
    assert all((trace / f"rank{r}" / "trace.json").exists() for r in range(3))
    for r in ranks[1:]:
        assert _same(r["server"], ranks[0]["server"]) and r["best"] == ranks[0]["best"]
        assert all(_same(a, b) for a, b in zip(r["clients"], ranks[0]["clients"]))
    single = FederatedRunner(FedConfig(**_fed_args(tree, str(tmp_path / "sp"), rounds=1,
                                                   parallel_clients=True)), device="cpu")
    start = {k: v.clone() for k, v in single.server.items()}
    single.run()
    for k, v in single.server.items():
        if not v.is_floating_point():
            assert torch.equal(ranks[0]["server"][k], v), k
            continue
        want, got = v.double() - start[k].double(), ranks[0]["server"][k].double() - start[k]
        assert float((got - want).abs().median()) <= 1e-3 * float(want.abs().max()), k
    run = "pacs_photo_fedavg_no_fusion_no_DG_resnet4_seed1"
    logs = os.listdir(str(tmp_path / "mh" / "logs"))
    assert logs == [run + ".jsonl"]  # one writer
    got = [r for r in read_rounds(str(tmp_path / "mh" / "logs" / logs[0])) if r["event"] == "round"]
    want = [r for r in read_rounds(single.logger.path) if r["event"] == "round"]
    assert [r["round"] for r in got] == [0] and sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        if k.startswith("train_loss/"):
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4, err_msg=k)
    assert got[0]["val_acc_mean"] == want[0]["val_acc_mean"]
    assert os.path.exists(str(tmp_path / "mh" / "ckpt" / (run + "_latest.ckpt")))


def _cli(tree, out, *extra):
    return [sys.executable, "-m", "ccst_tpu_torch.cli", "fed-train",
            *sum(([f"--{k.replace('_', '-')}", str(v)] for k, v in _fed_args(tree, out).items()),
                 []), "--device", "cpu", *extra]


def test_cli_launch_and_its_rules(tree, tmp_path):
    init = f"file://{tmp_path / 'store'}"
    out = str(tmp_path / "cli")
    outs = _spawn(lambda r: _cli(tree, out, "--coordinator", init, "--num-procs", "3",
                                 "--proc-id", str(r), "--client-shards", "3"), 3)
    results = []
    for rc, stdout, err in outs:
        assert rc == 0, err[-3000:]
        assert "backend gloo" in stdout
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    assert results[0] == results[1] == results[2] and results[0]["round"] in (0, 1)
    assert len(results[0]["server_sha256"]) == 64  # the same server bits on every rank
    log = os.path.join(out, "logs", "pacs_photo_fedavg_no_fusion_no_DG_resnet4_seed1.jsonl")
    assert [r["round"] for r in read_rounds(log) if r["event"] == "round"] == [0, 1]
    # three clients over two ranks do not split evenly
    init2 = f"file://{tmp_path / 'store2'}"
    outs = _spawn(lambda r: _cli(tree, str(tmp_path / "uneven"), "--coordinator", init2,
                                 "--num-procs", "2", "--proc-id", str(r)), 2)
    assert all(rc != 0 and "not divisible by 2 client shards" in err for rc, _, err in outs)
    with pytest.raises(SystemExit, match="deepall"):
        torch_cli(["fed-train", "--mode", "deepall", "--num-procs", "2", "--device", "cpu"])


def _data_shards_against_jax(tmp_path, monkeypatch, per_domain, steps, data_shards,
                             rank_args=None, **kw):
    """One round of ``steps`` batches of 8 a client from the same state: two
    ranks of the port splitting each batch, and ccst_tpu's parallel runner
    over a (client 1, data ``data_shards``) mesh. ``rank_args`` go to the
    ranks' worker only. Returns (start, the ranks' server, ccst_tpu's
    server), all in the port's names."""
    root = _tree(str(tmp_path / "tree"), (per_domain,) * 4)
    monkeypatch.setattr(jops, "train_transform",
                        lambda key, images, size, *a, **k: jimg.eval_transform(images, size))
    args = _fed_args(root, str(tmp_path / "jax"), rounds=1, **kw)
    args["batch_size"] = 8
    jr = JRunner(JFedConfig(**args, parallel_clients=True, client_shards=1,
                            data_shards=data_shards))
    assert {len(c.train) for c in jr.clients} == {steps}
    start = from_jax(jr.server["params"], jr.server["batch_stats"])
    torch.save(start, str(tmp_path / "start.pt"))
    jr.run_round(0)
    out = str(tmp_path / "mh")
    targs = dict(args, save_path=os.path.join(out, "ckpt"), log_path=os.path.join(out, "logs"),
                 data_shards=2, start=str(tmp_path / "start.pt"), **(rank_args or {}))
    ranks = _ranks("fed", 2, out, targs)
    assert _same(ranks[0]["server"], ranks[1]["server"])
    for k, v in ranks[0]["server"].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == steps, k
    return start, ranks[0]["server"], from_jax(jr.server["params"], jr.server["batch_stats"])


def _leafwise(got, want):
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-5, atol=1e-5) if "running" in k else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **tol, err_msg=k)


def test_data_shards_match_jax_client_data_mesh(tmp_path, monkeypatch):
    """One batch of 8 a client (8 images a domain): one local step each."""
    _, got, want = _data_shards_against_jax(tmp_path, monkeypatch, 8, 1, 2)
    _leafwise(got, want)


@pytest.mark.parametrize("data_shards", [1, 2])
def test_data_shards_fedprox_two_steps_match_jax(tmp_path, monkeypatch, data_shards):
    """FedProx, whose term enters at the second local step (17 images a
    domain: two full batches of 8 a client after the val split); mu = 10
    makes the proximal pull lr * mu = 0.5 of the first step's move, so a rank
    that adds a 1/D share of it after the group sum misses both bars.
    Against ccst_tpu's single-device parallel run (the global
    batch): every leaf within the one-step bar. Against its (client 1,
    data 2) mesh: per leaf the median |d_ranks - d_jax| at most 1e-2 of
    max |d_jax| of the update, because at the second step that mesh leaves
    its own single-device run by more than the one-step bar, BN biases
    first, in fedavg and fedprox alike (ROADMAP Queue 3)."""
    start, got, want = _data_shards_against_jax(tmp_path, monkeypatch, 17, 2, data_shards,
                                                mode="fedprox", mu=10.0)
    if data_shards == 1:
        _leafwise(got, want)
        return
    for k, v in want.items():
        if "running" in k or not v.is_floating_point():
            continue
        d = v.double() - start[k].double()
        err = float((got[k].double() - v.double()).abs().median())
        assert err <= 1e-2 * float(d.abs().max()), (k, err, float(d.abs().max()))


def test_welford_psum_over_two_ranks_matches_jax(tmp_path):
    from jax.sharding import Mesh, PartitionSpec as P

    from ccst_tpu.ops.welford import welford_init, welford_psum, welford_update

    chunks = np.random.default_rng(0).normal(3.0, 2.0, (2, 2, 5, 7, 64)).astype(np.float32)
    chunks[1] = chunks[1] * 1.5 + 1.0  # the second rank's population differs
    np.save(str(tmp_path / "chunks.npy"), chunks)
    ranks = _ranks("welford", 2, str(tmp_path / "w"), {"chunks": str(tmp_path / "chunks.npy")})
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def merged(x):
        return tuple(welford_psum(welford_update(welford_init(64), x[0]), "data"))

    want = jax.jit(jax.shard_map(merged, mesh=mesh, in_specs=P("data"), out_specs=P(),
                                 check_vma=False))(jnp.asarray(chunks))
    for r in ranks:
        for got, exp, name in zip(r["psum"], want, ("count", "mean", "m2")):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        assert float(r["psum"][0]) == 2 * 2 * 5 * 7
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["psum"], ranks[1]["psum"]))


# ---- the VGG trainers' mesh --------------------------------------------------

IMG, LR = 32, 1e-4


@pytest.fixture(scope="module")
def vgg_tree(tmp_path_factory):
    from ccst_tpu.models import convert as jconvert
    from ccst_tpu.models import vgg as jvgg

    root = _tree(str(tmp_path_factory.mktemp("vgg")), (12, 6, 6, 6), side=40)
    enc = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH))
    dec = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH))
    jconvert.save_npz(os.path.join(root, "enc.npz"), enc)
    jconvert.save_npz(os.path.join(root, "dec.npz"), dec)
    return root


def _adam_close(got, want, lr, steps, name):
    err = (torch.as_tensor(np.array(got)).double() - torch.as_tensor(np.array(want)).double()
           ).abs()
    assert float(err.median()) <= 1e-3 * lr * steps and float(err.max()) <= 2 * lr * steps, \
        (name, float(err.median()), float(err.max()))


def test_train_decoder_mesh_of_two_ranks_matches_jax(vgg_tree, tmp_path):
    from jax.sharding import Mesh

    from ccst_tpu.models import convert as jconvert
    from ccst_tpu.pipeline.train_decoder import DecoderTrainConfig as JCfg
    from ccst_tpu.pipeline.train_decoder import train_decoder as j_train
    from ccst_tpu_torch.models import vgg as tvgg
    from ccst_tpu_torch.models.convert import load_decoder, load_encoder
    from ccst_tpu_torch.pipeline.train_decoder import DecoderTrainConfig, DecoderTrainer

    steps = 2
    args = dict(dataset="pacs", list_root=vgg_tree, data_root=vgg_tree, image_size=IMG,
                batch_size=2, steps=steps, lr=LR, domains="art_painting,cartoon,sketch",
                vgg_weights=os.path.join(vgg_tree, "enc.npz"),
                init_decoder=os.path.join(vgg_tree, "dec.npz"))
    want = j_train(JCfg(**args, out_path=str(tmp_path / "jax.npz")),
                   mesh=Mesh(np.array(jax.devices()[:2]), ("data",)))
    ranks = _ranks("decoder", 2, str(tmp_path / "mh"), dict(args,
                                                            out_path=str(tmp_path / "t.npz")))
    for k in ("final_loss_c", "final_loss_s"):
        np.testing.assert_allclose(ranks[0]["report"][k], want[k], rtol=1e-3)
    ours, theirs = jconvert.load_decoder(str(tmp_path / "t.npz")), jconvert.load_decoder(
        str(tmp_path / "jax.npz"))
    for name in theirs:
        for k in ("w", "b"):
            _adam_close(ours[name][k], theirs[name][k], LR, steps, f"{name}.{k}")
    # one step over the group: the same bits on both ranks, and the step of
    # one process on the joined batch
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for name, p in ranks[0]["params"].items():
        for k in ("w", "b"):
            assert torch.equal(torch.as_tensor(p[k]), torch.as_tensor(ranks[1]["params"][name][k]))
    cfg = DecoderTrainConfig(**args)
    single = DecoderTrainer(cfg, load_encoder(cfg.vgg_weights), load_decoder(cfg.init_decoder),
                            "cpu")
    rng = lambda s: torch.from_numpy(np.random.default_rng(s).random(  # noqa: E731
        (2, IMG, IMG, 3), np.float32))
    lc, ls = single.step(rng(7), rng(8))
    np.testing.assert_allclose(ranks[0]["losses"], (float(lc), float(ls)), rtol=1e-5)
    mine = tvgg.params_from_trainable(single.decoder)
    for name in mine:
        for k in ("w", "b"):
            _adam_close(ranks[0]["params"][name][k], mine[name][k], LR, 1, f"{name}.{k}")
    # adain_train_step over the group against JAX's with axis_name over two devices
    from jax.sharding import PartitionSpec as P

    from ccst_tpu.models import adain_net as jnet

    enc, dec = (jconvert.load_encoder(args["vgg_weights"]),
                jconvert.load_decoder(args["init_decoder"]))
    jdec, jloss = jax.jit(jax.shard_map(
        lambda c, s: jnet.adain_train_step(enc, dec, c, s, axis_name="data"),
        mesh=Mesh(np.array(jax.devices()[:2]), ("data",)), in_specs=(P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False))(jnp.asarray(rng(7).numpy()),
                                                jnp.asarray(rng(8).numpy()))
    assert ranks[0]["sgd_loss"] == ranks[1]["sgd_loss"]
    np.testing.assert_allclose(ranks[0]["sgd_loss"], float(jloss), rtol=1e-4)
    for name in dec:
        for k in ("w", "b"):
            step = np.asarray(jdec[name][k]) - np.asarray(dec[name][k])
            got = np.asarray(ranks[0]["sgd_params"][name][k])
            assert np.array_equal(got, np.asarray(ranks[1]["sgd_params"][name][k]))
            err = np.abs(got - np.asarray(jdec[name][k])).max()
            assert err <= 1e-4 * np.abs(step).max() + 1e-7, (name, k, err)


def test_train_inverter_mesh_of_two_ranks_matches_jax(vgg_tree, tmp_path, monkeypatch):
    from jax.sharding import Mesh

    from ccst_tpu.privacy import generator as jgen
    from ccst_tpu.privacy import invert as jinv
    from ccst_tpu_torch.privacy import generator as tgen
    from ccst_tpu_torch.privacy import invert as tinv
    from ccst_tpu_torch.utils.checkpoint import load_checkpoint
    from tests.torch_parity import jit_flax_init

    jit_flax_init(monkeypatch)
    steps, lr = 2, 2e-4
    args = dict(dataset="pacs", source="art_painting", list_root=vgg_tree, data_root=vgg_tree,
                image_size=IMG, batch_size=2, steps=steps, lr=lr,
                vgg_weights=os.path.join(vgg_tree, "enc.npz"))
    want = jinv.train_inverter(jinv.InvertConfig(**args, out_dir=str(tmp_path / "jax")),
                               mesh=Mesh(np.array(jax.devices()[:2]), ("data",)))
    # the port starts from JAX's initial parameters (the worker loads them)
    init = jax.jit(lambda k: jgen.StyleInverter(image_size=IMG).init(
        k, jnp.zeros((1, 1024)), train=False)["params"])(jax.random.PRNGKey(1))
    torch.save(tgen.from_flax(jax.tree.map(np.asarray, init)), str(tmp_path / "init.pt"))
    ranks = _ranks("inverter", 2, str(tmp_path / "mh"),
                   dict(args, out_dir=str(tmp_path / "torch"), init=str(tmp_path / "init.pt")))
    np.testing.assert_allclose(ranks[0]["report"]["final_loss"], want["final_loss"], rtol=1e-3)
    assert ranks[0]["report"]["step"] == want["step"] == steps - 1
    ours = load_checkpoint(ranks[0]["report"]["checkpoint"])["params"]
    theirs = tgen.from_flax(load_checkpoint(want["checkpoint"])["params"])
    for k, v in theirs.items():
        _adam_close(ours[k], v, lr, steps, k)
    # one step over the group against one process on the joined batch
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert _same(ranks[0]["params"], ranks[1]["params"])
    cfg = tinv.InvertConfig(**args)
    model = tgen.StyleInverter(image_size=IMG)
    model.load_state_dict(torch.load(str(tmp_path / "init.pt")))
    enc = tinv._encoder_params(cfg)
    single = tinv.InverterTrainer(cfg, enc, "cpu", model=model)
    images = torch.from_numpy(np.random.default_rng(9).random((2, IMG, IMG, 3), np.float32))
    with torch.no_grad():
        z = tinv.style_vector(tinv.vgg.prepare_params(enc, torch.bfloat16, "cpu"), images)
    np.testing.assert_allclose(ranks[0]["loss"], float(single.step(images, z)), rtol=1e-5)
    for k, v in single.model.state_dict().items():
        _adam_close(ranks[0]["params"][k], v, lr, 1, k)


def test_invert_train_cli_launch_of_two_ranks(vgg_tree, tmp_path):
    """Each rank trains on its strided shard; both print the same result,
    rank 0 writes the checkpoint."""
    init = f"file://{tmp_path / 'store'}"
    out = str(tmp_path / "inv")
    outs = _spawn(lambda r: [
        sys.executable, "-m", "ccst_tpu_torch.cli", "invert-train", "--dataset", "pacs",
        "--source", "art_painting", "--list-root", vgg_tree, "--data-root", vgg_tree,
        "--image-size", str(IMG), "--batch-size", "2", "--steps", "2",
        "--vgg-weights", os.path.join(vgg_tree, "enc.npz"), "--out-dir", out,
        "--coordinator", init, "--num-procs", "2", "--proc-id", str(r), "--device", "cpu"], 2)
    results = []
    for rc, stdout, err in outs:
        assert rc == 0, err[-3000:]
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    for k in ("psnr", "step", "final_loss", "checkpoint"):
        assert results[0][k] == results[1][k], k
    assert np.isfinite(results[0]["final_loss"]) and os.path.exists(results[0]["checkpoint"])
