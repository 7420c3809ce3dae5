"""The port's semantic validation (``ccst_tpu_torch/experiments/
semantic_validation.py``) against the JAX project's
``experiments/semantic_validation.py``, module by module, on the CPU at a
tiny size (32 px, 2 images a class, 2 steps, 1 round); ``run_chain`` is in
``test_torch_experiments_chain.py``.

- ``make_shapes_dataset``: the same decoded pixels, the list files byte for byte;
- ``make_experiment_encoder`` from the JAX initial weights: every leaf within
  rtol 1e-4 of the LSUV rescale in float64, and within ``ccst_tpu``'s own
  distance from float64 plus that of ``ccst_tpu``'s (whose float32 ``jnp.std``
  over a layer's activations is up to ~3e-4 off on the CPU);
- ``pretrain_encoder``, two steps of both from the same encoder, decoder,
  head, batches and tints, then each of the port's steps against the JAX step
  handed the port's weights and Adam moments before it: the three losses
  within rtol 1e-4, and per leaf median |d_port - d_jax| at most 1e-2 of median
  |d_jax| (ROADMAP's "Adam near eps" rule; whole runs part, the test says why);
- ``_paired_orderings`` on the JAX artifact's per-arm results: equal;
- the slice: the port's ``run`` on ``--device cpu`` writes the JAX artifact's
  keys, the device and the stages' seconds, carries over what it has already
  measured, never from another device; without a card, ``--device cuda`` (the
  default) is an error, and the default artifact is the port's own.
"""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ccst_tpu.config as jconfig
import ccst_tpu_torch.config as tconfig
from ccst_tpu.data.loader import load_image
from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu_torch.experiments import semantic_validation as tsv
from experiments import semantic_validation as jsv
from tests.torch_parity import one_torch_thread, pinned_io_tier  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, N_PER_CLASS, SEED = 32, 2, 1


@pytest.fixture(scope="module", autouse=True)
def shapes4_registered():
    """``shapes4`` in both registries for this module only."""
    saved = dict(jconfig.DATASETS), dict(tconfig.DATASETS)
    jsv._register(SIZE)
    tsv._register(SIZE)
    yield
    for reg, old in zip((jconfig.DATASETS, tconfig.DATASETS), saved):
        reg.clear()
        reg.update(old)


def _dataset(root, module):
    module.make_shapes_dataset(root, SIZE, N_PER_CLASS, seed=SEED)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("shapes4")
    return {tag: _dataset(str(base / tag), mod) for tag, mod in (("jax", jsv), ("torch", tsv))}


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_shapes_dataset_matches_jax(roots):
    files = _files(roots["jax"])
    assert files == _files(roots["torch"])
    pngs = [f for f in files if f.endswith(".png")]
    lists = [f for f in files if f.endswith(".txt")]
    assert len(pngs) == 4 * 4 * N_PER_CLASS and len(lists) == 8
    for f in pngs:
        a, b = (load_image(os.path.join(roots[t], f), dtype="uint8") for t in ("jax", "torch"))
        assert a.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in lists:
        assert filecmp.cmp(os.path.join(roots["jax"], f), os.path.join(roots["torch"], f),
                           shallow=False), f


def _probes(root):
    return np.stack([load_image(os.path.join(root, f"SHAPES4/kfold/{d}/{c}/img000.png"), SIZE)
                     for d in jsv.DOMAINS[:-1] for c in jsv.CLASSES])


@pytest.fixture(scope="module")
def jax_encoder(roots):
    return jax.tree.map(np.asarray, jsv.make_experiment_encoder(_probes(roots["jax"])))


def _lsuv_float64(init, probes):
    """The LSUV rescale in float64 (torch on the CPU): the exact reference."""
    enc = {n: {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in p.items()}
           for n, p in init.items()}
    h = torch.from_numpy(probes.astype(np.float64)).permute(0, 3, 1, 2)
    for layer in jvgg.ENCODER_ARCH:
        if isinstance(layer, jvgg.Conv):
            p = enc[layer.name]
            x = torch.nn.functional.pad(h, (1, 1, 1, 1), mode="reflect") if layer.ksize == 3 else h
            pre = torch.nn.functional.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"])
            pre = torch.relu(pre) if layer.relu else pre
            s = float(pre.std(correction=0)) + 1e-8
            p["w"], p["b"], h = p["w"] / s, p["b"] / s, pre / s
            if layer.name == "conv4_1":
                return enc
        elif isinstance(layer, jvgg.Pool):
            h = torch.nn.functional.max_pool2d(h, 2, ceil_mode=True)


def test_experiment_encoder_matches_jax(roots, jax_encoder):
    """The port against the float64 LSUV at rtol 1e-4. ``ccst_tpu``'s own
    float32 ``jnp.std`` over a layer's ~10^6 activations is off float64 by up
    to ~3e-4 on the CPU (XLA sums them in one float32 run; torch's reduction is
    exact to ~1e-8), and each layer's scale carries the ones before it: so the
    port is held to float64 at the bar, and to ``ccst_tpu`` within ``ccst_tpu``'s
    own distance from float64 plus the bar."""
    init = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(0), jvgg.ENCODER_ARCH))
    probes = _probes(roots["torch"])
    got = tsv.make_experiment_encoder(probes, device="cpu", init=init)
    exact = _lsuv_float64(init, probes)
    assert sorted(got) == sorted(jax_encoder) == sorted(exact)
    for name in jax_encoder:
        for k in ("w", "b"):
            ours, theirs, want = got[name][k].numpy(), jax_encoder[name][k], exact[name][k].numpy()
            np.testing.assert_allclose(ours, want, rtol=1e-4, atol=0, err_msg=f"{name}/{k}")
            jax_off = np.abs(theirs - want).max() / np.abs(want).max()
            assert np.abs(ours - theirs).max() <= (jax_off + 1e-4) * np.abs(want).max(), \
                f"{name}/{k}"


def _hwio_tree(trainer, leaves):
    """A flat list in the order of ``trainer.opt.params`` (OIHW convs) as the
    JAX step's {"enc", "dec", "head"} tree (HWIO), numpy."""
    it = iter(leaves)
    tree = {}
    for tag, part in (("enc", trainer.enc), ("dec", trainer.dec)):
        tree[tag] = {}
        for name in part:
            w, b = next(it), next(it)
            tree[tag][name] = {"w": w.detach().permute(2, 3, 1, 0).numpy().copy(),
                               "b": b.detach().numpy().copy()}
    tree["head"] = {k: next(it).detach().numpy().copy() for k in ("w", "b")}
    return tree


def test_pretrain_encoder_two_steps_match_jax(roots, jax_encoder, monkeypatch):
    """Both packages' ``pretrain_encoder`` for two steps from the same weights
    on the same batches and tints; then each of the port's steps against the
    JAX step handed the port's state (weights and Adam moments) before it. A
    whole run parts after the first step: the encoder's gradient is
    ill-conditioned in float32 (the invariance term divides by per-image stds
    of relu4_1 channels near 0; both packages ~1e-2 of max |g| off float64),
    and Adam's first step moves a weight by +-lr by the sign of its gradient
    wherever |g| >> eps, so where float32 gets the sign of a gradient near 0
    wrong (in either package), the runs hold other weights from then on."""
    steps = 2
    dec0 = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(7), jvgg.DECODER_ARCH))
    head0 = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(13), (1024, 3)) * 0.01),
             "b": np.zeros((3,), np.float32)}

    # the JAX run: its losses (printed rounded) and its jitted step
    jax_losses, jax_step, jit = [], [], jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = jit(fn, *a, **kw)
        if getattr(fn, "__qualname__", "") != "pretrain_encoder.<locals>.step":
            return jitted  # optax jits helpers of its own

        def call(*args):
            out = jitted(*args)
            jax_losses.append([float(v) for v in out[2:]])
            return out
        jax_step.append(jitted)
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    jsv.pretrain_encoder(roots["jax"], SIZE, steps, jax.tree.map(jnp.asarray, jax_encoder))
    monkeypatch.setattr(jax, "jit", jit)

    # the port's run: each step's state before it, its inputs, losses and update
    records, step = [], tsv.AutoencoderPretrainer.step

    def recording_step(self, images, tint):
        opt = self.opt
        before = (_hwio_tree(self, opt.params), _hwio_tree(self, opt.mu),
                  _hwio_tree(self, opt.nu), opt.count)
        out = step(self, images, tint)
        records.append((before, np.asarray(images), np.asarray(tint),
                        [float(v) for v in out], _hwio_tree(self, opt.params)))
        return out

    monkeypatch.setattr(tsv.AutoencoderPretrainer, "step", recording_step)
    tenc, tdec_path = tsv.pretrain_encoder(roots["torch"], SIZE, steps, jax_encoder,
                                           device="cpu", dec=dec0, head=head0)
    assert len(jax_losses) == len(records) == steps
    first = records[0][0][0]
    for want, got in ((jax_encoder, first["enc"]), (dec0, first["dec"]), (head0, first["head"])):
        jax.tree.map(np.testing.assert_array_equal, got, want)
    np.testing.assert_allclose(records[0][3], jax_losses[0], rtol=1e-4)
    # what the port returns and saves is its trainer's last state
    last = records[-1][4]
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, tenc), last["enc"])
    jax.tree.map(np.testing.assert_array_equal, jconvert.load_decoder(tdec_path), last["dec"])

    tx = optax.adam(3e-4)
    for i, ((params, mu, nu, count), images, tint, losses, after) in enumerate(records):
        params = jax.tree.map(jnp.asarray, params)
        adam, rest = tx.init(params)
        state = (adam._replace(count=jnp.asarray(count, jnp.int32),
                               mu=jax.tree.map(jnp.asarray, mu),
                               nu=jax.tree.map(jnp.asarray, nu)), rest)
        out = jax_step[0](params, state, jnp.asarray(images), jnp.asarray(tint))
        np.testing.assert_allclose(losses, [float(v) for v in out[2:]], rtol=1e-4,
                                   err_msg=f"step {i + 1}")
        for path, d_port, d_jax in zip(
                jax.tree_util.tree_flatten_with_path(params)[0],
                jax.tree.leaves(jax.tree.map(lambda a, p: a - np.asarray(p), after, params)),
                jax.tree.leaves(jax.tree.map(lambda a, p: np.asarray(a) - np.asarray(p),
                                             out[0], params))):
            assert np.median(np.abs(d_port - d_jax)) <= 1e-2 * np.median(np.abs(d_jax)), \
                f"step {i + 1} {jax.tree_util.keystr(path[0])}"


def test_paired_orderings_match_jax():
    with open(os.path.join(REPO, "EXPERIMENT_SEMANTIC.json")) as f:
        per_arm = json.load(f)["per_arm"]
    per_arm["single"] = per_arm["single"][:3]  # a seed missing from one arm
    assert tsv._paired_orderings(per_arm) == jsv._paired_orderings(per_arm)


def test_run_writes_the_jax_artifact_keys(tmp_path):
    out = str(tmp_path / "semantic.json")
    summary = tsv.run(str(tmp_path / "work"), out, [SEED], [a for a, _, _ in tsv.ARMS],
                      size=SIZE, n_per_class=N_PER_CLASS, ae_steps=2, dec_steps=2, rounds=1,
                      device="cpu")
    with open(out) as f:
        written = json.load(f)
    with open(os.path.join(REPO, "EXPERIMENT_SEMANTIC.json")) as f:
        theirs = json.load(f)
    assert written == json.loads(json.dumps(summary))
    assert set(written) == set(theirs) | {"device", "timing"}
    assert written["device"] == "cpu" and written["seeds"] == [SEED]
    for arm, records in theirs["per_arm"].items():
        assert [set(r) for r in written["per_arm"][arm]] == [set(records[0])]
        assert 0.0 <= written["per_arm"][arm][0]["test_acc"] <= 1.0
    assert set(written["paired_orderings"]) == set(theirs["paired_orderings"])
    stages = [t["stage"] for t in written["timing"]]
    assert stages == ["fed", "ae_pretrain", "decoder_training", "chain", "fed", "chain", "fed",
                      "chain", "fed"]
    assert all(t["seconds"] > 0 for t in written["timing"])

    # a second run carries every (arm, seed) over and runs nothing
    again = tsv.run(str(tmp_path / "work2"), out, [SEED], ["bf16"], size=SIZE,
                    n_per_class=N_PER_CLASS, ae_steps=2, dec_steps=2, rounds=1, device="cpu")
    assert again["per_arm"] == written["per_arm"] and not os.path.exists(tmp_path / "work2")
    # ... but never from a run on another device
    written["device"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    with open(out, "w") as f:
        json.dump(written, f)
    with pytest.raises(SystemExit, match="made on"):
        tsv.run(str(tmp_path / "work3"), out, [SEED], ["bf16"], size=SIZE,
                n_per_class=N_PER_CLASS, ae_steps=2, dec_steps=2, rounds=1, device="cpu")


def test_main_defaults_to_the_card_and_its_own_artifact(tmp_path, monkeypatch):
    import ccst_tpu_torch.experiments.privacy_leakage as tpl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out.json")
    for main in (tsv.main, tpl.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--quick", "--out", out, "--workdir", str(tmp_path / "w")])
    assert not os.path.exists(out)
    results = os.path.join(REPO, "ccst_tpu_torch", "experiments", "results")
    assert tsv.RESULTS == results
    seen = {}
    monkeypatch.setattr(tsv, "run", lambda workdir, out, *a, **kw: seen.update(out=out, **kw))
    tsv.main(["--quick", "--workdir", str(tmp_path / "w")])
    assert seen["out"] == os.path.join(results, "EXPERIMENT_SEMANTIC.json")
    assert seen["device"] == "cuda"

