"""One local step of the port (``ccst_tpu_torch.federated.train_ops``) against
``ccst_tpu``'s, from the same state (carried across by ``from_jax``) on the
same batch, for every DG method x {fedavg, fedprox} (step index 1, so the
proximal term is on), with the random draws injected into both: Jigsaw's
orders, FedDG's picks and ratios, MixStyle's gate, lambda and permutation.
The random train transform is off on both sides (JAX's
``transform_on_device=False``; the port's ``train_transform`` patched to the
identity in the test; ``tests/test_torch_image_ops.py`` holds the transform
itself).

Tolerances (float32, resnet4 at 33 px): the loss within 1e-5 relative; every
updated leaf within rtol = 1e-4, atol = 1e-6 (SGD lr 0.05, so an update is
~1e-3); running statistics within 1e-5; the correct counts equal. Also: the
all-padding batch is an exact no-op, and ``_masked_percentile`` equals JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccst_tpu.data.jigsaw as jjig
import ccst_tpu.federated.train_ops as jops
import ccst_tpu_torch.data.jigsaw as tjig
import ccst_tpu_torch.federated.train_ops as tops
import ccst_tpu_torch.ops.fft_aug as tfft
from ccst_tpu.models.classifiers import get_network as jnet
from ccst_tpu.ops.fft_aug import source_to_target_freq
from ccst_tpu_torch.models.classifiers import get_network as tnet
from ccst_tpu_torch.models.convert_resnet import from_jax
from ccst_tpu_torch.models.layers import MixStyle

N_CLASSES, IMG, BATCH, LR = 7, 33, 6, 0.05
DG_METHODS = ["no_DG", "RSC", "Jigsaw", "MixStyle", "feddg"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in several
    workers at once, and each torch's default of a thread a core oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_train_transform(monkeypatch):
    """The port's counterpart of JAX's ``transform_on_device=False``."""
    monkeypatch.setattr(tops, "train_transform", lambda gen, images, *a, **k: images)


def _setup(dg, seed=0):
    jmodel = jnet("resnet4", N_CLASSES, dg_method=dg)
    v = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.2, 1.0, a.shape).astype(np.float32)),
                         v["batch_stats"])
    jstate = {"params": v["params"], "batch_stats": stats}
    # the server a little away from the client, so the proximal term pulls
    server = jax.tree.map(lambda a: a + 0.01 * jnp.asarray(rng.normal(size=a.shape), a.dtype),
                          v["params"])
    x = rng.random((BATCH, IMG, IMG, 3), np.float32)
    y = rng.integers(0, N_CLASSES, BATCH)
    return jmodel, tnet("resnet4", N_CLASSES, dg_method=dg), jstate, server, x, y


def _inject(monkeypatch, dg):
    rng = np.random.default_rng(11)
    if dg == "Jigsaw":
        orders = np.array([0, 3, 30, 0, 17, 1])
        monkeypatch.setattr(jjig, "sample_orders", lambda key, n, *a, **k: jnp.asarray(orders))
        monkeypatch.setattr(tjig, "sample_orders", lambda gen, n, *a, **k: torch.from_numpy(orders))
    elif dg == "feddg":
        picks, ratios = np.array([2, 0, 1, 2, 3, 0]), np.array([.1, .9, .5, .2, .6, .4], np.float32)

        def jax_aug(key, images, bank, L=0.0):
            return jax.vmap(lambda im, p, r: source_to_target_freq(im * 255.0, bank[p], r) / 255.0)(
                images, jnp.asarray(picks), jnp.asarray(ratios))

        monkeypatch.setattr(jops, "feddg_batch_augment", jax_aug)
        monkeypatch.setattr(tfft, "sample_feddg_draws",
                            lambda gen, n, k: (torch.from_numpy(picks), torch.from_numpy(ratios)))
    elif dg == "MixStyle":
        # layer1..3 applications: gate open, closed, open
        draws = [(True, rng.beta(0.1, 0.1, BATCH).astype(np.float32), rng.permutation(BATCH)),
                 (False, rng.beta(0.1, 0.1, BATCH).astype(np.float32), rng.permutation(BATCH)),
                 (True, rng.beta(0.1, 0.1, BATCH).astype(np.float32), rng.permutation(BATCH))]
        calls = {"jax": {"gate": 0, "beta": 0, "perm": 0}, "torch": 0}

        def take(kind, idx):
            i = calls["jax"][kind]
            calls["jax"][kind] += 1
            return draws[i][idx]

        monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None:
                            jnp.asarray(take("gate", 0)))
        monkeypatch.setattr(jax.random, "beta", lambda key, a, b, shape=(), **k:
                            jnp.asarray(take("beta", 1)).reshape(shape))
        monkeypatch.setattr(jax.random, "permutation", lambda key, x, **k:
                            jnp.asarray(take("perm", 2)))

        def torch_draw(self, generator, b):
            i = calls["torch"]
            calls["torch"] += 1
            gate, lmda, perm = draws[i]
            return gate, lmda, torch.from_numpy(perm)

        monkeypatch.setattr(MixStyle, "draw", torch_draw)
        return calls
    return None


def _steps(dg, mode, jstate, server, x, y, jmodel, tmodel, mask, amp_bank=None):
    kw = dict(n_classes=N_CLASSES, image_size=IMG, lr=LR, dg_method=dg, mode=mode, mu=0.5)
    jbatch = {"images": jnp.asarray(x), "labels": jnp.asarray(y, jnp.int32), "mask": jnp.asarray(mask)}
    tbatch = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y.astype(np.int64)),
              "mask": torch.from_numpy(mask)}
    if amp_bank is not None:
        jbatch["amp_bank"] = jnp.asarray(amp_bank)
        tbatch["amp_bank"] = torch.from_numpy(amp_bank)
    jnew, jm = jax.jit(jops.make_train_step(jmodel, **kw, transform_on_device=False))(
        jstate, server, jbatch, jax.random.PRNGKey(5), jnp.asarray(1))
    tstate = from_jax(jstate["params"], jstate["batch_stats"])
    tserver = from_jax(server, {})
    tnew, tm = tops.make_train_step(tmodel, **kw)(
        tstate, tserver, tbatch, torch.Generator().manual_seed(5), 1)
    return tstate, tnew, tm, from_jax(jnew["params"], jnew["batch_stats"]), jm


@pytest.mark.parametrize("mode", ["fedavg", "fedprox"])
@pytest.mark.parametrize("dg", DG_METHODS)
def test_train_step_matches_jax(dg, mode, monkeypatch):
    jmodel, tmodel, jstate, server, x, y = _setup(dg)
    calls = _inject(monkeypatch, dg)
    bank = (np.abs(np.random.default_rng(3).normal(size=(4, 3, IMG, IMG))) * 300).astype(np.float32)
    tstate, tnew, tm, want, jm = _steps(dg, mode, jstate, server, x, y, jmodel, tmodel,
                                        np.ones(BATCH, np.float32),
                                        bank if dg == "feddg" else None)
    if calls is not None:
        assert calls["torch"] == 3 and calls["jax"]["beta"] == 3
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
    assert float(tm.correct) == float(jm.correct) and float(tm.count) == float(jm.count)
    assert float(tm.jig_correct) == float(jm.jig_correct)
    moved = 0
    for k, w in want.items():
        got = tnew[k]
        if k.endswith("num_batches_tracked"):
            assert int(got) == int(tstate[k]) + 1, k
            continue
        tol = dict(rtol=1e-5, atol=1e-5) if "running" in k else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), w.numpy(), **tol, err_msg=k)
        moved += int(not torch.equal(got, tstate[k]))
    assert moved > len(want) // 2


def test_fedprox_term_only_from_step_one():
    """step 0: fedprox equals fedavg; step 1: it does not (fed_run.py:163-165)."""
    _, tmodel, jstate, server, x, y = _setup("no_DG")
    state = from_jax(jstate["params"], jstate["batch_stats"])
    batch = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y), "mask": torch.ones(BATCH)}
    out = {}
    for mode in ("fedavg", "fedprox"):
        step = tops.make_train_step(tmodel, n_classes=N_CLASSES, image_size=IMG, lr=LR, mode=mode,
                                    mu=0.5)
        for idx in (0, 1):
            out[mode, idx] = step(state, from_jax(server, {}), batch, torch.Generator(), idx)[1]
    assert float(out["fedavg", 0].loss) == float(out["fedprox", 0].loss)
    assert float(out["fedprox", 1].loss) > float(out["fedavg", 1].loss)


@pytest.mark.parametrize("dg", ["no_DG", "RSC"])
def test_padded_batch_is_an_exact_noop(dg):
    """All rows padding: neither parameters nor running statistics change
    (the forward ran on the padding, so its statistics are dropped)."""
    _, tmodel, jstate, server, x, y = _setup(dg)
    state = from_jax(jstate["params"], jstate["batch_stats"])
    before = {k: v.clone() for k, v in state.items()}
    step = tops.make_train_step(tmodel, n_classes=N_CLASSES, image_size=IMG, lr=LR, dg_method=dg,
                                mode="fedprox")
    batch = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y), "mask": torch.zeros(BATCH)}
    new, m = step(state, from_jax(server, {}), batch, torch.Generator(), 1)
    for k in before:
        assert torch.equal(new[k], before[k]), k
        assert torch.equal(state[k], before[k]), k  # the input state is not touched
    assert float(m.loss) == 0.0 and float(m.active) == 0.0 and float(m.count) == 0.0


@pytest.mark.parametrize("n_valid", [1, 2, 5, 9, 12])
def test_masked_percentile_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    x = rng.normal(size=12).astype(np.float32)
    mask = np.zeros(12, np.float32)
    mask[rng.permutation(12)[:n_valid]] = 1.0
    q = tops.RSC_PERCENT
    want = float(jops._masked_percentile(jnp.asarray(x), jnp.asarray(mask), q))
    got = float(tops._masked_percentile(torch.from_numpy(x), torch.from_numpy(mask), q))
    assert abs(got - want) <= 1e-6
    assert abs(got - float(np.percentile(x[mask > 0], q))) <= 1e-5


def test_eval_step_matches_jax():
    jmodel, tmodel, jstate, _, x, y = _setup("Jigsaw")
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y, jnp.int32), "mask": jnp.asarray(mask)}
    want = jax.jit(jops.make_eval_step(jmodel, image_size=28))(jstate, jb)
    got = tops.make_eval_step(tmodel, image_size=28)(
        from_jax(jstate["params"], jstate["batch_stats"]),
        {"images": torch.from_numpy(x), "labels": torch.from_numpy(y), "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert float(got[1]) == float(want[1]) and float(got[2]) == float(want[2]) == 4.0
