"""Channel-split ResNet (``ccst_tpu_torch/parallel/tensor.py``) against
``ccst_tpu``'s unsharded ``value_and_grad``.

Four gloo ranks of ``tests/torch_multihost_worker.py tensor`` on the CPU form
a (data 2, model 2) mesh and run ``resnet4`` in eval mode, as
``tests/test_parallel.py::test_resnet50_param_sharding_model_axis`` runs
``ccst_tpu``'s ResNet-50: the mean cross-entropy of a batch of 4 at 32 px,
two rows a data rank, ``min_dim = 64`` so that every conv of 64 output
channels and more splits over the model ranks. Held to ``ccst_tpu``'s
unsharded run on the same parameters: the loss (rtol 2e-5) and the logits
(atol 2e-4), that test's bars, and every gradient leaf within 1e-4 of its
largest magnitude (float32 sums in another order: the model ranks' input
gradients are summed, the data ranks' gradients averaged).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models.classifiers import get_network as jnet
from ccst_tpu_torch.models.convert_resnet import from_jax
from ccst_tpu_torch.parallel import tensor
from tests.test_torch_multihost import _ranks
from tests.torch_parity import one_torch_thread  # noqa: F401

CLASSES, MIN_DIM = 4, 64


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tensor"))
    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 4)
    model = jnet("resnet4", classes=CLASSES)
    variables = jax.jit(lambda k: model.init(k, jnp.asarray(x[:1]), train=False))(
        jax.random.PRNGKey(0))

    def loss_fn(params, x, labels):
        logits = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                             train=False)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1)), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jnp.asarray(x), jnp.asarray(labels))
    state = from_jax(variables["params"], variables["batch_stats"])
    torch.save({"state": state, "x": torch.from_numpy(x),
                "labels": torch.from_numpy(labels.astype(np.int64))},
               os.path.join(work, "inputs.pt"))
    ranks = _ranks("tensor", 4, os.path.join(work, "ranks"),
                   dict(inputs=os.path.join(work, "inputs.pt"), network="resnet4",
                        classes=CLASSES, min_dim=MIN_DIM))
    want = {k: v for k, v in from_jax(grads, variables["batch_stats"]).items()
            if "running" not in k and not k.endswith("num_batches_tracked")}
    return ranks, float(loss), np.asarray(logits), want, state


def test_a_conv_really_splits(runs):
    ranks, _, _, _, state = runs
    split = ranks[0]["split"]
    assert "layer4_0.Conv_2.weight" in split and "conv1.weight" in split
    assert "class_classifier.weight" not in split  # 4 classes < min_dim
    assert split == sorted(k for k, v in state.items()
                           if tensor.param_spec(k, v, 2, MIN_DIM))


def test_loss_logits_and_gradients_match_the_unsharded_jax_run(runs):
    ranks, loss, logits, want, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
        np.testing.assert_allclose(r["logits"].numpy(), logits, atol=2e-4)
        assert set(r["grads"]) == set(want)
        for k, g in want.items():
            got = r["grads"][k].numpy()
            assert got.shape == g.shape, k
            np.testing.assert_allclose(got, g.numpy(), rtol=0,
                                       atol=1e-4 * float(g.abs().max()), err_msg=k)
    # the model ranks of a data index hold the same whole gradients
    for a, b in ((0, 1), (2, 3)):
        for k in want:
            assert torch.equal(ranks[a]["grads"][k], ranks[b]["grads"][k]), k


def test_param_spec_policy():
    w = torch.zeros((256, 128, 3, 3))
    assert tensor.param_spec("w", w, 4) == ("model", None, None, None)
    assert tensor.param_spec("w", torch.zeros((64, 64, 1, 1)), 4) == ()  # below min_dim
    assert tensor.param_spec("w", torch.zeros((130, 4)), 4) == ()        # not divisible
    assert tensor.param_spec("b", torch.zeros((256,)), 4) == ()          # 1-D: replicated
    assert tensor.param_spec("fc", torch.zeros((128, 2048)), 2) == ("model", None)
