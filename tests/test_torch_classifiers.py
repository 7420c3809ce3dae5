"""The port's classifier zoo (``ccst_tpu_torch.models.classifiers``) against
``ccst_tpu``'s, with the weights carried across by ``convert_resnet.from_jax``.

Every zoo net at a small size (resnet4, resnet18, resnet18IN, a bottleneck
ResNet of one block a stage, a narrow DenseNet, DigitModel at 28 px, AlexNet)
runs the same numpy-seeded input in train and eval mode: logits within
rtol = atol = 1e-4 (float32, sums in another order), and the running
statistics after a train forward within 1e-5. BN leaves are randomised first
so that eval mode reads non-trivial statistics. The state-dict keys of every
registry net equal the JAX tree's, and FedBN's selector picks the same
leaves in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.federated.aggregate import is_bn_path
from ccst_tpu.models import classifiers as jcls
from ccst_tpu.models.convert_resnet import convert_torchvision_resnet as j_convert_tv
from ccst_tpu_torch.federated.aggregate import is_bn_key
from ccst_tpu_torch.federated.train_ops import forward
from ccst_tpu_torch.models import classifiers as tcls
from ccst_tpu_torch.models.convert_resnet import (
    convert_torchvision_resnet,
    from_jax,
    load_imagenet_resnet,
    to_jax,
)

from tests.torch_ref import TorchResNet18

TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)

# (id, JAX module, port module, input side)
ZOO = [
    ("resnet4", lambda: jcls.get_network("resnet4", 7), lambda: tcls.get_network("resnet4", 7), 32),
    ("resnet18", lambda: jcls.get_network("resnet18", 7), lambda: tcls.get_network("resnet18", 7),
     32),
    ("resnet18IN", lambda: jcls.get_network("resnet18IN", 7),
     lambda: tcls.get_network("resnet18IN", 7), 32),
    ("bottleneck-1111", lambda: jcls.ResNet(classes=7, block="bottleneck", stage_sizes=(1, 1, 1, 1)),
     lambda: tcls.ResNet(7, "bottleneck", (1, 1, 1, 1)), 32),
    ("densenet-narrow",
     lambda: jcls.DenseNet(classes=7, growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16),
     lambda: tcls.DenseNet(7, growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16), 32),
    ("DigitModel", lambda: jcls.DigitModel(classes=10), lambda: tcls.DigitModel(10), 28),
    ("alexnet", lambda: jcls.AlexNet(classes=10), lambda: tcls.AlexNet(10), 63),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in several
    workers at once, and each torch's default of a thread a core oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise_norms(tree, rng, stats=False):
    """BN / IN scale and bias (or running mean and var) drawn at random."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise_norms(v, rng, stats)
        elif k in ("scale", "var"):
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif (k == "bias" and not stats and v.ndim == 1) or k == "mean":
            out[k] = jnp.asarray(rng.normal(0, 0.2, v.shape).astype(np.float32))
        else:
            out[k] = v
    return out


def jax_init(model, side, seed=0):
    """``model.init`` jitted (flax's eager init dispatches op by op)."""
    return jax.jit(lambda k: model.init(k, jnp.zeros((1, side, side, 3)), train=False))(
        jax.random.PRNGKey(seed))


def jax_apply(model, variables, x, train):
    mutable = ["batch_stats"] if (train and "batch_stats" in variables) else False
    return jax.jit(lambda v, x: model.apply(v, x, train=train, mutable=mutable))(
        variables, jnp.asarray(x))


def jax_eval_and_train(model, variables, x):
    """(eval logits, (train logits, new batch_stats)) in one compiled program."""
    has_stats = "batch_stats" in variables

    def both(v, x):
        ev = model.apply(v, x, train=False)
        if has_stats:
            tr, new = model.apply(v, x, train=True, mutable=["batch_stats"])
            return ev, tr, new["batch_stats"]
        return ev, model.apply(v, x, train=True), {}

    return jax.jit(both)(variables, jnp.asarray(x))


def jax_variables(model, side, seed=0):
    rng = np.random.default_rng(seed)
    v = jax_init(model, side, seed)
    params = _randomise_norms(jax.tree.map(lambda a: a, v["params"]), rng)
    stats = _randomise_norms(v.get("batch_stats", {}), rng, stats=True)
    return params, stats


@pytest.mark.parametrize("name,jmake,tmake,side", ZOO, ids=[z[0] for z in ZOO])
def test_forward_train_and_eval_match_jax(name, jmake, tmake, side):
    jmodel, tmodel = jmake(), tmake()
    params, stats = jax_variables(jmodel, side)
    state = from_jax(params, stats)
    assert set(state) == set(tmodel.state_dict()), "state-dict keys differ from the JAX tree"
    x = np.random.default_rng(1).random((4, side, side, 3), np.float32)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}

    want_eval, want, new_stats = jax_eval_and_train(jmodel, variables, x)
    got_eval = forward(tmodel, state, torch.from_numpy(x), False).detach().numpy()
    np.testing.assert_allclose(got_eval, np.asarray(want_eval), **TOL)

    train_state = {k: v.clone() for k, v in state.items()}
    got = forward(tmodel, train_state, torch.from_numpy(x), True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for key, v in from_jax(params, new_stats).items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(train_state[key].numpy(), v.numpy(), **STATS_TOL,
                                       err_msg=key)
            assert not np.allclose(train_state[key].numpy(), state[key].numpy()), key


@pytest.mark.parametrize("name", tcls.NETS)
def test_registry_keys_and_fedbn_selection_match_jax(name):
    """Every registry net: the same leaves under the same names, and FedBN's
    selector keeps the same ones local (tests/test_federated.py:100 for JAX)."""
    side = {"DigitModel": 28, "alexnet": 63}.get(name, 36)
    jmodel, tmodel = jcls.get_network(name, 4), tcls.get_network(name, 4)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, side, side, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = from_jax(zeros["params"], zeros.get("batch_stats", {}))
    ours = tmodel.state_dict()
    assert set(state) == set(ours)
    for k, v in ours.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    jax_bn = set()
    for tree in ("params", "batch_stats"):
        for path, _ in jax.tree_util.tree_flatten_with_path(zeros.get(tree, {}))[0]:
            if is_bn_path(path):
                jax_bn.add(".".join(p.key for p in path[:-1]))
    port_bn = {k.rsplit(".", 1)[0] for k in ours if is_bn_key(k)}
    assert port_bn == jax_bn
    for k, _ in tmodel.named_buffers():  # every running statistic stays local under fedbn
        assert is_bn_key(k), k
    assert bool(port_bn) == (name != "densenet")


@pytest.mark.parametrize("name", ["resnet18", "DigitModel"])
def test_init_follows_the_jax_distributions(name):
    """init_weights draws flax's truncated normals: per leaf the spread is
    the JAX init's within 10%, nothing beyond 2 std, biases zero."""
    side = 28 if name == "DigitModel" else 32
    jv = jax_init(jcls.get_network(name, 7), side)
    want = from_jax(jv["params"], jv.get("batch_stats", {}))
    got = tcls.init_weights(tcls.get_network(name, 7), torch.Generator().manual_seed(0)).state_dict()
    for k, w in want.items():
        g = got[k]
        if k.endswith("weight") and g.ndim >= 2 and g.numel() >= 1000:
            ratio = g.std().item() / w.std().item()
            assert 0.9 < ratio < 1.1, (k, ratio)
            bound = 2 * w.std().item() / 0.8796 * 1.001
            assert g.abs().max().item() <= bound * 1.02, k
        elif not k.endswith("weight") or g.ndim == 1:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=k)
    a = tcls.init_weights(tcls.get_network(name, 7), torch.Generator().manual_seed(3)).state_dict()
    b = tcls.init_weights(tcls.get_network(name, 7), torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_from_jax_round_trip():
    jmodel = jcls.get_network("resnet4", 7)
    params, stats = jax_variables(jmodel, 32, seed=2)
    back_p, back_s = to_jax(from_jax(params, stats))
    for tree, back in ((params, back_p), (stats, back_s)):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat) == len(flat_back)
        for path, v in flat:
            np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(v))


def test_in_test_norm_swap_matches_jax():
    """--in-test: IN reusing BN's affine leaves, eval mode, against
    ``model.clone(norm="in")``."""
    jmodel = jcls.get_network("resnet18", 7)
    params, stats = jax_variables(jmodel, 32, seed=4)
    x = np.random.default_rng(5).random((2, 32, 32, 3), np.float32)
    want = jax_apply(jmodel.clone(norm="in"), {"params": params, "batch_stats": stats}, x, False)
    tmodel = tcls.get_network("resnet18", 7).with_norm("in")
    got = forward(tmodel, from_jax(params, stats), torch.from_numpy(x), False).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_torchvision_conversion_is_a_direct_key_map(tmp_path):
    """The torchvision-layout ResNet-18 (tests/torch_ref.py) through the key
    map: the same forward as the torch twin (head copied), the same leaves as
    ccst_tpu's converter, and the file gate of load_imagenet_resnet."""
    torch.manual_seed(0)
    twin = TorchResNet18(classes=7).eval()
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    tv = twin.state_dict()
    model = tcls.init_weights(tcls.get_network("resnet18", 7), torch.Generator().manual_seed(0))
    init = model.state_dict()
    state = convert_torchvision_resnet(tv, init)
    assert torch.equal(state["class_classifier.weight"], init["class_classifier.weight"])
    state["class_classifier.weight"] = tv["fc.weight"].clone()
    state["class_classifier.bias"] = tv["fc.bias"].clone()
    x = torch.from_numpy(np.random.default_rng(6).random((2, 32, 32, 3), np.float32))
    with torch.no_grad():
        want = twin(x.permute(0, 3, 1, 2)).numpy()
    got = forward(model, state, x, False).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)

    jmodel = jcls.get_network("resnet18", 7)
    jv = jax_init(jmodel, 32)
    jp, js = j_convert_tv(tv, jv["params"], jv["batch_stats"])
    theirs = from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    mine = convert_torchvision_resnet(tv, init)
    for k, v in theirs.items():
        if not k.startswith("class_classifier") and not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(mine[k].numpy(), v.numpy(), err_msg=k)

    path = str(tmp_path / "resnet18.pth")
    torch.save(tv, path)
    loaded, ok = load_imagenet_resnet(path, init)
    assert ok and torch.equal(loaded["layer2_0.Conv_2.weight"], tv["layer2.0.downsample.0.weight"])
    same, ok = load_imagenet_resnet(str(tmp_path / "missing.pth"), init)
    assert not ok and all(torch.equal(same[k], init[k]) for k in init)
