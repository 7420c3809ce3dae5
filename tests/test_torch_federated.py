"""Aggregation, tent and checkpoints of the port against ``ccst_tpu``.

- ``federated/aggregate.py``: all five modes over three clients of a
  one-block-a-stage bottleneck ResNet (it has ``bn3``, which adafea couples),
  server and clients within 1e-6 of ``ccst_tpu.federated.aggregate`` (float32
  weighted sums in another order); ``num_batches_tracked`` is client 0's;
- ``federated/tent.py``: one adaptation step, only BN affine leaves moving,
  each leaf's update within 1e-3 of its largest element of JAX's update (the
  entropy gradient at init is a sum with much cancellation, so float32 noise
  shows relative to small elements);
- ``utils/checkpoint.py``: the pure-Python msgpack reader gives what
  ``flax.serialization.msgpack_restore`` gives, and ``save_checkpoint``
  round-trips through ``torch.save``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ccst_tpu.federated.aggregate import aggregate as j_aggregate
from ccst_tpu.federated.aggregate import stack_clients, unstack_clients
from ccst_tpu.federated.tent import make_tent_step as j_tent_step
from ccst_tpu.models import classifiers as jcls
from ccst_tpu.utils.checkpoint import save_checkpoint as j_save
from ccst_tpu_torch.federated import aggregate as tagg
from ccst_tpu_torch.federated.tent import entropy_loss, make_tent_step
from ccst_tpu_torch.models import classifiers as tcls
from ccst_tpu_torch.models.convert_resnet import from_jax
from ccst_tpu_torch.utils.checkpoint import (
    is_msgpack_checkpoint,
    load_checkpoint,
    msgpack_restore,
    save_checkpoint,
)

SIDE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in several
    workers at once, and each torch's default of a thread a core oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_clients(n=3):
    model = jcls.ResNet(classes=5, block="bottleneck", stage_sizes=(1, 1, 1, 1))
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3)), train=False))
    out = []
    for i in range(n):
        v = init(jax.random.PRNGKey(i))
        rng = np.random.default_rng(i)
        jit = lambda a: jnp.asarray(a + rng.normal(0, 0.1, a.shape).astype(np.float32))
        out.append({"params": jax.tree.map(jit, v["params"]),
                    "batch_stats": jax.tree.map(lambda a: jnp.abs(jit(a)), v["batch_stats"])})
    return model, out


@pytest.mark.parametrize("mode", ["fedavg", "fedprox", "deepall", "fedbn", "adafea"])
def test_aggregation_matches_jax(mode):
    _, clients = _jax_clients()
    w = [0.5, 0.3, 0.2]
    sp, ss, ncp, ncs = jax.jit(lambda cp, cs: j_aggregate(mode, cp, cs, jnp.asarray(w)))(
        stack_clients([c["params"] for c in clients]),
        stack_clients([c["batch_stats"] for c in clients]))
    states = [from_jax(c["params"], c["batch_stats"]) for c in clients]
    for i, s in enumerate(states):
        for k in s:
            if k.endswith("num_batches_tracked"):
                s[k] = torch.tensor(5 + 2 * i)
    server, new_clients = tagg.aggregate(mode, states, w)
    want_server = from_jax(sp, ss)
    for k, v in server.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 5, k  # client 0's, never an average
            continue
        np.testing.assert_allclose(v.numpy(), want_server[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for i, (p, s) in enumerate(zip(unstack_clients(ncp, 3), unstack_clients(ncs, 3))):
        want = from_jax(p, s)
        for k, v in new_clients[i].items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6,
                                           err_msg=f"client {i} {k}")
    if mode == "fedbn":  # BN leaves stay each client's own
        assert torch.equal(new_clients[1]["bn1.weight"], states[1]["bn1.weight"])
        assert not torch.equal(new_clients[1]["bn1.weight"], new_clients[0]["bn1.weight"])
        assert torch.equal(new_clients[1]["conv1.weight"], new_clients[0]["conv1.weight"])
    if mode == "adafea":  # bn3 coupled to the server's statistics
        np.testing.assert_allclose(new_clients[2]["layer2_0.bn3.bias"].numpy(),
                                   server["layer2_0.bn3.running_mean"].numpy())


def test_tent_step_matches_jax():
    model = jcls.get_network("resnet4", 5)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3)), train=False))(
        jax.random.PRNGKey(3))
    x = np.random.default_rng(0).random((4, 40, 40, 3), np.float32)
    y = np.array([0, 1, 2, 3])
    mask = np.array([1, 1, 1, 0], np.float32)
    state = {"params": v["params"], "batch_stats": v["batch_stats"]}
    jnew, jc, jn = jax.jit(j_tent_step(model, SIDE, lr=0.5))(
        state, {"images": jnp.asarray(x), "labels": jnp.asarray(y), "mask": jnp.asarray(mask)})
    tstate = from_jax(v["params"], v["batch_stats"])
    tnew, tc, tn = make_tent_step(tcls.get_network("resnet4", 5), SIDE, lr=0.5)(
        tstate, {"images": torch.from_numpy(x), "labels": torch.from_numpy(y),
                 "mask": torch.from_numpy(mask)})
    want = from_jax(jnew["params"], jnew["batch_stats"])
    worst = 0.0
    for k, w in want.items():
        d_t, d_j = (tnew[k] - tstate[k]).numpy(), (w - tstate[k]).numpy()
        err = np.abs(d_t - d_j).max() / max(np.abs(d_j).max(), 1e-12)
        worst = max(worst, float(err))
        assert err <= 1e-3, (k, err)
        moved = not torch.equal(tnew[k], tstate[k])
        assert moved == (tagg.is_bn_key(k) and k.endswith(("weight", "bias"))), k
    assert float(tc) == float(jc) and float(tn) == float(jn) == 3.0
    print(f"tent: worst update error {worst:.2e} of the leaf's largest update")
    logits = torch.randn(5, 7)
    assert float(entropy_loss(logits, torch.ones(5))) > 0


def test_msgpack_reader_equals_flax(tmp_path):
    _, clients = _jax_clients(1)
    payload = {"server": clients[0], "round": 7,
               "best": {"val_acc_mean": 0.25, "round": 3, "test_acc": None},
               "scalar": np.float32(1.5), "big": np.arange(70000, dtype=np.int64),
               "neg": -3, "name": "x" * 40}
    data = serialization.msgpack_serialize(payload)
    want, got = serialization.msgpack_restore(data), msgpack_restore(data)
    flat_w = jax.tree_util.tree_flatten_with_path(want)
    flat_g = jax.tree_util.tree_flatten_with_path(got)
    assert flat_w[1] == flat_g[1]
    for (pw, a), (pg, b) in zip(flat_w[0], flat_g[0]):
        assert pw == pg and np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    path = str(tmp_path / "jax.ckpt")
    j_save(path, {k: v for k, v in payload.items() if k != "name"})  # it saves leaves as arrays
    assert is_msgpack_checkpoint(path)
    loaded = load_checkpoint(path)
    assert loaded["round"] == 7 and loaded["best"]["test_acc"] is None
    with pytest.raises(ValueError):
        msgpack_restore(data[:-3])


def test_torch_checkpoint_round_trip(tmp_path):
    state = tcls.get_network("resnet4", 5).state_dict()
    path = str(tmp_path / "sub" / "run_latest.ckpt")
    save_checkpoint(path, {"server": state, "round": 2, "best": {"val_acc_mean": 0.5, "round": 1,
                                                                  "test_acc": 0.25}})
    assert not is_msgpack_checkpoint(path)
    back = load_checkpoint(path)
    assert back["round"] == 2 and back["best"]["test_acc"] == 0.25
    assert all(torch.equal(back["server"][k], v) for k, v in state.items())
    assert not (tmp_path / "sub" / "run_latest.ckpt.tmp").exists()
