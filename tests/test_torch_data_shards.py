"""RSC and MixStyle with each client's batch split over two data ranks.

Both mix rows across the batch: RSC takes its sample-muting percentile over
the batch's prediction changes, MixStyle mixes each row's statistics with
those of another row of the batch. ``ccst_tpu``'s step computes both over the
whole batch under a (client 1, data 2) mesh; the port's ranks gather the rows
they need over the data group (``parallel/fed_mesh.py::DataGroup.gather``).
Each case runs ``tests/test_torch_multihost.py::_data_shards_against_jax``:
one round of one batch of 8 a client from the same state, the random
transform taken out on both sides, every server leaf within the one-step bar
(rtol 1e-4, atol 1e-6; running statistics 1e-5). MixStyle's draws (gate,
lambda, the permutation of all 8 rows) are fixed on both sides, as in
``tests/test_torch_train_ops.py``: the gate open, closed, open over layer1..3.
"""
import jax
import jax.numpy as jnp
import numpy as np

from tests.test_torch_multihost import _data_shards_against_jax, _leafwise
from tests.torch_parity import one_torch_thread, pinned_io_tier  # noqa: F401

BATCH = 8


def test_rsc_over_two_data_ranks_matches_jax(tmp_path, monkeypatch):
    _, got, want = _data_shards_against_jax(tmp_path, monkeypatch, 8, 1, 2, dg_method="RSC")
    _leafwise(got, want)


def test_mixstyle_over_two_data_ranks_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    draws = [(gate, rng.beta(0.1, 0.1, BATCH).astype(np.float32), rng.permutation(BATCH))
             for gate in (True, False, True)]
    calls = {"gate": 0, "beta": 0, "perm": 0}

    def take(kind, idx):
        i = calls[kind]
        calls[kind] += 1
        return draws[i % len(draws)][idx]

    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None:
                        jnp.asarray(take("gate", 0)))
    monkeypatch.setattr(jax.random, "beta", lambda key, a, b, shape=(), **k:
                        jnp.asarray(take("beta", 1)).reshape(shape))
    monkeypatch.setattr(jax.random, "permutation", lambda key, x, **k:
                        jnp.asarray(take("perm", 2)))
    mix = [[g, lm.tolist(), p.tolist()] for g, lm, p in draws]
    _, got, want = _data_shards_against_jax(tmp_path, monkeypatch, 8, 1, 2,
                                            rank_args={"mix_draws": mix}, dg_method="MixStyle")
    assert calls["perm"] >= 3 and calls["perm"] % 3 == 0
    _leafwise(got, want)
