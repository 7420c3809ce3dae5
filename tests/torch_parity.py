"""Fixtures shared by the port's parity tests (``tests/test_torch_*.py``).

- ``one_torch_thread``: one intra-op thread for the small tensors of these
  tests; the suite runs in several workers at once, and torch's default of a
  thread a core oversubscribes the machine.
- ``pinned_io_tier``: both packages read the same pixels. Each picks its image
  IO when a loader is made: the native library when it loads, else PIL. The
  two resizes differ by up to one uint8 level, and ``ccst_tpu``'s library may
  fail to load in a worker that raced another one's build. So the port's
  ``native.available`` is made to answer as ``ccst_tpu``'s does, asked anew at
  every call: whichever tier ``ccst_tpu`` takes, the port takes too.

A test module imports the ones it wants by name: both are autouse and
module-scoped, so they apply to every test of the module and are in place
before its own module-scoped fixtures (trees, style banks) run.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def pinned_io_tier():
    import ccst_tpu.native as jnative
    import ccst_tpu_torch.native as tnative

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "available", lambda: jnative.available())
        yield


def jit_flax_init(monkeypatch) -> None:
    import flax.linen as nn
    import jax

    init = nn.Module.init

    def jitted(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, **kw))(rngs, *args)

    monkeypatch.setattr(nn.Module, "init", jitted)
