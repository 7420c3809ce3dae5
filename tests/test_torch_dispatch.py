"""The stylize copy loop's contract (``ccst_tpu_torch/pipeline/stylize.py``:
``_DispatchAhead`` and ``StylizeEngine._as_input``).

Every pushed batch reaches its callback once, in order, one push late, and
``drain`` hands over the last; an array handed over stays the caller's (no
later push writes into it); the outputs are the engine's own bits.

On the CPU the loop copies at the flush and the engine copies its input as it
always did: neither engagement counter is recorded. On the card (tests marked
``card``: ``python -m pytest tests/test_torch_dispatch.py -m card
--noconftest``; this file imports no JAX) each output is copied on a copy
stream into new pinned host memory behind an event, and each pageable input
is staged through pinned memory: the same bits as a plain ``.cpu()``, arrays
held across later pushes intact, the caller's input untouched, and the
counters equal to the flushes and the calls.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.pipeline.stylize import StylizeEngine, _DispatchAhead
from ccst_tpu_torch.utils import profiling

ENGAGEMENT = ("dispatch.async_d2h", "stylize.h2d_staged")


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return torch.device("cuda", 0)


def _engine(device):
    enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(0))
    dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(1))
    return StylizeEngine(enc, dec, dtype=torch.float32, device=device, output_u8=True)


def _inputs(n, size=32, seed=1):
    rng = np.random.default_rng(seed)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, size, size, 3), np.uint8))
               for _ in range(n)]
    banks = (torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32) * 0.05),
             torch.from_numpy(rng.random((2, 512)).astype(np.float32) * 0.1 + 0.02))
    return batches, banks


class _Catch:
    """An emit callback that keeps each array it is handed, and a copy of it
    taken at that moment."""

    def __init__(self):
        self.got = []      # (tag, array as handed over)
        self.copies = []   # the same arrays, copied when handed over

    def __call__(self, tag):
        def emit(outs):
            self.got.append((tag, outs))
            self.copies.append(np.array(outs, copy=True))
        return emit


def _assert_intact(catch):
    for (_, a), b in zip(catch.got, catch.copies):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cpu_engine():
    return _engine("cpu")


def test_each_batch_is_emitted_once_in_order_one_push_late():
    pipe, catch = _DispatchAhead(), _Catch()
    batches = [torch.full((2, 3), i, dtype=torch.int32) for i in range(5)]
    for i, b in enumerate(batches):
        pipe.push(b, catch(i))
        assert [tag for tag, _ in catch.got] == list(range(i))
    pipe.drain()
    assert [tag for tag, _ in catch.got] == list(range(5))
    for (_, a), b in zip(catch.got, batches):
        np.testing.assert_array_equal(a, b.numpy())
    pipe.drain()  # nothing pending: nothing more
    assert len(catch.got) == 5


def test_emitted_arrays_stay_the_callers_and_equal_the_engines_outputs(cpu_engine):
    batches, banks = _inputs(8)
    pipe, catch = _DispatchAhead(), _Catch()
    for i, b in enumerate(batches):
        pipe.push(cpu_engine.stylize_multi(b, *banks), catch(i))
    pipe.drain()
    assert [tag for tag, _ in catch.got] == list(range(8))
    # the first two arrays were handed over six and more pushes ago
    _assert_intact(catch)
    for i, a in catch.got:
        assert a.dtype == np.uint8 and a.shape == (2, 2, 32, 32, 3)
        np.testing.assert_array_equal(a, cpu_engine.stylize_multi(batches[i], *banks)
                                      .cpu().numpy())


def test_on_the_cpu_neither_copy_engages_the_pinned_route(cpu_engine):
    batches, banks = _inputs(3)
    pipe = _DispatchAhead()
    with profile(activities=[ProfilerActivity.CPU]):
        for b in batches:
            pipe.push(cpu_engine.stylize_multi(b, *banks), lambda outs: None)
        pipe.drain()
        cpu_engine.style_stats_of(batches[0][:1])
    rec = profiling.record()
    assert rec["spans"]["dispatch.wait"]["count"] == rec["spans"]["dispatch.d2h"]["count"] == 3
    assert rec["spans"]["stylize.h2d"]["count"] == 4
    for name in ENGAGEMENT:
        assert rec["counters"].get(name, 0) == 0, name


@pytest.mark.card
def test_pinned_route_gives_the_bits_of_a_plain_copy_and_keeps_held_arrays(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    pipe, catch = _DispatchAhead(), _Catch()
    outs = []
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(9):
            t = torch.empty((3, 4, 64, 64, 3), dtype=torch.uint8, device=cuda_device)
            # the write lands late on the compute stream: a copy that did not
            # wait for it would read the tensor's stale memory
            torch.cuda._sleep(20_000_000)
            t.random_(0, 256, generator=gen)
            # every third batch a slice of the valid rows, as the CLI's last
            t = t[:, :3] if i % 3 == 2 else t
            outs.append(t)
            pipe.push(t, catch(i))
        pipe.drain()
    torch.cuda.synchronize()
    rec = profiling.record()
    assert [tag for tag, _ in catch.got] == list(range(9))
    for i, a in catch.got:
        np.testing.assert_array_equal(a, outs[i].cpu().numpy())
    # the first arrays were handed over six and more pushes ago
    _assert_intact(catch)
    assert rec["counters"]["dispatch.async_d2h"] == 9
    assert rec["counters"]["dispatch.d2h_bytes"] == sum(a.nbytes for _, a in catch.got)
    assert rec["spans"]["dispatch.wait"]["count"] == rec["spans"]["dispatch.d2h"]["count"] == 9


@pytest.mark.card
def test_staged_inputs_leave_the_callers_tensor_and_count_every_call(cuda_device):
    engine = _engine(cuda_device)
    batches, banks = _inputs(7)
    before = [b.clone() for b in batches]
    pipe, catch = _DispatchAhead(), _Catch()
    with profile(activities=[ProfilerActivity.CPU]):
        for i, b in enumerate(batches):
            pipe.push(engine.stylize_multi(b, *banks), catch(i))
        pipe.drain()
    rec = profiling.record()
    assert rec["counters"]["stylize.h2d_staged"] == len(batches)
    assert rec["counters"]["dispatch.async_d2h"] == len(batches)
    for b, b0 in zip(batches, before):
        assert not b.is_pinned()
        assert torch.equal(b, b0)
    _assert_intact(catch)
    # the same bits as the engine's outputs from inputs already on the card,
    # copied by a plain .cpu()
    for i, a in catch.got:
        plain = engine.stylize_multi(batches[i].to(cuda_device), *banks).cpu().numpy()
        np.testing.assert_array_equal(a, plain)
