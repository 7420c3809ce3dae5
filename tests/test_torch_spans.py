"""The port's spans and counters (``ccst_tpu_torch/utils/profiling.py``) on
the CPU: a shared no-op without a profiler, ``ccst::`` ranges and a record of
durations, self times and counts under one, at the stylize engine and its
copy loop, the federated round loop and the loader, and the operator's
``--trace-dir`` export. A profiled stylize run gives the same bytes as an
unprofiled one.
"""
import gc
import json
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccst_tpu_torch.cli import main as cli
from ccst_tpu_torch.config import FedConfig
from ccst_tpu_torch.data.lists import write_list
from ccst_tpu_torch.data.loader import ImageBatchLoader, save_image_u8
from ccst_tpu_torch.federated.runtime import FederatedRunner
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.pipeline import stylize as stylize_mod
from ccst_tpu_torch.pipeline.stylize import StylizeEngine, _DispatchAhead
from ccst_tpu_torch.utils import profiling
from ccst_tpu_torch.utils.profiling import count, maybe_trace, record, reset, span

DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]
EMPTY = {"spans": {}, "counters": {}}


@pytest.fixture(autouse=True)
def _fresh_record():
    reset()
    yield
    reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _no_ranges(monkeypatch):
    """Any range or CUDA event raises."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range or event without a profiler")

    monkeypatch.setattr(profiling, "_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 domains x 6 images at 36 px, 7 classes, train and test lists."""
    root = str(tmp_path_factory.mktemp("spans_tree"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names, labels = [], []
        for i in range(6):
            rel = f"PACS/kfold/{d}/c{i % 7}/img{i}.png"
            save_image_u8(rng.random((36, 36, 3), np.float32), os.path.join(root, rel))
            names.append(rel)
            labels.append(i % 7)
        for kind in ("train", "test"):
            write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_{kind}.txt"), names, labels)
    return root


@pytest.fixture(scope="module")
def engine():
    enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(0))
    dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(1))
    return StylizeEngine(enc, dec, dtype=torch.float32, device="cpu", output_u8=True)


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    _no_ranges(monkeypatch)
    assert not profiling.active()
    assert span("a") is span("b") is profiling._NO_SPAN
    # only this test's own calls are measured: the collector does not run
    # inside the loop (it would finalize what earlier tests left behind, on
    # this thread), and an allocation counts only if this test's frame is on
    # its stack (other threads of the process, such as a loader's, are not
    # this test's calls)
    gc.collect()
    gc.disable()
    tracemalloc.start(64)
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with span("a"):
                count("b", 3)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
        gc.enable()
    ours = tracemalloc.Filter(True, __file__, all_frames=True)
    before, after = before.filter_traces([ours]), after.filter_traces([ours])
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == profiling.__file__ and s.size_diff > 0]
    assert grown == []
    assert record() == EMPTY


def test_nested_spans_give_counts_self_times_and_ranges():
    with _profiled() as prof:
        assert profiling.active()
        for _ in range(2):
            with span("outer"):
                time.sleep(0.01)
                with span("inner"):
                    time.sleep(0.02)
        count("things", 5)
        count("things")
    rec = record()
    outer, inner = rec["spans"]["outer"], rec["spans"]["inner"]
    assert outer["count"] == inner["count"] == 2
    assert inner["self_seconds"] == pytest.approx(inner["seconds"])
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"])
    assert 0.015 < outer["self_seconds"] < outer["seconds"] and inner["seconds"] >= 0.04
    assert rec["counters"] == {"things": 6}
    names = [e.name for e in prof.events()]
    assert names.count("ccst::outer") == names.count("ccst::inner") == 2
    # outside the profile: nothing more is recorded
    with span("outer"):
        count("things")
    assert record() == rec


def _run_loop(engine, batches, banks, profiled):
    """Overall: every batch under the banks, through the dispatch-ahead loop."""
    got = []
    pipe = _DispatchAhead()

    def run():
        for b in batches:
            pipe.push(engine.stylize_multi(b, *banks), lambda outs: got.append(outs))
        pipe.drain()

    if profiled:
        with _profiled():
            run()
    else:
        run()
    return got, pipe


def test_a_profiled_stylize_loop_records_its_spans_and_gives_the_same_bytes(
        engine, monkeypatch):
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), np.uint8))
               for _ in range(3)]
    banks = (torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32) * 0.05),
             torch.from_numpy(rng.random((2, 512)).astype(np.float32) * 0.1 + 0.02))
    with monkeypatch.context() as m:
        _no_ranges(m)
        plain, _ = _run_loop(engine, batches, banks, profiled=False)
    assert record() == EMPTY
    traced, pipe = _run_loop(engine, batches, banks, profiled=True)
    assert len(traced) == len(plain) == 3
    for a, b in zip(traced, plain):
        assert a.dtype == np.uint8 and a.shape == (2, 2, 32, 32, 3)
        np.testing.assert_array_equal(a, b)
    rec = record()
    counts = {k: v["count"] for k, v in rec["spans"].items()}
    assert counts == {"stylize.h2d": 3, "stylize.encode": 3, "stylize.adain": 3,
                      "stylize.decode": 6, "stylize.finish": 9, "dispatch.wait": 3,
                      "dispatch.d2h": 3, "dispatch.emit": 3}
    assert rec["counters"] == {"stylize.h2d_bytes": sum(b.nbytes for b in batches),
                               "dispatch.d2h_bytes": sum(a.nbytes for a in traced)}
    d = rec["spans"]
    assert pipe.fetch_seconds >= d["dispatch.d2h"]["seconds"]
    # style_stats_of: its own span, the image's copy inside it
    reset()
    with _profiled():
        engine.style_stats_of(batches[0][:1])
    assert {k: v["count"] for k, v in record()["spans"].items()} == {
        "stylize.style_stats": 1, "stylize.h2d": 1}
    s = record()["spans"]["stylize.style_stats"]
    assert s["self_seconds"] == pytest.approx(
        s["seconds"] - record()["spans"]["stylize.h2d"]["seconds"])


def test_maybe_trace_writes_the_record_beside_the_trace(tmp_path):
    with _profiled():
        with span("before"):
            pass
    out = str(tmp_path / "trace")
    with maybe_trace(out):
        with span("work"):
            count("bytes", 7)
    assert sorted(os.listdir(out)) == ["spans.json", "trace.json"]
    with open(os.path.join(out, "spans.json")) as f:
        written = json.load(f)
    assert written == record() and set(written["spans"]) == {"work"}
    assert written["counters"] == {"bytes": 7}
    with open(os.path.join(out, "trace.json")) as f:
        assert "ccst::work" in f.read()
    with maybe_trace(""):
        assert not profiling.active()


def test_a_round_records_its_phases_and_the_evaluations_loader_waits(tree, tmp_path):
    out = str(tmp_path)
    cfg = FedConfig(dataset="pacs", target="photo", mode="fedavg", network="resnet4",
                    rounds=1, batch_size=4, image_size=36, lr=0.01, list_root=tree,
                    data_root=tree, save_path=os.path.join(out, "ckpt"),
                    log_path=os.path.join(out, "logs"), save_freq=1,
                    trace_dir=os.path.join(out, "trace"))
    runner = FederatedRunner(cfg, device="cpu")
    runner.run()
    with open(os.path.join(out, "trace", "spans.json")) as f:
        rec = json.load(f)
    counts = {k: v["count"] for k, v in rec["spans"].items()}
    n_train = sum(len(c.train) for c in runner.clients)
    n_eval = sum(len(c.val) for c in runner.clients) + len(runner.test_loader)
    n_loaders = len(runner.clients) + 1
    assert counts["fed.client_epoch"] == len(runner.clients)
    assert counts["fed.step"] == counts["fed.h2d"] == n_train
    assert counts["fed.loader_wait"] == n_train + len(runner.clients)
    assert counts["fed.evaluate"] == n_loaders
    assert counts["fed.eval_loader_wait"] == n_eval + n_loaders
    assert counts["fed.aggregate"] == 1
    # round 0 is the first and the last: latest, then best
    assert counts["fed.save"] == 2
    assert rec["counters"]["fed.save_bytes"] == sum(
        os.path.getsize(runner.ckpt[k]) for k in ("latest", "best"))
    # loader.decode runs on the loaders' own threads, recorded all the same
    assert counts["loader.decode"] == n_train + n_eval
    assert rec["counters"]["loader.gets"] == n_train + n_eval
    rounds = [json.loads(line) for line in open(runner.logger.path)]
    (rnd,) = [r for r in rounds if r["event"] == "round"]
    assert rnd["eval_loader_wait_seconds"] >= 0 and rnd["loader_wait_seconds"] >= 0
    assert rnd["eval_loader_wait_seconds"] <= rec["spans"]["fed.evaluate"]["seconds"]


def test_the_loader_counts_its_gets_and_queue_depth(tree):
    with open(os.path.join(tree, "txt_lists", "pacs", "cartoon_train.txt")) as f:
        rows = [line.split() for line in f]
    paths = [os.path.join(tree, p) for p, _ in rows] * 3
    loader = ImageBatchLoader(paths, batch_size=4, image_size=32, prefetch=2, backend="pil")
    with _profiled():
        batches = list(loader)
    rec = record()
    assert len(batches) == len(loader) == 5
    assert rec["counters"]["loader.gets"] == len(loader)
    assert rec["spans"]["loader.decode"]["count"] == len(loader)
    assert 0 <= rec["counters"]["loader.queue_depth"] <= 2 * len(loader)


def test_stylize_trace_dir_exports_the_runs_spans(tree, tmp_path, monkeypatch):
    common = ["--dataset", "pacs", "--list-root", tree, "--data-root", tree,
              "--style-stats-dir", str(tmp_path / "stats"), "--image-size", "32",
              "--batch-size", "4", "--dtype", "float32", "--device", "cpu"]
    assert cli(["style-bank", *common]) == 0
    with pytest.raises(SystemExit):
        cli(["style-bank", *common, "--trace-dir", str(tmp_path / "no")])
    trace = str(tmp_path / "trace")
    assert cli(["stylize", *common, "--target", "photo", "--output-root",
                str(tmp_path / "out"), "--trace-dir", trace]) == 0
    with open(os.path.join(trace, "spans.json")) as f:
        rec = json.load(f)
    counts = {k: v["count"] for k, v in rec["spans"].items()}
    # 6 images in batches of 4: 2 batches, and the loader's last, empty get
    assert counts["stylize.loader_wait"] == 3
    for name in ("stylize.h2d", "stylize.encode", "stylize.adain", "dispatch.wait",
                 "dispatch.d2h", "dispatch.emit"):
        assert counts[name] == 2, name
    assert counts["stylize.decode"] == 2 * 3
    assert rec["counters"]["stylize.h2d_bytes"] == 2 * 4 * 32 * 32 * 3
    # outputs of the valid rows only cross to the host
    assert rec["counters"]["dispatch.d2h_bytes"] == 3 * 6 * 32 * 32 * 3
    assert os.path.exists(os.path.join(trace, "trace.json"))
    assert stylize_mod.profiling.record() == rec
