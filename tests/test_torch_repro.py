"""The port's one-command repro driver (``ccst_tpu_torch/pipeline/repro.py``).

Fast: both packages' ``run_repro`` with their CLI's ``main`` replaced by a
recorder (which writes a run log for each ``fed-train``) must make the same
CLI calls in the same order with the same flags, the port's each with
``--device`` appended, and build the same results table. Slow (marked like
``tests/test_repro.py``): the whole chain on that test's synthetic tree
through the port's CLI on the CPU.
"""
import json
import os

import numpy as np
import pytest

import ccst_tpu.cli as jcli
import ccst_tpu_torch.cli as tcli
from ccst_tpu.pipeline.repro import ReproConfig as JConfig
from ccst_tpu.pipeline.repro import run_repro as j_repro
from ccst_tpu_torch.pipeline.repro import ReproConfig, run_repro
from tests.torch_parity import one_torch_thread  # noqa: F401


def _recorder(calls):
    def main(argv):
        calls.append(list(argv))
        if argv[0] == "fed-train":
            log_dir = argv[argv.index("--log-path") + 1]
            rounds = int(argv[argv.index("--rounds") + 1])
            seed = int(argv[argv.index("--seed") + 1])
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "run.jsonl"), "w") as f:
                for i in range(rounds):
                    f.write(json.dumps({"event": "round", "round": i, "val_acc_mean": 0.1 * i,
                                        "test_acc": 0.5 + 0.01 * i + 0.001 * seed}) + "\n")
        return 0

    return main


@pytest.mark.parametrize("kw", [
    dict(dataset="pacs", targets="photo,sketch", engine="int8-static", seeds="1,2", rounds=3),
    dict(dataset="camelyon17", modes="single", skip_baseline=True, k=2),
    dict(dataset="officehome", skip_stylize=True, seeds="3"),
])
def test_repro_makes_ccst_tpus_cli_calls(tmp_path, monkeypatch, capsys, kw):
    jcalls, tcalls = [], []
    monkeypatch.setattr(jcli, "main", _recorder(jcalls))
    monkeypatch.setattr(tcli, "main", _recorder(tcalls))
    common = dict(data_root=str(tmp_path / "data"), **kw)
    want = j_repro(JConfig(**common, out_dir=str(tmp_path / "out")))
    got = run_repro(ReproConfig(**common, out_dir=str(tmp_path / "out"), device="cpu"))
    assert tcalls == [c + ["--device", "cpu"] for c in jcalls]
    assert {c[0] for c in tcalls} >= {"fed-train"}
    assert got == want
    out = capsys.readouterr().out
    assert out.count(want["rendered"]) == 2


def test_repro_config_is_ccst_tpus_with_a_device():
    import dataclasses

    from ccst_tpu.pipeline import repro as jrepro
    from ccst_tpu_torch.pipeline import repro as trepro

    ours = [(f.name, f.default) for f in dataclasses.fields(ReproConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert ours == theirs + [("device", "cuda")]
    assert trepro.PAPER_DEFAULTS == jrepro.PAPER_DEFAULTS
    with pytest.raises(SystemExit, match="--data-root"):
        tcli.main(["repro", "--dataset", "pacs"])


@pytest.mark.slow  # several fed-train runs, like tests/test_repro.py
def test_repro_driver_end_to_end(tmp_path, monkeypatch):
    import ccst_tpu_torch.config as cc
    from ccst_tpu_torch.data.lists import parse_list
    from tests.test_repro import DOMAINS, _make_tree

    monkeypatch.setitem(cc.DATASETS, "pacs", cc.DatasetSpec(
        name="pacs", domains=tuple(DOMAINS), num_classes=2, image_size=36, stylize_size=36))
    root = str(tmp_path)
    _make_tree(root, np.random.default_rng(0))
    out_dir = os.path.join(root, "repro_out")
    result = run_repro(ReproConfig(
        dataset="pacs", data_root=root, out_dir=out_dir, targets="photo",
        modes="overall,single", k=2, seeds="1", network="resnet4", rounds=2, lr=0.05,
        batch_size=4, image_size=36, stylize_size=36, stylize_batch=4, dtype="float32",
        device="cpu"))
    assert result["arms"] == ["no_fusion", "adain-overall-K2", "adain-single-K2"]
    for arm in result["arms"]:
        cell = result["table"][arm]["photo"]
        assert len(cell["accs"]) == 1 and 0.0 <= cell["mean"] <= 1.0
        run_dir = os.path.join(out_dir, arm, "photo", "seed1")
        assert os.path.isdir(os.path.join(run_dir, "ckpt"))
        assert any(f.endswith(".jsonl") for f in os.listdir(os.path.join(run_dir, "logs")))
    for mode in ("overall", "single"):
        names, _ = parse_list(os.path.join(root, "txt_lists", f"pacs_adain-{mode}-K2", "photo",
                                           "cartoon_train.txt"))
        assert names and all(os.path.exists(os.path.join(root, n)) for n in names)
    saved = json.load(open(os.path.join(out_dir, "repro_results.json")))
    assert saved["table"] == result["table"]
    assert "no_fusion" in result["rendered"] and "±" in result["rendered"]
