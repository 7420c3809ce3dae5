"""The training stage through the port's CLI on the CPU: ``amp-bank`` against
``ccst-tpu amp-bank`` (the same ``.npy`` files, byte for byte), and
``fed-train`` / ``fed-test`` through ``python -m ccst_tpu_torch.cli ...
--device cpu`` on a tiny PACS tree (resnet4 at 33 px): two rounds, a resume
that starts at round 2, ``fed-test --checkpoint best`` printing exactly the
``test_acc`` the log recorded for the best round; in this process
``--in-test``, ``--tent``, ``--checkpoint latest``, every aggregation mode and DG plugin for a round, and the refused parallel
flags. No process of the port loads ``jax`` or ``ccst_tpu``.
"""
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccst_tpu.cli import main as jax_cli
from ccst_tpu.data.lists import write_list
from ccst_tpu.data.loader import save_image_u8
from ccst_tpu_torch.cli import main as torch_cli
from ccst_tpu_torch.utils.metrics import read_rounds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]
SOURCES = [d for d in DOMAINS if d != "photo"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in several
    workers at once, and each torch's default of a thread a core oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names, labels = [], []
        for i in range(10):
            rel = f"PACS/kfold/{d}/c{i % 7}/img{i}.png"
            save_image_u8(rng.random((40, 36, 3), np.float32), os.path.join(root, rel))
            names.append(rel)
            labels.append(i % 7)
        for part in ("train", "test"):
            write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_{part}.txt"), names, labels)
    return root


def _common(tree, out, *extra):
    return ["--dataset", "pacs", "--target", "photo", "--network", "resnet4", "--batch-size", "4",
            "--image-size", "33", "--list-root", tree, "--data-root", tree,
            "--save-path", os.path.join(out, "ckpt"), "--log-path", os.path.join(out, "logs"),
            "--save-freq", "1", *extra]


ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}  # as _one_torch_thread, for a process


def _run(*argv):
    return subprocess.run([sys.executable, "-m", "ccst_tpu_torch.cli", *argv, "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=300, env=ONE_THREAD)


def test_amp_bank_is_byte_equal_to_ccst_tpu(tree, tmp_path, capsys):
    outs = {}
    for tag, cli in (("jax", jax_cli), ("torch", torch_cli)):
        out = str(tmp_path / tag)
        for d in SOURCES:
            argv = ["amp-bank", "--dataset", "pacs", "--domain", d, "--list-root", tree,
                    "--data-root", tree, "--out-root", out, "--image-size", "33"]
            assert cli(argv + (["--device", "cpu"] if tag == "torch" else [])) == 0
        outs[tag] = out
        printed = capsys.readouterr().out
        assert printed.count("wrote 10 amplitude spectra") == len(SOURCES)
    files = sorted(os.path.relpath(os.path.join(dp, f), outs["jax"])
                   for dp, _, fs in os.walk(outs["jax"]) for f in fs)
    assert len(files) == 10 * len(SOURCES) and all(f.endswith(".npy") for f in files)
    for rel in files:
        assert filecmp.cmp(os.path.join(outs["jax"], rel), os.path.join(outs["torch"], rel),
                           shallow=False), rel


def test_fed_train_resume_and_fed_test_in_processes_of_their_own(tree, tmp_path):
    out = str(tmp_path)
    code = (
        "import sys, json\n"
        "from ccst_tpu_torch.cli import main\n"
        f"rc = main({['fed-train', *_common(tree, out, '--rounds', '2'), '--device', 'cpu']!r})\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ccst_tpu'))\n"
        "print(json.dumps({'rc': rc, 'loaded': loaded}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=ONE_THREAD)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}

    resumed = _run("fed-train", *_common(tree, out, "--rounds", "3", "--resume"))
    assert resumed.returncode == 0, resumed.stderr
    assert "[resume] round=2" in resumed.stdout

    log = os.path.join(out, "logs", "pacs_photo_fedavg_no_fusion_no_DG_resnet4_seed1.jsonl")
    records = read_rounds(log)
    rounds = [r for r in records if r["event"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1, 2]
    for r in rounds:
        assert all(np.isfinite(r[f"train_loss/{d}"]) for d in SOURCES)
        assert r["loader_wait_seconds"] >= 0
    best = max(rounds, key=lambda r: r["val_acc_mean"])  # the first of equals, as the runner
    best = next(r for r in rounds if r["val_acc_mean"] == best["val_acc_mean"])

    tested = _run("fed-test", *_common(tree, out), "--checkpoint", "best")
    assert tested.returncode == 0, tested.stderr
    assert json.loads(tested.stdout.strip().splitlines()[-1]) == {"checkpoint": "best",
                                                                  "test_acc": best["test_acc"]}


def test_fed_test_in_test_tent_and_latest(tree, tmp_path, capsys):
    out = str(tmp_path)
    assert torch_cli(["fed-train", *_common(tree, out, "--rounds", "2"), "--device", "cpu"]) == 0
    capsys.readouterr()
    for extra in (["--in-test"], ["--tent"], ["--checkpoint", "latest"]):
        assert torch_cli(["fed-test", *_common(tree, out), *extra, "--device", "cpu"]) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert all(0.0 <= v <= 1.0 for k, v in result.items() if k != "checkpoint"), result
    log = os.path.join(out, "logs", "pacs_photo_fedavg_no_fusion_no_DG_resnet4_seed1.jsonl")
    assert "tent_epoch" in {r["event"] for r in read_rounds(log)}


@pytest.mark.parametrize("extra", [["--mode", "fedbn"], ["--mode", "fedprox"],
                                   ["--mode", "adafea"], ["--mode", "deepall"],
                                   ["--dg-method", "RSC"], ["--dg-method", "Jigsaw"],
                                   ["--dg-method", "MixStyle"], ["--dg-method", "feddg"]],
                         ids=lambda e: e[1])
def test_every_mode_and_dg_plugin_trains_a_round(tree, tmp_path, capsys, extra):
    out = str(tmp_path)
    if extra[1] == "feddg":
        for d in SOURCES:
            assert torch_cli(["amp-bank", "--dataset", "pacs", "--domain", d, "--list-root", tree,
                              "--data-root", tree, "--out-root", tree, "--image-size", "33"]) == 0
    assert torch_cli(["fed-train", *_common(tree, out, "--rounds", "1", *extra),
                      "--device", "cpu"]) == 0
    best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert best["round"] == 0 and 0.0 <= best["test_acc"] <= 1.0
    assert torch_cli(["fed-train", *_common(tree, out, "--rounds", "1", *extra), "--test-only",
                      "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["test_acc"] == \
        best["test_acc"]


def test_parallel_flags_exit_with_the_roadmap_item(tree, tmp_path):
    """A mesh of more than one rank in one process exits naming the launch
    that provides the ranks (no longer a ROADMAP item: the launch is
    ported)."""
    proc = _run("fed-train", *_common(tree, str(tmp_path), "--rounds", "1", "--parallel-clients",
                                      "--client-shards", "3"))
    assert proc.returncode != 0 and "needs 3 ranks, have 1" in proc.stderr
    assert "--num-procs 3" in proc.stderr


def test_parallel_clients_cli_trains(tree, tmp_path):
    proc = _run("fed-train", *_common(tree, str(tmp_path), "--rounds", "1", "--parallel-clients"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 0.0 <= json.loads(proc.stdout.strip().splitlines()[-1])["test_acc"] <= 1.0
