"""One-command paper reproduction driver (``ccst-tpu-torch repro``).

Port of ``ccst_tpu/pipeline/repro.py``: the same chain, defaults and results
table, each stage through the port's CLI on ``--device`` (default ``cuda``).

Runs the COMPLETE CCST chain for a named dataset the way the paper does
(reference README.md:18-44,96-111):

  style-bank -> [filter-blank] -> [calibrate] -> stylize (overall/single)
  -> reorganize -> gen-lists -> fed-train (target x fusion arm x seed)
  -> summary table in the paper's layout (targets as columns, arms as rows,
     mean +/- sd over seeds at the best-val round — read_log.py:19-60
     semantics via utils/metrics.summarize_run).

On a fresh machine the ONLY missing ingredients are the dataset images and
the two AdaIN weight files (``vgg_normalised.pth`` / ``decoder.pth``,
reference README.md:21); docs/REPRODUCE.md names the exact expected layout.
Every other moving part — list generation, directory contracts, the
reference's per-dataset hyperparameters — is encoded here as defaults:

  PACS        resnet50  lr 1e-3 batch 64 img 222 iters 500 K=3  (README.md:98)
  OfficeHome  resnet18  lr 1e-3 batch 32 img 222 iters 500 K=3  (README.md:103)
  Camelyon17  densenet  lr 1e-3 batch 32 img  96 iters 200 K=4  (README.md:108)

Each stage is invoked through the SAME CLI entry points a human would use
(one code path, the CLI contract stays exercised); the driver only sequences
them and collects results. A marked-slow test runs this driver end-to-end on
a synthetic tree (tests/test_torch_repro.py).
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ccst_tpu_torch.config import dataset_spec

# the reference README's training commands, verbatim hyperparameters
PAPER_DEFAULTS: Dict[str, Dict] = {
    "pacs": dict(network="resnet50", lr=1e-3, batch_size=64, image_size=222,
                 rounds=500, k=3),
    "officehome": dict(network="resnet18", lr=1e-3, batch_size=32,
                       image_size=222, rounds=500, k=3),
    "camelyon17": dict(network="densenet", lr=1e-3, batch_size=32,
                       image_size=96, rounds=200, k=4),
}


@dataclass
class ReproConfig:
    dataset: str = "pacs"
    data_root: str = ""           # directory containing {DATASET}/kfold/...
    list_root: str = ""           # directory containing txt_lists/ ("" = data_root)
    output_root: str = ""         # stylized trees ("" = data_root)
    out_dir: str = "repro_out"    # logs, checkpoints, results table
    vgg_weights: str = ""         # vgg_normalised.pth (or .npz); "" = random (tests)
    decoder_weights: str = ""     # decoder.pth (or .npz)
    targets: str = ""             # comma list; "" = every domain in turn
    modes: str = "overall,single"  # fusion families to build + train
    k: int = 0                    # styles per image; 0 = paper default
    seeds: str = "1,2,3"          # fed-train seeds (paper reports 3-seed means)
    network: str = ""             # "" = paper default for the dataset
    rounds: int = 0               # 0 = paper default
    lr: float = 0.0               # 0 = paper default
    batch_size: int = 0           # fed batch; 0 = paper default
    image_size: int = 0           # fed resolution; 0 = paper default
    stylize_size: int = 0         # 0 = dataset spec (512 for PACS/camelyon17)
    stylize_batch: int = 32
    engine: str = "ref"           # stylize executor (ref | packed | int8 | int8-static | int8-fused)
    fed_mode: str = "fedavg"
    wk_iters: int = 1
    skip_baseline: bool = False   # drop the no_fusion comparison arm
    skip_stylize: bool = False    # reuse an existing stylized tree + lists
    dtype: str = "bfloat16"       # stylize compute dtype ("float32" on CPU tests)
    val_size: float = 0.1
    device: str = "cuda"          # every stage's --device ("cpu": the plain versions)


def _csv(s: str) -> List[str]:
    return [x.strip() for x in s.split(",") if x.strip()]


def _run(cli, argv: List[str]) -> None:
    rc = cli(argv)
    if rc != 0:
        raise RuntimeError(f"stage failed (rc={rc}): {' '.join(argv[:4])} ...")


def run_repro(cfg: ReproConfig) -> Dict:
    """Execute the full chain; returns (and writes) the results table."""
    from ccst_tpu_torch.cli import main
    from ccst_tpu_torch.utils.metrics import summarize_run

    def cli_main(argv: List[str]) -> int:
        return main([*argv, "--device", cfg.device])

    spec = dataset_spec(cfg.dataset)
    paper = PAPER_DEFAULTS.get(cfg.dataset.lower(), PAPER_DEFAULTS["pacs"])
    list_root = cfg.list_root or cfg.data_root
    output_root = cfg.output_root or cfg.data_root
    targets = _csv(cfg.targets) or list(spec.domains)
    modes = _csv(cfg.modes)
    seeds = [int(s) for s in _csv(cfg.seeds)]
    k = cfg.k or paper["k"]
    network = cfg.network or paper["network"]
    rounds = cfg.rounds or paper["rounds"]
    lr = cfg.lr or paper["lr"]
    fed_batch = cfg.batch_size or paper["batch_size"]
    fed_size = cfg.image_size or paper["image_size"]
    stylize_size = cfg.stylize_size or spec.stylize_size

    os.makedirs(cfg.out_dir, exist_ok=True)
    weights = []
    if cfg.vgg_weights:
        weights += ["--vgg-weights", cfg.vgg_weights]
    if cfg.decoder_weights:
        weights += ["--decoder-weights", cfg.decoder_weights]
    sty_common = [
        "--dataset", cfg.dataset, "--list-root", list_root,
        "--data-root", cfg.data_root, "--output-root", output_root,
        "--style-stats-dir", os.path.join(output_root, "style_stats"),
        "--image-size", str(stylize_size),
        "--batch-size", str(cfg.stylize_batch), "--dtype", cfg.dtype,
        "--engine", cfg.engine, "--seed", "1", *weights,
    ]
    if spec.output_size > 0:
        sty_common += ["--output-size", str(spec.output_size)]

    if not cfg.skip_stylize:
        # stage 1: style banks for every domain (mean_std_computation with
        # the commented-out np.save actually enabled)
        _run(cli_main, ["style-bank", *sty_common])
        if "single" in modes and cfg.dataset.lower() == "camelyon17":
            # single mode samples style images from the _discardBlackWhite
            # lists (CCST_SingleStyleTransfer.py:165-166); the reference
            # uses but does not ship the filter
            _run(cli_main, [
                "filter-blank", "--dataset", cfg.dataset,
                "--list-root", list_root, "--data-root", cfg.data_root,
            ])
        # stage 2: cross-client transfer, once per CONTENT domain per mode.
        # The stylized tree (all_style_transferred_*) is target-independent
        # — each domain's images restyled under every OTHER domain's style —
        # so it is shared by every fed target; a target's unified tree then
        # needs every of ITS SOURCE domains stylized (the reorganize stage
        # below reads content=source entries, reference
        # reorganize_dataset.py:44-83).
        content_domains = [
            d for d in spec.domains
            if any(d != t for t in targets)  # a source for some target
        ]
        for content in content_domains:
            if cfg.engine in ("int8-static", "int8-fused"):
                _run(cli_main, ["calibrate", *sty_common, "--target", content])
            for mode in modes:
                _run(cli_main, [
                    "stylize", *sty_common, "--target", content, "--mode", mode,
                ])
        # stages 3-4 per fed target: unified tree + K-sampled lists
        for target in targets:
            for mode in modes:
                _run(cli_main, [
                    "reorganize", "--dataset", cfg.dataset, "--target", target,
                    "--mode", mode, "--list-root", list_root,
                    "--data-root", output_root,
                ])
                _run(cli_main, [
                    "gen-lists", "--dataset", cfg.dataset, "--target", target,
                    "--mode", mode, "--k", str(k), "--seed", "1",
                    "--list-root", list_root,
                ])

    # stage 5: federated training, one run per arm x target x seed
    arms = [f"adain-{m}-K{k}" for m in modes]
    if not cfg.skip_baseline:
        arms = ["no_fusion"] + arms
    table: Dict[str, Dict[str, Dict]] = {}
    for arm in arms:
        table[arm] = {}
        for target in targets:
            accs = []
            for seed in seeds:
                run_dir = os.path.join(
                    cfg.out_dir, arm, target, f"seed{seed}"
                )
                log_dir = os.path.join(run_dir, "logs")
                _run(cli_main, [
                    "fed-train", "--dataset", cfg.dataset, "--target", target,
                    "--mode", cfg.fed_mode, "--fusion-mode", arm,
                    "--network", network, "--rounds", str(rounds),
                    "--wk-iters", str(cfg.wk_iters), "--lr", str(lr),
                    "--batch-size", str(fed_batch),
                    "--image-size", str(fed_size),
                    "--val-size", str(cfg.val_size), "--seed", str(seed),
                    "--data-root", cfg.data_root, "--list-root", list_root,
                    "--save-path", os.path.join(run_dir, "ckpt"),
                    "--log-path", log_dir,
                    "--save-freq", str(max(rounds // 10, 1)),
                ])
                logs = glob.glob(os.path.join(log_dir, "*.jsonl"))
                if len(logs) != 1:
                    raise RuntimeError(
                        f"expected exactly one run log in {log_dir}, "
                        f"found {logs}"
                    )
                s = summarize_run(logs[0], expected_rounds=rounds)
                if not s["complete"]:
                    raise RuntimeError(f"incomplete run: {logs[0]} -> {s}")
                accs.append(float(s["test_acc_at_best_val"]))
            table[arm][target] = {
                "seeds": seeds,
                "accs": accs,
                "mean": float(np.mean(accs)),
                "sd": float(np.std(accs)),
            }
        row = table[arm]
        row["__avg__"] = {
            "mean": float(np.mean([row[t]["mean"] for t in targets])),
            "sd": float(np.mean([row[t]["sd"] for t in targets])),
        }

    result = {
        "dataset": cfg.dataset,
        "network": network,
        "rounds": rounds,
        "k": k,
        "targets": targets,
        "arms": arms,
        "table": table,
    }
    out_path = os.path.join(cfg.out_dir, "repro_results.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)

    # the paper's table layout: one row per arm, one column per target
    width = max(len(a) for a in arms) + 2
    cols = targets + ["avg"]
    lines = ["".ljust(width) + "  ".join(c[:12].rjust(13) for c in cols)]
    for arm in arms:
        cells = [
            f"{table[arm][t]['mean']:.3f}±{table[arm][t]['sd']:.3f}"
            for t in targets
        ] + [f"{table[arm]['__avg__']['mean']:.3f}"]
        lines.append(arm.ljust(width) + "  ".join(c.rjust(13) for c in cells))
    result["rendered"] = "\n".join(lines)
    print(result["rendered"])
    print(f"results table -> {out_path}")
    return result
