"""ccst-tpu-torch — the CLI of the PyTorch / CUDA port.

The ``style-bank``, ``calibrate`` and ``stylize`` subcommands of ``ccst-tpu``,
over the same ``StylizeConfig`` flags, and its list subcommands
``reorganize``, ``gen-lists``, ``filter-blank`` and ``split-data`` with its
flags and defaults; every subcommand also takes ``--device`` (default
``cuda``; the list subcommands touch no device and ignore it):

  ccst-tpu-torch style-bank --dataset pacs --list-root $DATA --data-root $DATA ...
  ccst-tpu-torch calibrate  --dataset pacs --target photo --engine int8-fused ...
  ccst-tpu-torch stylize    --dataset pacs --target photo --mode overall|single \
                            --engine ref|packed|int8|int8-static|int8-fused \
                            [--skip-existing] [--output-size 96] [--trace-dir DIR] ...

``style-bank --model wct`` writes WCT's second-order banks
(``{domain}_wct.npz``) and ``stylize --model wct --mode overall --engine ref``
stylizes with them through the five-level cascade (``pipeline/wct.py``; its
``--decoder-weights`` is one ``.npz`` of the five decoders).
  ccst-tpu-torch reorganize --dataset pacs --target photo --list-root $DATA ...
  ccst-tpu-torch gen-lists  --dataset pacs --target photo --k 3 --list-root $DATA
  ccst-tpu-torch amp-bank   --dataset pacs --domain cartoon --list-root $DATA
  ccst-tpu-torch fed-train  --dataset pacs --target photo --mode fedavg \
                            --fusion-mode adain-overall-K3 --network resnet50 ...
  ccst-tpu-torch fed-test   --dataset pacs --target photo ... --checkpoint best [--tent]

``fed-train`` trains the clients one after another on one device, or with
``--parallel-clients`` every client at once in one vmapped step, with cuDNN's
deterministic algorithms unless ``--nondeterministic`` is given (also on
``fed-test``). ``--coordinator HOST:PORT --num-procs N --proc-id K`` (or the
``CCST_COORDINATOR`` / ``CCST_NUM_PROCS`` / ``CCST_PROC_ID`` environment
variables) launches one rank of an N-process run on ``torch.distributed``
(``federated/multihost_runtime.py``: the clients split over the ranks,
``--data-shards D`` ranks splitting each client's batch); ``--client-shards``
/ ``--data-shards`` above 1 need such a launch. ``fed-train --test-only``
evaluates the best checkpoint (``ccst-tpu`` accepts the flag there and trains
anyway).

``stylize --trace-dir DIR`` and ``fed-train --trace-dir DIR`` write a
``torch.profiler`` trace of the run (``DIR/trace.json``) and the port's spans
and counters (``DIR/spans.json``, ``utils/profiling.py``).

  ccst-tpu-torch train-decoder --dataset pacs --domains art_painting,cartoon,sketch ...
  ccst-tpu-torch invert-train --dataset pacs --source art_painting --loss mse+perceptual ...
  ccst-tpu-torch invert-eval  --dataset pacs --source art_painting [--overall] [--holdout] \
                              [--lpips-vgg vgg16.pth --lpips-lin lin.pth]
  ccst-tpu-torch gan-train    --dataset pacs --source art_painting --gp-weight 10 \
                              --attn-res 32 --fid-samples 64

``train-decoder`` writes the decoder ``.npz`` that ``ccst-tpu stylize
--decoder-weights`` also reads; ``invert-eval`` reads ``ccst-tpu
invert-train``'s checkpoints as well as its own. ``invert-train`` takes the
same launch flags as ``fed-train`` (the reference's DDP loop: each rank its
strided shard of the images, the gradients averaged over the ranks);
``gan-train`` writes its state dicts to ``gan_{dataset}_{source}.pt``
(``ccst-tpu`` writes ``.msgpack``).

``calibrate`` writes the int8 scales file that ``stylize`` of either package
picks up (``--scales PATH``, or the default path next to the style banks).

  ccst-tpu-torch repro     --dataset pacs --data-root $DATA --vgg-weights V --decoder-weights D
  ccst-tpu-torch summarize logs/run_seed1.jsonl logs/run_seed2.jsonl [--expected-rounds 500]
  ccst-tpu-torch plot      logs/a.jsonl logs/b.jsonl -o curves.png [--metrics test_acc]

``repro`` runs the whole chain (style banks, stylize, reorganize, lists,
``fed-train`` for every arm, target and seed, the results table) through these
subcommands on ``--device``; ``summarize`` and ``plot`` read ``fed-train``'s
JSONL logs. Of ``ccst-tpu``'s subcommands the port lacks only ``bench``, which
runs the TPU benchmark.

Weights are ``.pth`` (reference checkpoints) or the native ``.npz`` that
``ccst-tpu`` also reads.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import fields
from typing import Any, Optional

import numpy as np
import torch


def _add_dataclass_args(parser: argparse.ArgumentParser, cls, skip=()) -> None:
    for f in fields(cls):
        if f.name in skip:
            continue
        arg = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(arg, action="store_true", default=f.default)
        else:
            caster = type(f.default) if f.default is not None else str
            parser.add_argument(arg, type=caster, default=f.default)


def _dataclass_from_args(cls, args) -> Any:
    return cls(**{f.name: getattr(args, f.name) for f in fields(cls) if hasattr(args, f.name)})


def _load_engine_params(args):
    from ccst_tpu_torch.models import vgg
    from ccst_tpu_torch.models.convert import load_decoder, load_encoder

    if args.vgg_weights:
        enc = load_encoder(args.vgg_weights)
    else:
        print("[warn] no --vgg-weights given; using random encoder init")
        enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(0))
    if args.decoder_weights:
        dec = load_decoder(args.decoder_weights)
    else:
        print("[warn] no --decoder-weights given; using random decoder init")
        dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(1))
    return enc, dec


def _load_wct_params(args):
    """WCT's encoder (VGG-19 on to conv5_1, from ``--vgg-weights``) and its
    five decoders (one ``.npz``, ``pipeline/wct.py::save_decoders``)."""
    from ccst_tpu_torch.models import vgg
    from ccst_tpu_torch.models.convert import load_weights
    from ccst_tpu_torch.pipeline import wct

    if args.vgg_weights:
        enc = load_weights(args.vgg_weights, vgg.WCT_ENCODER_ARCH)
        missing = [l.name for l in vgg.WCT_ENCODER_ARCH
                   if isinstance(l, vgg.Conv) and l.name not in enc]
        if missing:
            raise SystemExit(f"{args.vgg_weights} lacks WCT's encoder layers {missing}")
    else:
        print("[warn] no --vgg-weights given; using random encoder init")
        enc = vgg.init_params(vgg.WCT_ENCODER_ARCH, torch.Generator().manual_seed(0))
    if args.decoder_weights:
        decs = wct.load_decoders(args.decoder_weights)
    else:
        print("[warn] no --decoder-weights given; using random decoder init")
        decs = wct.init_decoders(torch.Generator().manual_seed(1))
    return enc, decs


def _env_int(name: str) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return 0
    try:
        return int(raw)
    except ValueError:
        raise SystemExit(f"{name}={raw!r} is not an integer")


def _multiproc_requested(coordinator: str, num_procs: int) -> bool:
    """True when a multi-process launch is asked for by the flags or by the
    CCST_COORDINATOR / CCST_NUM_PROCS environment variables. A bare
    CCST_PROC_ID does not count: it is most likely stale shell state."""
    return bool(coordinator or num_procs > 1 or os.environ.get("CCST_COORDINATOR")
                or _env_int("CCST_NUM_PROCS") > 1)


def _maybe_init_multiproc(coordinator: str, num_procs: int, proc_id: int, device: str) -> bool:
    """Join the process group when a launch is asked for; returns whether it
    did."""
    if not _multiproc_requested(coordinator, num_procs):
        return False
    from ccst_tpu_torch.parallel import multihost

    multihost.initialize(coordinator or None, num_procs if num_procs > 0 else None,
                         proc_id if proc_id >= 0 else None, device=device)
    return True


def cmd_style_bank(args) -> int:
    from ccst_tpu_torch.config import StylizeConfig, dataset_spec
    from ccst_tpu_torch.pipeline.style_bank import compute_style_bank

    cfg = _dataclass_from_args(StylizeConfig, args)
    domains = [args.domain] if args.domain else list(dataset_spec(cfg.dataset).domains)
    if args.model == "wct":
        from ccst_tpu_torch.pipeline.style_bank import compute_wct_bank

        enc, _ = _load_wct_params(args)
        for domain in domains:
            bank = compute_wct_bank(cfg, domain, enc, device=args.device)
            print(f"{domain}: WCT bank trace of cov by level = " + ", ".join(
                f"{lv} {float(bank.cov[lv].trace()):.3f}" for lv in bank.cov))
        return 0
    enc, _ = _load_engine_params(args)
    for domain in domains:
        mean, std = compute_style_bank(cfg, domain, encoder_params=enc, device=args.device)
        print(f"{domain}: bank mean|std norms = {np.linalg.norm(mean):.3f} | "
              f"{np.linalg.norm(std):.3f}")
    return 0


def _load_scales_for(cfg, enc, dec):
    """The int8 calibration for a stylize run: an explicit ``--scales PATH``
    must exist and belong to these weights (else it raises); with no flag,
    ``calibrate``'s default file is loaded when present, and skipped with a
    warning when it belongs to other weights (the engine then calibrates on
    its first batch). Stale clipping ranges are never applied silently."""
    from ccst_tpu_torch.models.vgg_fast import load_scales, weights_fingerprint
    from ccst_tpu_torch.pipeline.stylize import INT8_ENGINES, scales_path_for

    if cfg.engine not in INT8_ENGINES:
        return None

    fp = weights_fingerprint(enc, dec)
    if cfg.scales:
        return load_scales(cfg.scales, expect_fingerprint=fp)
    default = scales_path_for(cfg)
    if os.path.exists(default):
        try:
            scales = load_scales(default, expect_fingerprint=fp)
        except ValueError as e:
            print(f"[warn] ignoring stale calibration: {e}")
            return None
        print(f"[info] loading int8 calibration from {default}")
        return scales
    return None


def cmd_calibrate(args) -> int:
    """Compute and write the int8 engines' static activation scales (the
    first ``--max-images`` train-list images and the style banks,
    ``run_calibration``)."""
    from ccst_tpu_torch.config import StylizeConfig
    from ccst_tpu_torch.pipeline.style_bank import torch_dtype
    from ccst_tpu_torch.pipeline.stylize import INT8_ENGINES, StylizeEngine, run_calibration

    cfg = _dataclass_from_args(StylizeConfig, args)
    enc, dec = _load_engine_params(args)
    engine = StylizeEngine(
        enc, dec, dtype=torch_dtype(cfg.dtype), device=args.device,
        # only the static engines have scales to write
        engine=cfg.engine if cfg.engine in INT8_ENGINES else "int8-static",
    )
    # --scales doubles as the output path (stylize --scales then reads it)
    path = run_calibration(cfg, engine, max_images=args.max_images, out_path=cfg.scales)
    print(json.dumps({"scales_path": path, "n_scales": len(engine.scales)}))
    return 0


def cmd_stylize(args) -> int:
    from ccst_tpu_torch.config import StylizeConfig
    from ccst_tpu_torch.pipeline.style_bank import torch_dtype
    from ccst_tpu_torch.pipeline.stylize import (
        StylizeEngine,
        run_overall_transfer,
        run_single_transfer,
    )

    cfg = _dataclass_from_args(StylizeConfig, args)
    if args.model == "wct":
        from ccst_tpu_torch.pipeline.wct import WCTEngine

        if cfg.engine != "ref" or cfg.mode.lower() != "overall" or cfg.skip_existing:
            raise SystemExit("--model wct runs --engine ref --mode overall without "
                             "--skip-existing (its int8 engines and Single mode are later work)")
        enc, decs = _load_wct_params(args)
        engine = WCTEngine(enc, decs, dtype=torch_dtype(cfg.dtype), device=args.device,
                           output_size=cfg.output_size, output_u8=True)
    else:
        enc, dec = _load_engine_params(args)
        engine = StylizeEngine(
            enc, dec, dtype=torch_dtype(cfg.dtype), device=args.device,
            output_size=cfg.output_size,
            output_u8=True,  # quantize on the device: 4x less device->host traffic
            engine=cfg.engine, scales=_load_scales_for(cfg, enc, dec),
        )
    run = run_single_transfer if cfg.mode.lower() == "single" else run_overall_transfer
    report = run(cfg, engine)
    print(
        json.dumps(
            {
                "target": report.target,
                "styles": report.styles,
                "images_per_style": report.images,
                "seconds": round(report.seconds, 2),
                "images_per_sec": round(report.images_per_sec, 2),
            }
        )
    )
    return 0


def cmd_reorganize(args) -> int:
    from ccst_tpu_torch.data.lists import reorganize_unified_tree

    n = reorganize_unified_tree(
        args.list_root, args.dataset, args.target, args.mode,
        style_family=args.style, link=not args.copy,
        data_root=args.data_root, save_ext=args.save_ext,
    )
    print(f"placed {n} files in the unified tree for target={args.target}")
    return 0


def cmd_gen_lists(args) -> int:
    from ccst_tpu_torch.config import FusionConfig
    from ccst_tpu_torch.data.lists import generate_k_lists

    cfg = _dataclass_from_args(FusionConfig, args)
    written = generate_k_lists(
        args.list_root, cfg.dataset, cfg.target, cfg.k,
        mode=cfg.mode, style_family=cfg.style, seed=cfg.seed, save_ext=cfg.save_ext,
    )
    for client, path in written.items():
        print(f"{client}: {path}")
    return 0


def cmd_filter_blank(args) -> int:
    from ccst_tpu_torch.data.lists import filter_blank_images

    written = filter_blank_images(
        args.list_root, args.dataset, data_root=args.data_root,
        brightness_lo=args.brightness_lo, brightness_hi=args.brightness_hi,
        min_std=args.min_std,
    )
    for domain, path in written.items():
        print(f"{domain}: {path}")
    return 0


def cmd_split_data(args) -> int:
    from ccst_tpu_torch.data.lists import split_image_tree

    written = split_image_tree(
        args.data_root, args.dataset, args.list_root or args.data_root,
        train_fraction=args.train_fraction, seed=args.seed, tree_subdir=args.tree_subdir,
    )
    for domain, (tr, te) in written.items():
        print(f"{domain}: {tr} | {te}")
    return 0


def cmd_amp_bank(args) -> int:
    from ccst_tpu_torch.pipeline.amp_bank import compute_amp_bank

    n = compute_amp_bank(
        list_root=args.list_root, data_root=args.data_root, dataset=args.dataset,
        domain=args.domain, image_size=args.image_size, out_root=args.out_root or args.list_root,
    )
    print(f"wrote {n} amplitude spectra for {args.domain}")
    return 0


def _fed_test(runner, which: str, tent: bool) -> int:
    """``fed-test``: the target accuracy of checkpoint ``which``; with
    ``tent``, before and after test-time adaptation."""
    if not tent:
        acc = runner.test_only(which)
        print(f"target test accuracy: {acc:.4f}")
        print(json.dumps({"checkpoint": which, "test_acc": acc}))
        return 0
    from ccst_tpu_torch.federated.tent import tent_test
    from ccst_tpu_torch.utils.precision import no_tf32

    state = runner.load_server(which)
    with no_tf32(runner.deterministic):
        _, pre = runner.evaluate(state, runner.test_loader)
        print(f"pre-tent accuracy: {pre:.4f}")
        _, acc = tent_test(runner.eval_model, state, runner.test_loader, runner.cfg.image_size,
                           runner.batch_dict, logger=runner.logger)
    print(f"tent accuracy: {acc:.4f}")
    print(json.dumps({"checkpoint": which, "pre_tent_acc": pre, "tent_acc": acc}))
    return 0


def cmd_fed_train(args) -> int:
    from ccst_tpu_torch.config import FedConfig
    from ccst_tpu_torch.federated.runtime import FederatedRunner

    cfg = _dataclass_from_args(FedConfig, args)
    if _multiproc_requested(cfg.coordinator, cfg.num_procs):
        if cfg.mode.lower() == "deepall":
            raise SystemExit("--mode deepall pools every source into ONE pseudo-client and "
                             "cannot be split across processes; run it in one process")
        if cfg.test_only:
            raise SystemExit("--test-only evaluates in one process; drop the launch flags")
    multiproc = _maybe_init_multiproc(cfg.coordinator, cfg.num_procs, cfg.proc_id, args.device)
    amp_bank = None
    if cfg.dg_method.lower() == "feddg":
        from ccst_tpu_torch.pipeline.amp_bank import load_amp_bank

        amp_bank = load_amp_bank(args.list_root, cfg.dataset, cfg.source_domains,
                                 max_per_domain=64)
    if multiproc:
        from ccst_tpu_torch.federated.multihost_runtime import MultihostFedRunner

        runner = MultihostFedRunner(cfg, amp_bank=amp_bank, device=args.device,
                                    deterministic=not args.nondeterministic)
        print(json.dumps(runner.run()))
        return 0
    runner = FederatedRunner(cfg, amp_bank=amp_bank, device=args.device,
                             deterministic=not args.nondeterministic)
    if cfg.test_only:  # ccst-tpu accepts the flag on fed-train and trains anyway
        return _fed_test(runner, "best", tent=False)
    print(json.dumps(runner.run()))
    return 0


def cmd_fed_test(args) -> int:
    from ccst_tpu_torch.config import FedConfig
    from ccst_tpu_torch.federated.runtime import FederatedRunner

    cfg = _dataclass_from_args(FedConfig, args)
    runner = FederatedRunner(cfg, device=args.device, deterministic=not args.nondeterministic)
    return _fed_test(runner, args.checkpoint, cfg.tent)


def cmd_train_decoder(args) -> int:
    from ccst_tpu_torch.pipeline.train_decoder import DecoderTrainConfig, train_decoder

    cfg = DecoderTrainConfig(
        dataset=args.dataset,
        content_domain=args.content_domain,
        style_domain=args.style_domain,
        list_root=args.list_root,
        data_root=args.data_root,
        image_size=args.image_size,
        batch_size=args.batch_size,
        steps=args.steps,
        lr=args.lr,
        style_weight=args.style_weight,
        seed=args.seed,
        vgg_weights=args.vgg_weights,
        init_decoder=args.init_decoder,
        domains=args.domains,
        out_path=args.out_path,
    )
    print(json.dumps(train_decoder(cfg, device=args.device)))
    return 0


def cmd_invert_train(args) -> int:
    from ccst_tpu_torch.privacy.invert import InvertConfig, train_inverter

    cfg = InvertConfig(
        dataset=args.dataset, source=args.source, list_root=args.list_root,
        data_root=args.data_root, image_size=args.image_size, batch_size=args.batch_size,
        steps=args.steps, lr=args.lr, seed=args.seed, out_dir=args.out_dir,
        vgg_weights=args.vgg_weights, loss=args.loss, perc_weight=args.perc_weight,
        coordinator=args.coordinator, num_procs=args.num_procs, proc_id=args.proc_id,
    )
    # the reference's one DDP entry point (imagenet_reconstruct.py:141-175):
    # train_inverter joins the process group when the config asks for a launch
    print(json.dumps(train_inverter(cfg, device=args.device)))
    return 0


def cmd_invert_eval(args) -> int:
    from ccst_tpu_torch.privacy.invert import InvertConfig, evaluate_inverter

    cfg = InvertConfig(
        dataset=args.dataset, source=args.source, list_root=args.list_root,
        data_root=args.data_root, image_size=args.image_size, batch_size=args.batch_size,
        seed=args.seed, out_dir=args.out_dir, vgg_weights=args.vgg_weights,
        lpips_vgg=args.lpips_vgg, lpips_lin=args.lpips_lin,
        style_stats_dir=args.style_stats_dir,
    )
    report = evaluate_inverter(cfg, target=args.target, overall=args.overall,
                               holdout=args.holdout, device=args.device)
    print(json.dumps(report))
    return 0


def cmd_gan_train(args) -> int:
    """Train the lightweight GAN (hinge + DiffAugment + aux recon) on one
    domain's train images; writes ``gan_{dataset}_{source}.pt`` (the three
    state dicts), four EMA samples and, with ``--fid-samples``, the closing
    VGG-Frechet distance."""
    import time

    from ccst_tpu_torch.data.lists import parse_list, train_list_path
    from ccst_tpu_torch.data.loader import ImageBatchLoader, save_image_u8
    from ccst_tpu_torch.pipeline.train_decoder import synchronize
    from ccst_tpu_torch.privacy.gan import GanConfig, GanTrainer, vgg_frechet_distance
    from ccst_tpu_torch.utils.checkpoint import save_checkpoint
    from ccst_tpu_torch.utils.metrics import MetricsLogger

    cfg = GanConfig(
        image_size=args.image_size, latent_dim=args.latent_dim,
        batch_size=args.batch_size, lr=args.lr, steps=args.steps,
        aug_policy=args.aug_policy, seed=args.seed, fmap_max=args.fmap_max,
        gp_weight=args.gp_weight,
        attn_res=tuple(int(r) for r in args.attn_res.split(",") if r.strip()),
    )
    names, labels = parse_list(train_list_path(args.list_root, args.dataset, args.source))
    paths = [os.path.join(args.data_root, n) if args.data_root else n for n in names]
    loader = ImageBatchLoader(
        paths, labels, batch_size=cfg.batch_size, image_size=cfg.image_size,
        shuffle=True, seed=cfg.seed, loop=True, drop_last=True,
    )
    trainer = GanTrainer(cfg, device=args.device)
    logger = MetricsLogger(os.path.join(args.out_dir, f"gan_{args.dataset}_{args.source}.jsonl"))
    it = iter(loader)
    metrics = {}  # stays empty for --steps 0 (e.g. FID-score-only runs)
    t_start = None
    for step in range(cfg.steps):
        batch = next(it)
        metrics = trainer.train_step(torch.from_numpy(batch.images), step_idx=step)
        if step == 0:
            t_start = time.perf_counter()  # train_step's floats waited for the device
        if step % max(1, args.log_every) == 0:
            logger.log("gan_step", step=step, **metrics)
    synchronize(trainer.device)
    rate = ((cfg.steps - 1) / (time.perf_counter() - t_start) if cfg.steps > 1
            else float("nan"))
    save_checkpoint(os.path.join(args.out_dir, f"gan_{args.dataset}_{args.source}.pt"),
                    trainer.state())
    for i, img in enumerate(trainer.generate(4).cpu().numpy()):
        save_image_u8(img, os.path.join(args.out_dir, f"sample_{i}.png"))
    if args.fid_samples > 0:
        from ccst_tpu_torch.models import vgg
        from ccst_tpu_torch.models.convert import load_encoder

        # encoder only: the decoder plays no role in the Frechet metric
        enc = (load_encoder(args.vgg_weights) if args.vgg_weights
               else vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(0)))
        n = args.fid_samples
        real = np.concatenate(
            [next(it).images for _ in range((n + cfg.batch_size - 1) // cfg.batch_size)])[:n]
        fake = np.clip(trainer.generate(n).cpu().numpy(), 0.0, 1.0)
        metrics["fid_vgg"] = vgg_frechet_distance(enc, real, fake, device=trainer.device)
    logger.close()
    print(json.dumps({"steps": cfg.steps, "out_dir": args.out_dir, **metrics,
                      "steps_per_sec": rate, "img_per_sec": rate * cfg.batch_size}))
    return 0


def cmd_plot(args) -> int:
    from ccst_tpu_torch.utils.plotting import plot_runs

    out = plot_runs(
        args.logs, args.out,
        metrics=args.metrics.split(",") if args.metrics else None,
        title=args.title,
    )
    print(out)
    return 0


def cmd_repro(args) -> int:
    """Paper-reproduction driver (pipeline/repro.py): the full
    banks->stylize->reorganize->lists->fed-train->summary chain for a named
    dataset, with the reference README's hyperparameters as defaults."""
    from ccst_tpu_torch.pipeline.repro import ReproConfig, run_repro

    cfg = _dataclass_from_args(ReproConfig, args)
    if not cfg.data_root:
        raise SystemExit(
            "repro needs --data-root (the directory holding "
            f"{cfg.dataset.upper()}/kfold/... and txt_lists/; "
            "see docs/REPRODUCE.md for the exact layout)"
        )
    run_repro(cfg)
    return 0


def cmd_summarize(args) -> int:
    from ccst_tpu_torch.utils.metrics import summarize_many

    print(json.dumps(summarize_many(args.logs, args.expected_rounds), indent=2))
    return 0


def main(argv: Optional[list] = None) -> int:
    from ccst_tpu_torch.config import FedConfig, StylizeConfig
    from ccst_tpu_torch.pipeline.repro import ReproConfig

    parser = argparse.ArgumentParser(prog="ccst-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("style-bank", help="compute per-domain style statistics")
    _add_dataclass_args(p, StylizeConfig, skip=("trace_dir",))
    p.add_argument("--domain", default="", help="single domain (default: all)")
    p.set_defaults(fn=cmd_style_bank)

    p = sub.add_parser("stylize", help="cross-client style transfer")
    _add_dataclass_args(p, StylizeConfig)
    p.set_defaults(fn=cmd_stylize)
    for name in ("style-bank", "stylize"):
        sub.choices[name].add_argument(
            "--model", default="adain", choices=["adain", "wct"],
            help="AdaIN (relu4_1 mean/std banks) or WCT (five levels, second-order banks)")

    p = sub.add_parser("calibrate", help="write int8-static calibration scales")
    _add_dataclass_args(p, StylizeConfig, skip=("trace_dir",))
    p.add_argument("--max-images", type=int, default=8)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("reorganize", help="materialize the unified training tree")
    for name, default in (
        ("--dataset", "pacs"), ("--target", ""), ("--mode", "overall"),
        ("--style", "adain"), ("--list-root", ""), ("--data-root", ""),
        ("--save-ext", ""),
    ):
        p.add_argument(name, default=default)
    p.add_argument("--copy", action="store_true", help="copy instead of hardlink")
    p.set_defaults(fn=cmd_reorganize)

    p = sub.add_parser("gen-lists", help="generate K-sampled fusion lists")
    for name, default in (
        ("--dataset", "pacs"), ("--target", ""), ("--mode", "overall"),
        ("--style", "adain"), ("--list-root", ""),
    ):
        p.add_argument(name, default=default)
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save-ext", default="",
                   help="match the stylize stage's --save-ext, if any")
    p.set_defaults(fn=cmd_gen_lists)

    p = sub.add_parser("filter-blank", help="write _discardBlackWhite lists")
    p.add_argument("--dataset", default="camelyon17")
    p.add_argument("--list-root", default="")
    p.add_argument("--data-root", default="")
    p.add_argument("--brightness-lo", type=float, default=0.05)
    p.add_argument("--brightness-hi", type=float, default=0.95)
    p.add_argument("--min-std", type=float, default=0.02)
    p.set_defaults(fn=cmd_filter_blank)

    p = sub.add_parser("split-data", help="split an image tree into train/test lists")
    p.add_argument("--dataset", default="officehome")
    p.add_argument("--data-root", default="")
    p.add_argument("--list-root", default="")
    p.add_argument("--train-fraction", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--tree-subdir", default="")
    p.set_defaults(fn=cmd_split_data)

    p = sub.add_parser("amp-bank", help="precompute FedDG amplitude spectra")
    for name, default in (
        ("--dataset", "pacs"), ("--domain", ""), ("--list-root", ""),
        ("--data-root", ""), ("--out-root", ""),
    ):
        p.add_argument(name, default=default)
    p.add_argument("--image-size", type=int, default=222)
    p.set_defaults(fn=cmd_amp_bank)

    p = sub.add_parser("fed-train", help="federated training")
    _add_dataclass_args(p, FedConfig)
    p.set_defaults(fn=cmd_fed_train)

    p = sub.add_parser("fed-test", help="evaluate a federated checkpoint")
    _add_dataclass_args(p, FedConfig)
    p.add_argument("--checkpoint", default="best", choices=["best", "latest"])
    p.set_defaults(fn=cmd_fed_test)

    for name in ("fed-train", "fed-test"):
        sub.choices[name].add_argument(
            "--nondeterministic", action="store_true",
            help="let cuDNN pick its nondeterministic algorithms: a faster step whose "
                 "update differs in its last bits from run to run (the default is "
                 "deterministic)")

    p = sub.add_parser("invert-train", help="train a style-statistic inverter")
    for name, default in (
        ("--dataset", "pacs"), ("--source", ""), ("--list-root", ""), ("--data-root", ""),
        ("--out-dir", "inverter"), ("--vgg-weights", ""),
    ):
        p.add_argument(name, default=default)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--loss", choices=["mse", "mse+perceptual"], default="mse",
                   help="mse+perceptual = the LPIPS-criterion training variant "
                        "(imagenet_reconstruct_lpips.py)")
    p.add_argument("--perc-weight", type=float, default=0.1)
    p.add_argument("--coordinator", default="",
                   help="multi-process launch: HOST:PORT of rank 0 (or an init_method URL)")
    p.add_argument("--num-procs", type=int, default=0)
    p.add_argument("--proc-id", type=int, default=-1)
    p.set_defaults(fn=cmd_invert_train)

    p = sub.add_parser("invert-eval", help="PSNR/LPIPS of style-stat inversion")
    for name, default in (
        ("--dataset", "pacs"), ("--source", ""), ("--target", ""), ("--list-root", ""),
        ("--data-root", ""), ("--out-dir", "inverter"), ("--vgg-weights", ""),
        ("--lpips-vgg", ""), ("--lpips-lin", ""), ("--style-stats-dir", "style_stats"),
    ):
        p.add_argument(name, default=default)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--overall", action="store_true",
                   help="invert the domain-level Overall statistic")
    p.add_argument("--holdout", action="store_true",
                   help="score only the trainer's held-out val split")
    p.set_defaults(fn=cmd_invert_eval)

    p = sub.add_parser("gan-train", help="train the lightweight GAN on one domain")
    p.add_argument("--dataset", default="pacs")
    p.add_argument("--source", default="art_painting")
    p.add_argument("--list-root", default="")
    p.add_argument("--data-root", default="")
    p.add_argument("--out-dir", default="gan")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--latent-dim", type=int, default=256)
    p.add_argument("--fmap-max", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--aug-policy", default="color,translation,cutout")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gp-weight", type=float, default=0.0,
                   help="R1 gradient penalty weight (upstream uses 10)")
    p.add_argument("--attn-res", default="",
                   help="comma list of resolutions for LinearAttention, e.g. 32,64")
    p.add_argument("--fid-samples", type=int, default=0,
                   help="N>0: closing VGG-Frechet distance on N samples")
    p.add_argument("--vgg-weights", default="", help="encoder weights for --fid-samples")
    p.set_defaults(fn=cmd_gan_train)

    p = sub.add_parser("train-decoder", help="train the AdaIN decoder")
    p.add_argument("--dataset", default="pacs")
    p.add_argument("--content-domain", default="")
    p.add_argument("--style-domain", default="")
    p.add_argument("--list-root", default="")
    p.add_argument("--data-root", default="")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--style-weight", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--vgg-weights", default="")
    p.add_argument("--init-decoder", default="", help="warm-start decoder weights (.npz)")
    p.add_argument("--domains", default="",
                   help="comma-separated domain pool when content/style "
                        "domain is unset (e.g. sources only)")
    p.add_argument("--out-path", default="decoder_trained.npz")
    p.set_defaults(fn=cmd_train_decoder)

    p = sub.add_parser("summarize", help="read_log-style multi-run summary")
    p.add_argument("logs", nargs="+")
    p.add_argument("--expected-rounds", type=int, default=None)
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser(
        "plot", help="training-curve PNG from metrics JSONL (plotter.ipynb)"
    )
    p.add_argument("logs", nargs="+")
    p.add_argument("-o", "--out", default="curves.png")
    p.add_argument("--metrics", default="", help="comma-separated keys")
    p.add_argument("--title", default=None)
    p.set_defaults(fn=cmd_plot)

    for p in sub.choices.values():
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the plain versions; "
                            "the list subcommands, amp-bank, summarize and plot ignore it)")

    # after the loop above: ReproConfig has its own --device, which every stage gets
    p = sub.add_parser(
        "repro",
        help="one-command paper reproduction: banks -> stylize -> reorg -> "
        "lists -> fed-train (arm x target x seed) -> results table",
    )
    _add_dataclass_args(p, ReproConfig)
    p.set_defaults(fn=cmd_repro)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
