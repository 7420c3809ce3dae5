"""ccst-tpu-torch — the CLI of the PyTorch / CUDA port.

The ``style-bank`` and ``stylize`` subcommands of ``ccst-tpu``, over the same
``StylizeConfig`` flags, plus ``--device`` (default ``cuda``):

  ccst-tpu-torch style-bank --dataset pacs --list-root $DATA --data-root $DATA ...
  ccst-tpu-torch stylize    --dataset pacs --target photo --mode overall ...

Weights are ``.pth`` (reference checkpoints) or the native ``.npz`` that
``ccst-tpu`` also reads. The ported subset is listed in
``ccst_tpu_torch/pipeline/stylize.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import fields
from typing import Any, Optional

import numpy as np
import torch


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in fields(cls):
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


def cmd_style_bank(args) -> int:
    from ccst_tpu.config import StylizeConfig, dataset_spec
    from ccst_tpu_torch.pipeline.style_bank import compute_style_bank

    cfg = _dataclass_from_args(StylizeConfig, args)
    enc, _ = _load_engine_params(args)
    domains = [args.domain] if args.domain else list(dataset_spec(cfg.dataset).domains)
    for domain in domains:
        mean, std = compute_style_bank(cfg, domain, encoder_params=enc, device=args.device)
        print(f"{domain}: bank mean|std norms = {np.linalg.norm(mean):.3f} | "
              f"{np.linalg.norm(std):.3f}")
    return 0


def cmd_stylize(args) -> int:
    from ccst_tpu.config import StylizeConfig
    from ccst_tpu_torch.pipeline.style_bank import torch_dtype
    from ccst_tpu_torch.pipeline.stylize import (
        StylizeEngine,
        run_overall_transfer,
        run_single_transfer,
    )

    cfg = _dataclass_from_args(StylizeConfig, args)
    enc, dec = _load_engine_params(args)
    engine = StylizeEngine(
        enc, dec, dtype=torch_dtype(cfg.dtype), device=args.device,
        output_size=cfg.output_size,
        output_u8=True,  # quantize on the device: 4x less device->host traffic
        engine=cfg.engine,
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


def main(argv: Optional[list] = None) -> int:
    from ccst_tpu.config import StylizeConfig

    parser = argparse.ArgumentParser(prog="ccst-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("style-bank", help="compute per-domain style statistics")
    _add_dataclass_args(p, StylizeConfig)
    p.add_argument("--domain", default="", help="single domain (default: all)")
    p.set_defaults(fn=cmd_style_bank)

    p = sub.add_parser("stylize", help="cross-client style transfer")
    _add_dataclass_args(p, StylizeConfig)
    p.set_defaults(fn=cmd_stylize)

    for p in sub.choices.values():
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the plain versions)")

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
