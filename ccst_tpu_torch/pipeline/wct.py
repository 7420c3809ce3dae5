"""WCT universal style transfer (Li et al., arXiv:1705.08086) on the stylize
path: the five-level cascade under CCST's domain banks.

:class:`WCTEngine` is the engine of ``--model wct``, a sibling of AdaIN's
``StylizeEngine`` on ``pipeline/stylize.py::EngineBase``: the same input
staging (``_as_input``), uint8 epilogue (``_finish``) and dispatch-ahead copy
loop, so the CLI's Overall transfer and the benchmark drive it as they drive
AdaIN. ``stylize_multi`` takes a content batch under S second-order banks (``pipeline/style_bank.py::WCTBank``):

  - the content is encoded to relu5_1 once and whitened once (its relu5_1
    features are the same for every style);
  - each style then runs its own cascade, coarse to fine: colour at relu5_1
    and decode; then at relu4_1, relu3_1, relu2_1 and relu1_1 re-encode the
    decoded image to the level, whiten and colour it, and decode it with that
    level's decoder.

So a call of B images under S banks solves B (1 + 4 S) inverse square roots.
Convs run in the compute dtype through K3 (``kernels/conv.py``); the
transform's Gram sums in float32, its solve runs in float64 and its apply
takes compute-dtype operands with float32 sums (``ops/wct.py``). Only the ``ref`` engine and Overall
mode take WCT: the int8 engines, Single mode and ``--skip-existing`` refuse it.
While a profiler is active, ``stylize.wct_level`` spans each level's
encode-transform-decode, inside it ``stylize.encode``, ``stylize.wct`` and
``stylize.decode``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.ops import wct
from ccst_tpu_torch.pipeline.style_bank import WCTBank, load_wct_bank, wct_bank_path
from ccst_tpu_torch.pipeline.stylize import EngineBase
from ccst_tpu_torch.utils.profiling import span


# stylize_multi's check hook: (level, style, x, f, W_c, t, y) -> None
Recorder = Callable[[str, int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor], None]


class StackedBanks(NamedTuple):
    """S domains' banks on the device, by level: means (S, C) in float32 and
    colouring matrices (S, C, C) in float64."""

    mean: Dict[str, torch.Tensor]
    colour: Dict[str, torch.Tensor]


def init_decoders(generator: torch.Generator) -> Dict[str, vgg.Params]:
    """Torch's default init for the five decoders, float32 on the CPU."""
    return {level: vgg.init_params(vgg.WCT_DECODER_ARCHS[level], generator)
            for level in vgg.WCT_LEVELS}


def save_decoders(path: str, decoders: Dict[str, vgg.Params]) -> None:
    """The five decoders in one native ``.npz`` (``{level}.{conv}/w``, ``/b``)."""
    flat = {}
    for level, params in decoders.items():
        for name, p in params.items():
            for kind in ("w", "b"):
                flat[f"{level}.{name}/{kind}"] = np.asarray(torch.as_tensor(p[kind]).float())
    np.savez(path, **flat)


def load_decoders(path: str) -> Dict[str, vgg.Params]:
    out: Dict[str, vgg.Params] = {level: {} for level in vgg.WCT_LEVELS}
    with np.load(path) as data:
        for key in data.files:
            scoped, kind = key.rsplit("/", 1)
            level, name = scoped.split(".", 1)
            out[level].setdefault(name, {})[kind] = torch.as_tensor(data[key])
    missing = [lv for lv in vgg.WCT_LEVELS if not out[lv]]
    if missing:
        raise ValueError(f"{path} holds no decoder for {missing}")
    return out


class WCTEngine(EngineBase):
    """WCT stylization on one device; weights cast once to ``dtype``.
    ``encoder_params`` holds VGG-19 on to conv5_1, ``decoder_params`` one
    decoder a level of :data:`vgg.WCT_LEVELS`."""

    def __init__(self, encoder_params, decoder_params: Dict[str, vgg.Params], *,
                 dtype: torch.dtype = torch.bfloat16, device="cuda", output_size: int = -1,
                 output_u8: bool = False, engine: str = "ref"):
        if engine != "ref":
            raise ValueError(f"WCT runs on the ref engine only, not {engine!r} "
                             "(its int8 engines are later work)")
        super().__init__(dtype=dtype, device=device, output_size=output_size,
                         output_u8=output_u8)
        self.enc = vgg.prepare_params(encoder_params, dtype, self.device)
        self.decs = {level: vgg.prepare_params(decoder_params[level], dtype, self.device)
                     for level in vgg.WCT_LEVELS}

    def stack(self, banks: Sequence[WCTBank]) -> StackedBanks:
        """S domains' banks, stacked on the device once."""
        return StackedBanks(
            {lv: torch.stack([b.mean[lv] for b in banks]).float().to(self.device)
             for lv in vgg.WCT_LEVELS},
            {lv: torch.stack([b.colour[lv] for b in banks]).double().to(self.device)
             for lv in vgg.WCT_LEVELS})

    def overall_banks(self, cfg, styles: Sequence[str]):
        return (self.stack([load_wct_bank(wct_bank_path(cfg, s)) for s in styles]),)

    @torch.no_grad()
    def stylize_multi(self, images, banks: StackedBanks, alpha: float = 1.0,
                      record: Optional[Recorder] = None) -> torch.Tensor:
        """(B, H, W, 3) content x S banks -> (S, B, H, W, 3).

        ``record``, a check's hook, is called at each level of each style as
        ``record(level, s, x, f, w, t, y)`` with that level's input image
        ``x`` (B, H, W, 3), its features ``f``, their whitening ``W_c``
        (B, C, C, float64), the transformed features ``t`` and the decoded
        image ``y``: the call's own tensors, which the hook copies if it keeps
        them."""
        x = self._as_input(images)
        top = vgg.WCT_LEVELS[0]
        with span("stylize.wct_level"):
            with span("stylize.encode"):
                f5 = vgg.encode_to(self.enc, x, top)
            if record is None:
                del x
            with span("stylize.wct"):
                hi5, w5 = wct.whiten(f5)
        outs = []
        for s in range(banks.mean[top].shape[0]):
            with span("stylize.wct_level"):
                with span("stylize.wct"):
                    t = wct.colour(f5, hi5, w5, banks.mean[top][s], banks.colour[top][s], alpha)
                with span("stylize.decode"):
                    img = vgg.decode_from(self.decs[top], t, top)
            if record is not None:
                record(top, s, x, f5, w5, t, img)
            for level in vgg.WCT_LEVELS[1:]:
                with span("stylize.wct_level"):
                    with span("stylize.encode"):
                        f = vgg.encode_to(self.enc, img, level)
                    with span("stylize.wct"):
                        hi, w = wct.whiten(f)
                        t = wct.colour(f, hi, w, banks.mean[level][s], banks.colour[level][s],
                                       alpha)
                    with span("stylize.decode"):
                        y = vgg.decode_from(self.decs[level], t, level)
                if record is not None:
                    record(level, s, img, f, w, t, y)
                img = y
            with span("stylize.finish"):
                outs.append(self._finish(img))
        with span("stylize.finish"):
            return torch.stack(outs)
