"""Cross-client style transfer (CCST pipeline stage 2).

Port of ``ccst_tpu/pipeline/stylize.py`` (reference
style_transfer/AdaIN/CCST_OverallStyleTransfer.py and
CCST_SingleStyleTransfer.py): for a content domain, write a stylized copy of
every train image under each other domain's style: its shared style bank
("overall" mode), or the statistics of one random image of that domain drawn
per content batch ("single" mode, seeded like the reference).

  - :class:`StylizeEngine`: weights cast once to the compute dtype on one
    device; encode -> fused AdaIN + alpha blend -> decode, through the kernels
    of ``kernels/`` on the card. ``stylize_multi`` encodes a batch once,
    restyles the features under the S style banks in one AdaIN launch and
    decodes each. Engines:
      ``ref``          bf16 reference executor (float32: the exact parity
                       mode for verification), conv kernel K3;
      ``packed``       ``ref`` with the level-1 stage in space-to-depth form
                       (``models/vgg_fast.py``), K3 with edge padding there;
      ``int8``         dynamic per-tensor int8 scales at every conv, K0 with
                       ``w_scale * a_scale`` formed on the device;
      ``int8-static``  int8 end to end with calibrated static scales
                       (``models/vgg_fast.py``), int8 conv kernel K0;
      ``int8-fused``   ``int8-static`` with the level-1 stage of the encoder
                       (K1) and of the decoder (K2) as one kernel each; the
                       same outputs.
    ``ccst_tpu``'s ``int8-fused`` engine keeps the unfused decoder, because
    its fused decoder measured slower on the TPU. The two routes give the same
    bits, so which one an engine takes is for the card to say, and on the H100
    K2 is faster than the two K0 launches it replaces at batch 4 and at batch
    32 (``PERF.md``, the table of kernels): the port decodes through it.
    The int8 engines calibrate on the first batch and style bank they see, or
    take ``scales`` (from ``calibrate``, :func:`run_calibration`).
  - ``output_size > 0`` resizes the float32 outputs (antialiased bilinear,
    :func:`resize_bilinear`) before the uint8 quantization.
  - The transfer loop decodes each content batch once (uint8 transport,
    normalized on the device), launches batch N+1 before it hands batch N's
    uint8 output to the host (on the card both copies go through pinned
    memory in stream order, the output's on a copy stream of its own, so the
    host never waits for the compute stream to drain), and encodes the
    images on a thread pool. Overall mode without ``skip_existing`` restyles
    each batch under every bank at once; single mode and ``skip_existing``
    run style by style, as ``ccst_tpu`` does, the latter over the outputs
    that do not exist yet.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccst_tpu_torch.config import StylizeConfig, dataset_spec
from ccst_tpu_torch.data.lists import parse_list, stylized_output_path, train_list_path
from ccst_tpu_torch.data.loader import ImageBatchLoader, load_image, save_image_u8
from ccst_tpu_torch.kernels.adain import fused_adain, fused_adain_multi
from ccst_tpu_torch.kernels.moments import channel_moments
from ccst_tpu_torch.models import vgg, vgg_fast
# the antialiased bilinear resize of output_size (jax.image.resize parity)
from ccst_tpu_torch.ops.image import resize_square as resize_bilinear
from ccst_tpu_torch.pipeline.style_bank import load_style_stats
from ccst_tpu_torch.utils import profiling
from ccst_tpu_torch.utils.profiling import span

INT8_ENGINES = ("int8-static", "int8-fused")  # calibrated static scales
ENGINES = ("ref", "packed", "int8", *INT8_ENGINES)


class StylizeEngine:
    """AdaIN stylization on one device; weights cast once to ``dtype``.
    ``engine`` is one of :data:`ENGINES`; ``scales`` is a persisted int8
    calibration (``models/vgg_fast.py::load_scales``)."""

    def __init__(
        self,
        encoder_params,
        decoder_params,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        output_size: int = -1,
        output_u8: bool = False,
        engine: str = "ref",
        scales: Optional[Dict[str, float]] = None,
    ):
        if engine not in ENGINES:
            raise ValueError(f"unknown stylize engine {engine!r}")
        self.dtype = dtype
        self.device = torch.device(device)
        self.engine = engine
        self.output_size = output_size
        self.output_u8 = output_u8
        self.scales = scales
        self._needs_calibration = engine in INT8_ENGINES and scales is None
        if engine == "ref":
            self.enc = vgg.prepare_params(encoder_params, dtype, self.device)
            self.dec = vgg.prepare_params(decoder_params, dtype, self.device)
            self._encode = lambda x: vgg.apply_encoder(self.enc, x)
            self._decode = lambda t: vgg.apply_decoder(self.dec, t)
            return
        # the other engines keep the dtype-rounded weights they pack, quantize
        # or calibrate; the static int8 executors exist once scales do
        self.enc = self.dec = None
        self._enc_w = vgg_fast.cast_params(encoder_params, dtype)
        self._dec_w = vgg_fast.cast_params(decoder_params, dtype)
        if engine == "packed":
            ep = vgg_fast.prepare_encoder(self._enc_w, dtype, self.device)
            dp = vgg_fast.prepare_decoder(self._dec_w, dtype, self.device)
            self._encode = lambda x: vgg_fast.apply_encoder_packed(ep, x, dtype)
            self._decode = lambda t: vgg_fast.apply_decoder_packed(dp, t, dtype)
        elif engine == "int8":
            ep = vgg_fast.prepare_encoder_q8(self._enc_w, dtype, self.device)
            dp = vgg_fast.prepare_decoder_q8(self._dec_w, dtype, self.device)
            self._encode = lambda x: vgg_fast.apply_encoder_q8(ep, x, dtype)
            self._decode = lambda t: vgg_fast.apply_decoder_q8(dp, t, dtype)
        elif scales is not None:
            self._build_int8(scales)

    def _build_int8(self, scales) -> None:
        ep = vgg_fast.prepare_encoder_q8s(self._enc_w, scales, self.dtype, self.device)
        dp = vgg_fast.prepare_decoder_q8s(self._dec_w, scales, self.dtype, self.device)
        fused = self.engine == "int8-fused"
        encode = vgg_fast.apply_encoder_q8s_fused if fused else vgg_fast.apply_encoder_q8s
        decode = vgg_fast.apply_decoder_q8s_fused if fused else vgg_fast.apply_decoder_q8s
        self._encode = lambda x: encode(ep, x, self.dtype)
        self._decode = lambda t: decode(dp, t, self.dtype)

    @torch.no_grad()
    def calibrate(self, images, style_stats: Sequence[Tuple], max_images: int = 8) -> None:
        """int8 engines: one float32 reference pass over at most
        ``max_images`` content images and the style bank, then rebuild the
        quantized executors. Other engines: nothing to do."""
        if self.engine not in INT8_ENGINES:
            return
        x = torch.as_tensor(images[:max_images]).to(self.device)
        if x.dtype == torch.uint8:  # u8-transport batches calibrate in float32
            x = x.float() / 255.0
        self.scales = vgg_fast.calibrate_scales(
            self._enc_w, self._dec_w, x.float(), list(style_stats)
        )
        self._build_int8(self.scales)
        self._needs_calibration = False

    def _ensure_calibrated(self, images, s_means, s_stds) -> None:
        if self._needs_calibration:
            self.calibrate(images, list(zip(s_means, s_stds)))

    def _as_input(self, images) -> torch.Tensor:
        # uint8 transport: the same integer bytes / 255 in float32 as the
        # loader's float batches, normalized on the device
        images = torch.as_tensor(images)
        if profiling.active():
            profiling.count("stylize.h2d_bytes", images.nbytes)
        with span("stylize.h2d"):
            if (self.device.type == "cuda" and images.device.type == "cpu"
                    and not images.is_pinned()):
                # a pageable copy would wait for the stream to drain: stage
                # through a pinned tensor of the host allocator's cache (its
                # block is not reused before the copy has run), then copy
                # in stream order without blocking the host
                staged = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
                staged.copy_(images)
                images = staged.to(self.device, non_blocking=True)
                profiling.count("stylize.h2d_staged")
            else:
                images = images.to(self.device)
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        return images.to(self.dtype)

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        out = out.float()
        if self.output_size > 0:
            out = resize_bilinear(out, self.output_size)
        if self.output_u8:
            # save_image quantization on the device: clamp, x255, +0.5, truncate
            out = torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5
            out = torch.clamp(out, 0.0, 255.0).to(torch.uint8)
        return out

    def _restyle(self, feat, s_mean, s_std, alpha: float) -> torch.Tensor:
        with span("stylize.adain"):
            t = fused_adain(feat, s_mean, s_std, alpha=alpha)
        with span("stylize.decode"):
            t = self._decode(t)
        with span("stylize.finish"):
            return self._finish(t)

    def _stats(self, s) -> torch.Tensor:
        return torch.as_tensor(s, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def stylize(self, images, s_mean, s_std, alpha: float = 1.0) -> torch.Tensor:
        """(B, H, W, 3) content in [0, 1] (or uint8) -> stylized images,
        float32 unclamped (uint8 with ``output_u8``)."""
        s_mean, s_std = self._stats(s_mean), self._stats(s_std)
        self._ensure_calibrated(images, s_mean[None], s_std[None])
        feat = self._as_input(images)
        with span("stylize.encode"):
            feat = self._encode(feat)  # rebinding frees the input batch once encoded
        return self._restyle(feat, s_mean, s_std, alpha)

    @torch.no_grad()
    def stylize_multi(self, images, s_means, s_stds, alpha: float = 1.0) -> torch.Tensor:
        """(B, H, W, 3) content x (S, C) style banks -> (S, B, H, W, 3): one
        encode, one AdaIN launch for the S banks, S decodes."""
        s_means, s_stds = self._stats(s_means), self._stats(s_stds)
        self._ensure_calibrated(images, s_means, s_stds)
        feat = self._as_input(images)
        with span("stylize.encode"):
            feat = self._encode(feat)
        with span("stylize.adain"):
            restyled = fused_adain_multi(feat, s_means, s_stds, alpha=alpha)
        outs = []
        for t in restyled:
            # rebinding ``t`` frees each decoded batch once it is finished
            with span("stylize.decode"):
                t = self._decode(t)
            with span("stylize.finish"):
                t = self._finish(t)
            outs.append(t)
        with span("stylize.finish"):
            return torch.stack(outs)

    @torch.no_grad()
    def style_stats_of(self, image) -> Tuple[torch.Tensor, torch.Tensor]:
        """relu4_1 (mean, std) channel vectors of one (1, H, W, 3) image, with
        the population (``ddof=0``) variance of the reference's single-style
        statistics (CCST_SingleStyleTransfer.py:201-204). Every engine takes
        them through the ``ref`` encoder, as ``ccst_tpu``'s engine does."""
        if self.enc is None:  # the other engines prepare it on first use
            self.enc = vgg.prepare_params(self._enc_w, self.dtype, self.device)
        with span("stylize.style_stats"):
            feat = vgg.apply_encoder(self.enc, self._as_input(image))
            mean, m2, count = channel_moments(feat[:1])
            return mean, torch.sqrt(m2 / count + 1e-5)


def bank_path_for(cfg: StylizeConfig, style: str) -> str:
    """Style-bank file for ``style``: the native .npz, else the reference .npy."""
    path = os.path.join(cfg.style_stats_dir, cfg.dataset.lower(), f"{style}_mean_std.npz")
    return path if os.path.exists(path) else path[:-4] + ".npy"


def scales_path_for(cfg: StylizeConfig) -> str:
    """Default location of the persisted int8 calibration, next to the style
    banks: ``{style_stats_dir}/{dataset}/{target}_q8_scales.json``."""
    return os.path.join(
        cfg.style_stats_dir, cfg.dataset.lower(), f"{cfg.target}_q8_scales.json"
    )


def run_calibration(
    cfg: StylizeConfig, engine: StylizeEngine, max_images: int = 8, out_path: str = ""
) -> str:
    """Deterministic offline calibration for the int8 engines: the FIRST
    ``max_images`` entries of the target's train list, in list order, and
    every other domain's style bank. Writes the scales file
    (:func:`vgg_fast.save_scales`, with the weights' fingerprint) and returns
    its path; ``stylize`` reloads it from there or from ``--scales``."""
    if engine.engine not in INT8_ENGINES:
        raise ValueError(
            f"engine {engine.engine!r} does not support static calibration "
            "(use int8-static or int8-fused)"
        )
    spec = dataset_spec(cfg.dataset)
    styles = [d for d in spec.domains if d != cfg.target]
    names, _ = parse_list(train_list_path(cfg.list_root, cfg.dataset, cfg.target))
    names = names[:max_images]
    paths = [os.path.join(cfg.data_root, n) if cfg.data_root else n for n in names]
    images = np.stack([load_image(p, cfg.image_size) for p in paths])
    bank = [load_style_stats(bank_path_for(cfg, style)) for style in styles]
    engine.calibrate(images, bank, max_images=max_images)
    return vgg_fast.save_scales(
        out_path or scales_path_for(cfg), engine.scales,
        fingerprint=vgg_fast.weights_fingerprint(engine._enc_w, engine._dec_w),
    )


@dataclass
class TransferReport:
    target: str
    styles: List[str]
    images: int          # content images stylized per style
    seconds: float
    images_per_sec: float
    # where the main loop sat blocked (see ccst_tpu.pipeline.stylize)
    loader_wait_seconds: float = 0.0        # waiting for a decoded batch
    fetch_wait_seconds: float = 0.0         # device compute + d2h, less backpressure
    first_batch_wait_seconds: float = 0.0   # the priming decode
    encode_backpressure_seconds: float = 0.0  # write-back queue full
    encode_drain_seconds: float = 0.0       # final futures drain
    style_decode_wait_seconds: float = 0.0  # single mode only


def _content_loader(cfg: StylizeConfig) -> Tuple[ImageBatchLoader, List[str]]:
    names, labels = parse_list(train_list_path(cfg.list_root, cfg.dataset, cfg.target))
    paths = [os.path.join(cfg.data_root, n) for n in names] if cfg.data_root else names
    loader = ImageBatchLoader(
        paths, labels, batch_size=cfg.batch_size, image_size=cfg.image_size,
        shuffle=False, out_dtype="uint8",
    )
    return loader, names


def _out_path_of(cfg: StylizeConfig, rel: str, style: str, mode: str) -> str:
    out_rel = stylized_output_path(rel, cfg.target, style, mode)
    if cfg.save_ext:
        out_rel = os.path.splitext(out_rel)[0] + cfg.save_ext
    return os.path.join(cfg.output_root, out_rel) if cfg.output_root else out_rel


# cap on queued write-back jobs: each pending future pins its image array
_MAX_INFLIGHT_WRITES = 64


def _writeback(
    pool: cf.Executor,
    outputs: np.ndarray,
    rel_names: Sequence[str],
    cfg: StylizeConfig,
    style: str,
    mode: str,
    futs: List[cf.Future],
) -> float:
    """Queue the batch's images for encoding; returns the seconds spent
    blocked on write-back backpressure."""
    for img, rel in zip(outputs, rel_names):
        futs.append(pool.submit(save_image_u8, img, _out_path_of(cfg, rel, style, mode)))
    t1 = time.perf_counter()
    while len(futs) > _MAX_INFLIGHT_WRITES:
        futs.pop(0).result()
    return time.perf_counter() - t1


class _PinnedCopy:
    """A CUDA tensor's copy into a new pinned host tensor, on ``stream``
    behind the kernels queued so far on the tensor's current stream. The
    source stays referenced until :meth:`result` has seen the copy land, so
    the device allocator cannot hand its memory out under the copy."""

    def __init__(self, src: torch.Tensor, stream: torch.cuda.Stream):
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        stream.wait_event(ready)
        # a new block of the host allocator's cache each time: the arrays
        # handed to ``emit`` are the callers' to keep
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            self.host.copy_(src, non_blocking=True)
        self.landed = torch.cuda.Event()
        self.landed.record(stream)
        self.src = src

    def result(self) -> np.ndarray:
        self.landed.synchronize()
        self.src = None
        return self.host.numpy()


class _DispatchAhead:
    """One-slot dispatch-ahead: batch N reaches the host callback only after
    batch N+1 has been launched, so the card computes N+1 while the host
    copies and encodes N. ``fetch_seconds`` is the time the loop sat in those
    copies, less the encode backpressure the emit callback reports.

    A CUDA batch is copied as it is pushed: on a copy stream of this object's
    own, behind an event on the compute stream, into new pinned host memory
    (:class:`_PinnedCopy`); its flush waits for that copy to land, so the copy
    of N runs on the copy engine under N+1's kernels and the host never waits
    for the compute stream to drain. Any other batch is copied at its flush.

    While a profiler is active, ``dispatch.d2h`` spans the copy (on the CUDA
    route its enqueue in :meth:`push`), ``dispatch.wait`` the host's wait in
    the flush (on the CUDA route for the landed copy: the card's queued
    kernels and the copy behind them) and ``dispatch.emit`` the callback;
    ``dispatch.async_d2h`` counts the flushes of CUDA-route copies."""

    def __init__(self) -> None:
        self._pending = None   # (_PinnedCopy or tensor, emit callback)
        self._stream = None    # the copy stream, made on the first CUDA batch
        self.fetch_seconds = 0.0

    def push(self, outs_device: torch.Tensor, emit) -> None:
        if outs_device.is_cuda:
            t1 = time.perf_counter()
            if self._stream is None or self._stream.device != outs_device.device:
                self._stream = torch.cuda.Stream(outs_device.device)
            with span("dispatch.d2h"):
                outs_device = _PinnedCopy(outs_device, self._stream)
            profiling.count("dispatch.d2h_bytes", outs_device.host.nbytes)
            self.fetch_seconds += time.perf_counter() - t1
        prev, self._pending = self._pending, (outs_device, emit)
        if prev is not None:
            self._flush(prev)

    def drain(self) -> None:
        if self._pending is not None:
            self._flush(self._pending)
            self._pending = None

    def _flush(self, p) -> None:
        t1 = time.perf_counter()
        outs, emit = p
        with span("dispatch.wait"):
            if isinstance(outs, _PinnedCopy):
                outs = outs.result()
                profiling.count("dispatch.async_d2h")
        if isinstance(outs, torch.Tensor):
            with span("dispatch.d2h"):
                outs = outs.cpu().numpy()
            profiling.count("dispatch.d2h_bytes", outs.nbytes)
        with span("dispatch.emit"):
            backpressure = emit(outs) or 0.0
        self.fetch_seconds += time.perf_counter() - t1 - backpressure


def _style_lists(cfg: StylizeConfig, styles: Sequence[str]) -> Dict[str, List[str]]:
    """Single mode: the image paths of each style domain, from the
    blank-filtered ``{dataset}_discardBlackWhite`` list where it exists (the
    reference samples camelyon17 styles from those,
    CCST_SingleStyleTransfer.py:165-166; ``filter-blank`` writes them), else
    from the train list."""
    out = {}
    for style in styles:
        filtered = train_list_path(cfg.list_root, f"{cfg.dataset.lower()}_discardBlackWhite", style)
        src = (filtered if os.path.exists(filtered)
               else train_list_path(cfg.list_root, cfg.dataset, style))
        names, _ = parse_list(src)
        out[style] = [os.path.join(cfg.data_root, n) for n in names] if cfg.data_root else names
    return out


def _run_transfer(cfg: StylizeConfig, engine: StylizeEngine, mode: str) -> TransferReport:
    spec = dataset_spec(cfg.dataset)
    styles = [d for d in spec.domains if d != cfg.target]
    loader, rel_names = _content_loader(cfg)
    with profiling.maybe_trace(cfg.trace_dir):
        if mode.lower() == "single" or cfg.skip_existing:
            report = _run_style_major(cfg, engine, mode, styles, loader, rel_names)
        else:
            report = _run_batch_major(cfg, engine, mode, styles, loader, rel_names)
    _write_timing(cfg, mode, report)
    return report


def _run_batch_major(cfg, engine, mode, styles, loader, rel_names) -> TransferReport:
    """Overall mode: decode and encode each content batch once, then restyle
    it under every style bank in one ``stylize_multi``."""
    t0 = time.perf_counter()
    n_done = 0
    bank = [load_style_stats(bank_path_for(cfg, style)) for style in styles]
    s_means = engine._stats(np.stack([m for m, _ in bank]))
    s_stds = engine._stats(np.stack([s for _, s in bank]))
    with cf.ThreadPoolExecutor(8) as pool:
        offset = 0
        futs: List[cf.Future] = []
        pipe = _DispatchAhead()
        t_loader = t_first = t_bp = 0.0
        it = iter(loader)
        first = True
        while True:
            t1 = time.perf_counter()
            with span("stylize.loader_wait"):
                batch = next(it, None)
            dt = time.perf_counter() - t1
            if first:
                t_first, first = dt, False
            else:
                t_loader += dt
            if batch is None:
                break
            # slice to the valid rows on the device so padding never crosses
            # the d2h link
            outs = engine.stylize_multi(
                torch.from_numpy(batch.images), s_means, s_stds, cfg.alpha
            )[:, : batch.valid]
            rel = rel_names[offset : offset + batch.valid]
            offset += batch.valid

            def emit(outs_np, rel=rel):
                nonlocal n_done, t_bp
                bp = 0.0
                for si, style in enumerate(styles):
                    bp += _writeback(pool, outs_np[si], rel, cfg, style, mode, futs)
                    n_done += len(rel)
                t_bp += bp
                return bp  # _DispatchAhead subtracts it from fetch_wait

            pipe.push(outs, emit)
        pipe.drain()
        t1 = time.perf_counter()
        for f in futs:
            f.result()
        t_drain = time.perf_counter() - t1
    elapsed = time.perf_counter() - t0
    return TransferReport(
        target=cfg.target,
        styles=styles,
        images=n_done // max(len(styles), 1),
        seconds=elapsed,
        images_per_sec=n_done / max(elapsed, 1e-9),
        loader_wait_seconds=round(t_loader, 3),
        fetch_wait_seconds=round(pipe.fetch_seconds, 3),
        first_batch_wait_seconds=round(t_first, 3),
        encode_backpressure_seconds=round(t_bp, 3),
        encode_drain_seconds=round(t_drain, 3),
    )


def _run_style_major(cfg, engine, mode, styles, loader, rel_names) -> TransferReport:
    """Style by style (``ccst_tpu/pipeline/stylize.py``'s loop): single mode
    draws one style image per content batch from one ``random.Random(seed)``,
    in style then batch order, and takes its relu4_1 statistics on the device;
    ``skip_existing`` loads only the content images whose output for the
    style does not exist yet."""
    single = mode.lower() == "single"
    rng = random.Random(cfg.seed)
    style_lists = _style_lists(cfg, styles) if single else {}
    t0 = time.perf_counter()
    n_done = 0
    t_loader = t_first = t_bp = t_fetch = t_drain = t_style = 0.0
    with cf.ThreadPoolExecutor(8) as pool:
        for style in styles:
            if not single:
                s_mean, s_std = load_style_stats(bank_path_for(cfg, style))
            style_loader, style_rels = loader, rel_names
            if cfg.skip_existing:
                missing = [i for i, rel in enumerate(rel_names)
                           if not os.path.exists(_out_path_of(cfg, rel, style, mode))]
                if not missing:
                    continue
                style_rels = [rel_names[i] for i in missing]
                style_loader = ImageBatchLoader(
                    [loader.paths[i] for i in missing], [loader.labels[i] for i in missing],
                    batch_size=cfg.batch_size, image_size=cfg.image_size, shuffle=False,
                    out_dtype="uint8",
                )
            offset = 0
            futs: List[cf.Future] = []
            pipe = _DispatchAhead()
            it = iter(style_loader)
            first = True

            def read_next():
                """The next content batch and, in single mode, its style
                image's decode started on the pool: one draw a batch, in batch
                order, so the choices are those of a loop without prefetch."""
                t1 = time.perf_counter()
                with span("stylize.loader_wait"):
                    b = next(it, None)
                dt = time.perf_counter() - t1
                sf = None
                if b is not None and single:
                    sf = pool.submit(load_image, rng.choice(style_lists[style]), cfg.image_size)
                return b, sf, dt

            cur = read_next()
            while True:
                batch, style_fut, dt = cur
                if first:
                    t_first += dt
                    first = False
                else:
                    t_loader += dt
                if batch is None:
                    break
                # the next batch (and its style decode) before this batch's style image
                cur = read_next()
                if single:
                    t1 = time.perf_counter()
                    style_img = style_fut.result()
                    t_style += time.perf_counter() - t1
                    s_mean, s_std = engine.style_stats_of(torch.from_numpy(style_img)[None])
                out = engine.stylize(
                    torch.from_numpy(batch.images), s_mean, s_std, cfg.alpha
                )[: batch.valid]
                rel = style_rels[offset : offset + batch.valid]
                offset += batch.valid

                def emit(out_np, rel=rel, style=style):
                    nonlocal n_done, t_bp
                    bp = _writeback(pool, out_np, rel, cfg, style, mode, futs)
                    t_bp += bp
                    n_done += len(rel)
                    return bp  # _DispatchAhead subtracts it from fetch_wait

                pipe.push(out, emit)
            pipe.drain()
            t_fetch += pipe.fetch_seconds
            t1 = time.perf_counter()
            for f in futs:
                f.result()
            t_drain += time.perf_counter() - t1
    elapsed = time.perf_counter() - t0
    return TransferReport(
        target=cfg.target,
        styles=styles,
        images=n_done // max(len(styles), 1),
        seconds=elapsed,
        images_per_sec=n_done / max(elapsed, 1e-9),
        loader_wait_seconds=round(t_loader, 3),
        fetch_wait_seconds=round(t_fetch, 3),
        first_batch_wait_seconds=round(t_first, 3),
        encode_backpressure_seconds=round(t_bp, 3),
        encode_drain_seconds=round(t_drain, 3),
        style_decode_wait_seconds=round(t_style, 3),
    )


def _write_timing(cfg: StylizeConfig, mode: str, report: TransferReport) -> None:
    """Timing file, e.g. ``pacs_photo_overall_stylize_time.json``
    (CCST_OverallStyleTransfer.py:171-175)."""
    root = cfg.output_root or "."
    os.makedirs(root, exist_ok=True)
    path = os.path.join(
        root, f"{cfg.dataset.lower()}_{cfg.target}_{mode.lower()}_stylize_time.json"
    )
    with open(path, "w") as f:
        json.dump(
            {
                "target": report.target,
                "styles": report.styles,
                "seconds": report.seconds,
                "images_per_style": report.images,
                "images_per_sec": report.images_per_sec,
                "image_size": cfg.image_size,
                "batch_size": cfg.batch_size,
                "loader_wait_seconds": report.loader_wait_seconds,
                "fetch_wait_seconds": report.fetch_wait_seconds,
                "first_batch_wait_seconds": report.first_batch_wait_seconds,
                "encode_backpressure_seconds": report.encode_backpressure_seconds,
                "encode_drain_seconds": report.encode_drain_seconds,
                "style_decode_wait_seconds": report.style_decode_wait_seconds,
            },
            f,
            indent=2,
        )


def run_overall_transfer(cfg: StylizeConfig, engine: StylizeEngine) -> TransferReport:
    """Domain-bank ("Overall") cross-client transfer
    (CCST_OverallStyleTransfer.py:138-167)."""
    return _run_transfer(cfg, engine, "overall")


def run_single_transfer(cfg: StylizeConfig, engine: StylizeEngine) -> TransferReport:
    """Per-batch random single-style transfer (CCST_SingleStyleTransfer.py:163-224)."""
    return _run_transfer(cfg, engine, "single")
