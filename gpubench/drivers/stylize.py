"""The stylize driver: AdaIN cross-client style transfer of content batches
held in host memory, through the port's ``StylizeEngine`` and its
dispatch-ahead copy loop, outputs kept in host memory (no PNG is written).

Traffic keys: ``engine`` (``ref`` | ``int8-fused``), ``mode`` (``overall``:
each batch restyled under every style bank by one ``stylize_multi``;
``single``: style by style, each batch under the statistics of one style
image drawn for it, ``style_stats_of`` then ``stylize``), ``batch``,
``pool_batches`` (distinct content batches, handed round in turn),
``style_pool`` (single mode: style images a domain), ``warm_batches``,
``trace_batches`` and ``keep`` (batches of the window whose outputs the check
compares, drawn from the seed among the first ``keep_within``, plus the
window's last).

Set-up makes everything from the seed on the device: the weights, the content
pool and the style images, then the style banks through the port's bank step
(``pipeline/style_bank.py``), and for an int8 engine its calibration on the
pool's first 8 images. The window hands batches to the engine until
``--seconds`` have passed, then waits for the last copy.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gpubench.flops import vgg as vgg_flops
from gpubench.harness import Run
from gpubench.reference import adain as ref
from gpubench.reference import int8_static
from gpubench.reference.images import blocky_noise

REF_BLOCK = 8  # images the reference takes at a time


class Inputs:
    """What set-up makes from the seed: weights, content pool, style images."""

    def __init__(self, r: Run):
        size, batch = r.param("image_size"), r.param("batch")
        gen = torch.Generator(device=r.device).manual_seed(r.seed)
        self.enc, self.dec = ref.make_weights(gen, r.param("decoder_scale"),
                                              r.param("decoder_shift"))
        self.pool = blocky_noise(gen, r.param("pool_batches") * batch, size)
        self.single = r.param("mode") == "single"
        n_style = r.param("style_pool") if self.single else r.param("style_bank_images")
        self.styles = [blocky_noise(gen, n_style, size) for _ in range(r.param("styles"))]
        self.batch = batch
        # the engine's input: pageable host tensors, as the loader's batches are
        self.pool_host = [self.pool[i:i + batch].cpu() for i in range(0, len(self.pool), batch)]
        # single mode: host float32 style images, as the CLI decodes them
        self.styles_host = ([[(s[i:i + 1].float() / 255.0).cpu() for i in range(len(s))]
                             for s in self.styles] if self.single else None)


def job_of_call(inputs: Inputs, rng: random.Random, i: int) -> Tuple[int, int, int]:
    """(content batch, style, style image) of call ``i``: Overall mode cycles
    the pool; single mode walks it style by style, as the CLI does, one style
    image drawn from ``rng`` a call."""
    n_pool = len(inputs.pool_host)
    if not inputs.single:
        return i % n_pool, -1, -1
    style = (i // n_pool) % len(inputs.styles)
    return i % n_pool, style, rng.randrange(len(inputs.styles[style]))


class Loop:
    """Jobs in turn: (content batch, style) pairs, and the copies behind them."""

    def __init__(self, r: Run, engine, inputs: Inputs, banks):
        from ccst_tpu_torch.pipeline.stylize import _DispatchAhead

        self.r, self.engine, self.inputs = r, engine, inputs
        self.banks = banks
        self.pipe = _DispatchAhead()
        self.rng = random.Random(r.seed)
        self.calls = 0
        self.latencies: List[float] = []
        self.keep: Dict[int, Tuple] = {}
        self.keep_ids: set = set()
        self.last: Optional[Tuple] = None

    def call(self, i: int) -> None:
        c, s, k = job = job_of_call(self.inputs, self.rng, i)
        t_hand = time.perf_counter()
        content = self.inputs.pool_host[c]
        stats = None
        if self.inputs.single:
            stats = self.engine.style_stats_of(self.inputs.styles_host[s][k])
            outs = self.engine.stylize(content, stats[0], stats[1])
        else:
            outs = self.engine.stylize_multi(content, self.banks[0], self.banks[1])

        def emit(outs_np, i=i, job=job, stats=stats, t_hand=t_hand):
            self.latencies.append(time.perf_counter() - t_hand)
            record = (job, outs_np, stats)
            if i in self.keep_ids:
                self.keep[i] = record
            self.last = (i, record)
            return 0.0

        self.pipe.push(outs, emit)
        self.calls += 1

    def run(self, n: Optional[int] = None, seconds: Optional[float] = None,
            spans: bool = False) -> Tuple[int, float]:
        """Calls until ``n`` are made or ``seconds`` have passed, then the
        last copy: (calls, seconds from the first hand-over to the last
        output in host memory)."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        start = self.calls
        while (n is None or self.calls - start < n) and (
                seconds is None or time.perf_counter() - t0 < seconds):
            if spans:
                with record_function("gpubench::call"):
                    self.call(self.calls)
            else:
                self.call(self.calls)
        self.pipe.drain()
        if self.r.device.type == "cuda":
            torch.cuda.synchronize()
        return self.calls - start, time.perf_counter() - t0


def _banks(r: Run, inputs: Inputs):
    """(means, stds), (S, 512) float32 on the device, through the port's bank
    step in the engine's dtype; none in single mode."""
    if inputs.single:
        return None
    from ccst_tpu_torch.ops.welford import welford_finalize, welford_init
    from ccst_tpu_torch.pipeline.style_bank import make_bank_step

    step = make_bank_step(inputs.enc, torch.bfloat16, r.device)
    means, stds = [], []
    for imgs in inputs.styles:
        state = welford_init(512, r.device)
        for i in range(0, len(imgs), inputs.batch):
            chunk = imgs[i:i + inputs.batch].float() / 255.0
            state = step(state, chunk, chunk.shape[0])
        m, s = welford_finalize(state)
        means.append(m)
        stds.append(s)
    return torch.stack(means), torch.stack(stds)


def run(r: Run) -> None:
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine

    inputs = Inputs(r)
    engine = StylizeEngine(inputs.enc, inputs.dec, dtype=torch.bfloat16, device=r.device,
                           output_u8=True, engine=r.param("engine"))
    banks = _banks(r, inputs)
    if r.param("engine") != "ref":
        engine.calibrate(inputs.pool_host[0], list(zip(*banks)), max_images=8)
    loop = Loop(r, engine, inputs, banks)
    loop.run(n=r.param("warm_batches"))
    loop.latencies.clear()
    loop.pipe.fetch_seconds = 0.0
    keep_rng = random.Random(r.seed ^ 0x5EED)
    start = loop.calls
    loop.keep_ids = {start + keep_rng.randrange(r.param("keep_within"))
                     for _ in range(r.param("keep"))}
    setup_s = time.perf_counter() - r.t_start

    calls, window_s = loop.run(seconds=r.seconds)
    job = vgg_flops.job_of(r.param)
    images = calls * job.images
    r.attempted = calls
    r.failed = calls - len(loop.latencies)
    r.end_to_end = {"stylize_img_s": images / window_s,
                    "stylize_batch_p95_ms": float(np.percentile(loop.latencies, 95)) * 1e3,
                    "setup_s": setup_s}
    r.counters = {"window_s": window_s, "calls": calls, "images": images,
                  "fetch_seconds": loop.pipe.fetch_seconds,
                  "model_flops_per_call": vgg_flops.model_flops(job),
                  "images_per_call": job.images}
    kept = dict(loop.keep)  # the window's drawn calls and its last
    kept[loop.last[0]] = loop.last[1]
    if r.trace:
        _trace(r, loop)
    if r.device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
    scales = dict(engine.scales) if engine.scales else None
    del engine, loop  # the reference runs with the port's memory freed
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    check(r, inputs, kept, banks, scales)


def _trace(r: Run, loop: Loop) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench.trace import WINDOW, reduce_profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if r.device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            calls, _ = loop.run(n=r.param("trace_batches"), spans=True)
    r.counters["traced_calls"] = calls
    r.traced = reduce_profile(prof)


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------


FAR = 4  # uint8 levels: a value this far from the reference's is counted


def _u8_gaps(program: np.ndarray, reference: torch.Tensor) -> Tuple[float, float]:
    """Over the images: the largest mean |difference| of one image in uint8
    levels, and the largest share of one image's values more than ``FAR``
    levels from the reference's."""
    p = torch.from_numpy(np.ascontiguousarray(program)).to(reference.device)
    diff = (p.int() - reference.int()).abs().reshape(-1, *reference.shape[-3:])
    mae = diff.float().mean(dim=(1, 2, 3)).max()
    far = (diff > FAR).float().mean(dim=(1, 2, 3)).max()
    return float(mae), float(far)


def _rel_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """max |program - reference| over max |reference|."""
    p, q = program.float().to(reference.device), reference.float()
    return float((p - q).abs().max() / q.abs().max().clamp_min(1e-30))


def reference_banks(inputs: Inputs, quant: Optional[str] = None):
    stats = [ref.style_bank(inputs.enc, imgs, REF_BLOCK, quant) for imgs in inputs.styles]
    return torch.stack([m for m, _ in stats]), torch.stack([s for _, s in stats])


def reference_outputs(r: Run, inputs: Inputs, kept, control: bool = False):
    """Per kept call: the reference's (S, B, H, W, 3) uint8 outputs, and in
    single mode the style statistics it worked out; the control computes in
    the next precision below the configuration's (int8 for bfloat16, int4
    for int8). Also returns what set-up derived: banks and scales."""
    engine = r.param("engine")
    quant = ("int8" if control else None) if engine == "ref" else None
    derived: Dict[str, object] = {}
    if not inputs.single:
        derived["banks"] = reference_banks(inputs, quant)
    model = None
    if engine == "int8-fused":
        enc, dec = int8_static.cast_bf16(inputs.enc), int8_static.cast_bf16(inputs.dec)
        # the images set-up calibrated on: the first 8 of the first batch
        scales = int8_static.calibrate(enc, dec, inputs.pool[:min(8, inputs.batch)],
                                       list(zip(*derived["banks"])))
        derived["scales"] = scales
        model = int8_static.Int8Static(enc, dec, scales, bits=4 if control else 8)
    outs = {}
    for i, (job, _, _) in kept.items():
        content = inputs.pool[job[0] * inputs.batch:(job[0] + 1) * inputs.batch]
        if inputs.single:
            m, s = ref.image_stats(inputs.enc, inputs.styles[job[1]][job[2]:job[2] + 1], quant)
            outs[i] = (ref.stylize(inputs.enc, inputs.dec, content, m[None], s[None],
                                   REF_BLOCK, quant), (m, s))
        elif model is not None:
            outs[i] = (int8_static.stylize(model, content, *derived["banks"], REF_BLOCK), None)
        else:
            outs[i] = (ref.stylize(inputs.enc, inputs.dec, content, *derived["banks"],
                                   REF_BLOCK, quant), None)
    return outs, derived


def gaps(r: Run, kept, program_banks, scales, reference, derived) -> Dict[str, float]:
    """Every number the check works out: over the compared images the worst
    image's mean |difference| in uint8 levels and its share of values off by
    more than ``FAR`` levels, and the gap of what set-up derived (banks;
    scales) or, in single mode, of the per-image style statistics. The cell's
    limits say which of them are compared."""
    per_call = [_u8_gaps(outs_np if outs_np.ndim == 5 else outs_np[None], reference[i][0])
                for i, (_, outs_np, _) in kept.items()]
    out = {"image_mae_worst": max(m for m, _ in per_call),
           "far_share_worst": max(f for _, f in per_call)}
    if program_banks is not None:
        out["bank_gap"] = max(_rel_gap(p, q) for p, q in zip(program_banks, derived["banks"]))
    if scales is not None:
        names = sorted(derived["scales"])
        out["scale_gap"] = _rel_gap(torch.tensor([scales[k] for k in names], dtype=torch.float64),
                                    torch.tensor([derived["scales"][k] for k in names],
                                                 dtype=torch.float64))
    stats = [(kept[i][2], reference[i][1]) for i in kept if kept[i][2] is not None]
    if stats:
        out["stats_gap"] = max(max(_rel_gap(p[0], q[0]), _rel_gap(p[1], q[1]))
                               for p, q in stats)
    return out


def check(r: Run, inputs: Inputs, kept, program_banks, scales) -> None:
    reference, derived = reference_outputs(r, inputs, kept)
    for name, value in gaps(r, kept, program_banks, scales, reference, derived).items():
        r.check(name, value)
