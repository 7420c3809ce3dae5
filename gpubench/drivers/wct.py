"""The WCT driver: universal style transfer (Li et al., arXiv:1705.08086) of
content batches held in host memory under CCST's second-order domain banks,
through the port's ``WCTEngine`` (``ccst_tpu_torch/pipeline/wct.py``) and its
dispatch-ahead copy loop, outputs kept in host memory (no PNG is written).

Traffic keys as ``drivers/stylize.py``'s Overall mode (``batch``,
``pool_batches``, ``warm_batches``, ``trace_batches``, ``keep``,
``keep_within``) and ``alpha``. Set-up makes everything from the seed on the
device: the encoder on to conv5_1 and the five decoders, the content pool and
the style images, then each domain's bank through the port's bank step
(``pipeline/style_bank.py::make_wct_bank_step``). The window hands batches to
the engine until ``--seconds`` have passed, then waits for the last copy.

The output check compares the window's last call and the drawn ones with
``reference/wct.py`` at the same inputs and weights, level by level, from
what the window's own ``stylize_multi`` computed: a recorder (the engine's
``record`` hook) keeps, of every call, ``record_images`` consecutive content
images drawn from the seed, at every level and under every style: the
level's input image, its features, their whitening ``W_c``, the transformed
features and the decoded image. Each of the four stages is then held to the
reference given the same input: the encoder (``encode_gap``), the whitening
(``whiten_gap``, float64 ``eigh``), the colouring and apply (``apply_gap``,
under the reference's float64 banks) and the decoder (``decode_gap``), each
the worst image's ``||program - reference||_F / ||reference||_F``. The whole
images of those calls (every image, after five levels) and the banks are
compared too, as readings: five whitenings magnify the bfloat16 convs'
rounding there as much as the controls'. The port's modules are imported
inside :func:`run`, so a checkout without WCT fails at once.
"""
from __future__ import annotations

import gc
import random
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from gpubench.drivers.stylize import Loop, _rel_gap, _trace, _u8_gaps
from gpubench.flops import wct as wct_flops
from gpubench.harness import Run
from gpubench.reference import matmul_precision
from gpubench.reference import wct as ref
from gpubench.reference.images import blocky_noise

REF_BLOCK = 8  # images the reference takes at a time


class Inputs:
    """What set-up makes from the seed: weights, content pool, style images."""

    def __init__(self, r: Run):
        size, batch = r.param("image_size"), r.param("batch")
        gen = torch.Generator(device=r.device).manual_seed(r.seed)
        self.enc, self.decs = ref.make_weights(gen, r.param("decoder_scale"),
                                               r.param("decoder_shift"))
        self.pool = blocky_noise(gen, r.param("pool_batches") * batch, size)
        self.styles = [blocky_noise(gen, r.param("style_bank_images"), size)
                       for _ in range(r.param("styles"))]
        self.batch = batch
        # the engine's input: pageable host tensors, as the loader's batches are
        self.pool_host = [self.pool[i:i + batch].cpu() for i in range(0, len(self.pool), batch)]


LEVEL_GAPS = ("encode_gap", "whiten_gap", "apply_gap", "decode_gap")


def recorder(levels: Dict, start: int, n: int):
    """The engine's ``record`` hook: copies images ``start .. start + n`` of
    each level's tensors into ``levels[(level, style)]`` (basic slices, so
    the copies wait on nothing on the host)."""
    def record(level, s, *tensors):
        levels[(level, s)] = tuple(a[start:start + n].clone() for a in tensors)

    return record


class WCTLoop(Loop):
    """``drivers/stylize.py``'s loop, each call one ``stylize_multi`` under
    the stacked banks, its recorder on."""

    def call(self, i: int) -> None:
        c = i % len(self.inputs.pool_host)
        n = min(self.r.param("record_images"), self.inputs.batch)
        start = random.Random(self.r.seed * 7919 + i).randrange(self.inputs.batch - n + 1)
        levels: Dict = {}
        t_hand = time.perf_counter()
        outs = self.engine.stylize_multi(self.inputs.pool_host[c], self.banks,
                                         self.r.param("alpha"), recorder(levels, start, n))

        def emit(outs_np, i=i, c=c, t_hand=t_hand, recorded=(start, levels)):
            self.latencies.append(time.perf_counter() - t_hand)
            record = ((c, -1, -1), outs_np, recorded)
            if i in self.keep_ids:
                self.keep[i] = record
            self.last = (i, record)
            return 0.0

        self.pipe.push(outs, emit)
        self.calls += 1


def dtype_of(r: Run) -> torch.dtype:
    """The convs' precision (``bfloat16``; the CPU tests also run ``float32``)."""
    return getattr(torch, r.param("precision"))


def program_banks(r: Run, inputs: Inputs):
    """Each domain's bank through the port's bank step, in the engine's dtype."""
    from ccst_tpu_torch.pipeline.style_bank import (make_wct_bank_step, wct_bank_finalize,
                                                    wct_bank_init)

    step = make_wct_bank_step(inputs.enc, dtype_of(r), r.device)
    banks = []
    for imgs in inputs.styles:
        sums = wct_bank_init()
        for i in range(0, len(imgs), inputs.batch):
            chunk = imgs[i:i + inputs.batch].float() / 255.0
            sums = step(sums, chunk, chunk.shape[0])
        banks.append(wct_bank_finalize(sums))
    return banks


def run(r: Run) -> None:
    from ccst_tpu_torch.pipeline.wct import WCTEngine
    from ccst_tpu_torch.utils.profiling import record

    inputs = Inputs(r)
    engine = WCTEngine(inputs.enc, inputs.decs, dtype=dtype_of(r), device=r.device,
                       output_u8=True, engine=r.param("engine"))
    banks = program_banks(r, inputs)
    loop = WCTLoop(r, engine, inputs, engine.stack(banks))
    loop.run(n=r.param("warm_batches"))
    loop.latencies.clear()
    loop.pipe.fetch_seconds = 0.0
    keep_rng = random.Random(r.seed ^ 0x5EED)
    start = loop.calls
    loop.keep_ids = {start + keep_rng.randrange(r.param("keep_within"))
                     for _ in range(r.param("keep"))}
    setup_s = time.perf_counter() - r.t_start

    calls, window_s = loop.run(seconds=r.seconds)
    job = wct_flops.job_of(r.param)
    images = calls * job.images
    r.attempted = calls
    r.failed = calls - len(loop.latencies)
    r.end_to_end = {"stylize_img_s": images / window_s,
                    "stylize_batch_p95_ms": float(np.percentile(loop.latencies, 95)) * 1e3,
                    "setup_s": setup_s}
    r.counters = {"window_s": window_s, "calls": calls, "images": images,
                  "fetch_seconds": loop.pipe.fetch_seconds,
                  "model_flops_per_call": wct_flops.model_flops(job),
                  "images_per_call": job.images}
    kept = dict(loop.keep)
    kept[loop.last[0]] = loop.last[1]
    if r.trace:
        _trace(r, loop)
        counted = record()["counters"]
        r.counters["wct.solves"] = counted.get("wct.solves", 0)
        r.counters["wct.gram_bytes"] = counted.get("wct.gram_bytes", 0)
    if r.device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
    del engine, loop  # the reference runs with the port's memory freed
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    check(r, inputs, kept, banks)


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------


def reference_banks(inputs: Inputs, quant: Optional[str] = None):
    return [ref.style_bank(inputs.enc, imgs, REF_BLOCK, quant) for imgs in inputs.styles]


CONTROLS = {  # name -> (conv quantization, transform store, apply operands): one below the config's
    "int8": ("int8", None, None),                     # the convs: int8 under bfloat16
    "bfloat16": (None, torch.bfloat16, None),         # the Gram and solve: bfloat16 under float32
    "float8": (None, None, torch.float8_e4m3fn),      # the apply: float8 under bfloat16
}


def reference_outputs(r: Run, inputs: Inputs, kept, control: str = ""):
    """Per kept call the reference's (S, B, H, W, 3) uint8 outputs, and its
    banks; ``control`` names an entry of :data:`CONTROLS`."""
    quant, store, operands = CONTROLS.get(control, (None, None, None))
    banks = reference_banks(inputs, quant)
    outs = {}
    for i, (job, _, _) in kept.items():
        content = inputs.pool[job[0] * inputs.batch:(job[0] + 1) * inputs.batch]
        outs[i] = ref.stylize(inputs.enc, inputs.decs, content, banks, REF_BLOCK,
                              r.param("alpha"), quant, store, operands)
    return outs, banks


def bank_gap(program, reference) -> float:
    """The largest gap, over the domains and levels, of the program's mean or
    covariance from the reference's (``max |p - q| / max |q|``); infinite
    where the program has no bank for a level."""
    return max(max(_rel_gap(p.mean[lv].double(), q.mean[lv]), _rel_gap(p.cov[lv], q.cov[lv]))
               if lv in p.cov else float("inf")
               for p, q in zip(program, reference) for lv in ref.LEVELS)


def _frob_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst image's ``||program - reference||_F / ||reference||_F``."""
    p, q = program.double().flatten(1), reference.double().flatten(1)
    return float(((p - q).norm(dim=1) / q.norm(dim=1).clamp_min(1e-300)).max())


def level_gaps(r: Run, inputs: Inputs, kept, banks, control: str = "") -> Dict[str, float]:
    """Over the recorded images of the kept calls, at every level and under
    every style, the worst gap of each stage from the reference given the
    stage's own recorded input (``LEVEL_GAPS``; infinite where a level was
    not recorded). With ``control``, the control's stages take the
    program's place, the others reading 0."""
    quant, store, operands = CONTROLS.get(control, (None, None, None))
    alpha = r.param("alpha")
    worst = dict.fromkeys(LEVEL_GAPS, 0.0)
    with torch.no_grad(), matmul_precision(False):
        for _, _, (_, levels) in kept.values():
            for lv in ref.LEVELS:
                for s, bank in enumerate(banks):
                    if (lv, s) not in levels:
                        worst = dict.fromkeys(LEVEL_GAPS, float("inf"))
                        continue
                    x, f, w, t, y = (a.to(r.device).permute(0, 3, 1, 2) if a.dim() == 4
                                     else a.to(r.device) for a in levels[(lv, s)])
                    x, t = x.float(), t.float()
                    mean, colour = bank.mean[lv], bank.colour[lv]
                    f_ref = ref.encode(inputs.enc, x, lv)
                    xc, w_ref = ref.whitening(f)
                    t_ref = ref.apply(f, xc, w_ref, mean, colour, alpha)
                    y_ref = ref.decode(inputs.decs[lv], t, lv)
                    if control:  # each stage's control given the stage's recorded input
                        xs, ws = ref.whitening(f, store) if store else (xc, w_ref)
                        y = ref.decode(inputs.decs[lv], t, lv, quant) if quant else y_ref
                        t = ref.apply(f, xs, ws, mean, colour, alpha, store, operands)
                        f = ref.encode(inputs.enc, x, lv, quant) if quant else f_ref
                        w = ws
                    found = {"encode_gap": _frob_gap(f, f_ref), "whiten_gap": _frob_gap(w, w_ref),
                             "apply_gap": _frob_gap(t, t_ref), "decode_gap": _frob_gap(y, y_ref)}
                    worst = {k: max(worst[k], found[k]) for k in LEVEL_GAPS}
    return worst


def gaps(kept, program_banks, reference, reference_banks) -> Dict[str, float]:
    """Over the compared images: the worst image's mean |difference| in
    uint8 levels and its share of values off by more than 4 levels; and the
    banks' gap."""
    per_call = [_u8_gaps(outs_np, reference[i]) for i, (_, outs_np, _) in kept.items()]
    return {"image_mae_worst": max(m for m, _ in per_call),
            "far_share_worst": max(f for _, f in per_call),
            "bank_gap": bank_gap(program_banks, reference_banks)}


def check(r: Run, inputs: Inputs, kept, program_banks) -> None:
    reference, banks = reference_outputs(r, inputs, kept)
    found = gaps(kept, program_banks, reference, banks)
    found.update(level_gaps(r, inputs, kept, banks))
    for name, value in found.items():
        r.check(name, value)


def control_readings(r: Run) -> Dict[str, float]:
    """Each control of :data:`CONTROLS` put in the program's place for as
    many calls as a run compares (3), against the reference: each reading by
    the check's name, prefixed by the control. The stages are held on what a
    sound run of the port recorded in those calls."""
    from ccst_tpu_torch.pipeline.wct import WCTEngine

    inputs = Inputs(r)
    engine = WCTEngine(inputs.enc, inputs.decs, dtype=dtype_of(r), device=r.device,
                       output_u8=True)
    stacked = engine.stack(program_banks(r, inputs))
    n = min(r.param("record_images"), inputs.batch)
    kept = {}
    for i in range(3):
        c, levels = i % len(inputs.pool_host), {}
        start = random.Random(r.seed * 7919 + i).randrange(inputs.batch - n + 1)
        outs = engine.stylize_multi(inputs.pool_host[c], stacked, r.param("alpha"),
                                    recorder(levels, start, n))
        kept[i] = ((c, -1, -1), outs.cpu().numpy(), (start, levels))
    del engine, stacked
    reference, banks = reference_outputs(r, inputs, kept)
    out = {}
    for control in CONTROLS:
        outs, c_banks = reference_outputs(r, inputs, kept, control)
        images = {i: (kept[i][0], outs[i].cpu().numpy(), None) for i in kept}
        found = gaps(images, c_banks, reference, banks)
        found.update(level_gaps(r, inputs, kept, banks, control))
        for k, v in found.items():
            out[f"{control}.{k}"] = v
    return out


def main(argv=None) -> int:
    """``python -m gpubench.drivers.wct --workload <cell> --seeds 1,2,3
    [--device cuda]``: the controls' readings, one JSON line a seed."""
    import argparse
    import json

    from gpubench import harness

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.load_run(args.workload, seed, 0.0, False, dev, t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": control_readings(r),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
