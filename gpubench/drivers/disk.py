"""The disk driver: CCST's offline stylize stage as its users run it, the CLI's
``run_overall_transfer`` (``ccst_tpu_torch/pipeline/stylize.py``) on a PNG
tree, outputs written as PNGs by the CLI's pool.

Traffic keys: ``engine``, ``batch``, ``pool_batches`` (a content domain's
images are ``pool_batches`` x ``batch``), ``keep`` (batches the check draws,
besides the window's last) and the stylize driver's others. Set-up writes,
under ``TMPDIR``, a PACS-shaped tree of seeded PNGs (``reference/images.py``'s
recipe) for the three source domains and their train lists, makes the four
domains' banks from ``style_bank_images`` seeded images each through the
port's bank step and saves them where ``stylize`` looks, and warms the engine
on one batch. The window runs one content domain after another (each under
the other three domains' banks, overwriting its outputs) until ``--seconds``
have passed; ``stylize_img_s`` counts the PNGs whose write
has completed, over the window. The tree is removed at the end.

The check decodes the window's last batch and the drawn ones from the PNGs
and compares them with ``reference/adain.py``, as the ``ref`` cell does.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import random
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from gpubench.drivers.fedavg import decode
from gpubench.drivers.stylize import REF_BLOCK, _rel_gap, _u8_gaps
from gpubench.flops import vgg as vgg_flops
from gpubench.harness import Run
from gpubench.reference import adain as ref
from gpubench.reference.images import blocky_noise

DOMAINS = ("art_painting", "cartoon", "photo", "sketch")  # PACS, in its spec order
SOURCES = ("art_painting", "cartoon", "sketch")           # photo held out


def run(r: Run) -> None:
    root = tempfile.mkdtemp(prefix="gpubench_disk_")
    try:
        _run(r, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_tree(r: Run, root: str, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """PNGs ``PACS/kfold/{domain}/img{i}.png`` of the source domains (zlib's
    fastest level) and their train lists; returns each domain's images,
    (N, H, W, 3) uint8."""
    from PIL import Image

    n = r.param("pool_batches") * r.param("batch")
    images, jobs = {}, []
    for domain in SOURCES:
        imgs = blocky_noise(gen, n, r.param("image_size"))
        images[domain] = imgs
        rels = [f"PACS/kfold/{domain}/img{i}.png" for i in range(n)]
        lists = os.path.join(root, "txt_lists", "pacs")
        os.makedirs(lists, exist_ok=True)
        os.makedirs(os.path.join(root, "PACS", "kfold", domain), exist_ok=True)
        with open(os.path.join(lists, f"{domain}_train.txt"), "w") as f:
            f.writelines(f"{rel} 0\n" for rel in rels)
        jobs += [(img, os.path.join(root, rel)) for rel, img in zip(rels, imgs.cpu().numpy())]
    with cf.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda j: Image.fromarray(j[0]).save(j[1], compress_level=1), jobs))
    return images


def _banks(r: Run, enc, style_images: Dict[str, torch.Tensor], stats_dir: str):
    """Every domain's (mean, std) through the port's bank step, saved where
    ``stylize`` reads them; returns them by domain."""
    from ccst_tpu_torch.ops.welford import welford_finalize, welford_init
    from ccst_tpu_torch.pipeline.style_bank import make_bank_step, save_style_stats

    step = make_bank_step(enc, torch.bfloat16, r.device)
    out = {}
    for domain, imgs in style_images.items():
        state = welford_init(512, r.device)
        for i in range(0, len(imgs), r.param("batch")):
            chunk = imgs[i:i + r.param("batch")].float() / 255.0
            state = step(state, chunk, chunk.shape[0])
        m, s = welford_finalize(state)
        save_style_stats(os.path.join(stats_dir, "pacs"), domain, m.cpu().numpy(),
                         s.cpu().numpy())
        out[domain] = (m, s)
    return out


def _config(r: Run, root: str, target: str):
    from ccst_tpu_torch.config import StylizeConfig

    return StylizeConfig(dataset="pacs", target=target, mode="overall",
                         image_size=r.param("image_size"), batch_size=r.param("batch"),
                         data_root=root, list_root=root,
                         style_stats_dir=os.path.join(root, "stats"),
                         output_root=os.path.join(root, "out"), dtype="bfloat16",
                         engine=r.param("engine"))


def _run(r: Run, root: str) -> None:
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine, run_overall_transfer

    gen = torch.Generator(device=r.device).manual_seed(r.seed)
    enc, dec = ref.make_weights(gen, r.param("decoder_scale"), r.param("decoder_shift"))
    contents = write_tree(r, root, gen)
    style_images = {d: blocky_noise(gen, r.param("style_bank_images"), r.param("image_size"))
                    for d in DOMAINS}
    banks = _banks(r, enc, style_images, os.path.join(root, "stats"))
    engine = StylizeEngine(enc, dec, dtype=torch.bfloat16, device=r.device, output_u8=True,
                           engine=r.param("engine"))
    # warm: the one batch shape the passes use, under the three banks
    warm = contents[SOURCES[0]][:r.param("batch")].cpu()
    styles = [d for d in DOMAINS if d != SOURCES[0]]
    engine.stylize_multi(warm, torch.stack([banks[d][0] for d in styles]),
                         torch.stack([banks[d][1] for d in styles])).cpu()
    setup_s = time.perf_counter() - r.t_start

    t0 = time.perf_counter()
    n_png, passes = 0, []
    while not passes or time.perf_counter() - t0 < r.seconds:
        target = SOURCES[len(passes) % len(SOURCES)]
        report = run_overall_transfer(_config(r, root, target), engine)
        n_png += report.images * len(report.styles)
        passes.append(target)
    window_s = time.perf_counter() - t0
    per_domain = r.param("pool_batches")
    job = vgg_flops.job_of(r.param)
    calls = len(passes) * per_domain
    r.attempted = calls
    r.failed = calls - n_png // job.images
    r.end_to_end = {"stylize_img_s": n_png / window_s, "setup_s": setup_s}
    r.counters = {"window_s": window_s, "calls": calls, "images": n_png,
                  "model_flops_per_call": vgg_flops.model_flops(job),
                  "images_per_call": job.images, "passes": len(passes)}
    if r.trace:
        _trace(r, root, engine, passes[-1])
    if r.device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
    del engine
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    # the window's last batch and ``keep`` drawn from the seed among its batches
    rng = random.Random(r.seed ^ 0x5EED)
    picked = {(passes[-1], per_domain - 1)}
    picked |= {(rng.choice(passes), rng.randrange(per_domain)) for _ in range(r.param("keep"))}
    check(r, root, enc, dec, contents, style_images, banks, sorted(picked))


def _trace(r: Run, root: str, engine, target: str) -> None:
    """One content domain's pass under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ccst_tpu_torch.pipeline.stylize import run_overall_transfer
    from gpubench.trace import WINDOW, reduce_profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if r.device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            run_overall_transfer(_config(r, root, target), engine)
    r.counters["traced_calls"] = r.param("pool_batches")
    r.traced = reduce_profile(prof)


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------


def check(r: Run, root: str, enc, dec, contents, style_images, program_banks,
          picked: List[Tuple[str, int]]) -> None:
    from ccst_tpu_torch.data.lists import stylized_output_path

    batch, size = r.param("batch"), r.param("image_size")
    with torch.no_grad():
        ref_banks = {d: ref.style_bank(enc, imgs, REF_BLOCK) for d, imgs in style_images.items()}
    per_batch = []
    for target, b in picked:
        styles = [d for d in DOMAINS if d != target]
        rels = [f"PACS/kfold/{target}/img{i}.png" for i in range(b * batch, (b + 1) * batch)]
        program = torch.stack([
            decode([os.path.join(root, "out", stylized_output_path(rel, target, s, "overall"))
                    for rel in rels], size) for s in styles])
        content = contents[target][b * batch:(b + 1) * batch]
        reference = ref.stylize(enc, dec, content, torch.stack([ref_banks[s][0] for s in styles]),
                                torch.stack([ref_banks[s][1] for s in styles]), REF_BLOCK)
        per_batch.append(_u8_gaps(program.numpy(), reference))
    r.check("image_mae_worst", max(m for m, _ in per_batch))
    r.check("far_share_worst", max(f for _, f in per_batch))
    r.check("bank_gap", max(max(_rel_gap(program_banks[d][0], ref_banks[d][0]),
                                _rel_gap(program_banks[d][1], ref_banks[d][1]))
                            for d in DOMAINS))
