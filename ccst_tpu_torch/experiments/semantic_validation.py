"""End-to-end semantic validation of the CCST mechanism, on the port.

Port of the JAX project's ``experiments/semantic_validation.py``: the claim
the pipeline exists for (cross-client style sharing improves held-out-domain
accuracy) measured on the synthetic "shapes4" domain shift, through the
port's own stages.

Benchmark: 4 classes (disk / square / cross / stripes) drawn alike in every
domain; each source domain ties a class to a colour through a per-image
multiplicative tint (the tie conflicts across domains), the held-out target
``mixed`` draws its tints uniformly. A client that trains on its own data takes
the colour shortcut and fails on the target; stylizing every client's images
into the other clients' styles rewrites their global colour statistics and
leaves the shapes.

The chain, per seed: an encoder made invertible (LSUV rescale, then joint
encoder + decoder + tint-head autoencoder pretraining), a decoder trained
against it (``pipeline/train_decoder.py``, warm-started from the autoencoder's),
then for each arm ``style-bank -> calibrate -> stylize -> reorganize ->
gen-lists -> fed-train``. Four arms, same seeds:

  ``no_fusion``  the baseline, no stylization;
  ``bf16``       Overall mode (domain banks) through the float32 ``ref``
                 engine (the arm keeps the JAX project's name);
  ``int8``       the same through the ``int8-static`` engine;
  ``single``     Single mode: one concrete style image per content batch.

Kernels on the card: the LSUV pass K3 (float32); the banks K3 (bf16) + K5;
the ``ref`` stylize K3 (float32) + K4; ``int8-static`` K0 + K4; Single mode
K3 + K5 + K4 a batch and style; the decoder training's frozen encoder passes
K3 (float32). The autoencoder pretraining and the classifiers train on the
autograd route (cuDNN), float32 with TF32 off; the whole run takes cuDNN's
deterministic algorithms, so a seed gives the same result run to run on one
card.

Writes ``ccst_tpu_torch/experiments/results/EXPERIMENT_SEMANTIC.json``: the
JAX script's keys, plus the device it ran on (``nvidia-smi``'s name and power
limit, or ``cpu``) and the wall seconds of every stage (``timing``). Arms and
seeds already in ``--out`` are carried over only from a run on the same
device.

    python -m ccst_tpu_torch.experiments.semantic_validation [--quick] [--seeds 1,2,3,4,5]
        [--arms no_fusion,bf16,int8,single] [--device cuda|cpu] [--out PATH] [--workdir DIR]

The weights start from torch generators seeded 0, 7 and 13, as the JAX
script seeds ``PRNGKey`` (:func:`initial_weights`).
"""
from __future__ import annotations

import argparse
import colorsys
import functools
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ccst_tpu_torch import config as cc
from ccst_tpu_torch.config import FedConfig, StylizeConfig
from ccst_tpu_torch.data.lists import generate_k_lists, reorganize_unified_tree, write_list
from ccst_tpu_torch.data.loader import load_image, save_image_u8
from ccst_tpu_torch.federated.runtime import FederatedRunner
from ccst_tpu_torch.kernels.conv import prepare_conv, reflect_conv3x3
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.models.convert import load_decoder, save_npz
from ccst_tpu_torch.pipeline.style_bank import compute_style_bank
from ccst_tpu_torch.pipeline.stylize import (
    StylizeEngine,
    run_calibration,
    run_overall_transfer,
    run_single_transfer,
)
from ccst_tpu_torch.pipeline.train_decoder import (
    DecoderTrainConfig,
    _pooled_loader,
    synchronize,
    train_decoder,
)
from ccst_tpu_torch.utils.optim import Adam
from ccst_tpu_torch.utils.precision import no_tf32

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")

DOMAINS = ["rot0", "rot1", "rot2", "mixed"]  # target: mixed
CLASSES = ["disk", "square", "cross", "stripes"]

# The colour cue is a per-image multiplicative tint on an achromatic base:
# in source domain rotK, class ci takes hue slot ((ci + K) % 4) / 4; on the
# target the hue is uniform. A tint is a per-channel affine of the image (a
# global colour statistic, which Overall AdaIN replaces), and hue slot h
# means class h in rot0, h - 1 in rot1, h - 2 in rot2, so a tint that
# survives stylization is ambiguous in the pooled fusion set.
_FG_LUM, _BG_LUM = 0.85, 0.30

# the sizes of a run: --quick, and the full one (its default seeds; --seeds widens them)
SIZES = {
    "quick": dict(n_per_class=8, ae_steps=10, dec_steps=30, rounds=2, seeds=[1]),
    "full": dict(n_per_class=40, ae_steps=1500, dec_steps=1200, rounds=16, seeds=[1, 2, 3]),
}
IMAGE_SIZE = 32  # a power of 2: the stylize decode round-trips exactly

# (arm, engine, mode); engine None: no stylization
ARMS = (
    ("no_fusion", None, "overall"),
    ("bf16", "ref", "overall"),
    ("int8", "int8-static", "overall"),
    ("single", "ref", "single"),
)


def require_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device must exist (no silent CPU run)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device here; pass --device cpu to run on "
                         "the CPU")
    return dev


def device_label(device) -> str:
    """What a result was measured on: ``cpu``, or the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(index)


def deterministic(fn):
    """``fn`` with TF32 off and cuDNN's deterministic algorithms on the card,
    as the federated runner trains: a seed gives the same bits run to run on
    one card (the trainers' own steps set TF32 off and leave the algorithms as
    found)."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with no_tf32(deterministic=True):
            return fn(*args, **kw)
    return run


def _image_tint(domain: str, ci: int, rng: np.random.Generator) -> np.ndarray:
    """Per-channel gain vector encoding the (spurious) colour cue."""
    if domain == "mixed":
        hue = rng.uniform(0.0, 1.0)  # no class correlation on the target
    else:
        k = DOMAINS.index(domain)
        hue = ((ci + k) % len(CLASSES)) / len(CLASSES)
    return np.asarray(colorsys.hsv_to_rgb(hue, 0.70, 1.0))


def _mask(cls: str, size: int, rng: np.random.Generator) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    # near-centred, large shapes: the class must be learnable from modest data
    cy, cx = rng.uniform(0.44, 0.56, 2)
    r = rng.uniform(0.24, 0.32)
    if cls == "disk":
        return ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.float32)
    if cls == "square":
        return ((np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)).astype(np.float32)
    if cls == "cross":
        w = r * 0.45
        return (
            ((np.abs(yy - cy) < w) & (np.abs(xx - cx) < r * 1.4))
            | ((np.abs(xx - cx) < w) & (np.abs(yy - cy) < r * 1.4))
        ).astype(np.float32)
    # stripes: horizontal bars inside a square window
    period = max(int(size * r * 0.7), 2)
    bars = ((np.arange(size) // period) % 2).astype(np.float32)[:, None]
    win = ((np.abs(yy - cy) < r * 1.3) & (np.abs(xx - cx) < r * 1.3))
    return (bars * np.ones((1, size))) * win.astype(np.float32)


def make_shapes_dataset(root: str, size: int, n_per_class: int, seed: int) -> None:
    """``SHAPES4/kfold/{domain}/{class}/imgNNN.png`` under ``root`` and
    ``txt_lists/shapes4/{domain}_{train,test}.txt``: the last quarter of each
    class is test."""
    for d in DOMAINS:
        rng = np.random.default_rng(seed * 100 + DOMAINS.index(d))
        names, labels = [], []
        for ci, cls in enumerate(CLASSES):
            for i in range(n_per_class):
                m = _mask(cls, size, rng)[..., None]
                base = m * _FG_LUM + (1 - m) * _BG_LUM
                base = base + rng.normal(0, 0.05, (size, size, 1))
                # noise before the tint: the image stays an exact per-channel
                # affine of the tint-free base
                img = base * _image_tint(d, ci, rng)
                rel = f"SHAPES4/kfold/{d}/{cls}/img{i:03d}.png"
                save_image_u8(np.clip(img, 0, 1).astype(np.float32), os.path.join(root, rel))
                names.append(rel)
                labels.append(ci)
        tr_n, tr_l, te_n, te_l = [], [], [], []
        for ci in range(len(CLASSES)):
            cls_names = [n for n, l in zip(names, labels) if l == ci]
            k = max(len(cls_names) // 4, 1)
            tr_n += cls_names[:-k]
            tr_l += [ci] * (len(cls_names) - k)
            te_n += cls_names[-k:]
            te_l += [ci] * k
        write_list(os.path.join(root, "txt_lists", "shapes4", f"{d}_train.txt"), tr_n, tr_l)
        write_list(os.path.join(root, "txt_lists", "shapes4", f"{d}_test.txt"), te_n, te_l)


def _register(size: int) -> None:
    """``shapes4`` in the port's dataset registry."""
    cc.DATASETS["shapes4"] = cc.DatasetSpec(
        name="shapes4", domains=tuple(DOMAINS), num_classes=len(CLASSES),
        image_size=size, stylize_size=size,
    )


def _tree(params) -> vgg.Params:
    """A ``Params`` tree (tensors or arrays) as float32 CPU tensors, copied."""
    return {name: {k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in p.items()}
            for name, p in params.items()}


def initial_weights(seed: int = 0):
    """The weights a run starts from: (encoder, autoencoder decoder, tint
    head) from torch generators seeded ``seed``, ``seed + 7`` and ``seed + 13``,
    as the JAX script seeds ``PRNGKey`` 0, 7 and 13 (torch and JAX draw other
    numbers from a seed)."""
    enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(seed))
    dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(seed + 7))
    g = torch.Generator().manual_seed(seed + 13)
    head = {"w": torch.randn((1024, 3), generator=g) * 0.01, "b": torch.zeros((3,))}
    return enc, dec, head


def make_experiment_encoder(probe_images, device="cuda", init: Optional[vgg.Params] = None
                            ) -> vgg.Params:
    """A random encoder rescaled layer by layer to unit post-ReLU std on a
    probe batch (LSUV; Mishkin & Matas 2016): a plain random encoder's
    activations decay ~12x by relu4_1, which collapses the banks. ``init``:
    the weights to rescale (default: :func:`initial_weights`' encoder). The
    pass runs through K3's float32 route on the card, TF32 off. Returns
    float32 CPU tensors."""
    enc = _tree(init if init is not None else initial_weights()[0])
    dev = torch.device(device)
    h = torch.as_tensor(np.asarray(probe_images, np.float32)).to(dev)
    with torch.no_grad(), no_tf32():
        for layer in vgg.ENCODER_ARCH:
            if isinstance(layer, vgg.Conv):
                p = enc[layer.name]
                cw = prepare_conv(p["w"], p["b"], torch.float32, dev)
                if layer.ksize == 3:
                    pre = reflect_conv3x3(h, cw, relu=layer.relu)
                else:
                    pre = vgg.conv1x1(h, cw)
                    if layer.relu:
                        pre = torch.relu(pre)
                # jnp.std: the population std (ddof 0), as a Python float
                s = torch.tensor(float(pre.std(correction=0)) + 1e-8, dtype=torch.float32)
                p["w"], p["b"] = p["w"] / s, p["b"] / s
                h = pre / s.to(dev)
                if layer.name == "conv4_1":
                    break
            elif isinstance(layer, vgg.Pool):
                h = vgg.maxpool_ceil(h)
    return enc


def _standardize(f: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel standardization over H, W (ddof 0) of NHWC."""
    mu = f.mean(dim=(1, 2), keepdim=True)
    sd = f.std(dim=(1, 2), keepdim=True, correction=0) + 1e-5
    return (f - mu) / sd


class AutoencoderPretrainer:
    """The joint encoder + decoder + tint-head step of :func:`pretrain_encoder`
    on ``vgg``'s autograd route, float32 with TF32 off, ``optax.adam(3e-4)``
    (``utils/optim.py``)."""

    def __init__(self, enc, dec, head, device):
        self.device = torch.device(device)
        self.enc = vgg.trainable_params(enc, self.device)
        self.dec = vgg.trainable_params(dec, self.device)
        self.head = {k: torch.nn.Parameter(torch.tensor(np.asarray(v), dtype=torch.float32,
                                                        device=self.device))
                     for k, v in head.items()}
        leaves = [p[k] for tree in (self.enc, self.dec, {"head": self.head})
                  for p in tree.values() for k in ("w", "b")]
        self.opt = Adam(leaves, 3e-4)

    def losses(self, x: torch.Tensor, tint: torch.Tensor):
        """(total, recon, inv, reg) of a batch and its tints (B, 1, 1, 3)."""
        f = vgg.apply_encoder(self.enc, x, route="autograd")
        recon = torch.mean((vgg.apply_decoder(self.dec, f, route="autograd") - x) ** 2)
        # style-content disentanglement: standardized features must not see
        # a random global tint, so global colour lives in the statistics
        f_t = vgg.apply_encoder(self.enc, x * tint, route="autograd")
        inv = torch.mean((_standardize(f_t) - _standardize(f)) ** 2)
        # and the statistics must carry it: a linear head reads the tint back
        stats = torch.cat([f_t.mean(dim=(1, 2)), f_t.std(dim=(1, 2), correction=0)], -1)
        pred = stats @ self.head["w"] + self.head["b"]
        reg = torch.mean((pred - tint[:, 0, 0, :]) ** 2)
        return recon + 20.0 * inv + reg, recon, inv, reg

    def step(self, images, tint):
        """One Adam step; returns the (recon, inv, reg) losses, detached."""
        x = torch.as_tensor(images).to(self.device)
        tint = torch.as_tensor(tint, dtype=torch.float32).to(self.device)
        with no_tf32():
            total, recon, inv, reg = self.losses(x, tint)
            grads = torch.autograd.grad(total, self.opt.params)
        self.opt.step(grads)
        return recon.detach(), inv.detach(), reg.detach()


def pretrain_encoder(root: str, size: int, steps: int, enc, device="cuda",
                     dec: Optional[vgg.Params] = None, head=None):
    """Make the encoder invertible before the decoder training: joint encoder
    + decoder pixel reconstruction on the pooled source domains (the target
    excluded), the zero-download substitute for a pretrained VGG. ``dec`` /
    ``head`` are the initial decoder and tint head (default:
    :func:`initial_weights`'). Saves the decoder as ``{root}/decoder_ae.npz``;
    returns (the encoder as float32 CPU tensors, that path)."""
    cfg = DecoderTrainConfig(
        dataset="shapes4", list_root=root, data_root=root,
        image_size=size, batch_size=8, steps=steps,
        domains=",".join(DOMAINS[:-1]),
    )
    if dec is None or head is None:
        _, dec0, head0 = initial_weights()
        dec, head = dec0 if dec is None else dec, head0 if head is None else head
    trainer = AutoencoderPretrainer(enc, dec, head, device)
    it = iter(_pooled_loader(cfg, ""))
    rng = np.random.default_rng(11)
    for i in range(steps):
        b = next(it)
        tint = rng.uniform(0.25, 1.0, (b.images.shape[0], 1, 1, 3)).astype(np.float32)
        lr_, li_, lg_ = trainer.step(torch.from_numpy(b.images), torch.from_numpy(tint))
        if (i + 1) % max(steps // 4, 1) == 0:
            print(f"[ae] step {i+1}/{steps} recon={float(lr_):.5f} "
                  f"inv={float(li_):.5f} tintreg={float(lg_):.5f}", flush=True)
    # the autoencoder's decoder warm-starts the AdaIN decoder training
    dec_path = os.path.join(root, "decoder_ae.npz")
    save_npz(dec_path, vgg.params_from_trainable(trainer.dec))
    return vgg.params_from_trainable(trainer.enc), dec_path


def _train_stylizer(root: str, size: int, steps: int, enc, init_decoder: str = "",
                    device="cuda"):
    """Train the mirror decoder against ``enc`` on the pooled source images
    (the target excluded), optionally warm-started. Returns (the decoder,
    ``train_decoder``'s result)."""
    enc_path = os.path.join(root, "encoder_lsuv.npz")
    save_npz(enc_path, enc)
    cfg = DecoderTrainConfig(
        dataset="shapes4", list_root=root, data_root=root,
        image_size=size, batch_size=8, steps=steps, lr=1e-4,
        out_path=os.path.join(root, "decoder_trained.npz"),
        log_every=max(steps // 4, 1),
        domains=",".join(DOMAINS[:-1]),
        vgg_weights=enc_path,
        init_decoder=init_decoder,
    )
    result = train_decoder(cfg, device=device)
    return load_decoder(result["out_path"]), result


def run_chain(root: str, size: int, engine_kind: str, seed: int, enc, dec,
              mode: str = "overall", device="cuda") -> None:
    """style-bank -> calibrate -> stylize -> reorganize -> gen-lists for every
    source content domain: the adain-{mode}-K3 fusion lists for the target.
    ``mode="overall"`` uses the domain banks (computed in bfloat16, the
    config's default); ``"single"`` draws one style image per batch. The
    ``ref`` engine runs in float32, the int8 engines in bfloat16 after
    calibrating on 8 images of their content domain."""
    target = DOMAINS[-1]
    base = dict(
        dataset="shapes4", list_root=root, data_root=root, output_root=root,
        style_stats_dir=os.path.join(root, "style_stats"),
        image_size=size, batch_size=8, seed=seed,
    )
    if mode == "overall":
        for d in DOMAINS:
            compute_style_bank(StylizeConfig(**base, target=d), d, encoder_params=enc,
                               device=device)
    for content in DOMAINS[:-1]:
        cfg = StylizeConfig(**base, target=content, engine=engine_kind, mode=mode)
        engine = StylizeEngine(
            enc, dec, dtype=torch.float32 if engine_kind == "ref" else torch.bfloat16,
            device=device, output_u8=True, engine=engine_kind,
        )
        if engine_kind.startswith("int8"):
            run_calibration(cfg, engine, max_images=8)
        if mode == "overall":
            run_overall_transfer(cfg, engine)
        else:
            run_single_transfer(cfg, engine)
    reorganize_unified_tree(root, "shapes4", target, mode, data_root=root)
    generate_k_lists(root, "shapes4", target, k=3, mode=mode, seed=seed)


def run_fed(root: str, size: int, fusion_mode: str, seed: int, rounds: int, device="cuda"
            ) -> Dict:
    """fed-train (resnet4, fedavg) on the fusion lists; the best record
    {val_acc_mean, round, test_acc} and the rounds' wall seconds
    (``round_seconds``, from the runner's log)."""
    cfg = FedConfig(
        dataset="shapes4", target=DOMAINS[-1], mode="fedavg",
        fusion_mode=fusion_mode, network="resnet4", rounds=rounds,
        batch_size=8, image_size=size, lr=0.1, seed=seed,
        data_root=root, list_root=root,
        save_path=os.path.join(root, f"ckpt_{fusion_mode}_{seed}"),
        log_path=os.path.join(root, f"logs_{fusion_mode}_{seed}"),
        save_freq=max(rounds, 1), min_scale=0.9,
    )
    runner = FederatedRunner(cfg, device=device)
    best = runner.run()
    with open(runner.logger.path) as f:
        records = [json.loads(line) for line in f]
    best["round_seconds"] = [r["seconds"] for r in records if r["event"] == "round"]
    return best


def _paired_orderings(results: Dict[str, List[Dict]]) -> Dict[str, Dict]:
    """Per-seed paired gaps between arms (same seed = same data and init):
    mean, sd, per-seed values, and how many seeds keep the ordering."""
    by_seed = {a: {r["seed"]: r["test_acc"] for r in rs} for a, rs in results.items()}
    out = {}
    for hi, lo in (("bf16", "single"), ("bf16", "no_fusion"), ("single", "no_fusion")):
        common = sorted(set(by_seed.get(hi, {})) & set(by_seed.get(lo, {})))
        if not common:
            continue
        gaps = [by_seed[hi][s] - by_seed[lo][s] for s in common]
        out[f"{hi}_minus_{lo}"] = {
            "seeds": common,
            "gaps": [round(g, 4) for g in gaps],
            "mean": float(np.mean(gaps)),
            "sd": float(np.std(gaps)),
            "n_positive": int(sum(g > 0 for g in gaps)),
        }
    return out


def _load_prior(out: str, device: str):
    """(per-arm results, timing entries) of an earlier artifact at ``out``;
    refused when it was made on another device (or does not say)."""
    if not os.path.exists(out):
        return {}, []
    with open(out) as f:
        prior = json.load(f)
    if prior.get("device") != device:
        raise SystemExit(f"{out} was made on {prior.get('device', 'an unrecorded device')!r}, "
                         f"not {device!r}: pass another --out")
    return prior.get("per_arm", {}), prior.get("timing", [])


@deterministic
def run(workdir: str, out: str, seeds: Sequence[int], arms: Sequence[str], *, size: int,
        n_per_class: int, ae_steps: int, dec_steps: int, rounds: int, device="cuda") -> Dict:
    """Every selected (arm, seed) not already in ``out``; writes and returns
    the summary."""
    dev = require_device(str(device))
    label = device_label(dev)
    _register(size)
    prior, timing = _load_prior(out, label)
    # arms not selected are carried over whole, and the (arm, seed) pairs
    # already measured are kept and skipped
    results: Dict[str, List[Dict]] = {a: list(prior.get(a, [])) for a, _, _ in ARMS}

    def clock(stage: str, t0: float, **fields) -> float:
        synchronize(dev)
        seconds = time.perf_counter() - t0
        timing.append({"stage": stage, **fields, "seconds": seconds})
        return seconds

    enc = dec_ae_path = None
    for seed in seeds:
        dec = None
        for arm, engine_kind, mode in ARMS:
            if arm not in arms or any(r.get("seed") == seed for r in results[arm]):
                continue
            root = os.path.join(workdir, f"{arm}_s{seed}")
            make_shapes_dataset(root, size, n_per_class, seed=seed)
            fusion = "no_fusion"
            if engine_kind is not None:
                if enc is None:
                    probes = np.stack([
                        load_image(os.path.join(root, f"SHAPES4/kfold/{d}/{c}/img000.png"), size)
                        for d in DOMAINS[:-1] for c in CLASSES])
                    t0 = time.perf_counter()
                    enc = make_experiment_encoder(probes, device=dev)
                    enc, dec_ae_path = pretrain_encoder(root, size, ae_steps, enc, device=dev)
                    s = clock("ae_pretrain", t0, steps=ae_steps)
                    timing[-1]["steps_per_sec"] = ae_steps / s
                if dec is None:
                    # a seed's data is the same in every arm: one decoder serves them all
                    t0 = time.perf_counter()
                    dec, trained = _train_stylizer(root, size, dec_steps, enc,
                                                   init_decoder=dec_ae_path, device=dev)
                    clock("decoder_training", t0, seed=seed, steps=dec_steps,
                          steps_per_sec=trained["steps_per_sec"])
                t0 = time.perf_counter()
                run_chain(root, size, engine_kind, seed, enc, dec, mode=mode, device=dev)
                clock("chain", t0, arm=arm, seed=seed)
                fusion = f"adain-{mode}-K3"
            t0 = time.perf_counter()
            best = run_fed(root, size, fusion, seed, rounds, device=dev)
            round_seconds = best.pop("round_seconds")
            clock("fed", t0, arm=arm, seed=seed, rounds=rounds,
                  mean_round_seconds=float(np.mean(round_seconds)))
            results[arm].append({"seed": seed, **best})
            print(f"[seed {seed}] {arm}: {best}", flush=True)

    def acc(arm):
        return [r["test_acc"] for r in results[arm]]

    def gain(a, b):
        if not results[a] or not results[b]:
            return None
        return float(np.mean(acc(a)) - np.mean(acc(b)))

    summary = {
        "benchmark": ("shapes4 synthetic domain shift (spurious class-tint correlation; "
                      "target: uncorrelated tints)"),
        "seeds": sorted({r["seed"] for rs in results.values() for r in rs}),
        "rounds": rounds,
        "n_train_per_domain": n_per_class * len(CLASSES) * 3 // 4,
        "per_arm": results,
        "mean_test_acc": {a: float(np.mean(acc(a))) for a in results if results[a]},
        "sd_test_acc": {a: float(np.std(acc(a))) for a in results if results[a]},
        "n_seeds_per_arm": {a: len(results[a]) for a in results},
        "ccst_gain_bf16_vs_no_fusion": gain("bf16", "no_fusion"),
        "int8_vs_bf16_gap": gain("int8", "bf16"),
        "ccst_gain_single_vs_no_fusion": gain("single", "no_fusion"),
        "per_seed_gain": [b - n for b, n in zip(acc("bf16"), acc("no_fusion"))],
        "paired_orderings": _paired_orderings(results),
        "device": label,
        "timing": timing,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k not in ("per_arm", "timing")},
                     indent=2))
    return summary


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run (1 seed, small data, few steps and rounds)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(RESULTS, "EXPERIMENT_SEMANTIC.json"))
    ap.add_argument("--workdir", default="")
    ap.add_argument("--arms", default="no_fusion,bf16,int8,single",
                    help="comma list of arms to (re)run; the others are carried over from an "
                         "existing --out made on the same device")
    ap.add_argument("--seeds", default="",
                    help="comma list of seeds; (arm, seed) results already in --out are kept "
                         "and skipped. Default: 1,2,3 (1 with --quick)")
    args = ap.parse_args(argv)
    sizes = dict(SIZES["quick" if args.quick else "full"])
    seeds = sizes.pop("seeds")
    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    unknown = set(arms) - {a for a, _, _ in ARMS}
    if unknown:
        ap.error(f"unknown arms: {sorted(unknown)}")
    workdir = args.workdir or tempfile.mkdtemp(prefix="ccst_semval_")
    return run(workdir, args.out, seeds, arms, size=IMAGE_SIZE, device=args.device, **sizes)


if __name__ == "__main__":
    main()
