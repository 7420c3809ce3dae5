"""The shapes4 semantic validation over initial draws: how far the trained
stylizer, and the ordering Overall (``bf16``) above Single, depend on where
the weights start, on each side.

    python -m tests.semantic_draws {jax,port,port-from-jax,mix-port-enc,mix-jax-enc} K
        [--depth stylizer|grid] [--quick] [--seeds 1,2,3,4,5] [--device cpu|cuda]
        [--threads N] [--save-stylizer DIR]
    python -m tests.semantic_draws {jax,port} 0 --stylizer DIR [--seeds S] [--quick]
    python -m tests.semantic_draws summarize FILE... [--out JSON]
    python -m tests.semantic_draws save-draws DIR K...
    python -m tests.semantic_draws float64 K STEPS
    python -m tests.semantic_draws draw-stats N

Sides, as in ``tests/privacy_draws.py``:

- ``jax``: the JAX project's ``experiments/semantic_validation.py`` with its
  ``PRNGKey`` 0, 7 and 13 moved to 1000 K + 0, 7 and 13 (K = 0: the script
  as it is);
- ``port``: the port's stages from ``semantic_validation.initial_weights(1000 K)``
  (K = 0: its default);
- ``port-from-jax``: the port from the JAX script's draws of ``jax`` K
  (``--jax-draws DIR``: from ``DIR/kK.npz``, which ``save-draws`` writes on
  the CPU, so that the card needs no JAX);
- ``mix-port-enc`` / ``mix-jax-enc``: the port from mixed draws of K, the
  port's encoder with the JAX script's decoder and tint head, or the JAX
  script's encoder with the port's decoder and head: which of the three
  draws carries a difference between ``port`` and ``port-from-jax``.

Depths:

- ``stylizer``: LSUV, the autoencoder and the decoder of the first seed, then
  ``run_chain`` for the ``bf16`` (Overall) and ``single`` arms; no
  ``fed-train``;
- ``grid``: the ``bf16`` and ``single`` arms through ``fed-train`` at
  ``--seeds``: the JAX script's own ``main`` (``--arms bf16,single``) or the
  port's ``semantic_validation.run``.

Both report the autoencoder's last logged recon / inv / tintreg, each seed's
decoder loss_c / loss_s after its last step, and the tint probe of every
stylized training tree and of the unstylized sources (:func:`tint_probe`).

``--stylizer DIR`` takes ``encoder_lsuv.npz`` and ``decoder_trained.npz`` from
a run's data root (either package writes them; ``--save-stylizer`` copies
them out of a run: the stylizer depth's into DIR, the grid's of seed S into
``DIR/sS``) and runs the named side's ``run_chain`` and
``fed-train`` from them, for ``bf16`` and ``single`` at the seed they were
trained for: a stylizer of one package through the other's pipeline.

``summarize`` reads the JSON lines of such runs (and of ``float64`` and
``draw-stats``, and of ``tests/privacy_draws.py``: its gaps, and how many
are at most 2 dB) and
prints, for each depth, size and device, every metric's distribution over the
draws of each side and a two-sided Mann-Whitney U test of each side against
each other (the grids also across devices, a side and its device as one
group); for the grids, each draw's arm means and paired gap and the share of
(draw, seed) pairs with ``bf16`` above ``single``, and the rank correlation
of a seed's Overall tint probe with its gap. ``--out`` writes the rows and
every record read as one JSON file (a record a line), which ``summarize``
reads back as it reads the runs' output.

``float64 K STEPS`` holds the two packages' autoencoder and decoder training
to each other over ``STEPS`` steps from the JAX draws of K
(:func:`float64_trajectories`); ``draw-stats N`` asks whether the two
generators' draws of k < N come from one distribution (:func:`draw_stats`).

Prints one JSON line. The port's side runs on ``--device`` (``cuda`` on the
card; where another installed package is named ``tests``, run the file:
``python tests/semantic_draws.py port K --depth grid --device cuda``); the
JAX side runs only on the CPU. Torch takes ``--threads`` (default
2) threads; XLA's CPU pool follows the process's CPU mask, so fix it with
``taskset -c``: the thread count changes a float32 trajectory.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

if __package__ in (None, ""):  # run as a file: the repository's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARMS = (("bf16", "overall"), ("single", "single"))
STYLIZER_FILES = ("encoder_lsuv.npz", "decoder_trained.npz")
_AE_LINE = re.compile(r"\[ae\] step (\d+)/\d+ recon=(\S+) inv=(\S+) tintreg=(\S+)")


class _Tee(io.TextIOBase):
    """Standard output copied to standard error and kept, so the stages'
    progress lines can be read back and the one JSON line stays alone."""

    def __init__(self):
        self.kept = io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return sys.stderr.write(s)

    def flush(self):
        sys.stderr.flush()


def tint_probe(paths, labels) -> float:
    """Nearest-centroid accuracy of the class from an image's mean RGB:
    centroids fitted on the even-indexed images, scored on the odd ones.
    Chance is 1 / 4; a global tint that carries the class reads high."""
    from PIL import Image

    x = np.stack([np.asarray(Image.open(p).convert("RGB"), np.float64).mean((0, 1))
                  for p in paths])
    y = np.asarray(labels)
    fit, score = slice(0, None, 2), slice(1, None, 2)
    classes = np.unique(y[fit])
    centroids = np.stack([x[fit][y[fit] == c].mean(0) for c in classes])
    d = ((x[score][:, None, :] - centroids[None]) ** 2).sum(-1)
    return float((classes[d.argmin(1)] == y[score]).mean())


def tree_probes(root: str, mode: str) -> dict:
    """The tint probe over the pooled source clients' training images
    (``source``) or their stylized copies in the other clients' styles
    (``overall`` / ``single``): pooled, and the mean of each client's own."""
    from ccst_tpu_torch.data.lists import parse_list, stylized_output_path, train_list_path

    sources = ["rot0", "rot1", "rot2"]
    pooled, per_client = ([], []), []
    for client in sources:
        names, labels = parse_list(train_list_path(root, "shapes4", client))
        if mode == "source":
            items = list(zip(names, labels))
        else:
            items = [(stylized_output_path(n, client, style, mode), l)
                     for style in sources if style != client for n, l in zip(names, labels)]
        paths = [os.path.join(root, n) for n, _ in items]
        labs = [l for _, l in items]
        per_client.append(tint_probe(paths, labs))
        pooled[0].extend(paths)
        pooled[1].extend(labs)
    return {"pooled": tint_probe(*pooled), "client_mean": float(np.mean(per_client))}


def seed_probes(work: str, seed: int) -> dict:
    """The tint probes of one seed's trees: the sources and the Overall copies
    in ``bf16_s{seed}``, the Single copies in ``single_s{seed}``."""
    overall = os.path.join(work, f"bf16_s{seed}")
    return {"source": tree_probes(overall, "source"),
            "overall": tree_probes(overall, "overall"),
            "single": tree_probes(os.path.join(work, f"single_s{seed}"), "single")}


def _sizes(quick: bool) -> dict:
    from ccst_tpu_torch.experiments.semantic_validation import IMAGE_SIZE, SIZES

    sizes = dict(SIZES["quick" if quick else "full"], size=IMAGE_SIZE)
    sizes.pop("seeds")
    return sizes


class _Side:
    """One package's stages behind one signature."""

    def __init__(self, side: str, k: int, device: str, jax_draws_dir: str = ""):
        self.side, self.k = side, k
        self.is_jax = side == "jax"
        if self.is_jax:
            import jax

            from tests.privacy_draws import jax_keys

            jax.config.update("jax_platforms", "cpu")
            import ccst_tpu.pipeline.train_decoder as trainer
            from ccst_tpu.data.loader import load_image
            from ccst_tpu.models.convert import load_decoder, load_encoder
            from experiments import semantic_validation as sv

            self.device = "cpu"
            self.wrap, self.jax_keys = (lambda fn: fn), jax_keys
        else:
            from ccst_tpu_torch.data.loader import load_image
            from ccst_tpu_torch.experiments import semantic_validation as sv
            from ccst_tpu_torch.models.convert import load_decoder, load_encoder

            trainer = sv
            self.device = str(sv.require_device(device))
            self.wrap = sv.deterministic
            self.init = sv.initial_weights(1000 * k)
            if side != "port":
                if jax_draws_dir:
                    theirs = load_draws(os.path.join(jax_draws_dir, f"k{k}.npz"))
                else:
                    from tests.privacy_draws import jax_draws

                    theirs = jax_draws(k)
                own = self.init
                self.init = {"port-from-jax": theirs,
                             "mix-port-enc": (own[0],) + tuple(theirs[1:]),
                             "mix-jax-enc": (theirs[0],) + tuple(own[1:])}[side]
        self.sv, self.trainer, self.load_image = sv, trainer, load_image
        self.load_encoder, self.load_decoder = load_encoder, load_decoder
        self.decoder_results = []

    @contextlib.contextmanager
    def recording(self):
        """The JAX keys moved (``jax``), and every ``train_decoder`` result kept."""
        train = self.trainer.train_decoder

        def recorded(*a, **kw):
            result = train(*a, **kw)
            self.decoder_results.append(result)
            return result

        self.trainer.train_decoder = recorded
        try:
            with self.jax_keys(self.k) if self.is_jax else contextlib.nullcontext():
                yield
        finally:
            self.trainer.train_decoder = train

    def dev(self):
        return {} if self.is_jax else {"device": self.device}

    def dataset(self, root, size, n_per_class, seed):
        self.sv._register(size)
        self.sv.make_shapes_dataset(root, size, n_per_class, seed=seed)

    def stylizer(self, root, size, ae_steps, dec_steps):
        """LSUV, the autoencoder and the decoder on the data at ``root``."""
        sv = self.sv
        probes = np.stack([
            self.load_image(os.path.join(root, f"SHAPES4/kfold/{d}/{c}/img000.png"), size)
            for d in sv.DOMAINS[:-1] for c in sv.CLASSES])
        if self.is_jax:
            enc = sv.make_experiment_encoder(probes)
            enc, dec_ae = sv.pretrain_encoder(root, size, ae_steps, enc)
            return enc, sv._train_stylizer(root, size, dec_steps, enc, init_decoder=dec_ae)
        enc0, dec0, head0 = self.init
        enc = sv.make_experiment_encoder(probes, device=self.device, init=enc0)
        enc, dec_ae = sv.pretrain_encoder(root, size, ae_steps, enc, device=self.device,
                                          dec=dec0, head=head0)
        return enc, sv._train_stylizer(root, size, dec_steps, enc, init_decoder=dec_ae,
                                       device=self.device)[0]

    def chain(self, root, size, seed, enc, dec, mode):
        self.sv.run_chain(root, size, "ref", seed, enc, dec, mode=mode, **self.dev())

    def fed(self, root, size, seed, mode, rounds):
        best = self.sv.run_fed(root, size, f"adain-{mode}-K3", seed, rounds, **self.dev())
        return best["test_acc"]

    def grid(self, work, seeds, sizes, quick):
        """The arms' accuracies {arm: {seed: test_acc}} from the package's own
        entry point."""
        out = os.path.join(work, "semantic.json")
        if self.is_jax:
            argv = ["semantic_validation.py", "--arms", "bf16,single", "--out", out,
                    "--workdir", work, "--seeds", ",".join(map(str, seeds))]
            saved, sys.argv = sys.argv, argv + (["--quick"] if quick else [])
            try:
                self.sv.main()
            finally:
                sys.argv = saved
            with open(out) as f:
                per_arm = json.load(f)["per_arm"]
        else:
            enc0, dec0, head0 = self.init
            per_arm = self.sv.run(work, out, seeds, [a for a, _ in ARMS], device=self.device,
                                  init=enc0, dec=dec0, head=head0, **sizes)["per_arm"]
        return {a: {r["seed"]: r["test_acc"] for r in per_arm[a]} for a, _ in ARMS}


def _ae_losses(log: str):
    lines = _AE_LINE.findall(log)
    if not lines:
        return None
    step, recon, inv, reg = lines[-1]
    return {"step": int(step), "recon": float(recon), "inv": float(inv), "tintreg": float(reg)}


def _decoder(result) -> dict:
    return {"loss_c": result["final_loss_c"], "loss_s": result["final_loss_s"]}


def run(args, work: str) -> dict:
    side = _Side(args.side, args.k, args.device, args.jax_draws)
    sizes = _sizes(args.quick)
    size, seeds = sizes["size"], args.seeds
    row = {"side": args.side, "k": args.k, "quick": args.quick,
           "device": "cpu" if side.is_jax else side.sv.device_label(side.device),
           "threads": args.threads}
    tee = _Tee()
    with contextlib.redirect_stdout(tee), side.recording():
        if args.stylizer:
            seed = seeds[0]
            enc = side.load_encoder(os.path.join(args.stylizer, STYLIZER_FILES[0]))
            dec = side.load_decoder(os.path.join(args.stylizer, STYLIZER_FILES[1]))
            row.update(depth="swap", stylizer=os.path.basename(os.path.normpath(args.stylizer)),
                       seed=seed)

            def swap():
                for arm, mode in ARMS:
                    root = os.path.join(work, f"{arm}_s{seed}")
                    side.dataset(root, size, sizes["n_per_class"], seed)
                    side.chain(root, size, seed, enc, dec, mode)
                    row[arm] = side.fed(root, size, seed, mode, sizes["rounds"])
                    row.setdefault("probe", {})[mode] = tree_probes(root, mode)

            side.wrap(swap)()
        elif args.depth == "stylizer":
            seed = seeds[0]
            row.update(depth="stylizer", seed=seed)

            def stylize():
                enc = dec = None
                for arm, mode in ARMS:
                    root = os.path.join(work, f"{arm}_s{seed}")
                    side.dataset(root, size, sizes["n_per_class"], seed)
                    if enc is None:
                        enc, dec = side.stylizer(root, size, sizes["ae_steps"],
                                                 sizes["dec_steps"])
                    side.chain(root, size, seed, enc, dec, mode)

            side.wrap(stylize)()
            row["probe"] = seed_probes(work, seed)
        else:
            row.update(depth="grid", seeds=seeds)
            acc = side.grid(work, seeds, sizes, args.quick)
            per_seed = []
            for seed, result in zip(seeds, side.decoder_results):
                per_seed.append({
                    "seed": seed, "bf16": acc["bf16"][seed], "single": acc["single"][seed],
                    "decoder": _decoder(result), "probe": seed_probes(work, seed)})
            gaps = [s["bf16"] - s["single"] for s in per_seed]
            row.update(per_seed=per_seed,
                       mean={a: float(np.mean([s[a] for s in per_seed])) for a, _ in ARMS},
                       gap_mean=float(np.mean(gaps)),
                       n_bf16_above_single=int(sum(g > 0 for g in gaps)))
    row["ae"] = _ae_losses(tee.kept.getvalue())
    if args.depth == "stylizer" and not args.stylizer:
        row["decoder"] = _decoder(side.decoder_results[0])
    if args.save_stylizer and not args.stylizer:
        grid = args.depth == "grid"
        for seed in seeds if grid else seeds[:1]:
            dst = os.path.join(args.save_stylizer, f"s{seed}") if grid else args.save_stylizer
            os.makedirs(dst, exist_ok=True)
            for name in STYLIZER_FILES:
                shutil.copy(os.path.join(work, f"bf16_s{seed}", name), os.path.join(dst, name))
    return row


_DRAW_TREES = ("enc", "dec", "head")


def save_draws(directory: str, ks) -> None:
    """The JAX script's draws of each key k as ``{directory}/k{k}.npz``."""
    from tests.privacy_draws import jax_draws

    os.makedirs(directory, exist_ok=True)
    for k in ks:
        enc, dec, head = jax_draws(k)
        flat = {f"{tree}/{layer}/{leaf}": v
                for tree, params in zip(_DRAW_TREES, (enc, dec, {"head": head}))
                for layer, p in params.items() for leaf, v in p.items()}
        np.savez(os.path.join(directory, f"k{k}.npz"), **flat)


def load_draws(path: str):
    """(encoder, autoencoder decoder, tint head) from :func:`save_draws`' file."""
    trees = {t: {} for t in _DRAW_TREES}
    with np.load(path) as z:
        for key in z.files:
            tree, layer, leaf = key.split("/")
            trees[tree].setdefault(layer, {})[leaf] = z[key]
    return trees["enc"], trees["dec"], trees["head"]["head"]


def _distance(a, b) -> float:
    """The largest relative L2 distance of one parameter tree from another,
    over the leaves (both as numpy arrays)."""
    import jax

    leaves = zip(jax.tree.leaves(a), jax.tree.leaves(b))
    return max(float(np.linalg.norm(np.asarray(x, np.float64) - np.asarray(y, np.float64))
                     / max(np.linalg.norm(np.asarray(y, np.float64)), 1e-30))
               for x, y in leaves)


def float64_trajectories(k: int, steps: int, work: str) -> dict:
    """The autoencoder and then the decoder trained for ``steps`` steps each
    from the JAX draws of key ``k`` (LSUV'd once, by the port) on the same
    ``--quick`` batches, each step's largest relative leaf distance between
    runs. The autoencoder: the port in float64 against the JAX script's own
    jitted step in float64 (``ccst_tpu.models.vgg.conv2d`` made to sum in the
    input's dtype for the call, as it pins float32; the port's Adam forming its
    bias correction in float64 for float64 moments, as optax does under x64:
    in float32 it forms it in float32, as optax does there), and both
    packages' float32 runs against the port's float64 one. The decoder, from the float64
    autoencoder's end: the JAX package's ``adain_losses`` casts to float32, so
    both packages' float32 runs (``train_decoder``'s step: ``optax.adam``,
    style weight 10) against the port's float64 run."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    import ccst_tpu.models.vgg as jvgg
    from ccst_tpu.models.adain_net import adain_losses as jax_adain_losses
    from ccst_tpu_torch.data.loader import load_image
    from ccst_tpu_torch.experiments import semantic_validation as tsv
    from ccst_tpu_torch.models import adain_net, vgg
    from ccst_tpu_torch.pipeline.train_decoder import DecoderTrainConfig, _pooled_loader
    from ccst_tpu_torch.utils import optim
    from ccst_tpu_torch.utils.optim import Adam
    from experiments import semantic_validation as jsv
    from tests.privacy_draws import jax_draws

    jax.config.update("jax_platforms", "cpu")
    sizes = _sizes(True)
    size, root = sizes["size"], os.path.join(work, "data")
    tsv._register(size)
    jsv._register(size)
    tsv.make_shapes_dataset(root, size, sizes["n_per_class"], seed=1)
    probes = np.stack([load_image(os.path.join(root, f"SHAPES4/kfold/{d}/{c}/img000.png"), size)
                       for d in tsv.DOMAINS[:-1] for c in tsv.CLASSES])
    enc0, dec0, head0 = jax_draws(k)
    enc0 = tsv.make_experiment_encoder(probes, device="cpu", init=enc0)
    cfg = DecoderTrainConfig(dataset="shapes4", list_root=root, data_root=root, image_size=size,
                             batch_size=8, steps=steps, domains=",".join(tsv.DOMAINS[:-1]))
    it, rng = iter(_pooled_loader(cfg, "")), np.random.default_rng(11)
    ae_batches = [(next(it).images, rng.uniform(0.25, 1.0, (8, 1, 1, 3)).astype(np.float32))
                  for _ in range(steps)]
    it = iter(_pooled_loader(cfg, ""))  # content and style: the same pooled order
    dec_batches = [next(it).images for _ in range(steps)]

    def tree(t):
        return {n: {w: np.asarray(v) for w, v in p.items()} for n, p in t.items()}

    start = {"enc": tree(enc0), "dec": tree(dec0), "head": {k: np.asarray(v)
                                                             for k, v in head0.items()}}

    # the JAX script's own step function, taken as it is jitted
    captured, jit = [], jax.jit
    jax.jit = lambda fn, *a, **kw: captured.append(fn) or jit(fn, *a, **kw)
    try:
        jsv.pretrain_encoder(root, size, 0, jax.tree.map(jnp.asarray, start["enc"]))
    finally:
        jax.jit = jit
    jax_ae_step = jit([f for f in captured
                       if f.__qualname__ == "pretrain_encoder.<locals>.step"][0])

    def port_ae(dtype):
        trainer = tsv.AutoencoderPretrainer.__new__(tsv.AutoencoderPretrainer)
        trainer.device = torch.device("cpu")
        trainer.enc = vgg.trainable_params(start["enc"], "cpu", dtype)
        trainer.dec = vgg.trainable_params(start["dec"], "cpu", dtype)
        trainer.head = {w: torch.nn.Parameter(torch.tensor(v, dtype=dtype))
                        for w, v in start["head"].items()}
        trainer.opt = Adam([p[w] for t in (trainer.enc, trainer.dec, {"head": trainer.head})
                            for p in t.values() for w in ("w", "b")], 3e-4)
        return trainer

    def port_tree(trainer):
        return {"enc": tree(vgg.params_from_trainable(trainer.enc)),
                "dec": tree(vgg.params_from_trainable(trainer.dec)),
                "head": {w: v.detach().numpy() for w, v in trainer.head.items()}}

    def jax_start(dtype):
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), start)
        return params, optax.adam(3e-4).init(params)

    rows = {"ae": [], "decoder": []}
    conv2d, correction = jvgg.conv2d, optim._Optimizer._correction

    def correction64(self, decay, like):
        """optax forms ``1 - decay**count`` in the default float: float64 under x64."""
        if like.dtype != torch.float64:
            return correction(self, decay, like)
        return 1 - torch.tensor(decay, dtype=torch.float64) ** self.count

    with jax.enable_x64(True):
        jvgg.conv2d = lambda x, w, b, **kw: conv2d(x, w, b, **dict(kw, accum_dtype=x.dtype))
        optim._Optimizer._correction = correction64
        try:
            (j64, o64), (j32, o32) = jax_start(jnp.float64), jax_start(jnp.float32)
            p64, p32 = port_ae(torch.float64), port_ae(torch.float32)
            for i, (x, tint) in enumerate(ae_batches):
                j64, o64, *l_j64 = jax_ae_step(j64, o64, jnp.asarray(x, jnp.float64),
                                               jnp.asarray(tint))
                j32, o32, *_ = jax_ae_step(j32, o32, jnp.asarray(x), jnp.asarray(tint))
                l_p64 = p64.step(torch.from_numpy(x.astype(np.float64)), torch.from_numpy(tint))
                p32.step(torch.from_numpy(x), torch.from_numpy(tint))
                ref = port_tree(p64)
                rows["ae"].append({
                    "step": i + 1, "port64_vs_jax64": _distance(ref, j64),
                    "port32_vs_port64": _distance(port_tree(p32), ref),
                    "jax32_vs_port64": _distance(j32, ref),
                    "losses_port64": [float(v) for v in l_p64],
                    "losses_jax64": [float(v) for v in l_j64]})
        finally:
            jvgg.conv2d, optim._Optimizer._correction = conv2d, correction

    # the decoder from the float64 autoencoder's end
    enc_t, dec_t = port_tree(p64)["enc"], port_tree(p64)["dec"]
    port_runs = {}
    for dtype in (torch.float64, torch.float32):
        d = vgg.trainable_params(dec_t, "cpu", dtype)
        port_runs[dtype] = (adain_net.frozen_encoder(enc_t, "cpu", dtype, kernel=False), d,
                            Adam(adain_net.decoder_leaves(d), 1e-4))
    jenc = jax.tree.map(jnp.asarray, enc_t)
    jdec = jax.tree.map(jnp.asarray, dec_t)
    tx = optax.adam(1e-4)
    jopt = tx.init(jdec)

    @jit
    def jax_dec_step(d, o, x):
        def total(dd):
            lc, ls = jax_adain_losses(jenc, dd, x, x)
            return lc + 10.0 * ls, (lc, ls)
        (_, aux), g = jax.value_and_grad(total, has_aux=True)(d)
        upd, o = tx.update(g, o, d)
        return optax.apply_updates(d, upd), o, aux

    for i, x in enumerate(dec_batches):
        jdec, jopt, (jlc, jls) = jax_dec_step(jdec, jopt, jnp.asarray(x))
        losses = {}
        for dtype, (frozen, d, opt) in port_runs.items():
            xt = torch.from_numpy(x).to(dtype)
            lc, ls = adain_net.adain_losses(frozen, d, xt, xt)
            opt.step(torch.autograd.grad(lc + 10.0 * ls, opt.params))
            losses[dtype] = [float(lc), float(ls)]
        ref = tree(vgg.params_from_trainable(port_runs[torch.float64][1]))
        rows["decoder"].append({
            "step": i + 1,
            "port32_vs_port64": _distance(
                tree(vgg.params_from_trainable(port_runs[torch.float32][1])), ref),
            "jax32_vs_port64": _distance(jdec, ref),
            "losses_port64": losses[torch.float64], "losses_jax32": [float(jlc), float(jls)]})
    return rows


def draw_stats(n: int) -> dict:
    """Whether the port's ``initial_weights(1000 k)`` and the JAX script's draws
    of key k (k < ``n``) come from one distribution: for every leaf of the
    encoder and autoencoder decoder its mean, std and largest magnitude, and
    the tint head's mean and std, a two-sided Mann-Whitney p over the draws;
    the smallest, beside 1 / (the number of statistics)."""
    from scipy.stats import mannwhitneyu

    from ccst_tpu_torch.experiments.semantic_validation import initial_weights
    from tests.privacy_draws import jax_draws

    def stats(draw):
        enc, dec, head = draw
        out = {}
        for name, tree in (("enc", enc), ("dec", dec), ("head", {"head": head})):
            for layer, p in tree.items():
                for leaf, v in p.items():
                    v = np.asarray(v, np.float64).ravel()
                    if not v.any():
                        continue  # the zero biases of the head
                    out.update({f"{name}.{layer}.{leaf}.mean": v.mean(),
                                f"{name}.{layer}.{leaf}.std": v.std(),
                                f"{name}.{layer}.{leaf}.absmax": np.abs(v).max()})
        return out

    port = [stats(initial_weights(1000 * k)) for k in range(n)]
    jax_side = [stats(jax_draws(k)) for k in range(n)]
    p = {key: float(mannwhitneyu([s[key] for s in port], [s[key] for s in jax_side],
                                 alternative="two-sided").pvalue) for key in port[0]}
    smallest = sorted(p.items(), key=lambda kv: kv[1])[:5]
    return {"draws": n, "statistics": len(p), "smallest_p": dict(smallest),
            "one_over_statistics": 1.0 / len(p)}


# the metrics of a stylizer, by path in a row (a grid's from its first seed)
STYLIZER_METRICS = ("ae.recon", "ae.inv", "ae.tintreg", "decoder.loss_c", "decoder.loss_s",
                    "probe.source.client_mean", "probe.overall.pooled",
                    "probe.overall.client_mean", "probe.single.pooled",
                    "probe.single.client_mean")
GRID_METRICS = ("mean.bf16", "mean.single", "gap_mean")
PRIVACY_METRICS = ("gap", "per_image", "overall")  # rows of tests/privacy_draws.py


def _get(row: dict, path: str):
    for key in path.split("."):
        row = row[key]
    return row


def _stylizer_view(row: dict) -> dict:
    """A grid row as the stylizer depth reports its first seed."""
    first = row["per_seed"][0]
    return dict(row, depth="stylizer", seed=first["seed"], decoder=first["decoder"],
                probe=first["probe"])


def _compare(groups: dict, metrics) -> dict:
    """Per side and metric: n, median, min, max, and a two-sided Mann-Whitney
    U test against each other side's draws."""
    from scipy.stats import mannwhitneyu

    out = {}
    for side, rows in sorted(groups.items()):
        entry = {"n": len(rows), "k": sorted(r["k"] for r in rows)}
        for m in metrics:
            v = np.asarray([_get(r, m) for r in rows], np.float64)
            entry[m] = {"median": float(np.median(v)), "min": float(v.min()),
                        "max": float(v.max())}
            for other, ref_rows in sorted(groups.items()):
                if other != side and len(ref_rows) >= 2 and len(v) >= 2:
                    res = mannwhitneyu(v, [_get(r, m) for r in ref_rows],
                                       alternative="two-sided")
                    entry[m].setdefault("mann_whitney", {})[other] = {
                        "U": float(res.statistic), "p": float(res.pvalue)}
        out[side] = entry
    return out


def _float64_summary(row: dict) -> dict:
    """The largest distance of each comparison over the steps, and where the
    float32 runs first part from float64 by more than 1e-2."""
    out = {"k": row["k"], "steps": row["steps"]}
    for part, steps in row["float64"].items():
        keys = [k for k in steps[0] if k.endswith(("_vs_jax64", "_vs_port64"))]
        out[part] = {k: {"max": max(s[k] for s in steps),
                         "first_step_above_1e-2": next((s["step"] for s in steps
                                                        if s[k] > 1e-2), None)}
                     for k in keys}
    return out


def summarize(files, out: str = "") -> dict:
    from scipy.stats import spearmanr

    rows, extra, records = [], {}, []
    for path in files:
        with open(path) as f:
            text = f.read()
        try:  # a file that --out wrote
            lines = [json.dumps(r) for r in json.loads(text)["records"]]
        except (ValueError, KeyError, TypeError):
            lines = text.splitlines()
        for line in lines:
            line = line.strip()
            if line.startswith("{"):
                row = json.loads(line)
                records.append(row)
                if "float64" in row:
                    extra.setdefault("float64", []).append(_float64_summary(row))
                elif "statistics" in row:
                    extra["draw_stats"] = row
                elif "side" in row:
                    row.setdefault("depth", "privacy")  # a privacy_draws.py row
                    row.setdefault("quick", True)
                    row.setdefault("device", "cpu")
                    rows.append(row)
    cells = {}
    for row in rows:
        size = "quick" if row["quick"] else "full"
        views = [(f"{row['depth']} {size} {row['device']}", row)]
        if row["depth"] == "grid":  # the grids also across devices, by package
            package = "jax" if row["side"] == "jax" else f"{row['side']} {row['device']}"
            views += [(f"grid {size} every device", dict(row, side=package)),
                      (f"stylizer {size} {row['device']}", _stylizer_view(row))]
        for cell, v in views:
            group = cells.setdefault(cell, {}).setdefault(v["side"], [])
            if v["depth"] == "swap" or all(r["k"] != v["k"] for r in group):
                group.append(v)  # a draw once a cell: a grid's first seed is its stylizer run
    summary = {}
    for cell, groups in sorted(cells.items()):
        depth = cell.split()[0]
        if depth == "stylizer":
            summary[cell] = _compare(groups, STYLIZER_METRICS)
        elif depth == "privacy":
            summary[cell] = _compare(groups, PRIVACY_METRICS)
            for side, rs in groups.items():
                summary[cell][side]["below_2_db"] = [sum(r["gap"] <= 2.0 for r in rs), len(rs)]
        elif depth == "grid":
            summary[cell] = _compare(groups, GRID_METRICS)
            for side, rs in groups.items():
                seeds = [s for r in rs for s in r["per_seed"]]
                pairs = [s["bf16"] > s["single"] for s in seeds]
                summary[cell][side]["pairs_bf16_above_single"] = [int(sum(pairs)), len(pairs)]
                if len(seeds) > 2:  # does the Overall tree's tint probe go with the gap?
                    rho = spearmanr([s["probe"]["overall"]["pooled"] for s in seeds],
                                    [s["bf16"] - s["single"] for s in seeds])
                    summary[cell][side]["spearman_overall_probe_vs_gap"] = {
                        "rho": float(rho.statistic), "p": float(rho.pvalue)}
                summary[cell][side]["draws"] = [
                    {"k": r["k"], "bf16": r["mean"]["bf16"], "single": r["mean"]["single"],
                     "gap_mean": r["gap_mean"], "n_bf16_above_single": r["n_bf16_above_single"],
                     "seeds": len(r["per_seed"])} for r in sorted(rs, key=lambda r: r["k"])]
        else:
            summary[cell] = {side: [{"k": r["k"], "stylizer": r["stylizer"], "bf16": r["bf16"],
                                     "single": r["single"]} for r in rs]
                             for side, rs in groups.items()}
    summary.update(extra)
    print(json.dumps(summary, indent=1))
    if out:
        with open(out, "w") as f:
            f.write('{"records": [\n' + ",\n".join(json.dumps(r) for r in records) + "\n]}\n")
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["float64"]:
        import torch

        torch.set_num_threads(2)
        k, steps = int(argv[1]), int(argv[2])
        with tempfile.TemporaryDirectory(prefix="semantic_float64_") as work:
            rows = float64_trajectories(k, steps, work)
        print(json.dumps({"float64": rows, "k": k, "steps": steps}), flush=True)
        return rows
    if argv[:1] == ["draw-stats"]:
        out = draw_stats(int(argv[1]))
        print(json.dumps(out), flush=True)
        return out
    if argv[:1] == ["save-draws"]:
        return save_draws(argv[1], [int(k) for k in argv[2:]])
    if argv[:1] == ["summarize"]:
        sp = argparse.ArgumentParser(prog="semantic_draws summarize")
        sp.add_argument("files", nargs="+")
        sp.add_argument("--out", default="")
        a = sp.parse_args(argv[1:])
        return summarize(a.files, a.out)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", choices=("jax", "port", "port-from-jax", "mix-port-enc",
                                     "mix-jax-enc"))
    ap.add_argument("k", type=int)
    ap.add_argument("--depth", choices=("stylizer", "grid"), default="stylizer")
    ap.add_argument("--quick", action="store_true", help="the --quick sizes of the scripts")
    ap.add_argument("--seeds", default="1,2,3,4,5",
                    help="data seeds of the grid; the stylizer depth and --stylizer take the "
                         "first")
    ap.add_argument("--device", default="cpu", help="the port's device: cpu (default) or cuda")
    ap.add_argument("--threads", type=int, default=2, help="torch's CPU threads")
    ap.add_argument("--stylizer", default="", help="a data root holding the stylizer files")
    ap.add_argument("--save-stylizer", default="",
                    help="copy the stylizer files to this directory (a grid's: each seed's "
                         "to DIR/sS)")
    ap.add_argument("--jax-draws", default="",
                    help="port-from-jax, mix-*: read the JAX draws from DIR/kK.npz "
                         "(save-draws)")
    args = ap.parse_args(argv)
    args.seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    if args.side == "jax" and args.device != "cpu":
        ap.error("the JAX side runs on the CPU only")
    if args.stylizer and args.side not in ("jax", "port"):
        ap.error("--stylizer runs the pipeline of jax or port")
    import torch

    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"semantic_draw_{args.side}{args.k}_") as work:
        row = run(args, work)
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
