"""One rank of a multi-process run of the port, for tests/test_torch_multihost.py.

    python tests/torch_multihost_worker.py CASE INIT_URL WORLD RANK OUT_DIR ARGS_JSON

Joins the process group (gloo, ``INIT_URL`` a ``file://`` store) through
``ccst_tpu_torch.parallel.multihost.initialize``, runs CASE and writes what
the parent compares to ``OUT_DIR/rank{RANK}.pt``. Imports the port only
(tests/test_torch_standalone.py walks this file too).

Cases:
  fed      ``MultihostFedRunner(FedConfig(**args)).run()``; with
           ``args["start"]`` (a state-dict file) every client starts there and
           the random train transform is the eval transform; with
           ``args["mix_draws"]`` (gate, lambda, permutation a MixStyle stage)
           MixStyle takes those draws, stage after stage;
  welford  ``welford_psum`` of this rank's seeded NHWC chunk;
  decoder  ``train_decoder(..., mesh=WORLD)``, then one ``DecoderTrainer``
           step and one ``adain_train_step(..., group=WORLD)`` on this
           rank's rows of a seeded batch;
  inverter ``train_inverter(..., mesh=WORLD)`` (from ``args["init"]``'s
           parameters when given), then one ``InverterTrainer`` step on this
           rank's rows of a seeded batch;
  spatial  (4 ranks) ``parallel/spatial.py``: the float32 ``ref`` stylize
           over the world, the int8-static one over ranks 0 and 1, the batch
           int8-static one over the world, each output gathered; on ranks 0
           and 1 ``whole_plane_stats`` of each rank's half of a feature plane;
  tensor   (4 ranks) ``parallel/tensor.py``: ``args["network"]`` over a
           (data 2, model 2) mesh, eval mode: the loss, the logits and the
           gradients of one batch, gathered whole.
"""
import json
import os
import sys

import numpy as np
import torch


def seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, np.float32))


def run_fed(args, out):
    import ccst_tpu_torch.federated.train_ops as tops
    from ccst_tpu_torch.config import FedConfig
    from ccst_tpu_torch.federated.multihost_runtime import MultihostFedRunner
    from ccst_tpu_torch.ops.image import eval_transform

    start = args.pop("start", "")
    mix = args.pop("mix_draws", None)
    if mix:
        from ccst_tpu_torch.models.layers import MixStyle

        calls = []

        def draw(self, generator, b):
            gate, lmda, perm = mix[len(calls) % len(mix)]
            calls.append(b)
            return gate, np.asarray(lmda, np.float32), torch.as_tensor(perm)

        MixStyle.draw = draw
    if start:
        tops.train_transform = lambda draws, images, size, *a, **k: eval_transform(images, size)
    runner = MultihostFedRunner(FedConfig(**args), device="cpu")
    if start:
        state = torch.load(start)
        runner.server = dict(state)
        runner.client_states = [dict(state) for _ in range(runner.n_clients)]
    best = runner.run()
    return {"best": best, "server": runner.server,
            "clients": runner.client_states, "my_clients": runner.my_clients}


def run_welford(args, out, rank):
    from ccst_tpu_torch.ops.welford import welford_init, welford_psum, welford_update

    feat = torch.from_numpy(np.load(args["chunks"])[rank])
    state = welford_update(welford_init(feat.shape[-1]), feat)
    return {"psum": tuple(welford_psum(state))}


def run_decoder(args, out, rank):
    import torch.distributed as dist

    from ccst_tpu_torch.models import vgg
    from ccst_tpu_torch.models.convert import load_decoder, load_encoder
    from ccst_tpu_torch.parallel import multihost
    from ccst_tpu_torch.pipeline.train_decoder import (DecoderTrainConfig, DecoderTrainer,
                                                       train_decoder)

    cfg = DecoderTrainConfig(**args)
    report = train_decoder(cfg, mesh=dist.group.WORLD, device="cpu")
    trainer = DecoderTrainer(cfg, load_encoder(cfg.vgg_weights),
                             load_decoder(cfg.init_decoder), "cpu", group=dist.group.WORLD)
    rows = multihost.group_rows(cfg.batch_size)
    size = cfg.image_size
    content, style = seeded((cfg.batch_size, size, size, 3), 7), seeded(
        (cfg.batch_size, size, size, 3), 8)
    lc, ls = trainer.step(content[rows], style[rows])
    # the SGD step of models/adain_net.py, averaged over the group
    from ccst_tpu_torch.models.adain_net import adain_train_step, frozen_encoder

    sgd = vgg.trainable_params(load_decoder(cfg.init_decoder), "cpu")
    sgd_loss = adain_train_step(frozen_encoder(load_encoder(cfg.vgg_weights), "cpu"), sgd,
                                content[rows], style[rows], group=dist.group.WORLD)
    return {"report": report, "losses": (float(lc), float(ls)),
            "params": vgg.params_from_trainable(trainer.decoder),
            "sgd_loss": float(sgd_loss), "sgd_params": vgg.params_from_trainable(sgd)}


def run_inverter(args, out, rank):
    import torch.distributed as dist

    from ccst_tpu_torch.parallel import multihost
    from ccst_tpu_torch.privacy import invert
    from ccst_tpu_torch.privacy.generator import StyleInverter

    init = args.pop("init", "")
    if init:  # start from the given parameters (the parent's JAX initialisation)
        class Loaded(StyleInverter):
            def __init__(self, image_size, generator=None):
                super().__init__(image_size=image_size)
                self.load_state_dict(torch.load(init))

        invert.StyleInverter = Loaded
    cfg = invert.InvertConfig(**args)
    report = invert.train_inverter(cfg, mesh=dist.group.WORLD, device="cpu")
    model = invert.StyleInverter(image_size=cfg.image_size,
                                 generator=torch.Generator().manual_seed(cfg.seed))
    enc = invert._encoder_params(cfg)
    trainer = invert.InverterTrainer(cfg, enc, "cpu", model=model, group=dist.group.WORLD)
    rows = multihost.group_rows(cfg.batch_size)
    images = seeded((cfg.batch_size, cfg.image_size, cfg.image_size, 3), 9)
    enc16 = invert.vgg.prepare_params(enc, torch.bfloat16, "cpu")
    with torch.no_grad():
        z = invert.style_vector(enc16, images[rows])
    loss = trainer.step(images[rows], z)
    return {"report": report, "loss": float(loss),
            "params": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def run_spatial(args, out, rank):
    import torch.distributed as dist

    from ccst_tpu_torch.models import vgg_fast
    from ccst_tpu_torch.models.convert import load_decoder, load_encoder
    from ccst_tpu_torch.parallel import spatial

    inp = {k: torch.from_numpy(v) for k, v in np.load(args["inputs"]).items()}
    enc, dec = load_encoder(args["enc"]), load_decoder(args["dec"])
    world = spatial.make_spatial_mesh(4)
    run = spatial.make_spatial_stylize(world, torch.float32, "cpu")
    result = {"f32": spatial.gather_rows(
        run(enc, dec, inp["images"], inp["s_mean"], inp["s_std"], 1.0), world)}
    eq = vgg_fast.prepare_encoder_q8s(vgg_fast.cast_params(enc, torch.float32), args["scales"],
                                      torch.bfloat16, "cpu")
    dq = vgg_fast.prepare_decoder_q8s(vgg_fast.cast_params(dec, torch.float32), args["scales"],
                                      torch.bfloat16, "cpu")
    pair = dist.new_group([0, 1])  # every rank of the world creates it
    if rank < 2:
        pair = spatial.make_spatial_mesh(2, pair)
        q8 = spatial.make_spatial_stylize_q8s(pair, eq, dq)
        result["q8"] = spatial.gather_rows(q8(inp["images8"], inp["s8_mean"], inp["s8_std"]),
                                           pair)
        half = inp["plane"].shape[1] // 2
        result["stats"] = spatial.whole_plane_stats(
            inp["plane"][:, rank * half:(rank + 1) * half].contiguous(), pair)
    batch = spatial.make_batch_stylize_q8s(world, eq, dq)
    result["batch"] = spatial.gather_rows(batch(inp["batch"], inp["s8_mean"], inp["s8_std"]),
                                          world, dim=0)
    return result


def run_tensor(args, out, rank):
    from ccst_tpu_torch.federated.train_ops import cross_entropy
    from ccst_tpu_torch.models.classifiers import get_network
    from ccst_tpu_torch.parallel import multihost, tensor

    inp = torch.load(args["inputs"])
    model = get_network(args["network"], args["classes"])
    model.load_state_dict(inp["state"])
    model.eval()
    mesh = tensor.make_dp_tp_mesh(2, 2)
    tp = tensor.with_tensor_parallel(model, mesh, args["min_dim"])
    batch = tensor.shard_batch({"x": inp["x"], "labels": inp["labels"]}, mesh)
    logits = tp(batch["x"].permute(0, 3, 1, 2))
    loss = cross_entropy(logits, batch["labels"]).mean()
    names, params = zip(*tp.named_parameters())
    grads = tensor.data_mean(torch.autograd.grad(loss, params), mesh)
    full = dict(model.state_dict())
    return {"loss": float(tensor.data_mean([loss.detach()], mesh)[0]),
            "logits": torch.cat(multihost.all_gather(logits.detach(), mesh.data_group)),
            "grads": tensor.unshard_params(dict(zip(names, grads)), full, mesh, args["min_dim"]),
            "split": sorted(k for k, v in tp.state_dict().items() if v.shape != full[k].shape)}


def main() -> None:
    case, init, world, rank, out = sys.argv[1:6]
    args = json.loads(sys.argv[6]) if len(sys.argv) > 6 else {}
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    from ccst_tpu_torch.parallel import multihost

    multihost.initialize(init, world, rank, device="cpu")
    if case == "fed":
        result = run_fed(args, out)
    elif case == "welford":
        result = run_welford(args, out, rank)
    elif case == "decoder":
        result = run_decoder(args, out, rank)
    elif case == "inverter":
        result = run_inverter(args, out, rank)
    elif case == "spatial":
        result = run_spatial(args, out, rank)
    elif case == "tensor":
        result = run_tensor(args, out, rank)
    else:
        raise SystemExit(f"unknown case {case!r}")
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
