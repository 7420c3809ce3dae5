"""Does one local step of ResNet-50 give the same bits twice?

    python -m ccst_tpu_torch.benchmarks.fed_bits [--deterministic] [--repeats 2] \
        [--network resnet50] [--batch 32] [--size 222] [--device cuda|cpu]

Runs the runner's fedavg step (float32, TF32 off) ``--repeats`` times from the
same state, batch and generator seed (the inputs of ``fed_profile``: seeded
``init_weights``, a seeded uint8 batch) and prints one JSON line with a SHA-256
of each step's updated state, bit for bit. Run it in two processes and compare
the digests across them; ``--deterministic`` asks cuDNN for deterministic
algorithms (``utils/precision.py::no_tf32(deterministic=True)``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys


def make_case(dev, network: str = "resnet50", batch: int = 32, size: int = 222,
              classes: int = 7):
    """``run() -> state`` of one step from fixed inputs on ``dev``."""
    import numpy as np
    import torch

    from ccst_tpu_torch.federated.train_ops import make_train_step
    from ccst_tpu_torch.models.classifiers import get_network, init_weights

    model = init_weights(get_network(network, classes), torch.Generator().manual_seed(0)).to(dev)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), np.uint8))
    data = {"images": u8.to(dev).float() / torch.full((), 255.0, device=dev),
            "labels": torch.from_numpy(rng.integers(0, classes, batch)).to(dev),
            "mask": torch.ones(batch, device=dev)}
    step = make_train_step(model, n_classes=classes, image_size=size, lr=1e-2)

    def run():
        new, _ = step(state, state, data, torch.Generator().manual_seed(0), 0)
        return new

    return run


def digest(state) -> str:
    """SHA-256 over every tensor of a state, in key order, bit for bit."""
    import torch

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def step_digests(dev, repeats: int = 2, deterministic: bool = False, **case) -> list:
    from ccst_tpu_torch.utils.precision import no_tf32

    with no_tf32(deterministic=deterministic):
        run = make_case(dev, **case)
        return [digest(run()) for _ in range(repeats)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--network", default="resnet50")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=222)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("fed_bits: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    digests = step_digests(dev, args.repeats, args.deterministic, network=args.network,
                           batch=args.batch, size=args.size)
    print(json.dumps({"network": args.network, "batch": args.batch, "size": args.size,
                      "deterministic": args.deterministic, "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
