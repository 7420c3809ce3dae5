"""The readings that the output check's limits are set from, at a cell's own
size, on the device given: the control (the reference put in the program's
place and computed in the next precision below the configuration's), and for
the training cell the faults planted in the reference put in its place.

    python3 -m gpubench.control --workload <cell> --seeds 1,2,3 [--device cuda]

Prints one JSON line a seed: each reading by the names the check uses. The
benchmark's own runs never run this; it reads no program output, only the
reference, so it needs no measured window.

- Stylize cells: the control's outputs, banks, scales or style statistics
  against the reference's, for as many calls as a run compares (3).
- Training: the control is the reference in float32 with TF32 on; the faults
  are ``half_batch`` (half of each batch left out, the mean over the rest)
  and ``exchange_left_out`` (the server takes client 0's state instead of the
  clients' mean). A state left unchanged reads 1 on ``grad_gap`` and
  ``update_gap_median`` by their definition and needs no run.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import tempfile
import time

import numpy as np
import torch

from gpubench import harness

CALLS = 3  # calls a run compares: its drawn ones and its last


def stylize_readings(r: harness.Run) -> dict:
    from gpubench.drivers import stylize as drv

    inputs = drv.Inputs(r)
    rng = random.Random(r.seed)
    jobs = {i: (drv.job_of_call(inputs, rng, i), None, None) for i in range(CALLS)}
    reference, derived = drv.reference_outputs(r, inputs, jobs)
    control, derived_c = drv.reference_outputs(r, inputs, jobs, control=True)
    kept = {i: (jobs[i][0], control[i][0].cpu().numpy(), control[i][1]) for i in jobs}
    return drv.gaps(r, kept, derived_c.get("banks"), derived_c.get("scales"), reference, derived)


def train_readings(r: harness.Run) -> dict:
    from gpubench.drivers import fedavg as drv
    from gpubench.reference import matmul_precision
    from gpubench.reference import resnet as ref

    with tempfile.TemporaryDirectory(prefix="gpubench_control_") as root:
        gen = torch.Generator(device=r.device).manual_seed(r.seed)
        labels = drv.write_tree(r, root, gen)
        state0 = ref.make_state(gen, r.param("classes"))
        batch = r.param("batch")
        clients = []
        for domain in r.param("clients"):
            paths = sorted(p for p in labels if f"/{domain}/" in p)
            order = np.random.default_rng(r.seed).permutation(len(paths))
            clients.append([([paths[j] for j in order[i * batch:(i + 1) * batch]], None, batch)
                            for i in range(r.param("check_steps"))])
        reference = drv.follow_steps(r, state0, clients[0], labels)
        out = {}
        for name, kw in (("control", dict(dtype=torch.float32, tf32=True)),
                         ("half_batch", dict(dtype=torch.float32, half_batch=True))):
            losses, _, states = drv.follow_steps(r, state0, clients[0], labels, **kw)
            for k, v in drv.step_gaps(r, state0, losses, states, reference).items():
                out[f"{name}.{k}"] = v
        # the clients' states after a round's first steps, each on its own batches
        finals = [drv.follow_steps(r, state0, c, labels, dtype=torch.float32)[2][-1]
                  for c in clients]
        avg = ref.fedavg(finals)
        out["exchange_left_out.aggregate_gap"] = drv.aggregate_gap(
            {k: finals[0][k] for k in avg}, avg)
        test = sorted(p for p in labels if f"/{r.param('target')}/" in p)
        images = drv.decode(test, r.param("image_size"))
        y = torch.tensor([labels[p] for p in test])
        f64 = ref.evaluate(avg, images, y, r.param("ref_block"), torch.float64)
        with matmul_precision(True):
            tf32 = ref.evaluate({k: v.float() for k, v in avg.items()}, images, y,
                                r.param("ref_block"), torch.float32)
        out["control.eval_loss_gap"] = abs(tf32[0] - f64[0]) / abs(f64[0])
        out["control.eval_acc_gap"] = abs(tf32[1] - f64[1])
        out["state_unchanged.grad_gap"] = out["state_unchanged.update_gap_median"] = 1.0
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.load_run(args.workload, seed, 0.0, False, dev, t0)
        readings = (train_readings(r) if r.traffic["driver"] == "fedavg"
                    else stylize_readings(r))
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
