"""Timing helpers for kernels that take a few microseconds, and the sweep
behind the channel-moments kernel's (K5's) chunk size.

    python -m ccst_tpu_torch.benchmarks.small_kernels [--reps 200] [--runs 7]

K4 (fused AdaIN) and K5 take less time on the card than the host needs to make
one call of their wrappers, so a loop of calls between two CUDA events times
the host (``runs_ms``). The card's own time is taken from ``--reps`` calls
captured into one CUDA graph and replayed (``graph_ms``): the kernels run back
to back with no host in the way, as they do inside an engine whose queue is
full. ``chip_smoke.py`` times K4 and K5 with these helpers at every shape of
theirs.

Run as a program, it times ``channel_moments`` on the card with the rows of a
block (``kernels.moments.CHUNK``) set to each of ``--chunks`` in turn, at the
bank's shapes: the measurement that the one chunk size in use rests on. Each
time is the minimum, median and maximum over ``--runs`` replays. Prints the
card's name and power limit, then one JSON object. Needs one CUDA card; seeded
random inputs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# relu4_1 of the bank step: 512 px at batch 3, 4 and 32, ragged channels, 256 px
SHAPES = (((3, 64, 64, 512), "bfloat16"), ((3, 64, 64, 500), "bfloat16"),
          ((3, 64, 64, 512), "float32"), ((4, 64, 64, 512), "bfloat16"),
          ((4, 64, 64, 512), "float32"), ((32, 64, 64, 512), "bfloat16"),
          ((4, 32, 32, 512), "bfloat16"))


def runs_ms(torch, fn, reps: int, runs: int, per: int = 1) -> dict:
    """Mean time of ``reps`` back-to-back calls in a run (CUDA events), divided
    by ``per``: min, median and max over ``runs`` runs, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (reps * per))
    times.sort()
    return dict(min=times[0], median=times[len(times) // 2], max=times[-1])


def graph_ms(torch, fn, reps: int, runs: int) -> dict:
    """Device time of one call of ``fn``: ``reps`` calls captured into one CUDA
    graph (after one call outside it, so that whatever ``fn`` sets up once is
    not captured), the graph replayed between two CUDA events; min, median and
    max over ``runs`` replays, in ms."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return runs_ms(torch, graph.replay, 1, runs, per=reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200, help="launches a graph")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--chunks", type=int, nargs="+", default=[128, 256, 512, 1024])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("small_kernels: no CUDA device", file=sys.stderr)
        return 2
    from ccst_tpu_torch.kernels import moments

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = dict(device=torch.cuda.get_device_name(0), reps=args.reps, runs=args.runs,
               chunk_in_use=moments.CHUNK)
    in_use = moments.CHUNK
    for shape, dtype_name in SHAPES:
        feat = (torch.randn(shape, generator=gen) * 3 + 10).to(dev, getattr(torch, dtype_name))
        want = moments.channel_moments_reference(feat)
        row = {}
        for chunk in args.chunks:
            moments.CHUNK = chunk
            for got, ref in zip(moments.channel_moments(feat), want):
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=0.0)
            row[str(chunk)] = graph_ms(torch, lambda: moments.channel_moments(feat),
                                       args.reps, args.runs)
        out["k5_" + "x".join(map(str, shape)) + "_" + dtype_name + "_ms_by_chunk"] = row
        del feat
    moments.CHUNK = in_use
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
