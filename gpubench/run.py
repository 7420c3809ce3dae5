"""Run one cell of the benchmark on this machine's first CUDA device.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output, and every number
the output check compared, beside its limit, as the last lines of standard
error. Exits 2 without a result where there is no CUDA device or fewer than
the cell asks for, and 3 where a module of JAX or of the JAX package was
loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

_T0 = time.perf_counter()


def main(argv=None) -> int:
    from gpubench import harness

    t_start = _T0 - harness.process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    workload = harness.load("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"gpubench: the cell needs {workload['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    r = harness.load_run(args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t_start)
    harness.execute(r)
    line = harness.result_line(r)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"gpubench: modules that must not load were loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    print(f"written by this process: {json.dumps(harness.bytes_written())}", file=sys.stderr)
    print(f"counters: {json.dumps(r.counters)}", file=sys.stderr)
    for name, value in r.readings.items():
        print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for c in r.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
