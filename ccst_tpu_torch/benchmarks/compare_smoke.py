"""Put several ``chip_smoke.py`` logs side by side: each kernel's time at each
timed shape, and the engines' ms per batch, one column per log.

    python -m ccst_tpu_torch.benchmarks.compare_smoke parent.log change.log change2.log parent2.log

To compare two trees on one card, run their ``chip_smoke.py`` in turns inside
one call (parent, change, change, parent), keep each standard output, and
give the files here in that order. Reads the per-kernel lines and the ``device
rates:`` line; prints one JSON object per row, ``ms`` in the order of the logs
(``null`` where a log has no such row). Needs no card.
"""
from __future__ import annotations

import json
import re
import sys
from typing import Dict, List, Tuple


_KERNEL = re.compile(r"^((?:K[0-5]|B[1-3])\S*) (.*?): .*?\| kernel ([0-9.]+) ms")


def parse(text: str) -> Dict[Tuple[str, ...], float]:
    """One log -> {("kernel", id, what was timed): ms, ("engine", name,
    batch): ms}, from the per-kernel lines (``K0 qconv conv2_1 (4, 256, 256,
    64, 128) reflect requant relu=True: bit-exact | kernel 0.0866 ms ...``)
    and the ``device rates:`` line."""
    rows: Dict[Tuple[str, ...], float] = {}
    for line in text.splitlines():
        if m := _KERNEL.match(line):
            rows[("kernel", m.group(1), m.group(2))] = float(m.group(3))
        elif line.startswith("device rates: "):
            rates = json.loads(line[len("device rates: "):])
            for name, r in rates.items():
                if name != "batch":
                    rows[("engine", name, f"batch {rates['batch']}")] = r["ms"]
    return rows


def table(logs: List[str]) -> List[dict]:
    parsed = [parse(text) for text in logs]
    keys = list(dict.fromkeys(key for p in parsed for key in p))
    return [dict(row=list(key), ms=[p.get(key) for p in parsed]) for key in keys]


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    logs = []
    for path in paths:
        with open(path) as f:
            logs.append(f.read())
    for row in table(logs):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
