"""What ``ptxas`` says of every CUDA kernel of the package: registers a thread,
static shared memory, spills, and how often it had to fence a ``wgmma`` itself.

    python -m ccst_tpu_torch.benchmarks.ptxas_report

Compiles each ``csrc/*.cu`` with ``nvcc -Xptxas -v`` (the flags of
``kernels/_build.py``, objects thrown away) and prints one JSON object per
source: ``{"source": ..., "kernels": [{"kernel", "registers", "smem_bytes",
"spill_store_bytes", "spill_load_bytes"}], "injected_fences": n}``. Dynamic
shared memory is chosen at launch and is not in ptxas's count. Needs ``nvcc``,
no card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def short_name(mangled: str) -> str:
    """``...24qconv3x3_s8_wgmma_kernelILi128ELi1ELi2EEEv...`` ->
    ``qconv3x3_s8_wgmma_kernel<128,1,2>``: the length-prefixed name that ends
    in ``_kernel`` and its integer template arguments; other names as they are."""
    for m in re.finditer(r"\d+", mangled):
        for skip in range(len(m.group())):  # the length is a suffix of the digit run
            size = int(m.group()[skip:])
            name = mangled[m.end():m.end() + size]
            if len(name) == size and name.endswith("_kernel") and name.isidentifier():
                targs = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[m.end() + size:])
                args = re.findall(r"L[a-z](\d+)E", targs.group(1)) if targs else []
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def parse(stderr: str) -> dict:
    """ptxas's verbose output -> the report of one source."""
    kernels, current = [], None
    for line in stderr.splitlines():
        if m := _ENTRY.search(line):
            current = dict(kernel=short_name(m.group(1)), registers=None, smem_bytes=0,
                           spill_store_bytes=0, spill_load_bytes=0)
            kernels.append(current)
        elif current is not None and (m := _SPILL.search(line)):
            current["spill_store_bytes"], current["spill_load_bytes"] = map(int, m.groups())
        elif current is not None and (m := _USED.search(line)):
            current["registers"] = int(m.group(1))
            current["smem_bytes"] = int(m.group(2) or 0)
    return dict(kernels=kernels, injected_fences=stderr.count("(C7519)"))


def main(argv=None) -> int:
    from ccst_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        for src in _build._sources():
            proc = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", f"{tmp}/o.o"],
                capture_output=True, text=True)
            if proc.returncode:
                print(proc.stderr, file=sys.stderr)
                return proc.returncode
            print(json.dumps(dict(source=f"ccst_tpu_torch/csrc/{src.name}", **parse(proc.stderr))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
