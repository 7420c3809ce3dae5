"""The benchmark of ``ccst_tpu_torch`` on one NVIDIA H100.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the harness runs is found by name, from data files under this
folder:

- ``workloads/<cell>.json``: the cell's configuration, traffic, ``why``,
  chips, the metrics it reports and the limits of its output check;
- ``configs/<config>.json``: the model's sizes, its source, what was reduced
  or assumed, its precision and its plain reference (``reference/``);
- ``traffic/<traffic>.json``: the parameters that one driver under
  ``drivers/`` (named by the file's ``driver`` key) turns into work;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``,
  which returns a number or ``None`` when the traced run holds nothing to read.

The yardstick lives here too: ``flops/`` counts every model FLOP and each
kernel's operations and bytes from shapes, against the H100 peaks it keeps;
``reference/`` holds the plain PyTorch references the output check compares
with; ``trace.py`` reduces a ``torch.profiler`` trace. Nothing here imports
``jax`` or the JAX package; ``reference/`` imports nothing of the port.
"""
