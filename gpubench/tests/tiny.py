"""Test-only sizes at which every cell runs on the CPU, through the plain
versions of the port's kernels, in seconds; and a runner for them."""
import time
from unittest import mock

import torch

from ccst_tpu_torch import native
from gpubench import harness

STYLIZE = dict(image_size=64, batch=2, pool_batches=2, style_bank_images=4, style_pool=2,
               warm_batches=1, trace_batches=2, keep=1, keep_within=2)
# a smaller learning rate keeps three steps of a 36 px ResNet-50 out of the chaos
# that BatchNorm over 4 rows of 2 x 2 planes makes of float32 rounding
FEDAVG = dict(image_size=36, jpeg_side=40, batch=4, lr=1e-4, ref_block=4,
              clients={"art_painting": 16, "cartoon": 14, "sketch": 18}, test_images=10)


def scale_of(cell: str):
    return FEDAVG if cell.startswith("fedavg") else STYLIZE


def run_cell(cell: str, seed: int = 2**31 + 11, trace: bool = False, limits=None,
             seconds: float = 0.3):
    """One run of ``cell`` on the CPU at its test size; ``limits`` replace the
    cell's own (which are the chip's, at the full size)."""
    torch.set_num_threads(2)
    r = harness.load_run(cell, seed, seconds, trace, torch.device("cpu"),
                         time.perf_counter(), scale_of(cell))
    if limits is not None:
        r.workload = {**r.workload, "limits": limits}
    # the card's machine decodes with PIL (it cannot build the native library);
    # here too, so that the loader and the reference read the same bytes
    with mock.patch.object(native, "available", lambda: False):
        harness.execute(r)
    return r
