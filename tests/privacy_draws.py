"""The ``--quick`` privacy finding over initial draws, on the CPU: how far the
leakage gap at those sizes depends on where the weights start, on each side.

    JAX_PLATFORMS=cpu python -m tests.privacy_draws {jax,port,port-from-jax} K

- ``jax``: the JAX project's ``experiments/privacy_leakage.py`` with its
  ``PRNGKey`` 0, 7 and 13 (encoder, autoencoder decoder, tint head) moved to
  1000 K + 0, 7 and 13 (K = 0: the script as it is);
- ``port``: the port's ``privacy_leakage.run`` from
  ``semantic_validation.initial_weights(1000 K)`` (K = 0: its default);
- ``port-from-jax``: the port from the JAX script's draws of ``jax`` K.

The data, the split and the inverter's seed are the same in all. Prints one
JSON line: the side, K, the gap, the three PSNRs and the wall seconds. One
draw takes minutes (the port's about 11 min on one CPU thread, the JAX
script's about 5); run several as separate processes.
"""
from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time


def jax_draws(k: int):
    """The JAX script's encoder, autoencoder decoder and tint head at keys
    1000 k + 0, 7 and 13, as numpy trees."""
    import jax
    import numpy as np

    from ccst_tpu.models import vgg as jvgg

    def tree(t):
        return jax.tree.map(np.asarray, t)

    return (tree(jvgg.init_params(jax.random.PRNGKey(1000 * k), jvgg.ENCODER_ARCH)),
            tree(jvgg.init_params(jax.random.PRNGKey(1000 * k + 7), jvgg.DECODER_ARCH)),
            {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(1000 * k + 13), (1024, 3))
                             * 0.01),
             "b": np.zeros((3,), np.float32)})


@contextlib.contextmanager
def jax_keys(k: int):
    """``jax.random.PRNGKey`` with the JAX scripts' seeds 0, 7 and 13 moved to
    1000 k + 0, 7 and 13 (every other seed as it is)."""
    import jax

    key = jax.random.PRNGKey
    jax.random.PRNGKey = lambda s, *a, **kw: key(s + 1000 * k if s in (0, 7, 13) else s,
                                                 *a, **kw)
    try:
        yield
    finally:
        jax.random.PRNGKey = key


def run_draw(side: str, k: int, work: str) -> dict:
    import ccst_tpu_torch.experiments.privacy_leakage as tpl

    out, grids = f"{work}/out.json", f"{work}/grids"
    if side == "jax":
        from experiments.privacy_leakage import run

        with jax_keys(k):
            summary = run(work, out, grids, **tpl.QUICK)
    else:
        import torch

        from ccst_tpu_torch.experiments.semantic_validation import initial_weights

        torch.set_num_threads(1)
        enc, dec, head = jax_draws(k) if side == "port-from-jax" else initial_weights(1000 * k)
        summary = tpl.run(work, out, grids, **tpl.QUICK, device="cpu", init=enc, dec=dec,
                          head=head)
    r = summary["per_source"]["rot0"]
    return {"side": side, "k": k, "gap": r["leakage_gap_db"],
            "per_image": r["per_image"]["psnr_mean"], "overall": r["overall"]["psnr_mean"],
            "mean_image": r["mean_image_baseline"]["psnr_mean"]}


def main(argv=None) -> dict:
    side, k = (argv or sys.argv[1:])[:2]
    if side not in ("jax", "port", "port-from-jax"):
        raise SystemExit(f"side must be jax, port or port-from-jax, not {side!r}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"privacy_draw_{side}{k}_") as work:
        row = run_draw(side, int(k), work)
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
