"""Training-curve plots from the JSONL metrics stream.

Counterpart of the reference's post-hoc analysis notebook
(`utils/plotter.ipynb`), which loads the xlsx round log into pandas and
plots accuracy-vs-round curves per mode/hyperparameter. Here the source of
truth is the MetricsLogger JSONL (utils/metrics.py); multiple runs overlay
on shared axes with the reference notebook's visual conventions
(linestyle/color cycles, per-metric subplots). Headless-safe (Agg backend).

CLI: ``ccst-tpu-torch plot run1.jsonl run2.jsonl -o curves.png``.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

from ccst_tpu_torch.utils.metrics import read_rounds

# the notebook's cycles (plotter.ipynb cell 2)
_LINESTYLES = ["-", ":", "--", "-."]
_COLORS = [
    "black", "royalblue", "green", "darkorange", "lightcoral", "darkviolet"
]

# metric key -> axis title, mirroring the notebook's fig_titles
_DEFAULT_METRICS = {
    "val_acc_mean": "Classification Accuracy (Source Domains, val)",
    "test_acc": "Classification Accuracy (Unknown Domain)",
    "train_loss": "Training Loss",
}


def _series(rounds: List[Dict], key: str):
    xs, ys = [], []
    for r in rounds:
        if r.get("event") == "round" and key in r and r[key] is not None:
            xs.append(r.get("round", len(xs)))
            ys.append(float(r[key]))
    return xs, ys


def plot_runs(
    paths: Sequence[str],
    out_path: str,
    metrics: Optional[Iterable[str]] = None,
    labels: Optional[Sequence[str]] = None,
    title: Optional[str] = None,
) -> str:
    """Overlay per-round curves of ``metrics`` for each JSONL run in
    ``paths``; writes a PNG and returns its path. Metrics missing from every
    run are skipped (e.g. jigsaw accuracy on a no-DG run)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = list(metrics) if metrics else list(_DEFAULT_METRICS)
    defaults = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    labels = list(labels) if labels else []
    labels += defaults[len(labels):]  # pad short label lists per-run
    per_run = [read_rounds(p) for p in paths]

    panels = []
    for m in metrics:
        if any(_series(r, m)[0] for r in per_run):
            panels.append(m)
    if not panels:
        raise ValueError(
            f"none of {metrics} present in any of {len(paths)} runs"
        )

    fig, axes = plt.subplots(
        1, len(panels), figsize=(6 * len(panels), 5), squeeze=False
    )
    for ax, m in zip(axes[0], panels):
        for i, rounds in enumerate(per_run):
            xs, ys = _series(rounds, m)
            if not xs:
                continue
            ax.plot(
                xs, ys,
                label=labels[i],
                color=_COLORS[i % len(_COLORS)],
                linestyle=_LINESTYLES[(i // len(_COLORS)) % len(_LINESTYLES)],
            )
        ax.set_xlabel("round")
        ax.set_title(_DEFAULT_METRICS.get(m, m))
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
