"""Structured metrics: one JSONL stream that can regenerate every report the
reference scatters across four channels (stdout, .log files, two TensorBoard
streams, xlsx — SURVEY.md §2.5), including the ``read_log.py`` summary
(best-val round's target-test accuracy).

The package's own copy of ``ccst_tpu/utils/metrics.py`` (it imports no JAX):
the same records, so ``summarize`` of either package reads the logs of both.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer + stdout mirror + optional
    TensorBoard scalars (replacing the reference's tensorboardX/TFLogger
    double stream, SURVEY.md §2.5)."""

    def __init__(
        self,
        path: Optional[str] = None,
        echo: bool = True,
        tensorboard: bool = False,
    ):
        self.path = path
        self.echo = echo
        self._tb = None
        self._step = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None
        if tensorboard and path:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.splitext(path)[0] + "_tb")
            except ImportError:
                pass

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._tb is not None:
            step = int(fields.get("round", fields.get("step", self._step)))
            self._step = step + 1
            for k, v in fields.items():
                if isinstance(v, (int, float)) and k not in ("round", "step", "time"):
                    self._tb.add_scalar(f"{event}/{k}", v, step)
        if self.echo:
            printable = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            print(f"[{event}] {printable}")

    def log_image(self, tag: str, image, step: Optional[int] = None) -> None:
        """Image summary — TFLogger.image_summary parity
        (reference utils/tf_logger.py:30-52). ``image``: (H, W, C) float in
        [0, 1] or uint8. No-op without a TensorBoard writer; always records
        a compact JSONL stub (shape + mean) so runs remain self-describing."""
        import numpy as np

        arr = np.asarray(image)
        step = self._step if step is None else int(step)
        if self._f:
            self._f.write(json.dumps({
                "event": "image", "tag": tag, "step": step,
                "shape": list(arr.shape), "mean": float(arr.mean()),
            }) + "\n")
            self._f.flush()
        if self._tb is not None:
            if arr.dtype != "uint8":
                arr = (arr.clip(0, 1) * 255).astype("uint8")
            self._tb.add_image(tag, arr, step, dataformats="HWC")

    def log_histogram(self, tag: str, values, step: Optional[int] = None,
                      bins: int = 64) -> None:
        """Histogram summary — TFLogger.histo_summary parity
        (reference utils/tf_logger.py:54-81). Bucketizes on the host and
        records the JSONL histogram; also forwards to TensorBoard if on."""
        import numpy as np

        vals = np.asarray(values).ravel()
        step = self._step if step is None else int(step)
        counts, edges = np.histogram(vals, bins=bins)
        if self._f:
            self._f.write(json.dumps({
                "event": "histogram", "tag": tag, "step": step,
                "min": float(vals.min()), "max": float(vals.max()),
                "mean": float(vals.mean()), "std": float(vals.std()),
                "counts": counts.tolist(),
                "edges": [float(edges[0]), float(edges[-1])],
            }) + "\n")
            self._f.flush()
        if self._tb is not None:
            self._tb.add_histogram(tag, vals, step)

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


def read_rounds(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize_run(path: str, expected_rounds: Optional[int] = None) -> Dict[str, Any]:
    """read_log.py equivalent (read_log.py:19-60): report the target-test
    accuracy at the best-validation round and whether the run completed."""
    rounds = [r for r in read_rounds(path) if r["event"] == "round"]
    best = None
    for r in rounds:
        if best is None or r.get("val_acc_mean", -1) > best.get("val_acc_mean", -1):
            best = r
    last_round = rounds[-1]["round"] if rounds else -1
    complete = expected_rounds is None or last_round >= expected_rounds - 1
    return {
        "rounds_seen": len(rounds),
        "last_round": last_round,
        "complete": complete,
        "best_round": best["round"] if best else None,
        "best_val_acc_mean": best.get("val_acc_mean") if best else None,
        "test_acc_at_best_val": best.get("test_acc") if best else None,
    }


def summarize_many(paths: Iterable[str], expected_rounds: Optional[int] = None):
    """Mean-over-runs summary like read_log.py's multi-seed aggregation."""
    summaries = [summarize_run(p, expected_rounds) for p in paths]
    accs = [s["test_acc_at_best_val"] for s in summaries if s["test_acc_at_best_val"] is not None]
    return {
        "runs": summaries,
        "mean_test_acc_at_best_val": sum(accs) / len(accs) if accs else None,
        "incomplete_runs": [i for i, s in enumerate(summaries) if not s["complete"]],
    }
