"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and prints the result line.

A driver (``drivers/<name>.py``, named by the traffic file) has one entry,
``run(r: Run)``: it sets up, measures the window, traces when asked, checks
the outputs, and fills ``r``. The harness then reads each of the cell's
per-layer metrics through ``metrics/<metric>.py::read(r)`` in a traced run,
and prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, ``breakdown`` (traced runs) and, last, ``checks``: every number
the output check compared, beside its limit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ccst_tpu")


def load(kind: str, name: str) -> Dict[str, Any]:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(os.path.join(ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def process_age_s() -> float:
    """Seconds since this process started (Linux, 10 ms resolution), or 0
    where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclass
class Run:
    """One run of one cell: what the harness hands a driver and what the
    driver and the readers fill in."""

    cell: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                              # process start, on perf_counter's clock
    scale: Dict[str, Any] = field(default_factory=dict)  # test-only size overrides
    end_to_end: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    traced: Any = None                          # trace.Trace of the traced window
    checks: List[Check] = field(default_factory=list)
    readings: Dict[str, float] = field(default_factory=dict)  # worked out, not compared
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0

    def param(self, key: str):
        """A traffic or configuration value, or its test-only override."""
        if key in self.scale:
            return self.scale[key]
        return self.traffic[key] if key in self.traffic else self.config[key]

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])

    def check(self, name: str, value: float) -> None:
        """Compare ``value`` with the cell's limit for ``name``; a number the
        cell sets no limit for is kept as a reading only (``PERF.md`` says
        why: it does not separate the sound program from the control)."""
        if name in self.workload["limits"]:
            self.checks.append(Check(name, float(value), self.limit(name)))
        else:
            self.readings[name] = float(value)


def load_run(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             scale: Optional[Dict[str, Any]] = None) -> Run:
    workload = load("workloads", cell)
    return Run(cell, workload, load("configs", workload["config"]),
               load("traffic", workload["traffic"]), seed, seconds, trace, device, t_start,
               dict(scale or {}))


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``, loaded by file path (metric names
    hold dots)."""
    path = os.path.join(ROOT, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def execute(r: Run) -> None:
    """Run the cell's driver (named by its traffic file)."""
    driver = importlib.import_module(f"gpubench.drivers.{r.traffic['driver']}")
    driver.run(r)


def metrics_of(r: Run) -> Dict[str, Dict[str, Any]]:
    """The end-to-end metrics, or in a traced run the per-layer metrics that
    found something to read, each with its unit (the cell's file names them
    as ``BENCHMARK.json`` does)."""
    units = r.workload["units"]
    out = {}
    if not r.trace:
        for name in r.workload["end_to_end"]:
            out[name] = {"value": r.end_to_end[name], "unit": units[name]}
        return out
    for name in r.workload["per_layer"]:
        value = reader(name)(r)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out


def device_info(r: Run) -> Dict[str, Any]:
    import torch

    info: Dict[str, Any] = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
                            "kind": (torch.cuda.get_device_name(r.device)
                                     if r.device.type == "cuda" else "cpu"),
                            "count": 1, "memory_peak_bytes": int(r.memory_peak_bytes)}
    if r.device.type == "cuda":
        try:
            info["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i",
                 str(r.device.index or 0)], capture_output=True, text=True, timeout=20,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            info["power_limit"] = "unknown"
    if r.trace and r.traced is not None:
        info["busy_s"] = r.traced.busy_s
        info["window_s"] = r.traced.window_s
    return info


def result_line(r: Run) -> Dict[str, Any]:
    line: Dict[str, Any] = {
        "correct": bool(r.checks) and all(c.ok for c in r.checks),
        "attempted": r.attempted,
        "failed": r.failed,
        "metrics": metrics_of(r),
        "device": device_info(r),
    }
    if r.trace and r.traced is not None:
        line["breakdown"] = {"device_ops": r.traced.top_kernels(),
                             "idle_gaps": r.traced.top_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in r.checks}
    return line


def bytes_written() -> Dict[str, int]:
    """What this process wrote (Linux's ``/proc/self/io``): ``wchar``, the
    bytes handed to write calls (files, pipes, the terminal), and
    ``write_bytes``, those that reached storage (files deleted before the
    kernel writes them back, or on tmpfs, never do); empty where it cannot
    say."""
    try:
        with open("/proc/self/io") as f:
            fields = dict(line.split(":") for line in f if ":" in line)
        return {k: int(fields[k]) for k in ("wchar", "write_bytes")}
    except (OSError, KeyError, ValueError):
        return {}


def forbidden_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that the port must never load,
    compared whole (``ccst_tpu_torch`` is not ``ccst_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
