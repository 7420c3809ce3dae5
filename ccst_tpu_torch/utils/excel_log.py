"""Tabular per-round metric export (reference utils/excel_log.py equivalent).

The reference appends per-round metrics to an ``.xlsx`` (dead code there,
commented at reconstruct_img/test.py:19). Here the same capability exports a
metrics JSONL stream to CSV (always) or XLSX (if openpyxl is installed; CSV
otherwise).
"""
from __future__ import annotations

import csv
import os
from typing import List, Optional

from ccst_tpu_torch.utils.metrics import read_rounds


def export_rounds_csv(
    jsonl_path: str, out_path: Optional[str] = None, event: str = "round"
) -> str:
    """Flatten all ``event`` records of a metrics stream into a CSV table."""
    rows = [r for r in read_rounds(jsonl_path) if r.get("event") == event]
    if out_path is None:
        out_path = os.path.splitext(jsonl_path)[0] + f"_{event}.csv"
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        for r in rows:
            writer.writerow(r)
    return out_path


def export_rounds_xlsx(jsonl_path: str, out_path: Optional[str] = None) -> str:
    """XLSX variant; requires openpyxl (falls back to CSV when missing)."""
    try:
        from openpyxl import Workbook
    except ImportError:
        return export_rounds_csv(jsonl_path, out_path and out_path.replace(".xlsx", ".csv"))
    rows = [r for r in read_rounds(jsonl_path) if r.get("event") == "round"]
    if out_path is None:
        out_path = os.path.splitext(jsonl_path)[0] + "_rounds.xlsx"
    wb = Workbook()
    ws = wb.active
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    ws.append(keys)
    for r in rows:
        ws.append([r.get(k) for k in keys])
    wb.save(out_path)
    return out_path
