"""Training-side data assembly for the federated runtime.

Rebuild of the reference's train/val/test loader factory
(data/data_helper.py:46-158): per source client, select the txt list for the
active fusion mode, carve a seeded validation split, optionally subsample
(``limit_data``), and build prefetching loaders. ``deepall`` concatenates all
sources into one loader (data_helper.py:67-68,103-119).

Divergences by design:
  - the live ``pdb.set_trace()`` at data_helper.py:81 is, obviously, not
    reproduced;
  - the val split is seeded per (seed, domain) instead of global torch RNG
    state, so it is stable regardless of call order;
  - test loader shuffling is optional (the reference hardcodes shuffle=True
    "for tent optimization", data_helper.py:157).

The package's own copy of ``ccst_tpu/federated/data.py`` (it imports no JAX):
the same splits and the same uint8 batches
(``tests/test_torch_standalone.py`` holds them together).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ccst_tpu_torch.config import FedConfig
from ccst_tpu_torch.data.lists import parse_list, test_list_path, train_list_path
from ccst_tpu_torch.data.loader import ImageBatchLoader


@dataclass
class ClientData:
    name: str
    train: ImageBatchLoader
    val: ImageBatchLoader
    n_train: int
    n_val: int


def _fusion_dir(cfg: FedConfig) -> Optional[str]:
    fm = cfg.fusion_mode
    if fm in ("no_fusion", "", None):
        return None
    # e.g. "adain-overall-K3" -> txt_lists/{ds}_adain-overall-K3/{target}/
    return fm


def _val_split(
    names: List[str], labels: List[int], val_size: float, seed: int, domain: str
) -> Tuple[Tuple[List[str], List[int]], Tuple[List[str], List[int]]]:
    """Seeded random val carve-out (reference get_random_subset,
    data/ImageLoader.py:13-28 with args.val_size=0.1)."""
    n = len(names)
    n_val = int(n * val_size)
    # stable per-domain offset: builtin hash() is randomized per process
    # (PYTHONHASHSEED), which silently gave every process its OWN train/val
    # partition — caught by the multi-host cross-runner equality test
    # (tests/test_multihost.py); crc32 is process-independent
    import zlib

    rng = np.random.default_rng(seed + (zlib.crc32(domain.encode()) % 100003))
    idx = rng.permutation(n)
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    pick = lambda ix: ([names[i] for i in ix], [labels[i] for i in ix])
    return pick(train_idx), pick(val_idx)


def _abs(paths: List[str], root: str) -> List[str]:
    return [os.path.join(root, p) for p in paths] if root else paths


def build_client_data(cfg: FedConfig) -> Tuple[List[ClientData], ImageBatchLoader]:
    """Returns ([client data per source domain], target test loader).

    Images come out of the loaders as uint8 bytes at ``loader_size``
    (u8 transport — 1/4 the host->device traffic; ``runtime._batch_dict``
    converts to the raw [0,1] float the device transforms expect,
    bit-identically to float32 loading). For deepall mode a single
    concatenated pseudo-client named "deepall" is returned.
    """
    spec = cfg.spec
    fusion = _fusion_dir(cfg)
    # host loaders decode at a slightly larger size so the on-device
    # RandomResizedCrop (scale >= min_scale) has real pixels to sample
    loader_size = cfg.image_size

    clients: List[ClientData] = []
    all_train: Tuple[List[str], List[int]] = ([], [])
    for domain in cfg.source_domains:
        path = train_list_path(
            cfg.list_root, cfg.dataset, domain, fusion_dir=fusion, target=cfg.target
        )
        names, labels = parse_list(path)
        (tr_n, tr_l), (va_n, va_l) = _val_split(
            names, labels, cfg.val_size, cfg.seed, domain
        )
        if cfg.limit_data < 1.0:
            keep = max(1, int(len(tr_n) * cfg.limit_data))
            rng = np.random.default_rng(cfg.seed)
            sel = rng.permutation(len(tr_n))[:keep]
            tr_n = [tr_n[i] for i in sel]
            tr_l = [tr_l[i] for i in sel]
        if cfg.mode.lower() == "deepall":
            all_train[0].extend(tr_n)
            all_train[1].extend(tr_l)
        train_loader = ImageBatchLoader(
            _abs(tr_n, cfg.data_root),
            tr_l,
            batch_size=cfg.batch_size,
            image_size=loader_size,
            shuffle=True,
            seed=cfg.seed,
            # u8 transport: runtime._batch_dict converts to [0,1] float on
            # device, bit-identically to float32 batches
            out_dtype="uint8",
        )
        val_loader = ImageBatchLoader(
            _abs(va_n, cfg.data_root),
            va_l,
            batch_size=cfg.batch_size,
            image_size=cfg.image_size,
            shuffle=False,
            out_dtype="uint8",
        )
        clients.append(
            ClientData(
                name=domain,
                train=train_loader,
                val=val_loader,
                n_train=len(tr_n),
                n_val=len(va_n),
            )
        )

    if cfg.mode.lower() == "deepall":
        # single centralized pseudo-client over all source data
        # (data_helper.py:103-119); per-domain val splits are kept for
        # best-model selection parity
        deepall_loader = ImageBatchLoader(
            _abs(all_train[0], cfg.data_root),
            all_train[1],
            batch_size=cfg.batch_size,
            image_size=loader_size,
            shuffle=True,
            seed=cfg.seed,
            out_dtype="uint8",
        )
        clients = [
            ClientData(
                name="deepall",
                train=deepall_loader,
                val=clients[0].val,
                n_train=len(all_train[0]),
                n_val=clients[0].n_val,
            )
        ] + clients  # keep per-domain vals accessible at [1:]

    test_names, test_labels = parse_list(
        test_list_path(cfg.list_root, cfg.dataset, cfg.target)
    )
    test_loader = ImageBatchLoader(
        _abs(test_names, cfg.data_root),
        test_labels,
        batch_size=cfg.batch_size,
        image_size=cfg.image_size,
        shuffle=False,
        out_dtype="uint8",
    )
    return clients, test_loader
