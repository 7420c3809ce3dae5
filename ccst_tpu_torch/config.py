"""Typed configuration of the offline pipeline and the dataset registry.

The package's own copy of ``ccst_tpu/config.py``, under the same names so a
reader finds the counterpart: the dataset registry, ``StylizeConfig`` and
``FusionConfig``. The federated-training and mesh configs are not copied; no
module of this package trains. Field names, defaults and the registry's
values equal the original's (``tests/test_torch_standalone.py`` holds them
together), so lists, banks and outputs of either package feed the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# ---------------------------------------------------------------------------
# Dataset / domain registry
# ---------------------------------------------------------------------------
# The reference hardcodes these tables in four places (SURVEY.md §5.6); this is
# the single source of truth.


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    domains: Tuple[str, ...]
    num_classes: int
    image_size: int          # training resolution (reference README uses 222)
    stylize_size: int        # resolution used for stylization (512 in README)
    output_size: int = -1    # post-stylize resize (-1 = keep); camelyon17: 96


DATASETS: Dict[str, DatasetSpec] = {
    "pacs": DatasetSpec(
        name="pacs",
        domains=("art_painting", "cartoon", "photo", "sketch"),
        num_classes=7,
        image_size=222,
        stylize_size=512,
    ),
    "officehome": DatasetSpec(
        name="officehome",
        domains=("art", "clipart", "product", "real_world"),
        num_classes=65,
        image_size=222,
        stylize_size=222,
    ),
    "camelyon17": DatasetSpec(
        name="camelyon17",
        domains=("hospital1", "hospital2", "hospital3", "hospital4", "hospital5"),
        num_classes=2,
        image_size=96,
        stylize_size=512,
        output_size=96,
    ),
    "digitsfive": DatasetSpec(
        name="digitsfive",
        domains=("MNIST", "MNIST_M", "SVHN", "SynthDigits", "USPS"),
        num_classes=10,
        image_size=28,
        stylize_size=28,
    ),
}


def dataset_spec(name: str) -> DatasetSpec:
    key = name.lower()
    if key not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    return DATASETS[key]


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclass
class StylizeConfig:
    """Config for the offline stylization pipeline (stages 1-2)."""

    dataset: str = "pacs"
    target: str = "art_painting"      # content domain
    mode: str = "overall"             # "overall" | "single"
    alpha: float = 1.0
    image_size: int = 512
    output_size: int = -1
    batch_size: int = 32
    seed: int = 1                     # reference CCST_SingleStyleTransfer.py:22-26
    data_root: str = ""
    list_root: str = ""               # directory holding txt_lists/
    style_stats_dir: str = "style_stats"
    output_root: str = ""             # where stylized trees are written
    vgg_weights: str = ""             # path to vgg params (.pth or .npz); "" = random
    decoder_weights: str = ""
    dtype: str = "bfloat16"           # compute dtype; stats always float32
    engine: str = "ref"               # executor: ref|packed|int8|int8-static|int8-fused
    scales: str = ""                  # persisted int8 calibration artifact
                                      # ("" = auto: load the `calibrate`
                                      # default path if present, else
                                      # self-calibrate on the first batch)
    save_ext: str = ""                # "" = keep original extension
    skip_existing: bool = False       # idempotent reruns: skip done outputs


@dataclass
class FusionConfig:
    """Fusion-mode list generation (reference data/data_list_generator.py)."""

    dataset: str = "pacs"
    target: str = "art_painting"
    style: str = "adain"              # style-transfer family name in paths
    mode: str = "overall"             # "overall" | "single"
    k: int = 3                        # styles sampled per image (K in the paper)
    seed: int = 1
    save_ext: str = ""                # must match the stylize stage's value


def asdict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def replace(cfg: Any, **kw: Any) -> Any:
    return dataclasses.replace(cfg, **kw)
