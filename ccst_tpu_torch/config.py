"""Typed configuration of the offline pipeline and the dataset registry.

The package's own copy of ``ccst_tpu/config.py``, under the same names so a
reader finds the counterpart: the dataset registry, ``StylizeConfig``,
``FusionConfig``, ``FedConfig``, ``MeshConfig`` and the ImageNet
normalization constants. Field names,
defaults and the registry's values equal the original's
(``tests/test_torch_standalone.py`` holds them together), so lists, banks and
outputs of either package feed the other. ``FedConfig`` keeps the original's
fields that nothing reads (``momentum``: training is plain SGD;
``random_horiz_flip``: the flip probability is fixed at 0.5). Its mesh and
multi-process fields drive ``parallel/fed_mesh.py`` and
``federated/multihost_runtime.py``, where a mesh is a grid of
``torch.distributed`` ranks rather than of local devices.
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

#: ImageNet normalization used by the training-side data layer
#: (reference data/data_helper.py:21-31).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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
    trace_dir: str = ""               # torch.profiler trace + spans.json (off if "")


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


@dataclass
class FedConfig:
    """Federated training config (reference federated/fed_run.py:457-505)."""

    dataset: str = "pacs"
    target: str = "art_painting"      # held-out test domain
    mode: str = "fedavg"              # fedavg | fedbn | fedprox | adafea | deepall
    fusion_mode: str = "no_fusion"    # no_fusion | adain-single-K{k} | adain-overall-K{k}
    dg_method: str = "no_DG"          # no_DG | RSC | Jigsaw | MixStyle | feddg
    network: str = "resnet18"
    rounds: int = 500                 # communication rounds ("iters")
    wk_iters: int = 1                 # local epochs per round
    lr: float = 1e-2
    momentum: float = 0.0             # reference uses plain SGD
    batch_size: int = 32
    image_size: int = 222
    val_size: float = 0.1
    seed: int = 1
    mu: float = 1e-3                  # FedProx proximal weight
    limit_data: float = 1.0           # fraction of each client's train list
    # Jigsaw
    jig_weight: float = 0.7
    jigsaw_n_classes: int = 30
    bias_whole_image: float = 0.9
    # FedDG / ELCFS
    meta_step_size: float = 1e-3
    clip_value: float = 1.0
    # transforms
    min_scale: float = 0.8
    max_scale: float = 1.0
    random_horiz_flip: float = 0.5
    # eval-time options
    in_test: bool = False             # swap BN -> IN at test
    tent: bool = False                # test-time entropy adaptation
    # io
    data_root: str = ""
    list_root: str = ""
    save_path: str = "checkpoints"
    log_path: str = "logs"
    trace_dir: str = ""               # torch.profiler trace + spans.json (off if "")
    save_freq: int = 10
    resume: bool = False
    test_only: bool = False
    # parallel execution
    client_axis: str = "client"       # mesh axis clients shard over
    data_axis: str = "data"           # mesh axis batches shard over
    parallel_clients: bool = False    # one vmapped step for ALL clients
    client_shards: int = 1            # mesh: client-axis size (1 = no mesh)
    data_shards: int = 1              # mesh: data-axis size
    # multi-process (DCN) launch — jax.distributed cluster formation
    # (federated/multihost_runtime.py; env fallbacks CCST_COORDINATOR /
    # CCST_NUM_PROCS / CCST_PROC_ID)
    coordinator: str = ""             # e.g. "host0:1357"; "" = single-process
    num_procs: int = 0                # 0 = single-process (or env/TPU auto)
    proc_id: int = -1                 # -1 = env/TPU auto

    @property
    def spec(self) -> DatasetSpec:
        return dataset_spec(self.dataset)

    @property
    def source_domains(self) -> Tuple[str, ...]:
        return tuple(d for d in self.spec.domains if d != self.target)


@dataclass
class MeshConfig:
    """Device mesh layout. axes sized 1 are free."""

    client: int = 1
    data: int = -1                    # -1: all remaining devices
    model: int = 1

    def axis_sizes(self, n_devices: int) -> Dict[str, int]:
        sizes = {"client": self.client, "data": self.data, "model": self.model}
        fixed = 1
        free = None
        for k, v in sizes.items():
            if v == -1:
                if free is not None:
                    raise ValueError("only one mesh axis may be -1")
                free = k
            else:
                fixed *= v
        if free is not None:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by {fixed}")
            sizes[free] = n_devices // fixed
        return sizes


def asdict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def replace(cfg: Any, **kw: Any) -> Any:
    return dataclasses.replace(cfg, **kw)
