"""Pickle-partition datasets: DigitsFive, Office-Caltech10, DomainNet.

Rebuild of the reference's ``utils/data_utils.py:12-113`` (DigitsDataset /
OfficeDataset / DomainNetDataset — imported by fed_run but unused on the
PACS/OfficeHome/Camelyon17 paths). These consume the FedBN-style artifact
layout: ``{root}/partitions/train_part{k}.pkl`` chunks of 10% each plus
``test.pkl`` (numpy pickles of (images, labels) or (paths, text_labels)).

TPU-first: loaders return fixed-shape float32 NHWC batches like
``ImageBatchLoader`` so the same jitted train steps consume them.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ccst_tpu_torch.data.loader import ImageBatchLoader

OFFICE_CALTECH_LABELS = {
    "back_pack": 0, "bike": 1, "calculator": 2, "headphones": 3,
    "keyboard": 4, "laptop_computer": 5, "monitor": 6, "mouse": 7,
    "mug": 8, "projector": 9,
}

DOMAINNET_LABELS = {
    "bird": 0, "feather": 1, "headphones": 2, "ice_cream": 3, "teapot": 4,
    "tiger": 5, "whale": 6, "windmill": 7, "wine_glass": 8, "zebra": 9,
}


def load_digits_arrays(
    data_path: str,
    percent: float = 0.1,
    train: bool = True,
    filename: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Percent-based partition loading (data_utils.py:14-36): >=10% loads
    whole 10%-chunks; <10% truncates chunk 0."""
    if filename is not None:
        images, labels = np.load(
            os.path.join(data_path, filename), allow_pickle=True
        )
    elif train:
        if percent >= 0.1:
            parts = []
            for part in range(int(percent * 10)):
                parts.append(
                    np.load(
                        os.path.join(data_path, f"partitions/train_part{part}.pkl"),
                        allow_pickle=True,
                    )
                )
            images = np.concatenate([p[0] for p in parts], axis=0)
            labels = np.concatenate([p[1] for p in parts], axis=0)
        else:
            images, labels = np.load(
                os.path.join(data_path, "partitions/train_part0.pkl"),
                allow_pickle=True,
            )
            n = int(images.shape[0] * percent * 10)
            images, labels = images[:n], labels[:n]
    else:
        images, labels = np.load(
            os.path.join(data_path, "test.pkl"), allow_pickle=True
        )
    return images, np.asarray(labels).astype(np.int64).squeeze()


class DigitsArrayLoader:
    """Fixed-shape batches straight from in-memory digit arrays.

    Grayscale sources broadcast to 3 channels (data_utils.py:45-48 renders
    mode 'L' then the transform stacks channels); uint8 scaled to [0, 1].
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        *,
        batch_size: int,
        image_size: int = 28,
        shuffle: bool = False,
        seed: int = 0,
    ):
        imgs = images.astype(np.float32)
        if imgs.max() > 1.5:
            imgs = imgs / 255.0
        if imgs.ndim == 3:  # (N, H, W) grayscale
            imgs = np.repeat(imgs[..., None], 3, axis=-1)
        elif imgs.shape[-1] == 1:
            imgs = np.repeat(imgs, 3, axis=-1)
        if imgs.shape[1] != image_size:
            from PIL import Image

            imgs = np.stack(
                [
                    np.asarray(
                        Image.fromarray(
                            (np.clip(im, 0, 1) * 255).astype(np.uint8)
                        ).resize((image_size, image_size), Image.BILINEAR),
                        dtype=np.float32,
                    )
                    / 255.0
                    for im in imgs
                ]
            )
        self.images = imgs
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.labels) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        from ccst_tpu_torch.data.loader import Batch

        idx = np.arange(len(self.labels))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        bs = self.batch_size
        for start in range(0, len(idx), bs):
            chunk = idx[start : start + bs]
            imgs = self.images[chunk]
            labels = self.labels[chunk]
            valid = len(chunk)
            if valid < bs:
                imgs = np.concatenate(
                    [imgs, np.zeros((bs - valid,) + imgs.shape[1:], np.float32)]
                )
                labels = np.concatenate([labels, np.zeros(bs - valid, np.int32)])
            yield Batch(images=imgs, labels=labels, paths=[], valid=valid)


def load_path_pickle_loader(
    pkl_path: str,
    base_path: str,
    label_dict: dict,
    *,
    batch_size: int,
    image_size: int,
    shuffle: bool = False,
    seed: int = 0,
) -> ImageBatchLoader:
    """Office-Caltech10 / DomainNet style (paths, text_labels) pickles
    (data_utils.py:58-113) -> prefetching image loader."""
    paths, text_labels = np.load(pkl_path, allow_pickle=True)
    labels = [label_dict[t] for t in text_labels]
    abs_paths = [os.path.join(base_path, p) for p in paths]
    return ImageBatchLoader(
        abs_paths, labels, batch_size=batch_size, image_size=image_size,
        shuffle=shuffle, seed=seed,
    )
