"""The port's copy of the Digits / Office pickle-partition datasets
(``ccst_tpu_torch/data/digits.py``, reference utils/data_utils.py): the cases
of ``tests/test_digits.py`` on the port's own modules."""
import os

import numpy as np
import pytest

from ccst_tpu_torch.data.digits import (
    DigitsArrayLoader,
    OFFICE_CALTECH_LABELS,
    load_digits_arrays,
    load_path_pickle_loader,
)
from ccst_tpu_torch.data.lists import split_image_tree
from ccst_tpu_torch.data.loader import save_image_u8


def obj_pair(a, b):
    arr = np.empty(2, dtype=object)
    arr[0], arr[1] = a, b
    return arr


@pytest.fixture
def digits_root(tmp_path, rng):
    root = str(tmp_path / "mnist")
    os.makedirs(os.path.join(root, "partitions"))
    for part in range(3):
        imgs = (rng.random((20, 28, 28)) * 255).astype(np.uint8)
        labels = rng.integers(0, 10, (20, 1))
        np.save(
            os.path.join(root, "partitions", f"train_part{part}.pkl"),
            obj_pair(imgs, labels),
            allow_pickle=True,
        )
    test_imgs = (rng.random((10, 28, 28)) * 255).astype(np.uint8)
    np.save(
        os.path.join(root, "test.pkl"),
        obj_pair(test_imgs, rng.integers(0, 10, (10, 1))),
        allow_pickle=True,
    )
    # np.save appends .npy; reference files have bare .pkl names
    for f in os.listdir(os.path.join(root, "partitions")):
        if f.endswith(".npy"):
            os.rename(
                os.path.join(root, "partitions", f),
                os.path.join(root, "partitions", f[:-4]),
            )
    os.rename(os.path.join(root, "test.pkl.npy"), os.path.join(root, "test.pkl"))
    return root


def test_digits_percent_loading(digits_root):
    imgs, labels = load_digits_arrays(digits_root, percent=0.2, train=True)
    assert imgs.shape[0] == 40  # two 10% chunks
    imgs, labels = load_digits_arrays(digits_root, percent=0.05, train=True)
    assert imgs.shape[0] == 10  # half of chunk 0
    imgs, labels = load_digits_arrays(digits_root, train=False)
    assert imgs.shape[0] == 10
    assert labels.ndim == 1


def test_digits_array_loader_grayscale_to_rgb(digits_root):
    imgs, labels = load_digits_arrays(digits_root, percent=0.1)
    loader = DigitsArrayLoader(imgs, labels, batch_size=8, image_size=28)
    batches = list(loader)
    assert batches[0].images.shape == (8, 28, 28, 3)
    assert batches[0].images.dtype == np.float32
    assert batches[0].images.max() <= 1.0
    assert batches[-1].valid == 20 - 2 * 8


def test_office_path_pickle_loader(tmp_path, rng):
    root = str(tmp_path)
    paths, texts = [], []
    for i, cls in enumerate(["bike", "mug"]):
        rel = f"imgs/{cls}_{i}.png"
        save_image_u8(rng.random((20, 20, 3), dtype=np.float32), os.path.join(root, rel))
        paths.append(rel)
        texts.append(cls)
    pkl = os.path.join(root, "amazon_train.pkl")
    np.save(pkl, obj_pair(paths, texts), allow_pickle=True)
    os.rename(pkl + ".npy", pkl)
    loader = load_path_pickle_loader(
        pkl, root, OFFICE_CALTECH_LABELS, batch_size=2, image_size=16
    )
    batch = next(iter(loader))
    assert batch.images.shape == (2, 16, 16, 3)
    assert set(batch.labels.tolist()) == {1, 8}  # bike=1, mug=8


def test_split_image_tree(tmp_path, rng):
    root = str(tmp_path)
    for d in ["art", "clipart", "product", "real_world"]:
        for cls in ["Alarm_Clock", "Bike"]:
            for i in range(10):
                save_image_u8(
                    rng.random((8, 8, 3), dtype=np.float32),
                    os.path.join(root, "officehome", d, cls, f"{i}.png"),
                )
    written = split_image_tree(root, "officehome", root, train_fraction=0.8, seed=1)
    assert set(written) == {"art", "clipart", "product", "real_world"}
    from ccst_tpu_torch.data.lists import parse_list

    tr_n, tr_l = parse_list(written["art"][0])
    te_n, te_l = parse_list(written["art"][1])
    assert len(tr_n) == 16 and len(te_n) == 4
    assert set(tr_l + te_l) == {0, 1}
    # stable labels across domains
    tr_n2, tr_l2 = parse_list(written["clipart"][0])
    lab_of = {os.path.basename(os.path.dirname(n)): l for n, l in zip(tr_n2, tr_l2)}
    assert lab_of["Alarm_Clock"] == 0 and lab_of["Bike"] == 1
