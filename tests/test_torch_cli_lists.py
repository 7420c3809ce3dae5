"""The list subcommands of ccst-tpu-torch (``split-data``, ``filter-blank``,
``gen-lists``, ``reorganize``) against ccst-tpu's, through both CLIs on one
synthetic PACS tree: exit code 0, the same printed lines (paths aside), and
the same files, byte for byte. No device is touched; ``--device`` is accepted
and ignored.
"""
import filecmp
import os
import shutil

import numpy as np
import pytest

from ccst_tpu.cli import main as jax_cli
from ccst_tpu.data.lists import parse_list, stylized_output_path, train_list_path, write_list
from ccst_tpu.data.loader import save_image_u8
from ccst_tpu_torch.cli import main as torch_cli

DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 domains x 2 classes x 3 PNGs (one nearly black, which filter-blank
    drops) and per-domain train lists."""
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names, labels = [], []
        for ci, cls in enumerate(("dog", "house")):
            for i in range(3):
                rel = f"PACS/kfold/{d}/{cls}/img{i}.png"
                mean = 0.01 if (ci, i) == (1, 2) else 0.3 + 0.1 * i
                img = np.clip(rng.normal(mean, 0.01 if mean < 0.05 else 0.15, (20, 18, 3)), 0, 1)
                save_image_u8(img.astype(np.float32), os.path.join(root, rel))
                names.append(rel)
                labels.append(ci)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, labels)
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _both(argv_of, roots, capsys):
    """Run ``argv_of(root)`` through ccst-tpu (roots[0]) and ccst-tpu-torch
    (roots[1], with ``--device cuda``); return each one's printed lines with
    its root replaced by ``ROOT``."""
    printed = []
    for cli, root, extra in ((jax_cli, roots[0], []), (torch_cli, roots[1], ["--device", "cuda"])):
        assert cli(argv_of(root) + extra) == 0
        printed.append(capsys.readouterr().out.replace(root, "ROOT").splitlines())
    return printed


def _assert_same_files(a, b, under=""):
    files = _files(os.path.join(a, under))
    assert files and files == _files(os.path.join(b, under))
    for rel in files:
        assert filecmp.cmp(os.path.join(a, under, rel), os.path.join(b, under, rel),
                           shallow=False), rel


def test_split_data_writes_the_same_lists(tree, tmp_path, capsys):
    roots = [str(tmp_path / "theirs"), str(tmp_path / "ours")]
    printed = _both(lambda r: ["split-data", "--dataset", "pacs", "--data-root", tree,
                               "--list-root", r, "--train-fraction", "0.67", "--seed", "2",
                               "--tree-subdir", "PACS/kfold"], roots, capsys)
    assert printed[0] == printed[1] and len(printed[0]) == len(DOMAINS)
    _assert_same_files(*roots)
    assert len(_files(roots[1])) == 2 * len(DOMAINS)


def test_filter_blank_writes_the_same_lists(tree, tmp_path, capsys):
    roots = [str(tmp_path / "theirs"), str(tmp_path / "ours")]
    for r in roots:
        shutil.copytree(os.path.join(tree, "txt_lists"), os.path.join(r, "txt_lists"))
    printed = _both(lambda r: ["filter-blank", "--dataset", "pacs", "--list-root", r,
                               "--data-root", tree], roots, capsys)
    assert printed[0] == printed[1] and len(printed[0]) == len(DOMAINS)
    _assert_same_files(*roots)
    kept, _ = parse_list(os.path.join(roots[1], "txt_lists", "pacs_discardBlackWhite",
                                      "photo_train.txt"))
    assert len(kept) == 5 and "PACS/kfold/photo/house/img2.png" not in kept


def test_gen_lists_writes_the_same_lists(tree, tmp_path, capsys):
    roots = [str(tmp_path / "theirs"), str(tmp_path / "ours")]
    for r in roots:
        shutil.copytree(os.path.join(tree, "txt_lists"), os.path.join(r, "txt_lists"))
    printed = _both(lambda r: ["gen-lists", "--dataset", "pacs", "--target", "photo",
                               "--list-root", r, "--k", "2", "--seed", "3"], roots, capsys)
    assert printed[0] == printed[1] and len(printed[0]) == len(DOMAINS) - 1
    _assert_same_files(*roots)
    assert len(_files(roots[1])) == len(DOMAINS) + len(DOMAINS) - 1


def test_reorganize_places_the_same_tree(tree, tmp_path, capsys):
    """Stand-ins for the stylize stage's outputs (copies of the originals at
    its paths), then the unified tree for target photo, copied (``--copy``)."""
    roots = [str(tmp_path / "theirs"), str(tmp_path / "ours")]
    for r in roots:
        shutil.copytree(tree, r)
        for d in DOMAINS:
            if d == "photo":
                continue
            names, _ = parse_list(train_list_path(r, "pacs", d))
            for rel in names:
                for style in DOMAINS:
                    if style not in (d, "photo"):
                        dst = os.path.join(r, stylized_output_path(rel, d, style, "overall"))
                        os.makedirs(os.path.dirname(dst), exist_ok=True)
                        shutil.copy(os.path.join(r, rel), dst)
    before = _files(roots[1])
    printed = _both(lambda r: ["reorganize", "--dataset", "pacs", "--target", "photo",
                               "--list-root", r, "--data-root", r, "--copy"], roots, capsys)
    assert printed[0] == printed[1] == ["placed 54 files in the unified tree for target=photo"]
    assert _files(roots[0]) == _files(roots[1]) and len(_files(roots[1])) == len(before) + 54
    _assert_same_files(*roots)
