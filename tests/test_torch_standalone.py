"""ccst_tpu_torch stands alone: it imports nothing of ccst_tpu and nothing of
JAX, and its own copies of the framework-free modules (config, data.lists,
data.loader, native) behave as the originals do.

Only this test file imports both packages. The copies are held to the
originals exactly: same dataclass fields and defaults, same registry, same
paths and list files byte for byte, same decoded and encoded image bytes with
the PIL backend (the native backend is the same C++ source in both).
"""
import ast
import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import ccst_tpu.config as jconfig
import ccst_tpu.data.lists as jlists
import ccst_tpu.data.loader as jloader
import ccst_tpu_torch.config as tconfig
import ccst_tpu_torch.data.lists as tlists
import ccst_tpu_torch.data.loader as tloader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dp, _, fs in os.walk(os.path.join(REPO, "ccst_tpu_torch")):
        files += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    """Top-level package of every import statement in the file, at any depth
    (imports inside functions count: the port imports lazily in places)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_sources_to_walk():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"chip_smoke.py", "ccst_tpu_torch/cli.py", "ccst_tpu_torch/config.py",
            "ccst_tpu_torch/data/lists.py", "ccst_tpu_torch/data/loader.py",
            "ccst_tpu_torch/native/__init__.py", "ccst_tpu_torch/pipeline/stylize.py"} <= names


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_ccst_tpu_or_jax(path):
    banned = _imported_roots(path) & {"ccst_tpu", "jax", "jaxlib", "flax", "optax"}
    assert not banned, f"{os.path.relpath(path, REPO)} imports {sorted(banned)}"


# ---- config ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["StylizeConfig", "FusionConfig", "DatasetSpec"])
def test_config_dataclass_fields_and_defaults(name):
    def describe(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert describe(getattr(tconfig, name)) == describe(getattr(jconfig, name))


@pytest.mark.parametrize("name", sorted(jconfig.DATASETS))
def test_dataset_spec_equals_original(name):
    ours, theirs = tconfig.dataset_spec(name), jconfig.dataset_spec(name.upper())
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert sorted(tconfig.DATASETS) == sorted(jconfig.DATASETS)


def test_dataset_spec_rejects_unknown_names():
    for mod in (tconfig, jconfig):
        with pytest.raises(KeyError, match="unknown dataset"):
            mod.dataset_spec("imagenet")
    cfg = tconfig.StylizeConfig(engine="int8-fused")
    assert tconfig.asdict(tconfig.replace(cfg, batch_size=4)) == jconfig.asdict(
        jconfig.replace(jconfig.StylizeConfig(engine="int8-fused"), batch_size=4))


# ---- lists ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A PACS-layout tree: 4 domains x 2 classes x 3 PNGs, written with the
    original package's encoder, and per-domain train lists."""
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names, labels = [], []
        for ci, cls in enumerate(("dog", "house")):
            for i in range(3):
                rel = f"PACS/kfold/{d}/{cls}/img{i}.png"
                img = np.clip(rng.normal(0.3 + 0.1 * i, 0.15, (40, 36, 3)), 0, 1)
                jloader.save_image_u8(img.astype(np.float32), os.path.join(root, rel))
                names.append(rel)
                labels.append(ci)
        jlists.write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, labels)
    return root


def test_list_round_trip_is_byte_identical(tree, tmp_path):
    src = os.path.join(tree, "txt_lists", "pacs", "photo_train.txt")
    assert tlists.parse_list(src) == jlists.parse_list(src)
    names, labels = tlists.parse_list(src)
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    tlists.write_list(ours, names, labels)
    jlists.write_list(theirs, names, labels)
    assert filecmp.cmp(ours, theirs, shallow=False) and filecmp.cmp(ours, src, shallow=False)


@pytest.mark.parametrize("fusion_dir,target", [(None, None), ("no_fusion", "photo"),
                                               ("adain-overall-K3", "photo")])
def test_list_paths_equal_original(fusion_dir, target):
    args = ("/lists", "PACS", "cartoon", fusion_dir, target)
    assert tlists.train_list_path(*args) == jlists.train_list_path(*args)
    assert tlists.test_list_path("/lists", "PACS", "cartoon") == jlists.test_list_path(
        "/lists", "PACS", "cartoon")


@pytest.mark.parametrize("mode", ["overall", "single"])
@pytest.mark.parametrize("path", ["/data/PACS/kfold/photo/dog/a.jpg",
                                  "/data/photo_sets/PACS/kfold/photo/house/b.png"])
def test_output_paths_equal_original(path, mode):
    assert tlists.stylized_output_path(path, "photo", "sketch", mode) == \
        jlists.stylized_output_path(path, "photo", "sketch", mode)
    for fn in ("unified_original_path", "unified_tree_path"):
        extra = ("sketch",) if fn == "unified_tree_path" else ()
        args = (path, "photo", *extra, "adain", mode)
        assert getattr(tlists, fn)(*args) == getattr(jlists, fn)(*args)
    with pytest.raises(ValueError, match="path segment"):
        tlists.stylized_output_path("/data/x.jpg", "photo", "sketch", mode)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_k_lists_are_byte_identical(tree, tmp_path):
    outs = {}
    for tag, mod in (("ours", tlists), ("theirs", jlists)):
        out_root = str(tmp_path / tag)
        written = mod.generate_k_lists(tree, "pacs", "photo", k=2, seed=3, out_root=out_root)
        assert sorted(written) == ["art_painting", "cartoon", "sketch"]
        outs[tag] = out_root
    files = _tree_files(outs["ours"])
    assert files == _tree_files(outs["theirs"]) and len(files) == 3
    for rel in files:
        assert filecmp.cmp(os.path.join(outs["ours"], rel), os.path.join(outs["theirs"], rel),
                           shallow=False), rel


def test_split_and_blank_filter_equal_original(tree, tmp_path):
    outs = {}
    for tag, mod in (("ours", tlists), ("theirs", jlists)):
        list_root = str(tmp_path / tag)
        split = mod.split_image_tree(tree, "pacs", list_root, train_fraction=0.67, seed=2,
                                     tree_subdir="PACS/kfold")
        assert sorted(split) == sorted(DOMAINS)
        mod.filter_blank_images(list_root, "pacs", data_root=tree)
        outs[tag] = list_root
    files = _tree_files(outs["ours"])
    assert files == _tree_files(outs["theirs"]) and len(files) >= 8
    for rel in files:
        assert filecmp.cmp(os.path.join(outs["ours"], rel), os.path.join(outs["theirs"], rel),
                           shallow=False), rel


def test_reorganize_places_the_same_tree(tree, tmp_path):
    """Stylized variants (stand-ins: copies of the originals at the stylize
    stage's paths) and originals land at the same unified-tree paths."""
    import shutil

    roots = {}
    for tag, mod in (("ours", tlists), ("theirs", jlists)):
        root = str(tmp_path / tag)
        shutil.copytree(tree, root)
        for d in ("art_painting", "cartoon", "sketch"):
            names, _ = mod.parse_list(mod.train_list_path(root, "pacs", d))
            for rel in names:
                for style in ("art_painting", "cartoon", "sketch"):
                    if style == d:
                        continue
                    dst = os.path.join(root, mod.stylized_output_path(rel, d, style, "overall"))
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy(os.path.join(root, rel), dst)
        placed = mod.reorganize_unified_tree(root, "pacs", "photo", "overall", data_root=root)
        roots[tag] = (root, placed)
    assert roots["ours"][1] == roots["theirs"][1] > 0
    assert _tree_files(roots["ours"][0]) == _tree_files(roots["theirs"][0])


# ---- loader ---------------------------------------------------------------


@pytest.mark.parametrize("size,dtype", [(None, "float32"), (32, "float32"), (32, "uint8"),
                                        (48, "uint8")])
def test_load_image_equals_original(tree, size, dtype):
    path = os.path.join(tree, "PACS/kfold/photo/dog/img1.png")
    ours, theirs = tloader.load_image(path, size, dtype), jloader.load_image(path, size, dtype)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("ext", ["png", "bmp"])
@pytest.mark.parametrize("kind", ["float32", "uint8"])
def test_save_image_bytes_equal_original(tmp_path, monkeypatch, ext, kind):
    """The PIL path of both (the native encoder switched off in both)."""
    import ccst_tpu.native as jnative
    import ccst_tpu_torch.native as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    img = np.random.default_rng(1).random((20, 24, 3), dtype=np.float32) * 1.2 - 0.1
    if kind == "uint8":
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    ours, theirs = str(tmp_path / f"ours.{ext}"), str(tmp_path / f"theirs.{ext}")
    tloader.save_image_u8(img, ours)
    jloader.save_image_u8(img, theirs)
    assert filecmp.cmp(ours, theirs, shallow=False)
    np.testing.assert_array_equal(tloader.load_image(ours, dtype="uint8"),
                                  jloader.load_image(theirs, dtype="uint8"))


@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("pad_final", [True, False])
def test_image_batch_loader_batches_equal_original(tree, out_dtype, pad_final):
    names, labels = jlists.parse_list(os.path.join(tree, "txt_lists", "pacs", "sketch_train.txt"))
    paths = [os.path.join(tree, n) for n in names][:5]
    kw = dict(batch_size=2, image_size=32, backend="pil", out_dtype=out_dtype,
              pad_final=pad_final, num_workers=2)
    ours = list(tloader.ImageBatchLoader(paths, labels[:5], **kw))
    theirs = list(jloader.ImageBatchLoader(paths, labels[:5], **kw))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.valid == b.valid and a.paths == b.paths
        assert a.images.dtype == b.images.dtype
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_native_tier_is_the_ports_own():
    """Same source, built into the port's own directory at first use."""
    import ccst_tpu.native as jnative
    import ccst_tpu_torch.native as tnative

    here = os.path.dirname(os.path.abspath(tnative.__file__))
    assert tnative._SO == os.path.join(here, "libccst_io.so") and tnative._SO != jnative._SO
    for name in ("ccst_io.cpp", "Makefile"):
        assert os.path.exists(os.path.join(here, name))
    with open(os.path.join(here, "ccst_io.cpp")) as f, \
            open(os.path.join(os.path.dirname(jnative.__file__), "ccst_io.cpp")) as g:
        ours, theirs = f.read(), g.read()
    # the code is the original's; only the header comment names the new home
    assert ours[ours.index("#include"):] == theirs[theirs.index("#include"):]
    assert isinstance(tnative.available(), bool)


# ---- the CLI in a process of its own ---------------------------------------


def test_cli_runs_without_ccst_tpu_or_jax(tree, tmp_path):
    """style-bank and stylize --device cpu in a fresh interpreter, weights made
    by the port itself: neither jax nor ccst_tpu is ever imported."""
    import torch

    from ccst_tpu_torch.models import convert, vgg

    enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(42))
    dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(43))
    convert.save_npz(str(tmp_path / "enc.npz"), enc)
    convert.save_npz(str(tmp_path / "dec.npz"), dec)
    common = [
        "--dataset", "pacs", "--list-root", tree, "--data-root", tree,
        "--output-root", str(tmp_path / "out"), "--style-stats-dir", str(tmp_path / "stats"),
        "--image-size", "32", "--batch-size", "4", "--dtype", "float32",
        "--vgg-weights", str(tmp_path / "enc.npz"), "--decoder-weights", str(tmp_path / "dec.npz"),
        "--device", "cpu",
    ]
    code = (
        "import sys, json\n"
        "from ccst_tpu_torch.cli import main\n"
        f"rc = main({['style-bank', *common]!r})\n"
        f"rc += main({['stylize', *common, '--target', 'photo', '--mode', 'overall']!r})\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ccst_tpu'))\n"
        "print(json.dumps({'rc': rc, 'loaded': loaded}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}
    outs = _tree_files(str(tmp_path / "out" / "PACS" / "all_style_transferred_Overall" / "photo"))
    assert len(outs) == 6 * 3
    assert os.path.exists(str(tmp_path / "stats" / "pacs" / "sketch_mean_std.npz"))
