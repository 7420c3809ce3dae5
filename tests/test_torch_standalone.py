"""ccst_tpu_torch stands alone: it imports nothing of ccst_tpu and nothing of
JAX (nor flax, optax, triton or msgpack), and its own copies of the
framework-free modules (config with ``MeshConfig``, data.lists, data.loader,
data.digits, native, federated.data, pipeline.amp_bank, utils.metrics,
utils.plotting, utils.excel_log, ``StageTimer``, the Jigsaw permutation
asset) behave as the originals do. The worker that the
multi-process tests spawn (``tests/torch_multihost_worker.py``) is walked
with the package.

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
from tests.torch_parity import pinned_io_tier  # noqa: F401  (both packages read the same pixels)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_multihost_worker.py")]
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
            "ccst_tpu_torch/models/adain_net.py", "ccst_tpu_torch/pipeline/train_decoder.py",
            "ccst_tpu_torch/privacy/generator.py", "ccst_tpu_torch/privacy/lpips.py",
            "ccst_tpu_torch/privacy/invert.py", "ccst_tpu_torch/privacy/gan.py",
            "ccst_tpu_torch/utils/optim.py",
            "ccst_tpu_torch/data/lists.py", "ccst_tpu_torch/data/loader.py",
            "ccst_tpu_torch/native/__init__.py", "ccst_tpu_torch/pipeline/stylize.py",
            "ccst_tpu_torch/federated/runtime.py", "ccst_tpu_torch/federated/data.py",
            "ccst_tpu_torch/pipeline/amp_bank.py", "ccst_tpu_torch/utils/metrics.py",
            "ccst_tpu_torch/utils/checkpoint.py", "ccst_tpu_torch/models/classifiers.py",
            "ccst_tpu_torch/parallel/fed_mesh.py", "ccst_tpu_torch/parallel/multihost.py",
            "ccst_tpu_torch/federated/multihost_runtime.py", "ccst_tpu_torch/data/digits.py",
            "ccst_tpu_torch/parallel/spatial.py", "ccst_tpu_torch/parallel/tensor.py",
            "ccst_tpu_torch/utils/swa.py", "ccst_tpu_torch/utils/plotting.py",
            "ccst_tpu_torch/utils/excel_log.py", "ccst_tpu_torch/pipeline/repro.py",
            "ccst_tpu_torch/experiments/semantic_validation.py",
            "ccst_tpu_torch/experiments/privacy_leakage.py",
            "tests/torch_multihost_worker.py"} <= names


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_ccst_tpu_or_jax(path):
    # nor triton: every kernel of the port is CUDA C++ under csrc/; nor msgpack:
    # the card's machine has none (utils/checkpoint.py reads flax's msgpack itself);
    # nor the JAX project's experiments/ (the port keeps its own copies)
    banned = _imported_roots(path) & {"ccst_tpu", "jax", "jaxlib", "flax", "optax", "triton",
                                      "msgpack", "experiments"}
    assert not banned, f"{os.path.relpath(path, REPO)} imports {sorted(banned)}"


# ---- config ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["StylizeConfig", "FusionConfig", "FedConfig", "DatasetSpec",
                                  "MeshConfig"])
def test_config_dataclass_fields_and_defaults(name):
    def describe(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert describe(getattr(tconfig, name)) == describe(getattr(jconfig, name))


@pytest.mark.parametrize("name", sorted(jconfig.DATASETS))
def test_dataset_spec_equals_original(name):
    ours, theirs = tconfig.dataset_spec(name), jconfig.dataset_spec(name.upper())
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert sorted(tconfig.DATASETS) == sorted(jconfig.DATASETS)


def test_fed_config_properties_and_constants_equal_original():
    for target in ("photo", "sketch"):
        ours, theirs = tconfig.FedConfig(target=target), jconfig.FedConfig(target=target)
        assert ours.source_domains == theirs.source_domains
        assert dataclasses.asdict(ours.spec) == dataclasses.asdict(theirs.spec)
    assert (tconfig.IMAGENET_MEAN, tconfig.IMAGENET_STD) == (jconfig.IMAGENET_MEAN,
                                                            jconfig.IMAGENET_STD)


@pytest.mark.parametrize("sizes", [dict(), dict(client=3), dict(client=1, data=2, model=-1),
                                   dict(client=2, data=-1, model=2)])
@pytest.mark.parametrize("n_devices", [1, 4, 6, 8])
def test_mesh_config_axis_sizes_equal_original(sizes, n_devices):
    def sizes_of(mod):
        try:
            return mod.MeshConfig(**sizes).axis_sizes(n_devices)
        except ValueError as e:
            return f"ValueError: {e}"

    assert sizes_of(tconfig) == sizes_of(jconfig)


# the port's copies of the report modules: the originals' text with the port's
# imports and CLI name, and these edits of their docstrings
_REPORT_EDITS = {
    "plotting": [("TPU-native counterpart of the reference's", "Counterpart of the reference's")],
    "excel_log": [("(if openpyxl is installed —\nit is not in this image, so CSV is the default "
                   "artifact).", "(if openpyxl is installed; CSV\notherwise).")],
}


@pytest.mark.parametrize("name", sorted(_REPORT_EDITS))
def test_report_modules_equal_originals(name):
    with open(os.path.join(REPO, "ccst_tpu", "utils", f"{name}.py")) as f:
        theirs = f.read().replace("from ccst_tpu.", "from ccst_tpu_torch.").replace(
            "``ccst-tpu ", "``ccst-tpu-torch ")
    for old, new in _REPORT_EDITS[name]:
        assert old in theirs
        theirs = theirs.replace(old, new)
    with open(os.path.join(REPO, "ccst_tpu_torch", "utils", f"{name}.py")) as f:
        assert f.read() == theirs


def test_stage_timer_equals_original():
    import inspect

    import ccst_tpu.utils.profiling as jprof
    import ccst_tpu_torch.utils.profiling as tprof

    assert inspect.getsource(tprof.StageTimer) == inspect.getsource(jprof.StageTimer)


def test_digits_module_equals_original(tmp_path):
    """data/digits.py is the original's text with the port's loader imported."""
    import ccst_tpu.data.digits as jdig
    import ccst_tpu_torch.data.digits as tdig

    with open(jdig.__file__) as f:
        theirs = f.read().replace("from ccst_tpu.data.loader", "from ccst_tpu_torch.data.loader")
    with open(tdig.__file__) as f:
        assert f.read() == theirs
    assert tdig.OFFICE_CALTECH_LABELS == jdig.OFFICE_CALTECH_LABELS
    assert tdig.DOMAINNET_LABELS == jdig.DOMAINNET_LABELS
    imgs = (np.random.default_rng(0).random((5, 20, 20)) * 255).astype(np.uint8)
    labels = np.arange(5)
    ours = list(tdig.DigitsArrayLoader(imgs, labels, batch_size=2, image_size=28, shuffle=True))
    want = list(jdig.DigitsArrayLoader(imgs, labels, batch_size=2, image_size=28, shuffle=True))
    assert len(ours) == len(want) == 3
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.valid == b.valid


# ---- the experiments' pure functions ---------------------------------------


def test_experiment_domains_and_classes_equal_original():
    import ccst_tpu_torch.experiments.semantic_validation as tsv
    import experiments.semantic_validation as jsv

    assert (tsv.DOMAINS, tsv.CLASSES) == (jsv.DOMAINS, jsv.CLASSES)
    assert (tsv._FG_LUM, tsv._BG_LUM) == (jsv._FG_LUM, jsv._BG_LUM)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_image_tint_and_mask_equal_original(seed):
    """The same draws from the same generator give the same arrays, and leave
    the generators in the same state."""
    import ccst_tpu_torch.experiments.semantic_validation as tsv
    import experiments.semantic_validation as jsv

    ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for size in (32, 64, 17):
        for d in jsv.DOMAINS:
            for ci, cls in enumerate(jsv.CLASSES):
                np.testing.assert_array_equal(tsv._mask(cls, size, ours),
                                              jsv._mask(cls, size, theirs))
                np.testing.assert_array_equal(tsv._image_tint(d, ci, ours),
                                              jsv._image_tint(d, ci, theirs))
    assert ours.bit_generator.state == theirs.bit_generator.state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paired_orderings_equal_original(seed):
    """Random per-arm results over up to 5 seeds, some arms missing seeds or
    empty."""
    import ccst_tpu_torch.experiments.semantic_validation as tsv
    import experiments.semantic_validation as jsv

    rng = np.random.default_rng(seed)
    results = {
        arm: [{"seed": s, "test_acc": float(rng.integers(0, 41)) / 40, "round": 3}
              for s in sorted(rng.choice(5, size=rng.integers(0, 6), replace=False) + 1)]
        for arm in ("no_fusion", "bf16", "int8", "single")
    }
    assert tsv._paired_orderings(results) == jsv._paired_orderings(results)


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


# ---- the training stage's copies ------------------------------------------


@pytest.mark.parametrize("mode", ["fedavg", "deepall"])
def test_client_data_equals_original(tree, mode):
    """federated/data.py: the crc32-seeded val split, limit_data, the deepall
    pseudo-client and the uint8 batches of every loader."""
    import ccst_tpu.federated.data as jdata
    import ccst_tpu_torch.federated.data as tdata

    for d in DOMAINS:  # the test lists the target's loader reads
        src = os.path.join(tree, "txt_lists", "pacs", f"{d}_train.txt")
        dst = os.path.join(tree, "txt_lists", "pacs", f"{d}_test.txt")
        if not os.path.exists(dst):
            jlists.write_list(dst, *jlists.parse_list(src))
    kw = dict(dataset="pacs", target="photo", mode=mode, list_root=tree, data_root=tree,
              batch_size=2, image_size=24, val_size=0.34, limit_data=0.8, seed=3)
    ours, ours_test = tdata.build_client_data(tconfig.FedConfig(**kw))
    theirs, theirs_test = jdata.build_client_data(jconfig.FedConfig(**kw))
    assert [c.name for c in ours] == [c.name for c in theirs]
    pairs = [(a.train, b.train) for a, b in zip(ours, theirs)]
    pairs += [(a.val, b.val) for a, b in zip(ours, theirs)] + [(ours_test, theirs_test)]
    for a, b in zip(ours, theirs):
        assert (a.n_train, a.n_val) == (b.n_train, b.n_val)
    for la, lb in pairs:
        assert la.paths == lb.paths and list(la.labels) == list(lb.labels)
        for ba, bb in zip(la, lb):
            assert ba.images.dtype == bb.images.dtype == np.uint8
            np.testing.assert_array_equal(ba.images, bb.images)
            assert ba.valid == bb.valid


def test_amp_bank_equals_original(tree, tmp_path):
    import ccst_tpu.pipeline.amp_bank as jamp
    import ccst_tpu_torch.pipeline.amp_bank as tamp

    assert tamp.amp_path("PACS/kfold/photo/dog/a.jpg") == jamp.amp_path("PACS/kfold/photo/dog/a.jpg")
    for tag, mod in (("ours", tamp), ("theirs", jamp)):
        assert mod.compute_amp_bank(list_root=tree, data_root=tree, dataset="pacs",
                                    domain="cartoon", image_size=20,
                                    out_root=str(tmp_path / tag)) == 6
    files = _tree_files(str(tmp_path / "ours"))
    assert files == _tree_files(str(tmp_path / "theirs")) and len(files) == 6
    for rel in files:
        assert filecmp.cmp(str(tmp_path / "ours" / rel), str(tmp_path / "theirs" / rel),
                           shallow=False)
    kw = dict(max_per_domain=4, data_root=tree, image_size=20, seed=2)
    np.testing.assert_array_equal(tamp.load_amp_bank(tree, "pacs", ["cartoon", "sketch"], **kw),
                                  jamp.load_amp_bank(tree, "pacs", ["cartoon", "sketch"], **kw))


def test_metrics_logger_and_summaries_equal_original(tmp_path, capsys):
    import ccst_tpu.utils.metrics as jm
    import ccst_tpu_torch.utils.metrics as tm

    paths = {}
    for tag, mod in (("ours", tm), ("theirs", jm)):
        path = str(tmp_path / tag / "run.jsonl")
        logger = mod.MetricsLogger(path)
        for r, (val, test) in enumerate(((0.2, 0.5), (0.6, 0.4), (0.6, 0.9))):
            logger.log("round", round=r, val_acc_mean=val, test_acc=test)
        logger.log_histogram("w", np.arange(10.0), step=1, bins=4)
        logger.close()
        paths[tag] = path
    printed = capsys.readouterr().out.splitlines()
    assert printed[:3] == printed[3:]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "time"} for r in recs]
    assert strip(tm.read_rounds(paths["ours"])) == strip(jm.read_rounds(paths["theirs"]))
    assert tm.summarize_many([paths["ours"]], 3) == jm.summarize_many([paths["theirs"]], 3)
    assert tm.summarize_run(paths["ours"])["test_acc_at_best_val"] == 0.4


def test_jigsaw_permutations_are_the_ports_own_copy():
    import ccst_tpu.data.jigsaw as jjig
    import ccst_tpu_torch.data.jigsaw as tjig

    ours = os.path.join(os.path.dirname(tjig.__file__), "assets", "permutations_30.npy")
    theirs = os.path.join(os.path.dirname(jjig.__file__), "assets", "permutations_30.npy")
    assert ours != theirs and filecmp.cmp(ours, theirs, shallow=False)


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
