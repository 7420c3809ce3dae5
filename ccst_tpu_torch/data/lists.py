"""Dataset txt-lists and the CCST filesystem contract.

The reference pipeline's inter-stage "API" is a directory-naming convention
(SURVEY.md §1): stylize CLIs mirror the source tree under
``all_style_transferred_{Overall,Single}`` via string replacement
(CCST_OverallStyleTransfer.py:158-167), the reorganizer merges those into
``kfold_adain-{mode}-multi/{target}`` (data/reorganize_dataset.py:44-83), and
the K-list generator samples stylized variants into
``txt_lists/{dataset}_{style}-{mode}-K{K}/{target}/{client}_train.txt``
(data/data_list_generator.py:50-83). This module implements that contract
with explicit path algebra instead of blind ``str.replace``, fixes the
reference's append-mode duplication bug (data_list_generator.py:57), and
keeps outputs byte-compatible so reference tooling can read them.

List format: ``"<image_path> <int_label>"`` per line (data/ImageLoader.py:31).

The package's own copy of ``ccst_tpu/data/lists.py``, same names, same bytes
on disk.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ccst_tpu_torch.config import dataset_spec


def parse_list(path: str | Path) -> Tuple[List[str], List[int]]:
    """Parse a txt list into (paths, labels). Reference `_dataset_info`."""
    names: List[str] = []
    labels: List[int] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # rsplit: filenames may contain spaces (the reference's
            # split(' ') crashes on them; the byte format is unchanged)
            name, label = line.rsplit(" ", 1)
            names.append(name)
            labels.append(int(label))
    return names, labels


def write_list(path: str | Path, names: Sequence[str], labels: Sequence[int]) -> None:
    """Write a txt list (truncating — the reference's append-mode rerun bug is
    deliberately not reproduced)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for name, label in zip(names, labels):
            f.write(f"{name} {label}\n")


def train_list_path(
    list_root: str, dataset: str, domain: str, fusion_dir: Optional[str] = None,
    target: Optional[str] = None,
) -> str:
    """Path of a domain's train list.

    ``fusion_dir`` of None/"no_fusion" selects the plain per-dataset lists;
    otherwise lists live under ``txt_lists/{dataset}_{fusion_dir}/{target}/``
    (reference data/data_helper.py:70-76).
    """
    if fusion_dir in (None, "", "no_fusion"):
        return os.path.join(list_root, "txt_lists", dataset.lower(), f"{domain}_train.txt")
    assert target is not None
    return os.path.join(
        list_root, "txt_lists", f"{dataset.lower()}_{fusion_dir}", target,
        f"{domain}_train.txt",
    )


def test_list_path(list_root: str, dataset: str, domain: str) -> str:
    return os.path.join(list_root, "txt_lists", dataset.lower(), f"{domain}_test.txt")


# ---------------------------------------------------------------------------
# Stylized-output path rewriting (the stage-1 -> stage-2 contract)
# ---------------------------------------------------------------------------


def _replace_path_segment(path: str, old: str, new: str) -> str:
    """Replace the first whole path *segment* equal to ``old`` with ``new``.

    The reference rewrites paths with blind ``str.replace`` (e.g.
    CCST_OverallStyleTransfer.py:161-163), which corrupts output paths when a
    data root happens to contain the domain name as a substring (e.g.
    ``/data/photo_sets/...`` with target ``photo``). Matching only complete
    segments removes that failure mode while keeping the same contract.
    """
    parts = path.split(os.sep)
    for i, part in enumerate(parts):
        if part == old:
            parts[i] = new
            return os.sep.join(parts)
    raise ValueError(f"no {old!r} path segment to rewrite in {path!r}")


def stylized_output_path(
    content_path: str, target: str, style: str, mode: str,
    source_marker: str = "kfold",
) -> str:
    """Where the stylized copy of ``content_path`` is written.

    Mirrors CCST_OverallStyleTransfer.py:160-163 / CCST_SingleStyleTransfer.py:
    ``kfold`` -> ``all_style_transferred_{Overall|Single}``, the target-domain
    path segment gains a ``/{style}`` subdir, and the filename gains a
    ``_{style}`` suffix before the extension. Both rewrites match whole path
    segments only (see ``_replace_path_segment``).
    """
    tree = f"all_style_transferred_{mode.capitalize()}"
    out = _replace_path_segment(content_path, source_marker, tree)
    out = _replace_path_segment(out, target, f"{target}{os.sep}{style}")
    root, ext = os.path.splitext(out)
    return f"{root}_{style}{ext}"


def unified_original_path(
    content_path: str, target: str, style_family: str, mode: str,
    source_marker: str = "kfold",
) -> str:
    """Path of the *original* image's copy inside the unified training tree
    ``{source_marker}_{family}-{mode}-multi/{target}/...``
    (data/data_list_generator.py:60)."""
    tree = f"{source_marker}_{style_family}-{mode.lower()}-multi"
    return _replace_path_segment(
        content_path, source_marker, f"{tree}{os.sep}{target}"
    )


def unified_tree_path(
    content_path: str, target: str, style: str, style_family: str, mode: str,
    source_marker: str = "kfold",
) -> str:
    """Path of a stylized image inside the unified training tree, i.e. the
    unified original path with a ``_{style}`` filename suffix
    (data/data_list_generator.py:79)."""
    out = unified_original_path(
        content_path, target, style_family, mode, source_marker
    )
    root, ext = os.path.splitext(out)
    return f"{root}_{style}{ext}"


# ---------------------------------------------------------------------------
# K-list generation (stage 3)
# ---------------------------------------------------------------------------


def generate_k_lists(
    list_root: str,
    dataset: str,
    target: str,
    k: int,
    mode: str = "overall",
    style_family: str = "adain",
    seed: int = 1,
    out_root: Optional[str] = None,
    source_marker: str = "kfold",
    save_ext: str = "",
) -> Dict[str, str]:
    """Generate fusion-mode train lists for every source client.

    ``save_ext`` must match the stylize/reorganize stages' value when one
    was used, so the list entries carry the materialized extension.

    Reference semantics (data/data_list_generator.py:50-83): for each source
    client and each of its train images, sample K of the N-1 source domains
    *without replacement*; a draw of the client's own domain keeps the
    original path, any other domain points at the stylized variant in the
    unified tree. Deterministic under ``seed``.

    Returns {client: written list path}.
    """
    spec = dataset_spec(dataset)
    if target not in spec.domains:
        raise ValueError(f"{target!r} not a domain of {dataset}: {spec.domains}")
    sources = [d for d in spec.domains if d != target]
    if not 1 <= k <= len(sources):
        raise ValueError(f"K={k} out of range for {len(sources)} source domains")
    rng = np.random.default_rng(seed)
    out_root = out_root or list_root
    fusion_dir = f"{style_family}-{mode.lower()}-K{k}"
    written: Dict[str, str] = {}
    for client in sources:
        names, labels = parse_list(
            train_list_path(list_root, dataset, client)
        )
        out_names: List[str] = []
        out_labels: List[int] = []
        for name, label in zip(names, labels):
            choices = rng.choice(len(sources), size=k, replace=False)
            for ci in choices:
                style = sources[ci]
                if style == client:
                    # own-domain draw -> the original's copy in the unified
                    # tree, no style suffix (data_list_generator.py:71)
                    entry = unified_original_path(
                        name, target, style_family, mode,
                        source_marker=source_marker,
                    )
                else:
                    entry = unified_tree_path(
                        name, target, style, style_family, mode,
                        source_marker=source_marker,
                    )
                    if save_ext:  # stylized variants carry the save ext;
                        # originals keep theirs (reorganize copies them as-is)
                        entry = os.path.splitext(entry)[0] + save_ext
                out_names.append(entry)
                out_labels.append(label)
        path = train_list_path(
            out_root, dataset, client, fusion_dir=fusion_dir, target=target
        )
        write_list(path, out_names, out_labels)
        written[client] = path
    return written


def filter_blank_images(
    list_root: str,
    dataset: str,
    data_root: str = "",
    brightness_lo: float = 0.05,
    brightness_hi: float = 0.95,
    min_std: float = 0.02,
    sample_size: int = 64,
) -> Dict[str, str]:
    """Write ``{dataset}_discardBlackWhite`` train lists excluding
    near-blank images.

    The reference's single-mode stylize samples camelyon17 style images from
    pre-filtered ``camelyon17_discardBlackWhite`` lists to skip blank slide
    patches (CCST_SingleStyleTransfer.py:165-166) but does not ship the
    filter itself. This implements it: an image is kept iff its mean
    luminance is inside (brightness_lo, brightness_hi) and its pixel std
    exceeds ``min_std`` (computed on a cheap ``sample_size``-px thumbnail).

    Returns {domain: filtered list path}.
    """
    from ccst_tpu_torch.data.loader import load_image

    spec = dataset_spec(dataset)
    written: Dict[str, str] = {}
    out_ds = f"{dataset.lower()}_discardBlackWhite"
    for domain in spec.domains:
        src_list = train_list_path(list_root, dataset, domain)
        if not os.path.exists(src_list):
            continue
        names, labels = parse_list(src_list)
        keep_n: List[str] = []
        keep_l: List[int] = []
        for name, label in zip(names, labels):
            path = os.path.join(data_root, name) if data_root else name
            try:
                thumb = load_image(path, sample_size)
            except Exception:
                continue
            mean = float(thumb.mean())
            std = float(thumb.std())
            if brightness_lo < mean < brightness_hi and std > min_std:
                keep_n.append(name)
                keep_l.append(label)
        if names and not keep_n:
            raise IOError(
                f"filter-blank kept 0 of {len(names)} {domain} images — "
                "every decode failed or everything looked blank; check "
                "--data-root (a wrong root silently decodes nothing)"
            )
        out_path = os.path.join(
            list_root, "txt_lists", out_ds, f"{domain}_train.txt"
        )
        write_list(out_path, keep_n, keep_l)
        written[domain] = out_path
    return written


def split_image_tree(
    data_root: str,
    dataset: str,
    list_root: str,
    train_fraction: float = 0.8,
    seed: int = 1,
    tree_subdir: str = "",
) -> Dict[str, Tuple[str, str]]:
    """Walk ``{data_root}/{tree_subdir or dataset}/{domain}/{class}/img`` and
    write per-domain train/test txt lists with an ``train_fraction`` split
    (reference utils/split_data.py, which hardcodes OfficeHome and 80/20).

    Class -> label indices are assigned by sorted class-name order, stable
    across domains. Only image files (.jpg/.jpeg/.png/.bmp/.webp) are
    indexed — class folders often carry Thumbs.db/.DS_Store strays.
    Returns {domain: (train_list, test_list)} paths.

    Chaining note: the fusion stages (gen-lists/reorganize) locate images by
    the ``kfold`` path segment (reference layout); point ``tree_subdir`` at
    a ``.../kfold`` directory (e.g. ``PACS/kfold``) when the split output
    will feed them.
    """
    spec = dataset_spec(dataset)
    tree = os.path.join(data_root, tree_subdir or dataset)
    rng = np.random.default_rng(seed)
    # global class registry across domains (sorted for determinism)
    classes = sorted(
        {
            c
            for d in spec.domains
            if os.path.isdir(os.path.join(tree, d))
            for c in os.listdir(os.path.join(tree, d))
            if os.path.isdir(os.path.join(tree, d, c))
        }
    )
    class_idx = {c: i for i, c in enumerate(classes)}
    written: Dict[str, Tuple[str, str]] = {}
    for domain in spec.domains:
        droot = os.path.join(tree, domain)
        if not os.path.isdir(droot):
            continue
        names: List[str] = []
        labels: List[int] = []
        for cls in sorted(os.listdir(droot)):
            cdir = os.path.join(droot, cls)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                if os.path.splitext(fname)[1].lower() not in (
                    ".jpg", ".jpeg", ".png", ".bmp", ".webp"
                ):
                    continue
                names.append(os.path.relpath(os.path.join(cdir, fname), data_root))
                labels.append(class_idx[cls])
        order = rng.permutation(len(names))
        n_train = int(len(names) * train_fraction)
        pick = lambda ix: ([names[i] for i in ix], [labels[i] for i in ix])
        tr = pick(order[:n_train])
        te = pick(order[n_train:])
        tr_path = train_list_path(list_root, dataset, domain)
        te_path = test_list_path(list_root, dataset, domain)
        write_list(tr_path, *tr)
        write_list(te_path, *te)
        written[domain] = (tr_path, te_path)
    return written


def _place(src: str, dst: str, link: bool) -> bool:
    """Returns True when a file was materialized (False = already there)."""
    import shutil

    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.exists(dst):
        return False  # idempotent rerun (reference reorganize_dataset.py:67,73)
    if link:
        try:
            os.link(src, dst)
            return True
        except OSError:
            pass
    shutil.copy2(src, dst)
    return True


def reorganize_unified_tree(
    list_root: str,
    dataset: str,
    target: str,
    mode: str,
    style_family: str = "adain",
    source_marker: str = "kfold",
    link: bool = True,
    data_root: str = "",
    save_ext: str = "",
) -> int:
    """Materialize the unified training tree for a held-out ``target``.

    ``save_ext`` must match the stylize stage's ``--save-ext`` when one was
    used (stylize rewrites the output extension; without it here the
    stylized variants would be looked up under the original extension).

    For every source client's train-list image: place the original and each
    other source domain's stylized variant (produced by the stylize stage at
    ``stylized_output_path``) at their ``unified_*_path`` locations
    (reference data/reorganize_dataset.py:44-81). The reference copies files;
    we hardlink by default (same bytes, no disk duplication) with copy
    fallback. List-driven, so test images are excluded by construction
    (the reference excludes them by a hardcoded camelyon17 test-list check,
    reorganize_dataset.py:38-41,54). Returns the number of files placed.
    """
    spec = dataset_spec(dataset)
    sources = [d for d in spec.domains if d != target]
    root = data_root or list_root
    absolute = lambda p: p if os.path.isabs(p) else os.path.join(root, p)
    count = 0
    for client in sources:
        names, _ = parse_list(train_list_path(list_root, dataset, client))
        for name in names:
            count += _place(
                absolute(name),
                absolute(
                    unified_original_path(
                        name, target, style_family, mode, source_marker
                    )
                ),
                link,
            )
            for style in sources:
                if style == client:
                    continue
                src_rel = stylized_output_path(
                    name, client, style, mode, source_marker
                )
                dst_rel = unified_tree_path(
                    name, target, style, style_family, mode, source_marker
                )
                if save_ext:
                    src_rel = os.path.splitext(src_rel)[0] + save_ext
                    dst_rel = os.path.splitext(dst_rel)[0] + save_ext
                src = absolute(src_rel)
                if not os.path.exists(src):
                    raise FileNotFoundError(
                        f"stylized variant missing: {src} (run the stylize "
                        f"stage for content={client}, style={style} first; "
                        "pass the same --save-ext it used, if any)"
                    )
                count += _place(src, absolute(dst_rel), link)
    return count
