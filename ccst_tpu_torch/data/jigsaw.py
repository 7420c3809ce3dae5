"""Jigsaw puzzle machinery (3x3 tile permutation, 31-way order classes).

Counterpart of ``ccst_tpu/data/jigsaw.py`` (reference ``JigsawDataset``,
data/ImageLoader.py:88-136): images are cut into a 3x3 grid, the tiles are
shuffled by one of 30 fixed permutations (class 0 = unshuffled;
``bias_whole_image`` keeps most samples whole), and the model predicts the
permutation index beside the class.

The permutation table is the package's own copy of the reference's
``permutations_30.npy`` (``assets/``, byte for byte the JAX package's), loaded
as ``retrieve_permutations`` does (data/ImageLoader.py:102-106, the min == 1
rebase). The draw (:func:`sample_orders`, on the host from an explicit
``torch.Generator``) is split from the shuffle (:func:`tile_and_permute`, one
``torch.gather`` on the images' device, pure, so ``torch.func.vmap`` applies
one client's orders a slice; the JAX package's one-hot matmul was a workaround
for its compiler).
"""
from __future__ import annotations

import os
from functools import lru_cache
import numpy as np
import torch

GRID = 3
N_TILES = GRID * GRID

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


@lru_cache(maxsize=None)
def permutation_set(n_perms: int = 30, seed: int = 0) -> np.ndarray:
    """(n_perms, 9) int64 permutation table: the vendored asset where there is
    one (0-based), else a deterministic greedy max-min-Hamming set under
    ``seed`` (the JAX package's construction, step for step)."""
    asset = os.path.join(_ASSET_DIR, f"permutations_{n_perms}.npy")
    if seed == 0 and os.path.exists(asset):
        table = np.load(asset)
        if table.min() == 1:
            table = table - 1
        return table.astype(np.int64)
    rng = np.random.default_rng(seed)
    pool = np.array([rng.permutation(N_TILES) for _ in range(5000)])
    pool = np.unique(pool, axis=0)
    chosen = [pool[0]]
    for _ in range(n_perms - 1):
        dists = np.stack([np.sum(pool != c[None, :], axis=1) for c in chosen], axis=0)
        chosen.append(pool[int(dists.min(axis=0).argmax())])
    return np.stack(chosen)


def tile_and_permute(images: torch.Tensor, orders: torch.Tensor, perms: torch.Tensor
                     ) -> torch.Tensor:
    """Shuffle the 3x3 tiles of an (N, H, W, C) batch (H, W divisible by 3):
    tile t of the output is source tile ``perms[order - 1][t]``; order 0 keeps
    the image (ImageLoader.py:132-133)."""
    n, h, w, c = images.shape
    if h % GRID or w % GRID:
        raise ValueError(f"jigsaw needs H,W divisible by {GRID}, got {h}x{w}")
    th, tw = h // GRID, w // GRID
    tiles = (images.reshape(n, GRID, th, GRID, tw, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(n, N_TILES, th * tw * c))
    perms = perms.to(images.device, non_blocking=True)
    identity = torch.arange(N_TILES, device=images.device)[None, :]
    table = torch.cat([identity, perms], dim=0)  # (P + 1, 9)
    sel = table[orders.to(images.device, non_blocking=True)]  # (N, 9)
    shuffled = torch.gather(tiles, 1, sel[:, :, None].expand(-1, -1, tiles.shape[2]))
    return (shuffled.reshape(n, GRID, GRID, th, tw, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h, w, c))


def sample_orders(generator: torch.Generator, n: int, n_perms: int = 30,
                  bias_whole_image: float = 0.9) -> torch.Tensor:
    """(n,) int64 on the host: 0 with probability ``bias_whole_image``, else
    uniform over [0, n_perms] (ImageLoader.py:126-129)."""
    orders = torch.randint(0, n_perms + 1, (n,), generator=generator)
    whole = torch.rand((n,), generator=generator) < bias_whole_image
    return torch.where(whole, torch.zeros_like(orders), orders)
