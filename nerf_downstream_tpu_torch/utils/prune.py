"""Pruning utilities (counterpart of ``nerf_downstream_tpu/utils/prune.py``).

They work on the reference's variable trees (nested dicts of numpy arrays,
as ``train/checkpoints.py`` reads them). A tree path joined with ``/`` names
a module the way the reference's flax modules name themselves, for example
``block4_0/conv1`` or ``conv4_conv``; ``SparseConv.path`` holds the same
string (from ``convert.flax_path``), so a conv finds its own entry in the
maps below. Masks mirror conv kernels and are keyed by the kernel's path
(``block4_0/conv1/kernel``).
"""

from __future__ import annotations

import numpy as np

from nerf_downstream_tpu_torch.ops.weight_sparse import (
    block_live_from_weights,
    valid_offsets_from_weights,
)


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    """{path tuple: leaf} of a nested dict, in key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = leaf
    return tree


def _conv_kernels(params):
    """(path, array) of every [K, Cin, Cout] conv kernel with K > 1."""
    for path, leaf in flatten(params).items():
        arr = np.asarray(leaf)
        if path[-1] == "kernel" and arr.ndim == 3 and arr.shape[0] > 1:
            yield path, arr


def count_parameters_tree(params) -> dict:
    """{"total": N, "pruned": exact zeros in kernels}."""
    total = pruned = 0
    for path, leaf in flatten(params).items():
        arr = np.asarray(leaf)
        total += int(arr.size)
        if path[-1] == "kernel":
            pruned += int(np.sum(arr == 0))
    return {"total": total, "pruned": pruned}


def magnitude_prune(params, amount: float):
    """Zero the smallest-|w| ``amount`` fraction of every conv kernel;
    returns (pruned_params, masks)."""
    flat = flatten(params)
    masks = {}
    for path, leaf in flat.items():
        w = np.asarray(leaf)
        if not (path[-1] == "kernel" and w.ndim == 3):
            continue
        k = int(w.size * amount)
        if k == 0:
            mask = np.ones_like(w, bool)
        else:
            ths = np.partition(np.abs(w).ravel(), k - 1)[k - 1]
            mask = np.abs(w) > ths
            flat[path] = w * mask
        masks["/".join(path)] = mask
    return unflatten(flat), masks


def apply_masks(params, masks: dict):
    """Multiply stored masks onto their kernels."""
    flat = flatten(params)
    for path, leaf in flat.items():
        key = "/".join(path)
        if key in masks:
            arr = np.asarray(leaf)
            flat[path] = arr * np.asarray(masks[key]).astype(arr.dtype)
    return unflatten(flat)


def fold_pruning_masks(params, masks: dict | None) -> tuple[dict, dict]:
    """Fold checkpoint-carried masks into the weights (the pruning made
    permanent). With no masks this returns ``params`` as they are."""
    if not masks:
        return params, {}
    return apply_masks(params, masks), {"folded": len(masks)}


def pruned_offsets_map(params) -> dict:
    """{conv module path -> live offset tuple} of the conv kernels
    (K > 1) where pruning killed some, but not all, offsets."""
    out = {}
    for path, arr in _conv_kernels(params):
        live = valid_offsets_from_weights(arr)
        if 0 < len(live) < arr.shape[0]:
            out["/".join(path[:-1])] = live
    return out


def block_live_map(params, block: int = 128) -> dict:
    """{conv module path -> bool[K, nbi, nbo]} weight-block liveness at
    granularity ``block``, for the conv kernels (K > 1) with more than one
    block per matrix and at least one dead block."""
    out = {}
    for path, arr in _conv_kernels(params):
        live = block_live_from_weights(arr, block=block)
        if live[:, 0, 0].size and live.size > live.shape[0] and (
            not live.all()
        ):
            out["/".join(path[:-1])] = live
    return out


def parse_sparse_mode(sparsify: bool, sparse_mode: str) -> list[int]:
    """The nine conv modes: as given with ``--sparsify`` (nine positive
    values), else all dense."""
    if not sparsify:
        return [0] * 9
    modes = [int(n) for n in sparse_mode.split(",")]
    assert len(modes) == 9, "sparse mode should have length 9."
    assert 0 not in modes, (
        "sparse_mode should be positive when sparsify is on.")
    return modes


def derive_maps(params: dict, sparse_mode, layout: str,
                granularity: int = 128) -> tuple[dict | None, dict | None]:
    """(valid_offsets_map, block_live_map) of a pruned parameter tree for
    the mode-1 convs: the live offsets of every conv, and with layout csr
    or coo the live weight blocks at ``granularity`` (None where empty)."""
    vmap = bmap = None
    if 1 in list(sparse_mode):
        vmap = pruned_offsets_map(params) or None
        if vmap:
            print("pruned offset map:", {k: len(v) for k, v in vmap.items()})
        if layout in ("csr", "coo"):
            bmap = block_live_map(params, block=granularity) or None
            if bmap:
                print("block-live map:", {k: f"{int(v.sum())}/{v.size}"
                                          for k, v in bmap.items()})
    return vmap, bmap
