"""Carry the 3D models' (Res16UNet, ResNet, FCNN, ResUNet2 and the point
models), the 2D models' and the fused ensemble's weights between the
reference's flax variable trees and the port's ``state_dict``.

The reference stores ``{"params": ..., "batch_stats": ...}`` as nested
dicts; its norms are auto-named ``<class>_<i>`` in creation order within
their module (a ``BasicBlock``'s shortcut norm is the third, a
``Bottleneck``'s the fourth; the instance-segmentation head's norm is a
Res16UNet's eleventh), the class being the norm type's
(``MaskedBatchNorm``, ``MinkInstanceNorm``, ``MinkLayerNorm`` or
``MinkPowerNorm``, each port norm's ``flax_name``). BatchNorm keeps
``mean`` and ``var`` in ``batch_stats``, PowerNorm ``running_phi``,
``iters`` (int32) and ``ema_gz``; IN and LN keep none. Conv kernels
keep the reference layout ``[K, Cin, Cout]`` with x-fastest offsets, and
the ResNet head flax's ``kernel [C, out]``, so no tensor is transposed. Trees are read as nested
dicts of numpy arrays (or anything ``np.asarray`` accepts).

Each model class names its family's path function (``flax_paths``;
``flax_layout`` reads it, with the norm class and the block type, and
``FlaxLayout()`` is a Res16UNet's or a ResNet's with BatchNorm). The
FCNNs (``models/mink/fcnn.py``) map by ``fcnn_flax_path``:
``mlp1.dense`` is ``mlp1/Dense_0`` and ``mlp1.norm``
``mlp1/MaskedBatchNorm_0``; a conv block ``convX.conv`` / ``convX.bn`` is
``convX_conv`` / ``convX_bn``; the heads keep their names, their flax
BatchNorms' ``scale``, ``bias``, ``mean`` and ``var`` their leaves.

The point models (``models/mink/dgcnn.py``, ``pointnet.py``,
``encoding.py``, ``models/paconv``) carry the reference's module names,
flax's automatic ones included (``conv1.Dense_0``, ``conv1.BatchNorm_0``,
``conv1.MaskedBatchNorm_0``), so their paths map one to one
(``point_flax_path``): a norm's ``weight``, ``running_mean`` and
``running_var`` are flax's ``scale``, ``mean`` and ``var``, a flax
BatchNorm's ``mean`` and ``var`` go to ``batch_stats``, and PAConv's
weight banks ``matrice<i>`` keep their [Cin, m * Cout] layout. An
EncodedRes16UNet's ``trunk.`` keys map as a Res16UNet's under ``trunk``.
ResUNet2 maps the same way but for its blocks' norms, which the
reference names by class in creation order
(``resunet_flax_path``); its top-level norms carry those names already.

The fused ensemble (``models/ensemble.py``) maps its branches under
``image`` and ``voxel`` as those families map (``ensemble_flax_path``),
and its heads and scalar ``fusion_alpha`` by name.

The 2D models (``models/image``: ``_ResNetBased`` and ``ViT``) carry the
reference's module names, so their paths map one to one
(``image_flax_path``): a ViT's ``blocks.<i>`` is ``block<i>`` and its
LayerNorms, attention and MLP take flax's automatic names; BatchNorm
``mean`` and ``var`` go to ``batch_stats``. Their conv kernels are
transposed between the port's OIHW and flax's HWIO; dense and attention
kernels keep flax's layouts (``[C, out]``, ``[dim, heads, head_dim]``,
``[heads, head_dim, dim]``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# conv-norm-act units of Res16UNet, in the order the reference creates
# their norms (<class>_0 .. _9; the insseg head's "offset" norm is _10)
UNITS = ("conv0a", "conv0b", "conv1", "conv2", "conv3", "conv4",
         "convtr4", "convtr5", "convtr6", "convtr7", "offset")
BN = "MaskedBatchNorm"
_NORM_LEAF = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
    "running_phi": ("batch_stats", "running_phi"),
    "iters": ("batch_stats", "iters"),
    "ema_gz": ("batch_stats", "ema_gz"),
}
_BLOCK_NORMS = ("norm1", "norm2", "norm3")


# layouts whose 4-d leaves are 2D conv kernels (OIHW here, HWIO in flax)
IMAGE_LAYOUTS = ("image", "ensemble")
# the ViT's module names that differ from the flax modules'
_IMAGE_NAMES = {"norm1": "LayerNorm_0", "norm2": "LayerNorm_1",
                "attn": "MultiHeadDotProductAttention_0", "mlp": "MlpBlock_0",
                "fc1": "Dense_0", "fc2": "Dense_1"}


def image_flax_path(key: str) -> tuple[str, ...]:
    """(collection, module..., leaf) of a 2D model's ``state_dict`` key."""
    p = key.split(".")
    if p[0] == "blocks":  # a ViT encoder block
        p = [f"block{p[1]}"] + [_IMAGE_NAMES.get(n, n) for n in p[2:]]
    elif p[0] == "norm":  # the ViT's last LayerNorm
        p = ["LayerNorm_0"] + p[1:]
    return ("batch_stats" if p[-1] in ("mean", "var") else "params", *p)


def norm_name(model: torch.nn.Module) -> str:
    """The flax class name of ``model``'s 3D norms (its ``flax_norm`` where
    it names one, as ResUNet2 does for its blocks' norms; BatchNorm's when
    it has none)."""
    if getattr(model, "flax_norm", None):
        return model.flax_norm
    for m in model.modules():
        name = getattr(type(m), "flax_name", None)
        if name is not None:
            return name
    return BN


_FLAX_BN_LEAF = {"scale": "params", "bias": "params", "mean": "batch_stats",
                 "var": "batch_stats"}


def fcnn_flax_path(key: str) -> tuple[str, ...]:
    """(collection, module..., leaf) of an FCNN's ``state_dict`` key."""
    p = key.split(".")
    if p[0] == "mlp1":
        if p[1] == "dense":
            return ("params", "mlp1", "Dense_0", p[2])
        coll, leaf = _NORM_LEAF[p[2]]
        return (coll, "mlp1", f"{BN}_0", leaf)
    if p[0].startswith("conv") and len(p) == 3:
        if p[1] == "conv":
            return ("params", f"{p[0]}_conv", p[2])
        coll, leaf = _NORM_LEAF[p[2]]
        return (coll, f"{p[0]}_bn", leaf)
    if p[0] in ("head1_bn", "head2_bn"):
        return (_FLAX_BN_LEAF[p[1]], p[0], p[1])
    if p[0] in ("head1", "head2", "final"):
        return ("params", p[0], p[1])
    raise KeyError(f"no flax counterpart for {key!r}")


def direct_flax_path(key: str) -> tuple[str, ...]:
    """(collection, module..., leaf) of a key whose modules carry the
    reference's names: only the norms' leaves are renamed."""
    p = key.split(".")
    if p[-1] in _NORM_LEAF:
        coll, leaf = _NORM_LEAF[p[-1]]
    else:
        coll, leaf = _FLAX_BN_LEAF.get(p[-1], "params"), p[-1]
    return (coll, *p[:-1], leaf)


def point_flax_path(key: str, bottleneck: bool = False,
                    norm: str = BN) -> tuple[str, ...]:
    """(collection, module..., leaf) of a point model's key; an
    EncodedRes16UNet's trunk maps as a Res16UNet (``flax_path``)."""
    if key.startswith("trunk."):
        coll, *rest = flax_path(key[len("trunk."):], bottleneck, norm)
        return (coll, "trunk", *rest)
    return direct_flax_path(key)


def resunet_flax_path(key: str, norm: str = BN) -> tuple[str, ...]:
    """(collection, module..., leaf) of a ResUNet2 key; ``norm`` is the
    flax class of its blocks' norms."""
    p = key.split(".")
    if p[0].startswith("block") and p[1] in _BLOCK_NORMS:
        coll, leaf = _NORM_LEAF[p[2]]
        return (coll, p[0], f"{norm}_{_BLOCK_NORMS.index(p[1])}", leaf)
    return direct_flax_path(key)


def ensemble_flax_path(key: str, bottleneck: bool = False,
                       norm: str = BN) -> tuple[str, ...]:
    """(collection, module..., leaf) of an ``Ensemble2D3D`` key: the image
    branch under ``image`` as a 2D model's, the voxel branch under
    ``voxel`` as a ResNet's, the heads and ``fusion_alpha`` as they are."""
    branch, _, rest = key.partition(".")
    if branch == "image":
        coll, *p = image_flax_path(rest)
        return (coll, "image", *p)
    if branch == "voxel":
        coll, *p = flax_path(rest, bottleneck, norm)
        return (coll, "voxel", *p)
    if branch in ("image_head", "head", "fusion_alpha"):
        return ("params", *key.split("."))
    raise KeyError(f"no flax counterpart for {key!r}")


class FlaxLayout(NamedTuple):
    """How a model's ``state_dict`` keys map to the reference's trees: the
    path function of its family (``paths``, the model class's
    ``flax_paths``: "image", "fcnn", "resunet", "point", "ensemble", or
    "sparse" for Res16UNet and ResNet), the flax class of its 3D norms
    (``norm_name``) and whether its blocks are ``Bottleneck``s (whose
    shortcut norm is the fourth)."""
    paths: str = "sparse"
    norm: str = BN
    bottleneck: bool = False


def flax_layout(model: torch.nn.Module) -> FlaxLayout:
    """``model``'s ``FlaxLayout``, from what its classes declare."""
    from nerf_downstream_tpu_torch.models.mink.blocks import Bottleneck

    return FlaxLayout(getattr(model, "flax_paths", "sparse"), norm_name(model),
                      any(isinstance(m, Bottleneck) for m in model.modules()))


def _paths(layout: FlaxLayout):
    """``key -> flax path`` for the keys of a model of ``layout``."""
    if layout.paths == "image":
        return image_flax_path
    if layout.paths == "fcnn":
        return fcnn_flax_path
    if layout.paths == "resunet":
        return lambda key: resunet_flax_path(key, layout.norm)
    if layout.paths == "point":
        return lambda key: point_flax_path(key, layout.bottleneck,
                                           layout.norm)
    if layout.paths == "ensemble":
        return lambda key: ensemble_flax_path(key, layout.bottleneck,
                                              layout.norm)
    if layout.paths != "sparse":
        raise ValueError(f"unknown flax layout {layout.paths!r}")
    return lambda key: flax_path(key, layout.bottleneck, layout.norm)


def flax_path(key: str, bottleneck: bool = False,
              norm: str = BN) -> tuple[str, ...]:
    """(collection, module..., leaf) of a port ``state_dict`` key;
    ``bottleneck`` when the model's blocks are ``Bottleneck``s, ``norm``
    the flax class name of its norms."""
    p = key.split(".")
    if p[0] == "conv1" and len(p) == 2:  # the ResNet stem conv
        return ("params", "conv1", p[1])
    if p[0] == "norm":  # the ResNet stem norm
        coll, leaf = _NORM_LEAF[p[1]]
        return (coll, f"{norm}_0", leaf)
    if p[0] in ("offset_conv1", "offset_conv2"):  # the insseg head
        return ("params", p[0], p[1])
    if p[0] == "offset_norm":
        coll, leaf = _NORM_LEAF[p[1]]
        return (coll, f"{norm}_{UNITS.index('offset')}", leaf)
    if p[0] in UNITS:
        if p[1] == "conv":
            return ("params", f"{p[0]}_conv", p[2])
        coll, leaf = _NORM_LEAF[p[2]]
        return (coll, f"{norm}_{UNITS.index(p[0])}", leaf)
    if p[0].startswith("block") or p[0].startswith("layer"):
        # Res16UNet blocks are block<i>.<j>, ResNet ones layer<i>_block<j>
        if p[0].startswith("block"):
            fb, rest = f"{p[0]}_{p[1]}", p[2:]
        else:
            fb, rest = p[0], p[1:]
        if rest[0] == "downsample":  # downsample.{conv,norm}.<leaf>
            if rest[1] == "conv":
                return ("params", fb, "downsample_conv", rest[2])
            coll, leaf = _NORM_LEAF[rest[2]]
            return (coll, fb, f"{norm}_{3 if bottleneck else 2}", leaf)
        if rest[0] in ("conv1", "conv2", "conv3"):
            return ("params", fb, rest[0], rest[1])
        coll, leaf = _NORM_LEAF[rest[1]]
        return (coll, fb, f"{norm}_{_BLOCK_NORMS.index(rest[0])}", leaf)
    if p[0] == "final":
        return ("params", "final", p[1])
    raise KeyError(f"no flax counterpart for {key!r}")


def flax_to_state_dict(model: torch.nn.Module,
                       variables: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of ``model`` filled from the reference's
    ``{"params", "batch_stats"}`` trees. A params-only tree (no
    ``"params"`` key at the top, such as a gradient tree) gives the
    parameters alone."""
    if "params" not in variables:
        variables = {"params": variables}
        keys = [k for k, _ in model.named_parameters()]
    else:
        keys = list(model.state_dict())
    refs = model.state_dict()
    layout = flax_layout(model)
    path_of = _paths(layout)
    image = layout.paths in IMAGE_LAYOUTS
    out = {}
    for key in keys:
        ref = refs[key]
        node = variables
        for name in path_of(key):
            node = node[name]
        arr = np.asarray(node, dtype=(np.int32 if ref.dtype == torch.int32
                                      else np.float32))
        if image and arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(arr.copy())
    return out


def load_flax_variables(model: torch.nn.Module, variables: dict):
    """Load the reference's variable trees into ``model`` (strict)."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model


def state_dict_to_flax(state: dict,
                       layout: FlaxLayout = FlaxLayout()) -> dict:
    """The reference's ``{"params", "batch_stats"}`` trees (nested dicts of
    float32 numpy arrays, int32 for PowerNorm's ``iters``) of a port
    ``state_dict`` (or of any mapping from its keys to tensors, such as
    parameter gradients) of a model of ``layout`` (``flax_layout(model)``;
    the default is a Res16UNet's or a ResNet's with BatchNorm and
    ``BasicBlock``s)."""
    tree: dict = {}
    path_of = _paths(layout)
    image = layout.paths in IMAGE_LAYOUTS
    for key, value in state.items():
        path = path_of(key)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        # a copy: the tree must not change when the module updates its
        # buffers in place
        dt = torch.int32 if value.dtype == torch.int32 else torch.float32
        arr = value.detach().to("cpu", dt).numpy().copy()
        if image and arr.ndim == 4:  # OIHW -> HWIO
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        node[path[-1]] = arr
    return tree


def init_flax_variables(model: torch.nn.Module, seed: int) -> dict:
    """Random variables for ``model`` in the reference's tree layout, from
    ``seed``: He-normal conv kernels (fan-in K * Cin, or kh * kw * Cin for
    a 2D conv, drawn in flax's HWIO), a dense head's
    kernel normal over fan-in C, norm scale, bias and running statistics
    drawn near identity so every norm does work (PowerNorm's ``iters``
    0, its ``ema_gz`` small).
    """
    rng = np.random.default_rng(seed)
    tree: dict = {}
    state = model.state_dict()
    layout = flax_layout(model)
    path_of = _paths(layout)
    for key, ref in state.items():
        path = path_of(key)
        shape = tuple(ref.shape)
        leaf = path[-1]
        if layout.paths in IMAGE_LAYOUTS and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])  # HWIO
        if leaf.startswith("matrice"):  # PAConv's bank [Cin, m * Cout]
            arr = rng.normal(size=shape) * np.sqrt(2.0 / shape[0])
        elif leaf == "kernel" and len(shape) == 2:
            arr = rng.normal(size=shape) * np.sqrt(1.0 / shape[0])
        elif leaf == "kernel" and len(shape) == 4:  # a 2D conv, HWIO
            arr = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif leaf == "kernel":
            arr = rng.normal(size=shape) * np.sqrt(2.0 / (shape[0] * shape[1]))
        elif leaf == "scale":
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("var", "running_phi"):
            arr = rng.uniform(0.5, 2.0, shape)
        elif leaf == "iters":
            arr = np.zeros(shape, np.int32)
        else:  # bias, mean, ema_gz
            arr = rng.normal(size=shape) * 0.1
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[leaf] = arr.astype(np.int32 if leaf == "iters" else np.float32)
    return tree
