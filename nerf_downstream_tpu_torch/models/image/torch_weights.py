"""ImageNet-pretrained weight import for the 2D models (counterpart of
``nerf_downstream_tpu/models/image/torch_weights.py``).

``convert_torchvision_resnet`` and ``convert_timm_vit`` turn a
torchvision ResNet/ResNeXt/WideResNet or timm ViT/DeiT3 ``state_dict``
(already on disk: nothing is downloaded) into the reference's flax trees,
and ``save_converted`` writes them as one ``.npz`` into the pretrained
store, in the JAX package's layout, so one store serves both packages.
``pretrained=True`` configs load it at state creation
(``apply_pretrained``, which carries the trees into the port's model
through ``convert.py``). Heads are never imported: the reference replaces
them with fresh task heads.

Store location: ``$NDT_PRETRAINED_DIR`` or ``~/.cache/nerf_downstream_tpu/
pretrained``.
"""

from __future__ import annotations

import logging
import os

import numpy as np


def pretrained_store_dir() -> str:
    return os.environ.get(
        "NDT_PRETRAINED_DIR",
        os.path.expanduser("~/.cache/nerf_downstream_tpu/pretrained"),
    )


def pretrained_path(arch: str) -> str:
    return os.path.join(pretrained_store_dir(), f"{arch}.npz")


def _t_conv(w):
    """torch conv [out, in(/groups), kh, kw] -> flax [kh, kw, in(/g), out]."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _np(sd, k):
    v = sd[k]
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_torchvision_resnet(sd: dict, arch: str):
    """torchvision ResNet/ResNeXt/WideResNet state_dict -> flax trees.

    Returns (params, batch_stats) for the ``ResNet2D`` backbone (the
    ``model`` submodule of ``_ResNetBased``); the fc head is skipped.
    Key map: ``layerL.i.convN.weight`` -> ``layerL_i/convN/kernel``,
    ``.bnN.{weight,bias}`` -> ``bnN/{scale,bias}``,
    ``.downsample.{0,1}`` -> ``downsample_{conv,bn}``,
    running stats -> the batch_stats collection.
    """
    from nerf_downstream_tpu_torch.models.image.resnet2d import RESNET_SPECS

    spec = RESNET_SPECS[arch]
    params: dict = {}
    stats: dict = {}

    def put_bn(dst: str, src: str):
        params[dst] = {
            "scale": _np(sd, f"{src}.weight"),
            "bias": _np(sd, f"{src}.bias"),
        }
        stats[dst] = {
            "mean": _np(sd, f"{src}.running_mean"),
            "var": _np(sd, f"{src}.running_var"),
        }

    params["conv1"] = {"kernel": _t_conv(_np(sd, "conv1.weight"))}
    put_bn("bn1", "bn1")
    n_convs = 2 if spec["block"] == "basic" else 3
    for stage, n in enumerate(spec["layers"]):
        for i in range(n):
            src = f"layer{stage + 1}.{i}"
            dst = f"layer{stage + 1}_{i}"
            blk: dict = {}
            for c in range(1, n_convs + 1):
                blk[f"conv{c}"] = {
                    "kernel": _t_conv(_np(sd, f"{src}.conv{c}.weight"))
                }
            params[dst] = blk
            bstats: dict = {}
            for c in range(1, n_convs + 1):
                blk[f"bn{c}"] = {
                    "scale": _np(sd, f"{src}.bn{c}.weight"),
                    "bias": _np(sd, f"{src}.bn{c}.bias"),
                }
                bstats[f"bn{c}"] = {
                    "mean": _np(sd, f"{src}.bn{c}.running_mean"),
                    "var": _np(sd, f"{src}.bn{c}.running_var"),
                }
            if f"{src}.downsample.0.weight" in sd:
                blk["downsample_conv"] = {
                    "kernel": _t_conv(_np(sd, f"{src}.downsample.0.weight"))
                }
                blk["downsample_bn"] = {
                    "scale": _np(sd, f"{src}.downsample.1.weight"),
                    "bias": _np(sd, f"{src}.downsample.1.bias"),
                }
                bstats["downsample_bn"] = {
                    "mean": _np(sd, f"{src}.downsample.1.running_mean"),
                    "var": _np(sd, f"{src}.downsample.1.running_var"),
                }
            stats[dst] = bstats
    return params, stats


def convert_timm_vit(sd: dict, arch: str):
    """timm ViT/DeiT3 state_dict -> flax params for ``ViT`` (head skipped).

    qkv fusion is split into flax MultiHeadDotProductAttention's
    query/key/value DenseGenerals ([dim, heads, head_dim]); DeiT3 LayerScale
    gammas map to ls1/ls2.
    """
    from nerf_downstream_tpu_torch.models.image.vit import VIT_SPECS

    spec = VIT_SPECS[arch]
    dim, depth, heads = spec["dim"], spec["depth"], spec["heads"]
    hd = dim // heads
    params: dict = {
        "patch_embed": {
            "kernel": _t_conv(_np(sd, "patch_embed.proj.weight")),
            "bias": _np(sd, "patch_embed.proj.bias"),
        },
        "cls_token": _np(sd, "cls_token"),
        "pos_embed": _np(sd, "pos_embed"),
        "LayerNorm_0": {
            "scale": _np(sd, "norm.weight"),
            "bias": _np(sd, "norm.bias"),
        },
    }

    def split_qkv(w, b):
        # timm qkv.weight [3*dim, dim]: rows are outputs (q, k, v stacked)
        w = w.reshape(3, dim, dim)
        b = b.reshape(3, dim)
        out = []
        for j in range(3):
            # torch Linear y = x W^T: W[out, in] -> flax kernel [in, out]
            k = np.ascontiguousarray(w[j].T).reshape(dim, heads, hd)
            out.append((k, b[j].reshape(heads, hd)))
        return out

    for i in range(depth):
        src = f"blocks.{i}"
        (qk, qb), (kk, kb), (vk, vb) = split_qkv(
            _np(sd, f"{src}.attn.qkv.weight"), _np(sd, f"{src}.attn.qkv.bias")
        )
        proj_w = _np(sd, f"{src}.attn.proj.weight")  # [dim, dim]
        blk = {
            "LayerNorm_0": {
                "scale": _np(sd, f"{src}.norm1.weight"),
                "bias": _np(sd, f"{src}.norm1.bias"),
            },
            "MultiHeadDotProductAttention_0": {
                "query": {"kernel": qk, "bias": qb},
                "key": {"kernel": kk, "bias": kb},
                "value": {"kernel": vk, "bias": vb},
                "out": {
                    "kernel": np.ascontiguousarray(proj_w.T).reshape(
                        heads, hd, dim
                    ),
                    "bias": _np(sd, f"{src}.attn.proj.bias"),
                },
            },
            "LayerNorm_1": {
                "scale": _np(sd, f"{src}.norm2.weight"),
                "bias": _np(sd, f"{src}.norm2.bias"),
            },
            "MlpBlock_0": {
                "Dense_0": {
                    "kernel": np.ascontiguousarray(
                        _np(sd, f"{src}.mlp.fc1.weight").T
                    ),
                    "bias": _np(sd, f"{src}.mlp.fc1.bias"),
                },
                "Dense_1": {
                    "kernel": np.ascontiguousarray(
                        _np(sd, f"{src}.mlp.fc2.weight").T
                    ),
                    "bias": _np(sd, f"{src}.mlp.fc2.bias"),
                },
            },
        }
        if f"{src}.ls1.gamma" in sd:  # DeiT3 LayerScale
            blk["ls1"] = _np(sd, f"{src}.ls1.gamma")
            blk["ls2"] = _np(sd, f"{src}.ls2.gamma")
        params[f"block{i}"] = blk
    return params


def _flatten(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def save_converted(arch: str, params: dict, batch_stats: dict | None,
                   path: str | None = None) -> str:
    """Flatten and save converted trees as one npz (keys
    ``params/<path>`` and ``batch_stats/<path>``)."""
    path = path or pretrained_path(arch)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(params, "params")
    if batch_stats:
        flat.update(_flatten(batch_stats, "batch_stats"))
    np.savez(path, **flat)
    return path


def load_converted(arch: str, path: str | None = None):
    """Load a converted npz -> (params, batch_stats) trees, or None."""
    path = path or pretrained_path(arch)
    if not os.path.exists(path):
        return None
    trees: dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for k in data.files:
            coll, *names = k.split("/")
            node = trees[coll]
            for name in names[:-1]:
                node = node.setdefault(name, {})
            node[names[-1]] = data[k]
    return trees["params"], trees["batch_stats"]


def apply_pretrained(model, arch: str, submodule: str | None):
    """Load the stored pretrained weights of ``arch`` into ``model`` (in
    place) and return it.

    ``submodule`` is the backbone's name inside the model ("model" for
    ``_ResNetBased``, None for ``ViT``, whose backbone sits at the root
    with only the head left fresh). Every stored leaf must name a leaf of
    the model with its shape. Without a store entry the model is returned
    unchanged with a warning, as the reference's is.
    """
    from nerf_downstream_tpu_torch import convert

    loaded = load_converted(arch)
    if loaded is None:
        logging.warning(
            f"pretrained=True for {arch!r} but no converted weights at "
            f"{pretrained_path(arch)}; convert a state_dict once with "
            "convert_torchvision_resnet / convert_timm_vit and "
            "save_converted. Training from scratch.")
        return model

    def merge(dst, src, where):
        for k, v in src.items():
            if k not in dst:
                raise KeyError(f"pretrained key {where}/{k} not in model")
            if isinstance(v, dict):
                merge(dst[k], v, f"{where}/{k}")
            elif tuple(dst[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch at {where}/{k}: model "
                    f"{dst[k].shape} vs pretrained {v.shape}")
            else:
                dst[k] = np.asarray(v, np.float32)

    tree = convert.state_dict_to_flax(model.state_dict(),
                                      convert.flax_layout(model))
    for coll, src in zip(("params", "batch_stats"), loaded):
        if not src:
            continue
        dst = tree.setdefault(coll, {})
        if submodule is not None:
            dst, coll = dst[submodule], f"{coll}/{submodule}"
        merge(dst, src, coll)
    sd = convert.flax_to_state_dict(model, tree)
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    logging.info(f"loaded pretrained {arch} weights from the local store")
    return model
