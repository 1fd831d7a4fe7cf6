"""Import checkpoints of the reference's PyTorch implementation
(MinkowskiEngine models trained with Lightning) into the port
(counterpart of ``nerf_downstream_tpu/train/torch_import.py``).

A Lightning checkpoint's ``state_dict`` of a Res16UNet (``MinkUNet``) or
a sparse ResNet classifier maps key by key onto the port's
``state_dict``; nothing is transposed:

- ME conv kernels are [K, Cin, Cout] with x-fastest offsets, the port's
  layout; ME keeps a kernel-volume-1 conv as [Cin, Cout], the port as
  [1, Cin, Cout];
- ME's BatchNorm wraps torch's as ``.bn``: its ``weight``, ``bias``,
  ``running_mean`` and ``running_var`` keep their names;
- the Lightning module's ``model.`` prefix is dropped, and so are
  ``num_batches_tracked`` and every key the port has no counterpart for.

``merge_into`` lays the mapped tensors over a model's own ``state_dict``
(a key missing from the checkpoint keeps the model's value; a shape that
differs raises). ``import_reference_checkpoint(path, model_name, model)``
does both. The checkpoint is read with ``torch.load(weights_only=True)``:
tensors and plain Python types only.

    from nerf_downstream_tpu_torch.models import get_model
    from nerf_downstream_tpu_torch.train.torch_import import (
        import_reference_checkpoint)
    model = get_model("Res16UNet34C", in_channel=3, out_channel=20)
    import_reference_checkpoint("epoch=99.ckpt", "Res16UNet34C", model)
"""

from __future__ import annotations

import re
from typing import Mapping

import torch

# the reference's sequential stem/encoder/decoder entries -> the port's
# conv-norm units (index 0 = the conv, 1 = its norm; conv0p1s1 holds two
# units)
_UNET_UNITS = {
    "conv0p1s1.0": ("conv0a", "conv"), "conv0p1s1.1": ("conv0a", "norm"),
    "conv0p1s1.3": ("conv0b", "conv"), "conv0p1s1.4": ("conv0b", "norm"),
    "conv1p1s2.0": ("conv1", "conv"), "conv1p1s2.1": ("conv1", "norm"),
    "conv2p2s2.0": ("conv2", "conv"), "conv2p2s2.1": ("conv2", "norm"),
    "conv3p4s2.0": ("conv3", "conv"), "conv3p4s2.1": ("conv3", "norm"),
    "conv4p8s2.0": ("conv4", "conv"), "conv4p8s2.1": ("conv4", "norm"),
    "convtr4p16s2.0": ("convtr4", "conv"),
    "convtr4p16s2.1": ("convtr4", "norm"),
    "convtr5p8s2.0": ("convtr5", "conv"), "convtr5p8s2.1": ("convtr5", "norm"),
    "convtr6p4s2.0": ("convtr6", "conv"), "convtr6p4s2.1": ("convtr6", "norm"),
    "convtr7p2s2.0": ("convtr7", "conv"), "convtr7p2s2.1": ("convtr7", "norm"),
}
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")
_BLOCK_SUB = {"downsample.0": "downsample.conv",
              "downsample.1": "downsample.norm"}


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a Lightning checkpoint (or a bare state
    dict) at ``path``, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckpt.get("state_dict", ckpt))


def _strip(sd: Mapping[str, torch.Tensor]) -> dict:
    """Drop the Lightning module's ``model.`` prefix and the BN counters."""
    return {(k[6:] if k.startswith("model.") else k): torch.as_tensor(v)
            for k, v in sd.items() if "num_batches_tracked" not in k}


def _kernel3d(t: torch.Tensor) -> torch.Tensor:
    return t[None] if t.ndim == 2 else t


def _block_entry(scope: str, sub: str, field: str, value):
    """(port key, tensor) of a residual block's conv, norm or shortcut
    entry, or None for a field the port has no counterpart for."""
    name = f"{scope}.{_BLOCK_SUB.get(sub, sub)}"
    if "conv" in name.rsplit(".", 1)[-1] and field == "kernel":
        return f"{name}.kernel", _kernel3d(value)
    if "norm" in name.rsplit(".", 1)[-1] and field in _BN_FIELDS:
        return f"{name}.{field}", value
    return None


def import_res16unet(sd: Mapping[str, torch.Tensor]) -> dict:
    """A reference Res16UNet ``state_dict`` as port keys -> tensors."""
    out = {}
    for key, value in _strip(sd).items():
        m = re.match(r"(conv(?:tr)?\d?p?\d*s?\d*\.\d)\.(?:bn\.)?(\w+)$", key)
        if m and m.group(1) in _UNET_UNITS:
            unit, part = _UNET_UNITS[m.group(1)]
            field = m.group(2)
            if part == "conv" and field == "kernel":
                out[f"{unit}.conv.kernel"] = _kernel3d(value)
            elif part == "norm" and field in _BN_FIELDS:
                out[f"{unit}.norm.{field}"] = value
            continue
        m = re.match(r"block(\d)\.(\d+)\.(conv\d|norm\d|downsample\.\d)\."
                     r"(?:bn\.)?(\w+)$", key)
        if m:
            bi, bj, sub, field = m.groups()
            hit = _block_entry(f"block{bi}.{bj}", sub, field, value)
            if hit is not None:
                out[hit[0]] = hit[1]
            continue
        if key in ("final.kernel", "final.bias"):
            out[key] = _kernel3d(value) if key.endswith("kernel") else value
    return out


def import_resnet(sd: Mapping[str, torch.Tensor]) -> dict:
    """A reference sparse-ResNet ``state_dict`` as port keys -> tensors
    (its 1x1 ``final`` conv [Cin, Cout] is the port's dense head)."""
    out = {}
    for key, value in _strip(sd).items():
        if key == "conv1.kernel":
            out[key] = _kernel3d(value)
        elif key.startswith("bn1.bn."):
            field = key.rsplit(".", 1)[-1]
            if field in _BN_FIELDS:
                out[f"norm.{field}"] = value
        elif key in ("final.kernel", "final.bias"):
            out[key] = value
        else:
            m = re.match(r"layer(\d)\.(\d+)\.(conv\d|norm\d|downsample\.\d)"
                         r"\.(?:bn\.)?(\w+)$", key)
            if m:
                li, bj, sub, field = m.groups()
                hit = _block_entry(f"layer{li}_block{bj}", sub, field, value)
                if hit is not None:
                    out[hit[0]] = hit[1]
    return out


def merge_into(model: torch.nn.Module, imported: Mapping[str, torch.Tensor]):
    """Load ``imported`` (port keys -> tensors) over ``model``'s own
    ``state_dict``, each in the type of the model's entry; keys the model
    lacks are ignored, a shape that differs raises. Returns ``model``."""
    state = model.state_dict()
    for key, value in imported.items():
        if key not in state:
            continue
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(value.shape)} "
                             f"vs {tuple(state[key].shape)}")
        state[key] = value.to(state[key].dtype)
    model.load_state_dict(state, strict=True)
    return model


def import_reference_checkpoint(path: str, model_name: str,
                                model: torch.nn.Module) -> torch.nn.Module:
    """Load the reference checkpoint at ``path`` into ``model``, a port
    model of the registry name ``model_name``."""
    sd = load_torch_state_dict(path)
    if "Res16UNet" in model_name or "MinkUNet" in model_name:
        imported = import_res16unet(sd)
    elif model_name.startswith("ResNet"):
        imported = import_resnet(sd)
    else:
        raise ValueError(f"no import mapping for {model_name!r}")
    return merge_into(model, imported)
