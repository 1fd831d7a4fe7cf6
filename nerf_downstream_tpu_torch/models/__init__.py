"""Model registry (counterpart of ``nerf_downstream_tpu/models/__init__.py``,
Res16UNet family only)."""

from __future__ import annotations


def get_model(name: str = "Res16UNet18A", in_channel: int = 27,
              out_channel: int = 20, sparse=None, **kwargs):
    """Build a Res16UNet by registry name. ``in_channel`` is required here
    (PyTorch sizes weights at construction; the reference infers it).
    ``sparse`` is the nine-slot conv-mode list (``Res16UNet.sparse_mode``;
    None = dense)."""
    from nerf_downstream_tpu_torch.models.mink import res16unet

    if sparse is not None:
        kwargs["sparse_mode"] = tuple(sparse)
    if name == "Res16UNet":
        return res16unet.Res16UNet(in_channel, out_channel, **kwargs)
    if name in res16unet.VARIANTS:
        return res16unet.make_res16unet(name, in_channel, out_channel,
                                        **kwargs)
    raise ValueError(f"model {name!r} is not ported (Res16UNet family only)")
