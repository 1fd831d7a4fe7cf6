"""Model registry (counterpart of ``nerf_downstream_tpu/models/__init__.py``:
the Res16UNet family, the ResNet classifiers and MinkowskiFCNN /
MinkowskiSplatFCNN).

``get_model`` and the ``Res16UNet`` factory are gin-configurable under the
reference's names and parameters, so ``get_model.name = "Res16UNet"`` and
``Res16UNet.PLANES = (...)`` bind as they do there.
"""

from __future__ import annotations

from nerf_downstream_tpu_torch import config as cfg


@cfg.configurable("Res16UNet")
def res16unet_factory(
    in_channel: int = 27,
    out_channel: int = 20,
    PLANES=(32, 48, 64, 96, 96, 96, 64, 64),
    DILATIONS=(1, 1, 1, 1, 1, 1, 1, 1),
    LAYERS=(2, 2, 2, 2, 2, 2, 2, 2),
    BLOCK="BasicBlock",
    NORM_TYPE="BN",
    nonlinearity="MinkowskiReLU",
    bn_momentum: float = 0.1,
    sparse_mode=(0,) * 9,
    **kwargs,
):
    """gin surface of the reference's Res16UNet constructor: the UPPERCASE
    hyperparameter names map onto the port's ``Res16UNet`` arguments."""
    from nerf_downstream_tpu_torch.models.mink.res16unet import Res16UNet

    # the port's own lowercase names, where a caller passes them, win
    block = kwargs.pop("block", BLOCK)
    block = block if isinstance(block, str) else block.__name__
    return Res16UNet(
        in_channel, out_channel,
        planes=tuple(kwargs.pop("planes", PLANES)),
        dilations=tuple(kwargs.pop("dilations", DILATIONS)),
        layers=tuple(kwargs.pop("layers", LAYERS)),
        block=block,
        norm_type=kwargs.pop("norm_type", NORM_TYPE),
        nonlinearity=nonlinearity,
        bn_momentum=bn_momentum,
        sparse_mode=tuple(sparse_mode),
        **kwargs,
    )


@cfg.configurable("get_model")
def get_model(name: str = "Res16UNet18A", in_channel: int = 27,
              out_channel: int = 20, sparse=None, **kwargs):
    """Build a Res16UNet, a ResNet or an FCNN by registry name.
    ``in_channel`` is required here (PyTorch sizes weights at
    construction; the reference infers it). ``sparse`` is the Res16UNet's
    nine-slot conv-mode list (``Res16UNet.sparse_mode``; None = dense).
    Other registry names raise (ROADMAP.md Queue 1 item 3c)."""
    from nerf_downstream_tpu_torch.models.mink import fcnn, res16unet, resnet

    if name in ("MinkowskiFCNN", "MinkowskiSplatFCNN"):
        return fcnn.make_fcnn(name, in_channel, out_channel, **kwargs)
    if name in resnet._VARIANTS:
        return resnet.make_resnet(name, in_channel, out_channel, **kwargs)
    if sparse is not None:
        kwargs["sparse_mode"] = tuple(sparse)
    if name == "Res16UNet":
        return res16unet_factory(in_channel, out_channel, **kwargs)
    if name in res16unet.VARIANTS:
        return res16unet.make_res16unet(name, in_channel, out_channel,
                                        **kwargs)
    raise NotImplementedError(
        f"model {name!r} is not ported (the Res16UNet family, the ResNets "
        "and the FCNNs only; ROADMAP.md Queue 1 item 3c)")
