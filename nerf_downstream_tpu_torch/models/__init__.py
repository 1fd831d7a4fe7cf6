"""Model registry (counterpart of ``nerf_downstream_tpu/models/__init__.py``):
every name the reference's ``_build`` builds: the Res16UNet family (with
Res16UNet50/101), the ResNet classifiers, MinkowskiFCNN /
MinkowskiSplatFCNN, EncodedRes16UNet(2), MinkowskiPointNet, the ResUNet2
family (and its ResUNet14/18/34 aliases of Res16UNet), and the dense
point models DGCNN_cls / DGCNN_semseg (and its alias DGCNN), PointNet,
PAConvPointNet and PAConvDGCNN.

``get_model``, the ``Res16UNet`` factory and the ``PAConvPointNet``
factory are gin-configurable under the reference's names and parameters,
so ``get_model.name = "Res16UNet"``, ``Res16UNet.PLANES = (...)`` and
``PAConvPointNet.k = 8`` bind as they do there.
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


# models over dense [B, N, C] clouds (``DensePointTask``'s input)
DENSE = ("DGCNN_cls", "DGCNN_semseg", "DGCNN", "PointNet", "PAConvPointNet",
         "PAConvDGCNN")


@cfg.configurable("get_model")
def get_model(name: str = "Res16UNet18A", in_channel: int = 27,
              out_channel: int = 20, sparse=None, **kwargs):
    """Build a model by registry name. ``in_channel`` is required here
    (PyTorch sizes weights at construction; the reference infers it).
    ``sparse`` is the Res16UNet's nine-slot conv-mode list
    (``Res16UNet.sparse_mode``; None = dense). The voxelization knobs a
    CLI passes (``ctx``, ``assume_unique``) are dropped for the models
    that voxelize nothing (the dense models, MinkowskiPointNet)."""
    from nerf_downstream_tpu_torch.models.mink import (
        encoding,
        fcnn,
        res16unet,
        resnet,
        resunet,
    )

    if name in DENSE or name == "MinkowskiPointNet":
        kwargs.pop("ctx", None)
        kwargs.pop("assume_unique", None)
    if name in ("MinkowskiFCNN", "MinkowskiSplatFCNN"):
        return fcnn.make_fcnn(name, in_channel, out_channel, **kwargs)
    if name in resnet._VARIANTS:
        return resnet.make_resnet(name, in_channel, out_channel, **kwargs)
    if name in ("EncodedRes16UNet", "EncodedRes16UNet2"):
        return encoding.EncodedRes16UNet(
            in_channel, out_channel,
            variant2=(name == "EncodedRes16UNet2"), **kwargs)
    if name in ("MinkowskiPointNet", "PointNet"):
        from nerf_downstream_tpu_torch.models.mink import pointnet

        return pointnet.make_pointnet(name, in_channel, out_channel, **kwargs)
    if name in ("DGCNN_cls", "DGCNN_semseg", "DGCNN"):
        from nerf_downstream_tpu_torch.models.mink import dgcnn

        return dgcnn.make_dgcnn(name, in_channel, out_channel, **kwargs)
    if name in ("PAConvPointNet", "PAConvDGCNN"):
        from nerf_downstream_tpu_torch.models import paconv

        return paconv.make_paconv(name, in_channel, out_channel, **kwargs)
    if name in resunet.NAMES:
        return resunet.make_resunet(name, in_channel, out_channel, **kwargs)
    if sparse is not None:
        kwargs["sparse_mode"] = tuple(sparse)
    if name == "Res16UNet":
        return res16unet_factory(in_channel, out_channel, **kwargs)
    if name in res16unet.VARIANTS:
        return res16unet.make_res16unet(name, in_channel, out_channel,
                                        **kwargs)
    raise ValueError(f"unknown model {name!r}")
