"""Dataset registry (counterpart of ``nerf_downstream_tpu/data/datasets.py``).

The reference's nine datasets: ``ScannetDataset``,
``PlenoxelScannetDataset``, the three CO3D classification readers,
ModelNet40 (``ModelNet40H5Dataset`` and its alias ``ModelNet40H5``),
``SemanticKITTIDataset`` and ``StanfordDataset``.
"""

from __future__ import annotations

from nerf_downstream_tpu_torch import config as cfg


def _table():
    from nerf_downstream_tpu_torch.data import (
        co3d,
        modelnet40,
        scannet,
        semantic_kitti,
        stanford,
    )

    return {
        "ModelNet40H5": modelnet40.ModelNet40H5,
        "ModelNet40H5Dataset": modelnet40.ModelNet40H5Dataset,
        "Co3DDataset": co3d.Co3DDataset,
        "Co3D10pDataset": co3d.Co3D10pDataset,
        "Co3DDatasetBase": co3d.Co3DDatasetBase,
        "ScannetDataset": scannet.ScannetDataset,
        "PlenoxelScannetDataset": scannet.PlenoxelScannetDataset,
        "SemanticKITTIDataset": semantic_kitti.SemanticKITTIDataset,
        "StanfordDataset": stanford.StanfordDataset,
    }


@cfg.configurable("get_dataset")
def get_dataset(dataset_name: str = "Co3DDataset"):
    table = _table()
    if dataset_name not in table:
        raise ValueError(
            f"unknown dataset {dataset_name!r}; available: {sorted(table)}"
        )
    return table[dataset_name]
