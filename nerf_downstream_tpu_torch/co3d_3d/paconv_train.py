"""PAConv's ModelNet40 trainer (counterpart of ``co3d_3d/paconv_train.py``).

    python -m nerf_downstream_tpu_torch.co3d_3d.paconv_train \\
        --model PAConvDGCNN --data_root <modelnet40_ply_hdf5_2048> \\
        --save_path experiments/paconv

takes the reference's arguments (``--ginc --ginb --model --data_root
--batch_size --val_batch_size --epochs --lr --weight_decay --num_points
--workers --seed --save_path --devices``) and trains a model over dense
[B, N, 3] clouds (``PAConvPointNet``, ``PAConvDGCNN``, ``DGCNN_cls``,
``PointNet``; the model's knobs through ``get_model.*`` bindings) on
``ModelNet40H5Dataset``: SGD with momentum 0.9, cosine lr, ``--epochs``
epochs of drop-last batches, a validation pass on the test files after
each epoch, the best checkpoint by ``val/acc1``, and a last pass of the
best checkpoint, whose metrics ``main`` returns. Outputs go into
``save_path``: ``paconv/metrics.csv``, ``last.ckpt`` and ``best.ckpt`` in
the reference's msgpack layout.

The port adds ``--device`` (``cuda`` by default, which raises without a
GPU; ``cpu`` runs on the host), ``--max_steps`` (where the run stops;
default: steps per epoch x epochs, which the cosine schedule spans
either way) and ``--resume`` (go on from
``save_path/last.ckpt``: weights, momentum and step). A fresh model is
initialised from ``--seed`` with the reference's distributions
(``train.modules.init_variables``); ``ClassificationTraining.load_weights``
and ``.checkpoint_path`` bindings start it from a checkpoint instead, as
in the reference. ``--devices`` above 1 raises (ROADMAP.md Queue 1 item
4).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from nerf_downstream_tpu_torch import config as gin
from nerf_downstream_tpu_torch.co3d_3d.train import seed_everything
from nerf_downstream_tpu_torch.data.datasets import get_dataset
from nerf_downstream_tpu_torch.data.utils import collate_pointnet
from nerf_downstream_tpu_torch.device import resolve_device
from nerf_downstream_tpu_torch.models import get_model
from nerf_downstream_tpu_torch.train.loggers import get_logger
from nerf_downstream_tpu_torch.train.loop import Trainer
from nerf_downstream_tpu_torch.train.modules import (
    ClassificationTraining,
    init_variables,
)


class PointCloudDM:
    """Dense [B, N, 3] batches: train batches in the order of a numpy
    ``default_rng(seed)`` permutation per epoch, the last partial batch
    dropped; validation batches in file order, likewise drop-last."""

    def __init__(self, dataset_cls, batch_size, val_batch_size, num_workers,
                 seed=0):
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size
        self.num_workers = num_workers
        self.rng = np.random.default_rng(seed)
        self._cls = dataset_cls
        self._ds = {}

    def dataset(self, phase):
        if phase not in self._ds:
            self._ds[phase] = self._cls(phase=phase)
        return self._ds[phase]

    def _collate(self, ds, idxs):
        batch = collate_pointnet([ds[int(i)] for i in idxs])
        batch["mask"] = np.ones(len(idxs), bool)
        return batch

    def train_batches(self):
        ds = self.dataset("train")
        while True:
            order = self.rng.permutation(len(ds))
            for i in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
                yield self._collate(ds, order[i:i + self.batch_size])

    def val_batches(self, phase="val"):
        ds = self.dataset(phase)
        for i in range(0, len(ds) - self.val_batch_size + 1,
                       self.val_batch_size):
            yield self._collate(ds, range(i, i + self.val_batch_size))


class DensePointTask(ClassificationTraining):
    """Classification whose model takes the batch's dense coordinates
    [B, N, 3] (f32)."""

    def model_input(self, batch: dict):
        return batch["coordinates"].float()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ginc", action="append")
    parser.add_argument("--ginb", action="append")
    parser.add_argument("--model", type=str, default="PAConvPointNet")
    parser.add_argument("--data_root", type=str,
                        default="./datasets/modelnet40_ply_hdf5_2048/")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--val_batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save_path", type=str, default="experiments/paconv")
    parser.add_argument("--devices", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after this many steps (default: "
                             "steps per epoch x epochs)")
    parser.add_argument("--resume", action="store_true",
                        help="go on from save_path/last.ckpt")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, force=True)
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: data-parallel training is not "
            "ported (ROADMAP.md Queue 1 item 4)")
    dev = resolve_device(args.device)
    gin.parse_config_files_and_bindings(args.ginc, args.ginb)
    gin.bind("ModelNet40H5Dataset", "data_root", args.data_root)
    gin.bind("ModelNet40H5Dataset", "num_points", args.num_points)
    gin.bind("get_model", "out_channel", 40)

    seed_everything(args.seed)
    model = get_model(name=args.model, in_channel=3, out_channel=40)
    init_variables(model, args.seed)
    model.to(dev)
    dm = PointCloudDM(get_dataset("ModelNet40H5Dataset"), args.batch_size,
                      args.val_batch_size, args.workers, args.seed)
    steps_per_epoch = max(1, len(dm.dataset("train")) // args.batch_size)
    # the cosine schedule spans the epochs; --max_steps only ends the run
    gin.bind("train", "max_steps", steps_per_epoch * args.epochs)
    max_steps = (steps_per_epoch * args.epochs if args.max_steps is None
                 else args.max_steps)
    task = DensePointTask(model, optimizer_name="SGD",
                          scheduler_name="CosineAnnealingLR", lr=args.lr,
                          weight_decay=args.weight_decay)
    gin.parse_config("SGD.momentum = 0.9")
    last = os.path.join(args.save_path, "last.ckpt")
    trainer = Trainer(
        task, dm, max_steps=max_steps, val_every_n_steps=steps_per_epoch,
        loggers=[get_logger("csv", args.save_path, "paconv")],
        default_root_dir=args.save_path, monitor_metric="val/acc1",
        resume_from_checkpoint=(last if args.resume and os.path.exists(last)
                                else None),
        seed=args.seed, device=dev,
    )
    state = trainer.fit()
    return trainer.test(state, ckpt_path="best", phase="val")


if __name__ == "__main__":
    main()
