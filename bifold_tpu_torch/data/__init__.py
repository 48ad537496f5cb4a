"""Dataset registry and dataloader assembly.

Counterpart of bifold_tpu/data/__init__.py: the ``Datasets`` registry keyed
by the config's ``name`` (:26-49; the bimanual and real datasets through
factories, so pandas and Pillow are imported only when such a dataset is
built), :func:`build_dataset` and :func:`get_dataloaders` (:60: train
shuffled with ``drop_last``, test in order; a null ``test_dataset.name``
falls back to the train dataset's config in the test partition; the test
set's Processor returned for reuse). The loaders process batches on the
trainer's device; under data parallelism each builds this process's slice
of every global batch.
"""

from __future__ import annotations

from typing import Optional

from bifold_tpu_torch.core.registry import Registry
from bifold_tpu_torch.data.datasets import (
    BaseDataset,
    SingleDataset,
    SingleDatasetSequential,
    SyntheticDataset,
)
from bifold_tpu_torch.data.loader import DataLoader, collate
from bifold_tpu_torch.data.processor import Processor

__all__ = ["Datasets", "BaseDataset", "DataLoader", "Processor", "collate",
           "build_dataset", "get_dataloaders"]

Datasets: Registry = Registry("dataset")
Datasets.register("single")(SingleDataset)
Datasets.register("single_sequential")(SingleDatasetSequential)
Datasets.register("synthetic")(SyntheticDataset)


@Datasets.register("bimanual")
def _bimanual(*args, **kwargs):
    from bifold_tpu_torch.data.bimanual_dataset import BimanualDataset
    return BimanualDataset(*args, **kwargs)


@Datasets.register("bimanual_sequential")
def _bimanual_sequential(*args, **kwargs):
    from bifold_tpu_torch.data.bimanual_dataset import BimanualDatasetSequential
    return BimanualDatasetSequential(*args, **kwargs)


@Datasets.register("real")
def _real(*args, **kwargs):
    from bifold_tpu_torch.data.real_dataset import RealDataset
    return RealDataset(*args, **kwargs)


def build_dataset(dataset_cfg, processor_cfg, partition: str,
                  autoprocessor_name: Optional[str] = None, seed: int = 0):
    name = dict(dataset_cfg)["name"]
    cls = Datasets.get(name)
    return cls(dataset_cfg, processor_config=processor_cfg, partition=partition,
               autoprocessor_name=autoprocessor_name, seed=seed)


def get_dataloaders(cfg, device="cpu", process_id: int = 0, process_count: int = 1):
    """(train loader or None under ``eval_only``, test loader, the test
    set's Processor), both loaders processing on ``device`` and building
    slice ``process_id`` of ``process_count`` of each global batch."""
    automodel = dict(cfg["model"]).get("automodel_name")
    seed = int(dict(cfg).get("seed", 0))

    train_dataloader = None
    if not cfg["eval_only"]:
        train_dataset = build_dataset(cfg["train_dataset"], cfg["processor"],
                                      partition="train",
                                      autoprocessor_name=automodel, seed=seed)
        if cfg.get("debug"):
            train_dataset[0]
        train_dataloader = DataLoader(
            train_dataset, batch_size=cfg["batch_size"], shuffle=True, seed=seed,
            device=device, process_id=process_id, process_count=process_count)

    test_cfg = cfg["test_dataset"]
    if dict(test_cfg).get("name") is None:
        test_cfg = cfg["train_dataset"]
    test_dataset = build_dataset(test_cfg, cfg["processor"], partition="test",
                                 autoprocessor_name=automodel, seed=seed)
    if cfg.get("debug"):
        test_dataset[0]
    test_dataloader = DataLoader(
        test_dataset, batch_size=cfg.get("test_batch_size", cfg["batch_size"]),
        shuffle=False, drop_last=False, device=device, process_id=process_id,
        process_count=process_count)
    return train_dataloader, test_dataloader, test_dataset.processor
