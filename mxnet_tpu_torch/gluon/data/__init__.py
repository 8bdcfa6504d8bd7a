"""Gluon's data pipeline (counterpart of `mxnet_tpu/gluon/data/`)."""
from . import batchify, vision
from .augment import DeviceAugment
from .dataloader import DataLoader, default_batchify_fn
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import (BatchSampler, FilterSampler, IntervalSampler,
                      RandomSampler, Sampler, SequentialSampler)

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "IntervalSampler", "FilterSampler", "DataLoader", "DeviceAugment",
           "default_batchify_fn", "batchify", "vision"]
