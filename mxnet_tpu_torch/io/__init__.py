"""Data iterators (counterpart of `mxnet_tpu/io/`)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,
                 LibSVMIter, ResizeIter, PrefetchingIter)
from .bucket import BucketSentenceIter
from .image_record import ImageRecordIter
from .prefetch import DevicePrefetcher

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter", "BucketSentenceIter",
           "ImageRecordIter", "DevicePrefetcher"]
