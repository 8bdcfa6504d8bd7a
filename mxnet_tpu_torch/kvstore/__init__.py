"""KVStore (counterpart of `mxnet_tpu/kvstore/`): the stores that reduce
a parameter's per-context copies in one process, and the
`GradBucketer` that fuses their gradients into size-capped buckets."""
from .base import KVStoreBase, create, TestStore
from .bucketing import GradBucketer
from .local import LocalKVStore
from .tpu_ici import TPUICIStore

KVStore = LocalKVStore  # the classic API's store type

__all__ = ["KVStoreBase", "KVStore", "create", "TestStore", "LocalKVStore",
           "TPUICIStore", "GradBucketer"]
