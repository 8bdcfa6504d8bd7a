"""KVStore (counterpart of `mxnet_tpu/kvstore/`): the stores that reduce
a parameter's per-context copies in one process.  ``GradBucketer`` is
ROADMAP queue A item A7c in the port, and naming it raises."""
from .base import KVStoreBase, create, TestStore
from .local import LocalKVStore
from .tpu_ici import TPUICIStore

KVStore = LocalKVStore  # the classic API's store type

__all__ = ["KVStoreBase", "KVStore", "create", "TestStore", "LocalKVStore",
           "TPUICIStore"]


def __getattr__(name):
    if name in ("GradBucketer", "bucketing"):
        raise NotImplementedError(
            f"kvstore.{name}: gradient bucketing is ROADMAP queue A item "
            "A7c in the port; pushpull_list reduces key by key")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
