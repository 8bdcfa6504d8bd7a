"""Text utilities (counterpart of `mxnet_tpu/contrib/text/`): token
counting and the `Vocabulary`.  The pretrained embeddings (`embedding`)
are not ported yet."""
from . import utils
from .vocab import Vocabulary

__all__ = ["utils", "Vocabulary"]
