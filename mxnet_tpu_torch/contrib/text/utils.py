"""Text tokenization helpers (counterpart of
`mxnet_tpu/contrib/text/utils.py`)."""
from __future__ import annotations

import re
from collections import Counter

__all__ = ["count_tokens_from_str"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Count the tokens of a string split at ``token_delim`` and
    ``seq_delim`` (lower-cased with ``to_lower``) into a
    ``collections.Counter`` (``counter_to_update`` if given)."""
    source_str = re.sub(
        f"[{re.escape(token_delim)}{re.escape(seq_delim)}]+", " ",
        source_str)
    if to_lower:
        source_str = source_str.lower()
    tokens = [t for t in source_str.split(" ") if t]
    counter = counter_to_update if counter_to_update is not None else Counter()
    counter.update(tokens)
    return counter
