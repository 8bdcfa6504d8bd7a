"""Vocabulary (counterpart of `mxnet_tpu/contrib/text/vocab.py`)."""
from __future__ import annotations

__all__ = ["Vocabulary"]


class Vocabulary:
    """Token <-> index mapping built from a token Counter.

    Index 0 is the unknown token; `reserved_tokens` follow, then tokens by
    descending frequency (ties broken alphabetically), truncated by
    `most_freq_count` and filtered by `min_freq`.
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq <= 0:
            raise ValueError("min_freq must be positive")
        self._unknown_token = unknown_token
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise ValueError("unknown_token must not appear in "
                             "reserved_tokens")
        if len(set(reserved_tokens)) != len(reserved_tokens):
            raise ValueError("reserved_tokens must be unique")
        self._idx_to_token = [unknown_token] + reserved_tokens
        self._reserved_tokens = reserved_tokens or None
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        room = None if most_freq_count is None else most_freq_count
        for token, freq in pairs:
            if freq < min_freq or token in self._token_to_idx:
                continue
            if room is not None:
                if room == 0:
                    break
                room -= 1
            self._token_to_idx[token] = len(self._idx_to_token)
            self._idx_to_token.append(token)

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index/indices; unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idxs = [self._token_to_idx.get(t, 0) for t in toks]
        return idxs[0] if single else idxs

    def to_tokens(self, indices):
        import numpy as onp
        single = isinstance(indices, (int, onp.integer))
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError(f"index {i} out of vocabulary range")
        toks = [self._idx_to_token[i] for i in idxs]
        return toks[0] if single else toks
