"""The port's `contrib.text` (token counting, `Vocabulary`) against the
JAX package's, mirroring `tests/test_text.py`: the same strings give the
same counters, indices and tokens (exact: no arithmetic)."""
import pytest
import torch

from mxnet_tpu.contrib import text as ref_text
from mxnet_tpu_torch.contrib import text

torch.set_num_threads(1)

CORPUS = "the cat sat\nOn the mat  the end\nthe cat ran on\n"


@pytest.mark.parametrize("to_lower", [False, True])
def test_count_tokens_matches_reference(to_lower):
    got = text.utils.count_tokens_from_str(CORPUS, to_lower=to_lower)
    expect = ref_text.utils.count_tokens_from_str(CORPUS, to_lower=to_lower)
    assert got == expect
    c = text.utils.count_tokens_from_str("a b  b\nc a a", to_lower=False)
    assert c["a"] == 3 and c["b"] == 2 and c["c"] == 1
    more = text.utils.count_tokens_from_str("x a", counter_to_update=c)
    assert more is c and c["a"] == 4 and c["x"] == 1


@pytest.mark.parametrize("kw", [
    {}, {"most_freq_count": 2, "min_freq": 2, "reserved_tokens": ["<pad>"]},
    {"most_freq_count": 3}, {"min_freq": 3, "unknown_token": "<oov>"}])
def test_vocabulary_matches_reference(kw):
    counter = text.utils.count_tokens_from_str(CORPUS, to_lower=True)
    got = text.Vocabulary(counter, **kw)
    expect = ref_text.Vocabulary(counter, **kw)
    assert got.idx_to_token == expect.idx_to_token
    assert got.token_to_idx == expect.token_to_idx
    assert len(got) == len(expect)
    assert got.unknown_token == expect.unknown_token
    assert got.reserved_tokens == expect.reserved_tokens
    words = CORPUS.lower().split() + ["zebra"]
    assert got.to_indices(words) == expect.to_indices(words)
    assert got.to_indices("cat") == expect.to_indices("cat")
    idx = list(range(len(got)))
    assert got.to_tokens(idx) == expect.to_tokens(idx)


def test_vocabulary_ordering_limits_and_errors():
    c = text.utils.count_tokens_from_str("d d d b b c c a")
    v = text.Vocabulary(c, most_freq_count=2, min_freq=2,
                        reserved_tokens=["<pad>"])
    assert v.idx_to_token == ["<unk>", "<pad>", "d", "b"]
    assert v.to_indices("d") == 2
    assert v.to_indices(["a", "d"]) == [0, 2]
    assert v.to_tokens([0, 3]) == ["<unk>", "b"]
    with pytest.raises(ValueError):
        v.to_tokens(99)
    with pytest.raises(ValueError):
        text.Vocabulary(c, min_freq=0)
    with pytest.raises(ValueError):
        text.Vocabulary(c, reserved_tokens=["<unk>"])
    with pytest.raises(ValueError):
        text.Vocabulary(c, reserved_tokens=["x", "x"])
