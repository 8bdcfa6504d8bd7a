"""Train-mode seed words on the device, one slot per random draw.

Every random draw of a train-mode forward (a dropout mask, the flash
kernels' attention dropout) takes two uint32 seed words.  The host draws
them from the scope's CPU ``torch.Generator`` (`autograd.record` /
``train_mode(generator=...)``), in the order the forward reaches the draw
sites, as `DRAWS` says for each kind; the kernels read them from device
memory.  Eagerly, each draw's words are copied to the device on their own
(through a pinned buffer, without a sync).

A CUDA graph replays the launches it captured with the pointers it
captured, so a captured step cannot take fresh words by value.  While
`gluon.FusedTrainStep` captures a step, it installs a `SeedTable` with a
static device buffer: draw ``i`` of the step takes row ``i`` of it.  Before
each replay the host draws the same kinds in the same order from the same
generator (`draw_words`) and writes them into that buffer, so every replay
draws fresh bits, the same ones the eager step would have drawn.
"""
from __future__ import annotations

import numpy as onp
import torch

from .capture import upload
from .invoke import current_generator, current_seed_table

__all__ = ["DRAWS", "SeedTable", "draw_seed", "draw_words", "words_tensor"]

_M32 = 0xFFFFFFFF


def _dropout_words(gen):
    """A 62-bit seed split into its low and high words."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return seed & _M32, seed >> 32


def _attention_words(gen):
    """Two uint32 words, the flash kernels' dropout key."""
    return tuple(torch.randint(0, 2 ** 32, (2,), generator=gen).tolist())


# kind -> how its two words come from the generator
DRAWS = {"dropout": _dropout_words, "attention": _attention_words}


def words_tensor(words, device):
    """Two uint32 words as an int32 (2,) tensor on ``device``, copied to
    the card without a sync (`capture.upload`)."""
    return upload(onp.asarray(words, dtype=onp.uint32).view(onp.int32),
                  device)


def draw_words(kinds, generator):
    """The words of draws of ``kinds``, in order, from ``generator``:
    what a replay writes into the seed buffer."""
    return [DRAWS[k](generator) for k in kinds]


class SeedTable:
    """The draws of one step, in the order the forward reaches them:
    ``kinds[i]`` and ``words[i]`` of draw ``i``.  With ``buffer`` (an
    int32 (n, 2) tensor on the device) draw ``i`` hands out row ``i`` and
    copies nothing: the owner writes the words before the buffer is
    read.  Without it, each draw gets its own device tensor."""

    def __init__(self, buffer=None):
        self.kinds = []
        self.words = []
        self._buffer = buffer

    def take(self, kind, words, device):
        slot = len(self.kinds)
        self.kinds.append(kind)
        self.words.append(tuple(words))
        if self._buffer is None:
            return words_tensor(words, device)
        if slot >= self._buffer.shape[0]:
            raise RuntimeError(
                f"the step drew more seeds ({slot + 1}) than its first run "
                f"did ({self._buffer.shape[0]}); a captured step must "
                "reach the same draw sites every time")
        return self._buffer[slot]


def draw_seed(kind, device, what=None):
    """Two seed words for one draw of ``kind`` (a key of `DRAWS`) on
    ``device``: drawn from the scope's generator on the host, handed out
    by the active `SeedTable` if one is installed."""
    gen = current_generator()
    if gen is None:
        what = what or kind
        raise ValueError(f"{what} in train mode needs a torch.Generator: "
                         "run under autograd.record(generator=...) or "
                         "autograd.train_mode(generator=...)")
    words = DRAWS[kind](gen)
    table = current_seed_table()
    if table is None:
        return words_tensor(words, device)
    return table.take(kind, words, device)
