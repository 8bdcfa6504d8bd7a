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

A rematerialization boundary (`npx.remat`) runs its forward twice: once
in the forward pass and once more in the backward, to recompute what it
did not save.  Both runs must draw the same bits, so the boundary holds a
`DrawTape`: the first run records the device tensor each draw handed
out, and the recompute is handed the same tensors in the same order.  A
recompute draws nothing from the generator and takes no row of the
`SeedTable`, so a captured step's buffer has one row a draw site and a
replay's `draw_words` counts each site once.
"""
from __future__ import annotations

import numpy as onp
import torch

from .capture import upload
from .invoke import current_generator, current_seed_table, draw_tapes

__all__ = ["DRAWS", "DrawTape", "SeedTable", "draw_seed", "draw_words",
           "words_tensor"]

_M32 = 0xFFFFFFFF


def _dropout_words(gen):
    """A 62-bit seed split into its low and high words."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return seed & _M32, seed >> 32


def _key_words(gen):
    """Two uint32 words, a threefry key: the flash kernels' dropout key,
    or the key of a ``jax.random`` draw computed in torch
    (`ops.threefry`: DeviceAugment's crops and flips, SGLD's noise, the
    RNN layers' masks between layers)."""
    return tuple(torch.randint(0, 2 ** 32, (2,), generator=gen).tolist())


# kind -> how its two words come from the generator
DRAWS = {"dropout": _dropout_words, "attention": _key_words,
         "augment": _key_words, "normal": _key_words, "rnn": _key_words}


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


class DrawTape:
    """The draws of one run of a remat boundary's forward: ``kinds`` and
    the device tensors handed out, in order.  Recording, each draw is
    appended; replaying (``replay()``), each draw is served the next
    recorded tensor, which must be of the same kind."""

    def __init__(self):
        self.kinds = []
        self.tensors = []
        self.replaying = False
        self._next = 0

    def replay(self):
        self.replaying = True
        self._next = 0

    def serve(self, kind):
        i = self._next
        if i >= len(self.kinds) or self.kinds[i] != kind:
            raise RuntimeError(
                f"a recomputed forward drew {kind!r} at draw {i}, where its "
                f"first run drew {self.kinds[i:i + 1] or 'nothing'}: a "
                "remat boundary must reach the same draw sites every time")
        self._next += 1
        return self.tensors[i]


def draw_seed(kind, device, what=None):
    """Two seed words for one draw of ``kind`` (a key of `DRAWS`) on
    ``device``: drawn from the scope's generator on the host, handed out
    by the active `SeedTable` if one is installed.  Inside a remat
    boundary's recompute, the tensor its first run was handed instead
    (`DrawTape`)."""
    recording = []
    for tape in reversed(draw_tapes()):
        if tape.replaying:
            seed = tape.serve(kind)
            break
        recording.append(tape)
    else:
        seed = _draw(kind, device, what)
    for tape in recording:
        tape.kinds.append(kind)
        tape.tensors.append(seed)
    return seed


def _draw(kind, device, what):
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
