"""Continuous batching for autoregressive decode (counterpart of
`mxnet_tpu/serve/continuous.py`).

The drain-batch serving shape (batch N prompts, decode until *all*
finish) wastes device time: short sequences sit done while the longest
one drags the batch.  Continuous batching (the Orca/vLLM scheduling
shape) splits serving into two programs:

* **prefill** — per sequence: ``prefill_fn(prompt) -> (carry, token)``
  consumes the whole prompt once and returns the sequence's decode
  state plus the first generated token.  It runs eagerly (prompts vary
  in length; the reference jits it once per length);
* **decode** — one fixed-shape step over a **slot-stacked** batch:
  ``decode_fn(carry_stack, last_tokens) -> (carry_stack, next_tokens)``
  advances every active slot one token.  The batcher keeps the stack
  and the ``(slots,)`` tokens in static tensors, and the step's outputs
  land back in them.  On the card the step is ONE CUDA graph
  (`ops.capture.Graph`), captured at the first step and replayed after:
  steady state never captures again (`telemetry.watch_jit` watches its
  ``captures`` count, as the reference's watches its trace cache).  On
  the CPU the step runs eagerly.

New sequences **join between decode steps**: a finished prefill is
copied in place into a free slot of the static stack (``index_copy_``,
under `ops.capture.GRAPH_LOCK`; the stack is never rebound, or the
replay would read freed memory) while the rest of the batch keeps
decoding.  A sequence leaves the moment it emits ``eos_id`` or hits its
token budget, freeing the slot for the next admission.  Inactive slots
decode garbage rows; like endpoint batch padding this requires
``decode_fn`` to be row-independent, so occupied slots are numerically
identical to a solo run.  On the card that holds bitwise because the
step always runs at the fixed slot count, so cuBLAS picks the same
kernels whatever the other slots hold.

The per-step host sync is the (slots,) token vector only — the carry
stays on the device for the sequence's whole life.
"""
from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future

import numpy as onp
import torch

from .. import telemetry as _telemetry
from ..ops import capture
from .endpoint import EndpointClosed, _tree_map

__all__ = ["ContinuousBatcher"]

_counter = itertools.count()


def _leaves(tree):
    """The tensors of ``tree`` in `_tree_map`'s order."""
    out = []
    _tree_map(out.append, tree)
    return out


def _structure(tree):
    """``tree`` with every leaf replaced by ``"*"``: equal for two trees
    of one structure."""
    return _tree_map(lambda _leaf: "*", tree)


class _Decode:
    """``decode_fn`` as one step over the batcher's static buffers, its
    outputs copied back into them.  On a CUDA carry the first call runs
    the function once eagerly (cuBLAS picks its kernels, the allocator
    grows), captures the step and replays it; later calls replay.  A
    failed capture raises.  On the CPU every call runs the step
    eagerly.  ``captures`` counts captures."""

    def __init__(self, fn):
        self._fn = fn
        self._graph = None
        self.captures = 0

    def _step(self, carry, last):
        new_carry, new_last = self._fn(carry, last)
        for dst, src in zip(_leaves(carry), _leaves(new_carry)):
            dst.copy_(src)
        last.copy_(new_last)

    def __call__(self, carry, last):
        with torch.no_grad():
            if not capture.capturable(last.device):
                self._step(carry, last)
                return
            if self._graph is None:
                self._fn(carry, last)          # outputs dropped
                graph = capture.Graph(last.device)
                graph.capture(lambda: self._step(carry, last))
                self._graph = graph
                self.captures += 1
            self._graph.replay()


class _Sequence:
    __slots__ = ("prompt", "max_new_tokens", "future", "tokens", "slot")

    def __init__(self, prompt, max_new_tokens):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.future = Future()
        self.tokens = []
        self.slot = None


class ContinuousBatcher:
    """Runs ``decode_fn`` as a persistent slot-batch; ``submit()`` adds
    sequences that join it between steps.

    Parameters
    ----------
    prefill_fn : callable
        ``prompt -> (carry, first_token)``: ``prompt`` a 1-D int numpy
        array; carry a tensor, or a tuple/list/dict of tensors, of
        per-sequence state on the decode's device; token an integer (a
        0-d tensor or a Python int).
    decode_fn : callable
        ``(carry_stack, last_tokens) -> (carry_stack, next_tokens)``
        over the slot axis (axis 0); must be row-independent (each
        slot's next token depends only on that slot's carry and token)
        and capturable into a CUDA graph on the card (no host reads).
    slots : int
        Decode batch capacity (fixes the decode step's shape).
    max_new_tokens : int
        Default per-sequence generation budget (prompt's first token
        included).
    eos_id : int or None
        Token that ends a sequence early.
    """

    def __init__(self, prefill_fn, decode_fn, slots=4, max_new_tokens=32,
                 eos_id=None, name=None, start=True):
        if slots < 1:
            raise ValueError("need at least one decode slot")
        self.name = name or f"continuous_{next(_counter)}"
        self.slots = slots
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self._prefill = prefill_fn
        # the decode step is THE hot loop: watch it for re-captures
        self._decode = _telemetry.watch_jit(
            _Decode(decode_fn), name=f"serve/{self.name}/decode")
        self._waiting = []
        self._active = [None] * slots     # slot -> _Sequence
        self._carry = None                # slot-stacked decode state
        self._last = None                 # (slots,) last emitted tokens
        self._slot_index = None           # arange(slots) on the device
        self._cv = threading.Condition()
        self._closed = False
        self._drain = True

        reg = _telemetry.default_registry()
        steps = reg.counter(
            "mxtpu_continuous_total",
            "Continuous-batcher activity: decode steps, sequence joins, "
            "sequence leaves", ("batcher", "event"))
        self._ev = {e: steps.labels(batcher=self.name, event=e)
                    for e in ("steps", "joins", "leaves")}
        self._occupancy = reg.gauge(
            "mxtpu_continuous_occupancy",
            "Active decode slots / capacity",
            ("batcher",)).labels(batcher=self.name)
        self._worker = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._worker is None or not self._worker.is_alive():
            self._closed = False
            self._worker = threading.Thread(
                target=self._run, name=f"continuous:{self.name}",
                daemon=True)
            self._worker.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._drain = drain
            self._cv.notify_all()
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout=timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- intake ------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None):
        """Queue one prompt (1-D int array).  Returns a Future resolving
        to the generated token array (first token included, eos
        excluded)."""
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        prompt = onp.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token array")
        budget = int(max_new_tokens if max_new_tokens is not None
                     else self.max_new_tokens)
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        seq = _Sequence(prompt, budget)
        with self._cv:
            if self._closed:
                raise EndpointClosed(
                    f"continuous batcher {self.name} is shut down")
            self._waiting.append(seq)
            self._cv.notify()
        return seq.future

    def generate(self, prompt, max_new_tokens=None, timeout=None):
        """Blocking submit."""
        return self.submit(
            prompt, max_new_tokens=max_new_tokens).result(timeout=timeout)

    def stats(self):
        with self._cv:
            active = sum(s is not None for s in self._active)
            waiting = len(self._waiting)
        return {"slots": self.slots, "active": active, "waiting": waiting,
                "steps": self._ev["steps"].value,
                "joins": self._ev["joins"].value,
                "leaves": self._ev["leaves"].value}

    # -- the decode loop ---------------------------------------------------
    def _free_slots(self):
        return [i for i, s in enumerate(self._active) if s is None]

    def _check_join(self, carry):
        """A joining carry must match the running slot stack leaf for
        leaf: the decode step is fixed-shape, so a prefill whose carry
        shape tracks the prompt (e.g. an unpadded KV cache) would poison
        the whole batch at the join."""
        stack_def, new_def = _structure(self._carry), _structure(carry)
        if stack_def != new_def:
            raise ValueError(
                f"prefill carry structure {new_def} does not match the "
                f"running decode stack {stack_def}: prefill_fn must "
                "return the same pytree for every prompt")
        for s, n in zip(_leaves(self._carry), _leaves(carry)):
            if tuple(s.shape[1:]) != tuple(n.shape) or s.dtype != n.dtype:
                raise ValueError(
                    f"prefill carry leaf shape {tuple(n.shape)}/{n.dtype} "
                    f"does not match the decode stack's per-slot shape "
                    f"{tuple(s.shape[1:])}/{s.dtype}: the decode step "
                    "is fixed-shape, so prefill_fn must emit identical "
                    "carry shapes for every prompt (pad the prompt or "
                    "the cache to a fixed length)")

    def _materialize(self, carry, tok):
        """The static slot stack and token vector, from the first
        sequence's carry structure (zeros)."""
        leaf = _leaves(carry)[0]
        if leaf.device.type == "cuda":
            torch.cuda.set_device(leaf.device)
        self._carry = _tree_map(
            lambda x: torch.zeros((self.slots,) + tuple(x.shape),
                                  dtype=x.dtype, device=x.device), carry)
        self._last = torch.zeros((self.slots,), dtype=tok.dtype,
                                 device=leaf.device)
        self._slot_index = torch.arange(self.slots, device=leaf.device)

    def _join(self, carry, tok, slot):
        """Copy one prefill into ``slot`` of the static stack, in place."""
        idx = self._slot_index[slot:slot + 1]
        with capture.GRAPH_LOCK, torch.no_grad():
            for s, n in zip(_leaves(self._carry), _leaves(carry)):
                s.index_copy_(0, idx, n.unsqueeze(0))
            self._last.index_copy_(0, idx, tok.reshape(1).to(
                self._last.dtype))

    def _admit(self):
        """Prefill waiting sequences into free slots (between steps)."""
        while True:
            with self._cv:
                free = self._free_slots()
                if not free or not self._waiting:
                    return
                seq = self._waiting.pop(0)
                slot = free[0]
                self._active[slot] = seq
                seq.slot = slot
            try:
                carry, tok = self._prefill(seq.prompt)
                device = _leaves(carry)[0].device
                tok = torch.as_tensor(tok, device=device)
                if self._carry is None:
                    self._materialize(carry, tok)
                self._check_join(carry)
                self._join(carry, tok, slot)
            except Exception as exc:  # noqa: BLE001
                # a bad prompt fails ITS future only ("every future
                # resolves"); the slot frees, the worker and the other
                # sequences keep decoding
                with self._cv:
                    self._active[slot] = None
                if not seq.future.done():
                    seq.future.set_exception(exc)
                self._ev["leaves"].inc()
                continue
            seq.tokens.append(int(tok))
            self._ev["joins"].inc()
            self._finish_done([slot])    # budget of 1: done at prefill

    def _finish_done(self, slot_indices):
        """Resolve sequences that hit eos or their token budget."""
        for slot in slot_indices:
            seq = self._active[slot]
            if seq is None:
                continue
            done = len(seq.tokens) >= seq.max_new_tokens
            if self.eos_id is not None and seq.tokens \
                    and seq.tokens[-1] == self.eos_id:
                seq.tokens.pop()         # eos is a terminator, not output
                done = True
            if done:
                with self._cv:
                    self._active[slot] = None
                if not seq.future.done():
                    seq.future.set_result(
                        onp.asarray(seq.tokens, dtype=onp.int64))
                self._ev["leaves"].inc()

    def _fail_active(self, exc):
        """Fail every active sequence with ``exc`` and reset the slot
        stack (the shared carry is unusable after a decode error).  The
        static buffers are zeroed, not dropped: the captured step keeps
        reading them, so a reset costs no second capture."""
        with self._cv:
            seqs = [s for s in self._active if s is not None]
            self._active = [None] * self.slots
        if self._carry is not None:
            with capture.GRAPH_LOCK, torch.no_grad():
                for leaf in _leaves(self._carry):
                    leaf.zero_()
                self._last.zero_()
        for seq in seqs:
            if not seq.future.done():
                seq.future.set_exception(exc)
            self._ev["leaves"].inc()
        self._occupancy.set(0.0)

    def _run(self):
        while True:
            with self._cv:
                idle = not self._waiting \
                    and all(s is None for s in self._active)
                if self._closed and (idle or not self._drain):
                    break
                if idle:
                    self._cv.wait(timeout=0.1)
                    continue
            self._admit()
            active = [i for i, s in enumerate(self._active)
                      if s is not None]
            self._occupancy.set(len(active) / self.slots)
            if not active:
                continue
            try:
                # one step for the whole slot batch; the only host read
                # is the (slots,) token vector
                self._decode(self._carry, self._last)
                toks = self._last.tolist()
            except Exception as exc:  # noqa: BLE001
                # a decode failure poisons the whole slot stack: every
                # active sequence gets the exception (never a silent
                # drop), the stack resets, and the worker stays alive
                # for the sequences still waiting
                self._fail_active(exc)
                continue
            self._ev["steps"].inc()
            for slot in active:
                self._active[slot].tokens.append(int(toks[slot]))
            self._finish_done(active)
        # non-draining close: whatever is left must still get an answer
        with self._cv:
            leftovers = self._waiting[:] + [s for s in self._active
                                            if s is not None]
            self._waiting = []
            self._active = [None] * self.slots
        for seq in leftovers:
            if not seq.future.done():
                seq.future.set_exception(EndpointClosed(
                    f"continuous batcher {self.name} shut down without "
                    "draining"))
        self._occupancy.set(0.0)
