"""Gluon Block / HybridBlock (counterpart of `mxnet_tpu/gluon/block.py`).

A Block is an ``nn.Module``: children register as torch submodules, in
assignment order, and ``forward`` is torch's.  Gluon parameters are
`Parameter` objects registered in ``_reg_params``;
``collect_params()`` returns them under the reference's dotted names
(``encoder.layer0.attention.query.weight``, ``position_embed``), which
is what `utils.convert.load_reference_params` matches on.

``save_parameters`` / ``load_parameters`` write and read the JAX
package's ``.npz`` checkpoint (`utils.serialization`) under those
names, so a file crosses between the packages either way; upstream's
0x112 files load too.

``hybridize()`` compiles nothing in the port: PyTorch runs eagerly, and
capturing the forward (a CUDA graph) is later work.  A hybridized
block's forward runs under `ops.invoke.tracing`, the counterpart of the
reference's trace, so `npx.while_loop` and `npx.cond` inside it take
the reference's traced contract.

``cast`` recurses through the child blocks' own ``cast``, as the
reference's does, so a block that keeps a dtype of its own (the RNN
layers' initial states) follows a cast of its parent.

A call enters its input's context (`context.tensor_context` of the
first tensor argument) for the length of ``forward``, as the
reference's does, so a parameter with copies on several contexts hands
each ``data()`` inside the copy of the input's context: a CUDA tensor's
card, or the host copy that `split_and_load` marked on a CPU tensor.
An unmarked CPU input keeps a CPU context already current, else takes
``cpu(0)``.  The outputs of a call on a CPU context carry its mark on.
"""
from __future__ import annotations

import re

import torch
from torch import nn

from ..context import (context_scope, cpu, current_context, mark_context,
                       tensor_context)
from ..ops.invoke import is_tracing, tracing
from .parameter import Parameter

__all__ = ["Block", "HybridBlock"]


class _Children(dict):
    """A dict of name -> child whose call yields the children, standing
    in for torch's ``nn.Module.children()`` method."""

    def __call__(self):
        return iter(list(self.values()))


def _first_tensor(items):
    """The first tensor among ``items``, one level of list or tuple
    nesting deep (an RNN's list of states), or None."""
    for a in items:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    return b
    return None


def _call_context(args, kwargs):
    """The context a call on ``args`` enters, or None to stay in the
    current one."""
    first = _first_tensor(args)
    if first is None:
        first = _first_tensor(kwargs.values())
    if first is None:
        return None
    ctx = tensor_context(first)
    current = current_context()
    if ctx is None:                       # an unmarked CPU tensor
        if current.type == "cpu":
            return None
        ctx = cpu(0)
    return None if ctx == current else ctx


def _mark_outputs(out, ctx):
    if isinstance(out, torch.Tensor):
        mark_context(out, ctx)
    elif isinstance(out, (list, tuple)):
        for o in out:
            if isinstance(o, torch.Tensor):
                mark_context(o, ctx)
    return out


class Block(nn.Module):
    """Base building block."""

    def __init__(self):
        super().__init__()
        self._reg_params = {}

    def __call__(self, *args, **kwargs):
        ctx = _call_context(args, kwargs)
        if ctx is None:
            return super().__call__(*args, **kwargs)
        with context_scope(ctx):
            out = super().__call__(*args, **kwargs)
        return _mark_outputs(out, ctx) if ctx.type == "cpu" else out

    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if reg is not None:
            if isinstance(value, Parameter):
                reg[name] = value
            else:
                reg.pop(name, None)
        super().__setattr__(name, value)

    # -- parameter collection ---------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def collect_params(self, select=None):
        """Dotted name -> `Parameter`, over this block and its children;
        with ``select``, only the names that regex matches (from the
        start, as ``re.match``)."""
        ret = {}
        for name, param in self._collect_params_with_prefix().items():
            param._structure_name = name
            if select is None or re.match(select, name):
                ret[name] = param
        return ret

    @property
    def children(self):
        """Name -> direct child block, as the reference's property; the
        mapping is also callable, ``children()`` yielding the child
        modules as torch's ``nn.Module.children`` does, so torch's
        ``train``, ``to`` and ``apply`` walk the tree through it."""
        return _Children((name, child) for name, child in
                         self._modules.items() if child is not None)

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Allocate every parameter on ``ctx`` (None = the card; pass
        ``mx.cpu()`` for the CPU; a list keeps one copy of each parameter
        on every context of it) and fill it from ``generator``, a CPU
        ``torch.Generator`` (None = one seeded with 0).  Parameters
        without an initializer of their own use ``init``.  Parameters of
        unknown shape are filled at the first forward, from the same
        generator, in the order the forward reaches them."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for param in self.collect_params().values():
            param.initialize(init=param.init, ctx=ctx, default_init=init,
                             force_reinit=force_reinit, generator=generator)
        return self

    def _ensure_shapes(self, *args):
        """Settle deferred parameter shapes with one forward in predict
        mode, without gradients (running statistics untouched)."""
        if any(p._deferred_init is not None
               for p in self.collect_params().values()):
            from .. import autograd
            with torch.no_grad(), autograd.predict_mode():
                self(*args)

    # -- save / load (reference block.py:209-250) ---------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Save every initialized parameter's values (its first copy)
        under its dotted name (``deduplicate``: a parameter shared by
        several blocks once, under its first name)."""
        from ..utils.serialization import save_ndarrays
        arg_dict, seen = {}, set()
        for name, param in self._collect_params_with_prefix().items():
            if param._data is None or (deduplicate and id(param) in seen):
                continue
            seen.add(id(param))
            arg_dict[name] = param.list_data()[0]
        save_ndarrays(filename, arg_dict)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from ``filename`` by dotted name (a
        module-era ``arg:``/``aux:`` prefix is stripped), through
        `load_dict` (``dtype_source`` changes nothing, as in the
        reference)."""
        from ..context import cpu
        from ..utils.serialization import load_ndarrays
        loaded = load_ndarrays(filename, ctx=cpu())
        loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                  else k: v for k, v in loaded.items()}
        self.load_dict(loaded, ctx=ctx, allow_missing=allow_missing,
                       ignore_extra=ignore_extra, cast_dtype=cast_dtype,
                       source=f"'{filename}'")

    def load_dict(self, param_dict, ctx=None, allow_missing=False,
                  ignore_extra=False, cast_dtype=False, source="the dict"):
        """Set the parameters from ``param_dict`` (dotted name -> any
        array-like) by name.  Each keeps its own dtype, as in the
        reference (``cast_dtype`` changes nothing there either), and its
        device unless ``ctx`` is given; a parameter whose shape is still
        deferred takes it from the array.  A name missing from
        ``param_dict`` raises unless
        ``allow_missing``, one the block lacks unless ``ignore_extra``
        (``source`` names ``param_dict`` in the error)."""
        params = self._collect_params_with_prefix()
        for name, param in params.items():
            if name not in param_dict:
                if not allow_missing:
                    raise AssertionError(
                        f"Parameter '{name}' is missing in {source}")
                continue
            if ctx is not None:
                param.reset_ctx(ctx)
            param.set_data(param_dict[name])
        extra = set(param_dict) - set(params)
        if extra and not ignore_extra:
            raise AssertionError(
                f"Parameters {sorted(extra)} in {source} are not present "
                "in this Block")

    def zero_grad(self):
        """Clear every parameter's gradient (a cleared gradient reads as
        zeros)."""
        for param in self.collect_params().values():
            param.zero_grad()

    def hybridize(self, active=True, **kwargs):
        """Hybridize (``active``) or not every child block."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)
        return self

    def cast(self, dtype):
        """Cast every floating-point parameter to ``dtype``, through each
        child block's ``cast``."""
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dtype)
        for param in self._reg_params.values():
            if param.dtype.is_floating_point:
                param.cast(dtype)
        return self

    def as_endpoint(self, **serve_kwargs):
        """Expose this block as a batched inference service
        (:class:`mxnet_tpu_torch.serve.Endpoint`); keyword arguments go
        to ``Endpoint``."""
        from ..serve import Endpoint
        return Endpoint(self, **serve_kwargs)


class HybridBlock(Block):
    """A Block the reference can compile to one XLA program; in the port
    the same as `Block`, but for what ``hybridize`` does."""

    def hybridize(self, active=True, **kwargs):
        """Run this block's forward under `ops.invoke.tracing` (``active``)
        or not; the reference's compile options are accepted and do
        nothing.  Children run inside their parent's scope."""
        self._hybridized = bool(active)
        super().hybridize(False)
        return self

    def __call__(self, *args, **kwargs):
        if self.__dict__.get("_hybridized") and not is_tracing():
            with tracing():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)
