"""Foundational helpers shared across the port.

Counterpart of `mxnet_tpu/base.py`: the error root and the string
registry that initializers and metrics (and later optimizers and
kvstores) register into.  Pure Python; the port keeps its own copy so that it imports
nothing of the JAX package.
"""
from __future__ import annotations

__all__ = ["MXNetError", "registry"]


class MXNetError(RuntimeError):
    """Root error type (reference: `python/mxnet/error.py`)."""


class _Registry:
    """String-keyed class registry (dmlc-core's ``Registry<T>``)."""

    def __init__(self, name):
        self.name = name
        self._entries = {}

    def register(self, klass, name=None):
        self._entries[(name or klass.__name__).lower()] = klass
        return klass

    def get(self, name):
        key = name.lower()
        if key not in self._entries:
            raise ValueError(f"Cannot find {self.name} '{name}'. "
                             f"Registered: {sorted(self._entries)}")
        return self._entries[key]

    def create(self, name, *args, **kwargs):
        return self.get(name)(*args, **kwargs)


class registry:  # noqa: N801 - namespace, mirrors mx.registry
    _registries = {}

    @staticmethod
    def get_registry(name):
        if name not in registry._registries:
            registry._registries[name] = _Registry(name)
        return registry._registries[name]

    @staticmethod
    def get_register_func(base_class, nickname):
        reg = registry.get_registry(nickname)

        def register(klass, name=None):
            if not issubclass(klass, base_class):
                raise TypeError(
                    f"Can only register subclass of {base_class.__name__}")
            return reg.register(klass, name)

        return register
