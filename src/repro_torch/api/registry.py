"""String-keyed plugin registries for the serving stack.

Three extension points, mirroring the paper's swappable policies:

* **routers** — placement policies consumed by :class:`StreamScheduler`
  (FlowGuard, round-robin, your own).
* **drafts** — speculative proposal providers consumed by ``StreamPair``
  (n-gram, small-model lane, none).
* **spec policies** — speculation-depth controllers (SpecuStream, fixed
  depth, none).

Built-ins register themselves with the decorators below at definition site
(``core/flowguard.py``, ``core/specustream.py``, ``serving/draft.py``);
third-party code does the same::

    from repro_torch.api import register_router

    @register_router("random")
    def _make(config=None):
        return MyRandomRouter()

This module is intentionally dependency-free (no torch/numpy/core imports) so
any layer can import it without cycles.  Resolution lazily imports the
built-in modules so the registries are populated even when the caller has
only imported ``repro_torch.api``.  These registries are the port's own:
names registered with ``repro.api`` do not appear here.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict


class Registry:
    """A named string → factory mapping with decorator registration."""

    def __init__(self, kind, builtin_modules=None):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}
        self._builtin_modules = list(builtin_modules or [])
        self._loaded = False

    # ------------------------------------------------------------ registration
    def register(self, name, factory=None):
        """Register ``factory`` under ``name``; usable as a decorator."""
        if not name or not isinstance(name, str):
            raise ValueError(f"{self.kind} name must be a non-empty string")

        def _add(fn):
            prev = self._entries.get(name)
            if prev is not None and prev is not fn:
                raise ValueError(f"{self.kind} {name!r} is already registered")
            self._entries[name] = fn
            return fn

        return _add if factory is None else _add(factory)

    # -------------------------------------------------------------- resolution
    def _load_builtins(self):
        if self._loaded:
            return
        self._loaded = True
        for mod in self._builtin_modules:
            importlib.import_module(mod)

    def get(self, name):
        self._load_builtins()
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {self.names()}"
            ) from None

    def create(self, name, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def names(self):
        self._load_builtins()
        return sorted(self._entries)

    def __contains__(self, name):
        self._load_builtins()
        return name in self._entries


ROUTERS = Registry("router", builtin_modules=["repro_torch.core.flowguard"])
DRAFTS = Registry("draft", builtin_modules=["repro_torch.serving.draft",
                                            "repro_torch.core.engine"])
SPEC_POLICIES = Registry("spec_policy", builtin_modules=["repro_torch.core.specustream"])

register_router = ROUTERS.register
register_draft = DRAFTS.register
register_spec_policy = SPEC_POLICIES.register


def resolve_router(name, config=None):
    """Instantiate the router registered under ``name``."""
    return ROUTERS.create(name, config=config)


def resolve_draft(name, ctx):
    """Instantiate the draft provider registered under ``name``.

    ``ctx`` is the engine's :class:`~repro_torch.serving.draft.DraftContext`.
    """
    return DRAFTS.create(name, ctx)


def resolve_spec_policy(name, config=None, fixed_depth=5):
    """Instantiate the speculation-depth policy registered under ``name``."""
    return SPEC_POLICIES.create(name, config=config, fixed_depth=fixed_depth)
