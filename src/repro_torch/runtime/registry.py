"""Domain registry: name -> Domain factory.

Built-in domains are registered lazily by import path so that importing
:mod:`repro_torch.runtime` stays cheap (the pricing domain pulls in the MC
engine).

    from repro_torch.runtime import make_domain
    domain = make_domain("pricing", tasks, platforms)
"""
from __future__ import annotations

import importlib
from typing import Callable

from .domain import Domain

__all__ = ["register_domain", "domain_factory", "make_domain", "available_domains"]

#: name -> "module.path:ClassName" for domains shipped with the repo.
_BUILTIN: dict[str, str] = {
    "pricing": "repro_torch.domains.pricing:PricingDomain",
}

#: domains the reference package ships that this package does not have yet,
#: with the part of the port that will bring them
_NOT_YET_PORTED: dict[str, str] = {
    "lm_serving": "the LM-serving slice (repro_torch.domains.lm_serving)",
}

_REGISTRY: dict[str, Callable[..., Domain]] = {}


def register_domain(name: str, factory: Callable[..., Domain]) -> None:
    """Register a domain factory (usually the Domain subclass itself)."""
    _REGISTRY[name] = factory


def domain_factory(name: str) -> Callable[..., Domain]:
    if name in _REGISTRY:
        return _REGISTRY[name]
    path = _BUILTIN.get(name)
    if path is None and name in _NOT_YET_PORTED:
        raise KeyError(f"domain {name!r} is not ported yet: it waits for "
                       f"{_NOT_YET_PORTED[name]}")
    if path is None:
        raise KeyError(
            f"unknown domain {name!r}; available: {sorted(available_domains())}")
    mod_name, _, attr = path.partition(":")
    factory = getattr(importlib.import_module(mod_name), attr)
    _REGISTRY[name] = factory
    return factory


def make_domain(name: str, *args, **kw) -> Domain:
    """Instantiate a registered domain by name."""
    return domain_factory(name)(*args, **kw)


def available_domains() -> list[str]:
    return sorted(set(_BUILTIN) | set(_REGISTRY))
