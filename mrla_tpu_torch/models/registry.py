"""Model registry: architecture name -> constructor."""

from __future__ import annotations

from typing import Callable, Dict

from mrla_tpu_torch._device import resolve_device

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    """Decorator: register ``fn`` under its function name."""
    name = fn.__name__
    if name in _REGISTRY:
        raise ValueError(f"duplicate model registration: {name}")
    _REGISTRY[name] = fn
    return fn


def create_model(name: str, device="cuda", **kwargs):
    """Instantiate a registered architecture by name on ``device``.

    Parameters are initialised on the CPU (from ``generator=`` when given)
    and then moved, so one seed gives the same weights on every device."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    dev = resolve_device(device)
    return _REGISTRY[name](**kwargs).to(dev)


def get_model_ctor(name: str) -> Callable:
    """The constructor registered under ``name``; KeyError if none is."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'")
    return _REGISTRY[name]


def list_models() -> list[str]:
    return sorted(_REGISTRY)
