"""The fault hook of the kernel-dispatch sites.

``core/pruner.py`` and ``models/attention.py`` consult a ``kernel.*``
fault site before they call a kernel wrapper, but cannot see the serving
engine: the engine activates its injector (``serve/faults.py``, which
re-exports this hook) for the duration of ``run()``, and the sites consult
the module-level hook here.  The fast path (no injector active) is a
single global read.  Stdlib only, so the model and core layers depend on
nothing of the serving layer.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["KernelFault", "activate", "deactivate", "active", "fire", "kernel_site"]


class KernelFault(RuntimeError):
    """Simulated kernel failure at a ``kernel.*`` dispatch site.  The port
    raises it for both kernel kinds, ``"compile_error"`` and
    ``"fallback"``: it has no oracle to re-run on and no silent branch."""


_ACTIVE: Optional[Any] = None       # a serve.faults.FaultInjector, or None


def activate(injector: Optional[Any]) -> None:
    global _ACTIVE
    _ACTIVE = injector


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Any]:
    return _ACTIVE


def fire(site: str) -> Optional[str]:
    """Consult the globally-active injector (None when inactive)."""
    return _ACTIVE.fire(site) if _ACTIVE is not None else None


def kernel_site(site: str) -> None:
    """Consult a ``kernel.*`` site before its kernel wrapper is called:
    either kernel kind raises :class:`KernelFault` naming the site."""
    kind = fire(site)
    if kind is not None:
        raise KernelFault(f"injected {kind} at {site}: the port has no oracle "
                          "or fallback to take instead")
