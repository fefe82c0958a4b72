"""The few things the harness reads from the program, and name patching.

The harness takes from ``repro_torch`` only the system under test, its
counters (``engine.TRACE_COUNTS``, the application's ``stats``) and the
names under which its layers look each other up.  :class:`Patch`
replaces such names for a while and puts them back: the traced run's
kernel hooks and spans use it, and so do the tests' planted faults.
"""

from __future__ import annotations

import importlib


def rounds_run() -> int:
    """Coherence rounds the round engine has run in this process (it
    counts each under its shape key)."""
    from repro_torch.core.rounds.engine import TRACE_COUNTS
    return sum(n for k, n in TRACE_COUNTS.items() if k[0] == "round")


def resolve(module: str, dotted: str):
    """``(owner, attribute)`` for ``module`` and a dotted attribute
    (``"DevicePlane._telemetry"``); None if either is missing."""
    try:
        owner = importlib.import_module(module)
    except ImportError:
        return None
    *path, name = dotted.split(".")
    for part in path:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    if not hasattr(owner, name):
        return None
    return owner, name


class Patch:
    """Context manager: ``with Patch([(module, dotted, make), ...]):``
    sets each attribute to ``make(original)`` and restores it on exit.
    Targets that do not exist are skipped (a renamed layer leaves its
    span or hook silent instead of breaking the run)."""

    def __init__(self, targets):
        self.targets = list(targets)
        self._saved = []

    def __enter__(self):
        for module, dotted, make in self.targets:
            found = resolve(module, dotted)
            if found is None:
                continue
            owner, name = found
            own = vars(owner).get(name, _INHERITED)
            self._saved.append((owner, name, own))
            setattr(owner, name, make(getattr(owner, name)))
        return self

    def __exit__(self, *exc):
        for owner, name, own in reversed(self._saved):
            if own is _INHERITED:
                delattr(owner, name)
            else:
                setattr(owner, name, own)
        self._saved.clear()
        return False


_INHERITED = object()
