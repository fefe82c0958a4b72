"""Pluggable protocol-backend registry.

``SELCCLayer`` used to hard-wire its backends with if/elif string
dispatch; new coherence designs (the paper's Sec. 2 RPC strawman,
federated-coherence variants, ...) had to edit ``SELCCLayer.__init__``.
The registry inverts that: a backend module calls

    register_protocol("myproto", build, mem_cpu_cores=...)

at import time, and ``ClusterConfig(protocol="myproto")`` resolves
through :func:`get_protocol` — zero edits to the layer.  SELCC, SEL, and
GAM register themselves this way too (see the bottom of protocol.py,
sel.py, gam.py), as does the out-of-dispatch proof point core/rpc.py.

A ``build`` factory receives the fully-constructed :class:`SELCCLayer`
(env + fabric + config ready, nodes not yet built) and returns the list
of compute-node objects.  Each node must expose the Table-1 v2 surface
(see core/handles.py): slock/xlock/sunlock/xunlock/write/atomic_faa and
the slocked/xlocked scope guards from :class:`NodeAPIMixin`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class ProtocolSpec:
    """One registered coherence backend."""

    name: str
    build: Callable                 # build(layer) -> list[compute nodes]
    # memory-node CPU cores the fabric should model (RPC-served backends
    # are compute-limited at the memory side — the paper's key axis)
    mem_cpu_cores: Callable = field(default=lambda cfg: 1)
    description: str = ""


_REGISTRY: dict[str, ProtocolSpec] = {}


def register_protocol(name: str, build: Callable, *,
                      mem_cpu_cores: Callable | None = None,
                      description: str = "",
                      overwrite: bool = False) -> ProtocolSpec:
    """Public extension point: register a coherence backend under ``name``.

    ``build(layer)`` must return the compute-node list; ``mem_cpu_cores``
    optionally maps the ClusterConfig to the memory-side core count the
    fabric models (defaults to 1, the paper's near-zero-compute memory
    node).
    """
    key = name.lower()
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"protocol {name!r} is already registered; "
                         f"pass overwrite=True to replace it")
    spec = ProtocolSpec(name=key, build=build,
                        mem_cpu_cores=mem_cpu_cores or (lambda cfg: 1),
                        description=description)
    _REGISTRY[key] = spec
    return spec


def get_protocol(name: str) -> ProtocolSpec:
    spec = _REGISTRY.get(name.lower())
    if spec is None:
        raise ValueError(
            f"unknown protocol {name!r}; registered backends: "
            f"{', '.join(available_protocols()) or '(none)'} — new backends "
            f"plug in via repro_torch.core.register_protocol(name, build)")
    return spec


def available_protocols() -> list[str]:
    return sorted(_REGISTRY)
