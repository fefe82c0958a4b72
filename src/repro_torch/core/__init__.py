"""Core of the port: addresses, the latch-word spec, the rounds plane."""

from . import coherence
from .addressing import GAddr, as_gaddr, home_of

__all__ = ["GAddr", "as_gaddr", "coherence", "home_of"]
