"""See ``perfbench/__init__.py``."""
