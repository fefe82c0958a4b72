"""What every cell of the benchmark shares (see ``perfbench/__init__.py``)."""
