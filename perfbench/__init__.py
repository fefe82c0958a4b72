"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once, from the root of
a checkout, on the machine that holds the cards::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel is a file of its own, found by name:

* ``configs/<config>.json``: a deployment's sizes and guarantees; its
  ``driver``, ``reference`` and ``control`` keys name the modules under
  ``drivers/``, ``references/`` and ``controls/``;
* ``traffic/<traffic>.json``: a mix's parameters; its ``generator`` key
  names the module under ``generators/`` that reads it;
* ``metrics/<metric>.py``: the reader of one metric (``read(ctx)``);
* ``kernels/<name>.py``: the bytes one kernel call needs, and where the
  round engine looks the kernel up.

``lib/`` holds what every cell shares: the run itself
(``lib/harness.py``), YCSB's zipfian key chooser, the tree image
builder, the profiler arithmetic and the table of peaks.  Nothing here
imports ``jax`` or the JAX package ``repro``.
"""
