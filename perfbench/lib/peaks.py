"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM data sheet (the 700 W part): 3.35 TB/s of HBM3.  A
card set below 700 W runs slower under load; every run records the
card's name, and PERF.md writes the power limit beside each number.
"""

HBM_BYTES_PER_S = 3.35e12
