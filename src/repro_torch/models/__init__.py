"""The LM stack of the port: config, layers, rope, attention (K4 on the
card), the Mamba-2 SSD block (K5 on the card) and model assembly.

Each module mirrors the JAX package's module of the same name, with
PyTorch idiom inside: plain functions on tensors, parameters as the same
tree of plain dicts with layer-stacked ``[L, ...]`` leaves, and a Python
loop over layers where JAX scans.
"""
