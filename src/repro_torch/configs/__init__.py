"""Architecture registry of the port: one module per architecture it runs.

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` returns the reduced same-family config the
CPU tests use (tiny widths, few layers, small vocab); ``on_device``
gives a config the head dim the card's attention kernels take.  The names are the
JAX package's, and the port runs every one of its architectures: the
``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm`` and ``encdec``
families.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "deepseek_moe_16b",
    "dbrx_132b",
    "command_r_plus_104b",
    "qwen3_1p7b",
    "starcoder2_7b",
    "llama3_405b",
    "llava_next_mistral_7b",
    "recurrentgemma_2b",
    "mamba2_2p7b",
    "seamless_m4t_medium",
]

# canonical ids as given in the assignment
CANON = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-1.7b": "qwen3_1p7b",
    "starcoder2-7b": "starcoder2_7b",
    "llama3-405b": "llama3_405b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-2.7b": "mamba2_2p7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

def _module(name: str):
    mod = CANON.get(name, name).replace("-", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE_CONFIG


def all_arch_ids():
    inv = {v: k for k, v in CANON.items()}
    return [inv[a] for a in ARCHS]


def on_device(cfg, device):
    """``cfg`` as it runs on ``device`` (a ``torch.device`` or a name):
    on the card, a head dim that the attention kernels do not take (the
    smoke configs' 16) becomes the smallest one they take (64); on the
    CPU ``cfg`` itself."""
    import torch

    from ..kernels.flash_attention import HEAD_DIMS
    if torch.device(device).type != "cuda" or cfg.hd in HEAD_DIMS:
        return cfg
    return cfg.replace(head_dim=min(h for h in HEAD_DIMS if h >= cfg.hd))

