"""recurrentgemma-2b — RG-LRU + local attention, pattern (r,r,a); GQA kv=1
(MQA) in attention layers, head_dim 256, GeGLU d_ff=7680.
[arXiv:2402.19427; hf]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256_000, head_dim=256, ffn_type="geglu",
    layer_pattern="rra", local_window=2048, lru_width=2560,
    tie_embeddings=True,
    source="arXiv:2402.19427", verified="hf",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, d_ff=192, vocab=512,
    head_dim=32, local_window=64, lru_width=64,
)
