"""qwen3-1.7b — dense GQA kv=8 with qk_norm.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151_936, qk_norm=True, ffn_type="swiglu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B", verified="hf",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
)
