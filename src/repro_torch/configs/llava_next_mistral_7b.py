"""llava-next-mistral-7b — Mistral-7B backbone; anyres patch embeddings
enter as precomputed soft tokens (modality frontend is a stub per brief).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab=32_000, ffn_type="swiglu", n_patches=1152,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf", verified="unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
    n_patches=16,
)
