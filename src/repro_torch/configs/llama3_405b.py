"""llama3-405b — dense GQA kv=8, 128k vocab, 126 layers.
[arXiv:2407.21783; unverified]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8, d_ff=53_248,
    vocab=128_256, ffn_type="swiglu", rope_theta=500_000.0,
    source="arXiv:2407.21783", verified="unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=208, vocab=512,
)
