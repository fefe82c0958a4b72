"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed, top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102_400, n_experts=64, n_shared_experts=2, top_k=6,
    ffn_type="swiglu", source="arXiv:2401.06066", verified="hf",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab=512, n_experts=8, n_shared_experts=1, top_k=2,
)
