"""dbrx-132b — 16 experts top-4, GQA kv=8.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10_752,
    vocab=100_352, n_experts=16, n_shared_experts=0, top_k=4,
    ffn_type="swiglu", source="hf:databricks/dbrx-base",
    verified="unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, n_experts=4, top_k=2,
)
