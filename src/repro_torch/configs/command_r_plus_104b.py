"""command-r-plus-104b — dense GQA kv=8, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12_288, n_heads=96, n_kv_heads=8, d_ff=33_792,
    vocab=256_000, ffn_type="swiglu", use_bias=False,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01", verified="unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192, vocab=512,
)
