"""starcoder2-7b — dense GQA kv=4, RoPE, biased projections, GELU MLP.
[arXiv:2402.19173; hf]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18_432,
    vocab=49_152, ffn_type="gelu", use_bias=True,
    tie_embeddings=True,
    source="arXiv:2402.19173", verified="hf",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, d_ff=288, vocab=512,
)
