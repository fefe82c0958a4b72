"""seamless-m4t-medium — encoder-decoder backbone; audio frontend is a
stub: input_specs() provides precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256_206, ffn_type="gelu", use_bias=True, n_enc_layers=12,
    enc_ratio=4, source="arXiv:2308.11596", verified="hf",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
)
