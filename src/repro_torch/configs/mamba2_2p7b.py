"""mamba2-2.7b — attention-free SSD (state-space duality) stack,
ssm_state=128, headdim 64, expand 2.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50_280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, source="arXiv:2405.21060", verified="unverified",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=32,
)
