"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060; unverified].

24L d_model=768 attention-free, vocab=50280, ssm_state=128.  The same
values as the reference's ``configs/mamba2_130m.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family=Family.SSM,
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_chunk=128,
    ssm_expand=2, tie_embeddings=True,
    supports_long_context=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, vocab=512, ssm_state=16,
                      ssm_head_dim=16, ssm_chunk=8, remat=False)
