"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242;
unverified].

81 Mamba2 layers, d_model=3584; the SHARED attention block (32H, kv=32,
d_ff=14336) is applied every 6 Mamba layers (13 supers: 12 applications +
3 trailing Mamba layers).  ssm_state=64.  The same values as the
reference's ``configs/zamba2_7b.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family=Family.HYBRID,
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_chunk=128, ssm_expand=2,
    shared_attn_period=6, act="silu", glu=True,
    supports_long_context=True,
)

SMOKE = CONFIG.scaled(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512, ssm_state=16, ssm_head_dim=16,
                      ssm_chunk=8, shared_attn_period=2, remat=False)
