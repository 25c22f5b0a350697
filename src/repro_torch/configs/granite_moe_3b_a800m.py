"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-*; hf].

32L d_model=1536 24H (GQA kv=8) vocab=49155, MoE 40 experts top-8 with
per-expert d_ff=512 (the hf 1b-a400m sibling uses 32 experts; this
config keeps 40 experts top-8).  The same values as the reference's ``configs/granite_moe_3b_a800m.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family=Family.MOE,
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, d_ff_expert=512, vocab=49155,
    n_experts=40, top_k=8, act="silu", glu=True, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=64, d_ff_expert=64, vocab=512, n_experts=8,
                      top_k=2, remat=False)
