"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (kv=16) vocab=151936; 60 routed experts top-4 with
per-expert d_ff=1408 + 4 shared experts.  The same values as the
reference's ``configs/qwen2_moe_a2_7b.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family=Family.MOE,
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, d_ff_expert=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4,
    act="silu", glu=True, qkv_bias=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=64, d_ff_expert=64, vocab=512, n_experts=8,
                      top_k=2, n_shared_experts=1, remat=False)
