"""stablelm-2-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (kv=32, i.e. MHA) d_ff=5632 vocab=100352. The same
values as the reference's ``configs/stablelm_1_6b.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family=Family.DENSE,
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352, act="silu", glu=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512, remat=False)
