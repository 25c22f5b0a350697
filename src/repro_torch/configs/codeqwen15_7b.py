"""codeqwen1.5-7b — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416, QKV bias. The same
values as the reference's ``configs/codeqwen15_7b.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family=Family.DENSE,
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, act="silu", glu=True, qkv_bias=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512, remat=False)
