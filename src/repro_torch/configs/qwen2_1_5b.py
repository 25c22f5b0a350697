"""qwen2-1.5b — GQA, QKV bias [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The same values
as the reference's ``configs/qwen2_1_5b.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family=Family.DENSE,
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, act="silu", glu=True, qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=512, remat=False)
