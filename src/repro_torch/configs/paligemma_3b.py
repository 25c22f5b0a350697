"""paligemma-3b — SigLIP + gemma VLM backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.  The SigLIP vision
tower is a stub (precomputed patch embeddings, 256 tokens at 224px/14px
patches); the gemma decoder uses GeGLU and tied embeddings.  The same
values as the reference's ``configs/paligemma_3b.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family=Family.VLM,
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, act="gelu", glu=True, tie_embeddings=True,
    img_tokens=256, rope_theta=10000.0,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                      head_dim=16, d_ff=128, vocab=512, img_tokens=8,
                      remat=False)
