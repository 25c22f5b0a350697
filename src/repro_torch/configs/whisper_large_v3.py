"""whisper-large-v3 — enc-dec, conv frontend stub [arXiv:2212.04356;
unverified].

32 encoder + 32 decoder layers, d_model=1280 20H (kv=20) d_ff=5120
vocab=51866, plain-GELU MLPs.  The mel conv frontend is a STUB: the model
consumes precomputed frame embeddings [B, 1504, 1280] (1500 mel frames
padded to 1504, as the reference pads them).  The same values as the
reference's ``configs/whisper_large_v3.py``.
"""
from repro_torch.models.common import Family, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family=Family.ENCDEC,
    n_layers=32, n_encoder_layers=32, d_model=1280, n_heads=20,
    n_kv_heads=20, d_ff=5120, vocab=51866, act="gelu", glu=False,
    encoder_frames=1504,
)

SMOKE = CONFIG.scaled(n_layers=2, n_encoder_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                      encoder_frames=16, remat=False)
