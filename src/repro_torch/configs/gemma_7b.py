"""Gemma-7B [arXiv:2403.08295] — GeGLU, head_dim 256, (1+w) RMSNorm,
scaled tied embeddings, MHA (kv=16)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    rope_theta=10000.0, act="geglu", norm="rms",
    rms_plus_one=True, embed_scale=True, tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, kv_block=64, attn_block_k=64,
    remat="none",
)
