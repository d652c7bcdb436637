"""StarCoder2-3B [arXiv:2402.19173] — GQA kv=2, LayerNorm+bias, GELU MLP."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152,
    rope_theta=1.0e6, act="gelu", norm="ln", attn_bias=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, kv_block=64, attn_block_k=64,
    remat="none",
)
