"""LLaMA-3.1-8B [arXiv:2407.21783] — the paper's primary end-to-end model."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=500000.0,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, kv_block=64, attn_block_k=64,
    remat="none",
)
