"""LLaMA-2-7B — the paper's MHA evaluation model (g = 1)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=32000, rope_theta=10000.0,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, kv_block=64, attn_block_k=64,
    remat="none",
)
