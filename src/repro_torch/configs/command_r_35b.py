"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — parallel-residual,
no-bias GQA, tied embeddings, 8M rope theta."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000,
    rope_theta=8.0e6, act="swiglu", norm="ln",
    parallel_residual=True, tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, kv_block=64, attn_block_k=64,
    remat="none",
)
