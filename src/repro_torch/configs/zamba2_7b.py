"""Zamba2-7B [arXiv:2411.15242]: a Mamba2 backbone (ssm_state 64) with one
SHARED attention + MLP block invoked every 6 layers (one set of weights, one
quantized KV cache per invocation)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", mixer="mamba2",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    rope_theta=10000.0, act="swiglu", norm="rms",
    ssm_state=64, mamba_d_inner=7168, mamba_heads=112, mamba_groups=2,
    mamba_chunk=256, attn_every=6,
)

SMOKE = CONFIG.with_(
    n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, ssm_state=16, mamba_d_inner=256, mamba_heads=8,
    mamba_groups=2, mamba_chunk=32, attn_every=2,
    kv_block=64, attn_block_k=64,
    remat="none",
)
