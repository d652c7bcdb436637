"""Qwen2-VL-7B [arXiv:2409.12191]: M-RoPE (sections 16/24/24), GQA with 4
KV heads, QKV biases.  The vision tower is a stub: the model reads
precomputed patch embeddings on a 32x32 grid ahead of the text."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm", vision_stub=True,
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064,
    rope_theta=1.0e6, act="swiglu", norm="rms", attn_bias=True,
    mrope_sections=(16, 24, 24), n_patches=1024, patch_grid=(32, 32),
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, mrope_sections=(4, 6, 6), n_patches=16,
    patch_grid=(4, 4), kv_block=64, attn_block_k=64,
    remat="none",
)
