"""Qwen3-MoE 235B-A22B [Qwen3 report] — 94L, GQA kv=4 (g_q=16), q/k-norm,
128 experts top-8, per-expert d_ff=1536."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab=151936,
    rope_theta=1.0e6, act="swiglu", norm="rms", qk_norm=True,
    n_experts=128, top_k=8, d_expert=1536, router_norm_topk=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    vocab=512, n_experts=8, top_k=2, d_expert=64,
    kv_block=64, attn_block_k=64,
    remat="none",
)
