"""DeepSeek-V3 671B [arXiv:2412.19437]: MLA (a quantized latent cache, read
as shared K/V by the decode), 1 shared + 256 routed experts top-8 (sigmoid
router), the first 3 layers dense, an MTP head."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", mixer="mla",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280,
    rope_theta=10000.0, act="swiglu", norm="rms",
    n_experts=256, top_k=8, d_expert=2048, n_shared_experts=1,
    first_dense_layers=3, router_score="sigmoid", router_norm_topk=True,
    q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head_dim=128,
    mtp=True, optimizer="adafactor",
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, n_experts=8, top_k=2, d_expert=64,
    first_dense_layers=1, q_lora=64, kv_lora=128, qk_nope=32, qk_rope=32,
    v_head_dim=32, kv_block=64, attn_block_k=64,
    remat="none",
)
