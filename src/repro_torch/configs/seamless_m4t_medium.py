"""SeamlessM4T-medium [arXiv:2308.11596]: a 12-layer encoder and a 12-layer
decoder.  The modality front end is a stub: the encoder reads precomputed
frame embeddings.  The decoder's self attention uses the growing quantized
cache, its cross attention a static quantized cache built once after
encoding."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio", encdec=True,
    n_layers=24, enc_layers=12, dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256206,
    rope_theta=10000.0, act="gelu", norm="ln", attn_bias=True,
    enc_len=4096,
)

SMOKE = CONFIG.with_(
    n_layers=4, enc_layers=2, dec_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, vocab=512, enc_len=64,
    kv_block=64, attn_block_k=64,
    remat="none",
)
