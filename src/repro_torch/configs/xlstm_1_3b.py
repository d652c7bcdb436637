"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks in super-blocks of 7 mLSTM blocks
and 1 sLSTM block.  Attention-free: no KV cache, so BitDecoding does not
apply; the decode state has a constant size."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm", mixer="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304, rope=False, mlstm_per_slstm=7,
)

SMOKE = CONFIG.with_(
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab=512, mlstm_per_slstm=1,
    remat="none",
)
