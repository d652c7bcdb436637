"""Model zoo: build the backbone for an ArchConfig."""
from __future__ import annotations

from repro_torch.models.transformer import DecoderLM, HybridLM


def build_model(cfg):
    """``HybridLM`` for the Mamba2 hybrid (zamba2-7b), else ``DecoderLM``:
    the attention family (llama3-8b, llama2-7b, gemma-7b, starcoder2-3b,
    command-r-35b), the MoE family (qwen3-moe-235b-a22b; dense-then-MoE
    stacks and shared experts too) and MLA (deepseek-v3-671b).  Both refuse
    the configs of the families not ported yet."""
    if cfg.mixer == "mamba2":
        return HybridLM(cfg)
    return DecoderLM(cfg)
