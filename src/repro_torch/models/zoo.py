"""Model zoo: build the backbone for an ArchConfig."""
from __future__ import annotations

from repro_torch.models.transformer import DecoderLM


def build_model(cfg):
    """Only ``DecoderLM`` is ported: the attention family (llama3-8b,
    llama2-7b, gemma-7b, starcoder2-3b, command-r-35b), the MoE family
    (qwen3-moe-235b-a22b; dense-then-MoE stacks and shared experts too) and
    MLA (deepseek-v3-671b).  It refuses the configs of other families."""
    return DecoderLM(cfg)
