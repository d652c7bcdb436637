"""Model zoo: build the backbone for an ArchConfig."""
from __future__ import annotations

from repro_torch.models.transformer import DecoderLM


def build_model(cfg):
    """Only the attention-family ``DecoderLM`` is ported (llama3-8b,
    llama2-7b, gemma-7b, starcoder2-3b, command-r-35b); it refuses the
    configs of other families."""
    return DecoderLM(cfg)
