"""Model zoo: build the backbone for an ArchConfig."""
from __future__ import annotations

from repro_torch.models.transformer import DecoderLM


def build_model(cfg):
    """Only the attention-family ``DecoderLM`` is ported; it refuses the
    configs of other families."""
    return DecoderLM(cfg)
