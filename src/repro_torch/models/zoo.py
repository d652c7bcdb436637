"""Model zoo: build the backbone for an ArchConfig."""
from __future__ import annotations

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM, HybridLM, XLSTMLM


def build_model(cfg):
    """``EncDecLM`` for the encoder-decoder (seamless-m4t-medium),
    ``HybridLM`` for the Mamba2 hybrid (zamba2-7b), ``XLSTMLM`` for the
    recurrent xLSTM family (xlstm-1.3b), else ``DecoderLM``: the
    attention family (llama3-8b, llama2-7b, gemma-7b, starcoder2-3b,
    command-r-35b), the VLM stub with M-RoPE (qwen2-vl-7b), the MoE family
    (qwen3-moe-235b-a22b; dense-then-MoE stacks and shared experts too) and
    MLA (deepseek-v3-671b).  ``DecoderLM`` and ``HybridLM`` refuse the
    configs of the families not ported yet."""
    if cfg.encdec:
        return EncDecLM(cfg)
    if cfg.mixer == "mamba2":
        return HybridLM(cfg)
    if cfg.mixer == "xlstm":
        return XLSTMLM(cfg)
    return DecoderLM(cfg)
