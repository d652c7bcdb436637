"""Architecture configuration for the models the port runs.

A copy of the fields of the JAX package's ``ArchConfig`` that the dense,
MoE, MLA, Mamba2-hybrid, xLSTM, encoder-decoder and VLM-stub paths and the
training path read, with the JAX defaults, and the JAX package's
:class:`ShapeSpec` registry of the assigned shapes.  ``mixer`` and ``rope`` exist so that a config asking for what
the port does not run yet is refused by
:class:`repro_torch.models.transformer.DecoderLM`.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned shapes, the JAX package's (the same for every LM family).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    mixer: str = "attn"
    rope: bool = True
    rope_theta: float = 1.0e4
    mrope_sections: tuple | None = None
    qk_norm: bool = False
    attn_bias: bool = False
    parallel_residual: bool = False
    norm: str = "rms"  # rms | ln
    act: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    rms_plus_one: bool = False  # gemma: RMSNorm scales by (1 + w)
    attn_block_k: int = 512

    # encoder-decoder (seamless): the encoder reads stub frame embeddings
    encdec: bool = False
    enc_layers: int = 0
    dec_layers: int = 0
    enc_len: int = 4096  # stub frame-embedding length for decode shapes

    # VLM stub (qwen2-vl): precomputed patch embeddings ahead of the text
    vision_stub: bool = False
    n_patches: int = 1024
    patch_grid: tuple = (32, 32)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_score: str = "softmax"  # softmax | sigmoid
    router_norm_topk: bool = False
    aux_loss_weight: float = 1.0e-2

    # MLA (DeepSeek)
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head_dim: int = 0
    mtp: bool = False

    # SSM / hybrid (zamba2: a shared attention block every attn_every Mamba2 layers)
    ssm_state: int = 0
    mamba_heads: int = 0
    mamba_d_inner: int = 0
    mamba_groups: int = 1
    mamba_chunk: int = 256
    attn_every: int = 0
    # xLSTM: super-blocks of mlstm_per_slstm mLSTM blocks and 1 sLSTM block; the
    # recurrence's time chunk, and the chunkwise-parallel mLSTM prefill (prompts
    # of whole chunks) in place of the sequential one
    mlstm_per_slstm: int = 0
    xlstm_time_chunk: int = 64
    xlstm_chunkwise: bool = False

    # BitDecoding KV cache
    kv_bits: int = 4
    kv_block: int = 128
    kv_gran: str = "channel"

    # training: the optimizer (train/step.py, optim/), remat of each block
    # (``torch.utils.checkpoint``), the placement profile of a multi-rank run
    # (JAX's field and values; nothing reads it until multi-rank training,
    # ROADMAP queue A, item 12.5) and the gradient-accumulation microbatches
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "full"  # none | full
    sharding_profile: str = "fsdp_tp"  # tp | fsdp_tp
    microbatches: int = 8

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def g_q(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; logits of the padding ids are
        masked (``layers.mask_padded_vocab``)."""
        return -(-self.vocab // 256) * 256


_REGISTRY = ["llama3_8b", "llama2_7b", "gemma_7b", "starcoder2_3b", "command_r_35b",
             "qwen3_moe_235b_a22b", "deepseek_v3_671b", "zamba2_7b", "xlstm_1_3b",
             "seamless_m4t_medium", "qwen2_vl_7b"]


def _mod_name(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    mod_name = _mod_name(name)
    if mod_name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {_REGISTRY}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    """A reduced same-family config for CPU tests."""
    return _module(name).SMOKE
