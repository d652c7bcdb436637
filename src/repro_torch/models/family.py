"""Cache-family protocol: what a model declares about its decode state.

Every backbone exposes ``model.paged_spec() -> PagedSpec | None`` and the
serving engine (``repro_torch.serve.engine``) is driven by the returned spec.
The port serves four families: attention (``DecoderLM``, split K/V pools),
MLA (``DecoderLM``, one ``shared_kv`` latent pool), the Mamba2 hybrid
(``HybridLM``: split K/V pools for its shared attention block, its Mamba2
states as ``side_state``, prompts prefilled at their ``exact_prefill``
length) and the recurrent xLSTM family (``XLSTMLM``: ``paged=False``, its
whole state side state, served by the engine's exact-length shim).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Declared decode-cache capabilities of one model family."""

    paged: bool           # KV layers decode through the page table
    block_n: int          # tokens per page-table column
    n_kv_heads: int       # KV heads per paged layer
    d_k: int              # packed K width
    d_v: int              # value width
    shared_kv: bool = False   # single latent pool (MLA) vs split K/V pools
    page_layers: int = 0      # layer-cache instances behind each table column
    # constant-size per-slot state spliced at admission: ("path", batch_dim)
    side_state: tuple = ()
    # prompts must prefill at their exact length (no right-padding)
    exact_prefill: bool = False
    # the model supports suffix prefill against a dequantized prior
    # (``model.prefill(prior=...)``): the prefix-sharing prerequisite
    supports_prior: bool = False

    @property
    def pages_per_token(self) -> float:
        """Page-table columns consumed per cached token."""
        return 1.0 / self.block_n if self.paged else 0.0


def get_path(tree, path: str):
    """Resolve a '/'-joined ``side_state`` path inside a decode state."""
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def set_path(tree, path: str, value) -> None:
    """Set a '/'-joined ``side_state`` path inside a decode state, making
    the dicts on the way."""
    *head, last = path.split("/")
    for part in head:
        tree = tree.setdefault(part, {})
    tree[last] = value


def tensors_at(tree, path: str) -> list:
    """The tensors under a ``side_state`` path, in a fixed order: the path's
    own tensor, or the leaves of the dict it names (HybridLM's ``{"ssm",
    "conv"}``, XLSTMLM's ``{"C", "n", "m"}``)."""
    node = get_path(tree, path)
    return list(node.values()) if isinstance(node, dict) else [node]
