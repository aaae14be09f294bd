"""Mistral-Large-123B — dense [hf:mistralai/Mistral-Large-Instruct-2407]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    block_unit=("attn",),
    mlp_variant="swiglu",
    blockwise_threshold=4096,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="mistral-large-123b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        blockwise_threshold=64, attn_block_q=16, attn_block_kv=16)
