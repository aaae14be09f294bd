"""Gemma-7B — dense, GeGLU, head_dim 256 [arXiv:2403.08295]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab_size=256000, head_dim=256,
    block_unit=("attn",),
    mlp_variant="geglu",
    tie_embeddings=True,
    blockwise_threshold=4096,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="gemma-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
        blockwise_threshold=64, attn_block_q=16, attn_block_kv=16)
