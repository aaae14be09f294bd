"""Gemma3-27B — dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-*]. 62 layers = 10 x (5 local + 1 global) + 2 local tail;
local layers use a 1024-token sliding window."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    sliding_window=1024,
    block_unit=("local", "local", "local", "local", "local", "global"),
    mlp_variant="geglu",
    logit_softcap=30.0,
    blockwise_threshold=4096,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="gemma3-27b-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        sliding_window=16, blockwise_threshold=64,
        attn_block_q=16, attn_block_kv=16)
