"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, top_k=8,
    block_unit=("moe",),
    mlp_variant="swiglu",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="olmoe-1b-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab_size=512,
        n_experts=8, top_k=2, blockwise_threshold=64,
        attn_block_q=16, attn_block_kv=16)
