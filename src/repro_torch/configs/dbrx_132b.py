"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    n_experts=16, top_k=4,
    block_unit=("moe",),
    mlp_variant="swiglu",
    blockwise_threshold=4096,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="dbrx-132b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=48, vocab_size=512,
        n_experts=4, top_k=2, blockwise_threshold=64,
        attn_block_q=16, attn_block_kv=16)
