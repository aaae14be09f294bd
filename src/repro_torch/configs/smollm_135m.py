"""SmolLM-135M — llama-arch small dense [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64,
    block_unit=("attn",),
    mlp_variant="swiglu",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="smollm-135m-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
