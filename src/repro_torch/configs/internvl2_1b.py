"""InternVL2-1B — InternViT + InternLM2 backbone [arXiv:2404.16821].

Per the assignment, only the transformer BACKBONE is modeled; the vision
frontend is a STUB: ``input_specs()`` provides 256 precomputed patch
embeddings per image which are projected and prepended to the text tokens."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    block_unit=("attn",),
    mlp_variant="swiglu",
    frontend="vision", frontend_tokens=256,
    # 256 vision tokens prepend to the text sequence: blocks must
    # divide 32768 + 256
    attn_block_q=256, attn_block_kv=256,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="internvl2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        frontend_tokens=8, blockwise_threshold=64,
        attn_block_q=16, attn_block_kv=16)
