"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention, 1:2
attn:recurrent [arXiv:2402.19427]. 26 layers = 8 x (rec, rec, attn) + 2 rec
tail; attention layers use a 2048-token sliding window (MQA, kv=1)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    sliding_window=2048, lru_width=2560, conv_width=4,
    block_unit=("rec", "rec", "local"),
    mlp_variant="geglu",
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="recurrentgemma-2b-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512, lru_width=64,
        sliding_window=16, blockwise_threshold=64,
        attn_block_q=16, attn_block_kv=16)
