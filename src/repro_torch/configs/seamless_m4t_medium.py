"""SeamlessM4T-medium — encoder-decoder, multimodal [arXiv:2308.11596].

Per the assignment, the audio frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (B, enc_seq, d_model) consumed by a 12-layer
bidirectional encoder; the 12-layer decoder cross-attends to it. Decode
shapes exercise the decoder with cached cross-attention KV."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    n_enc_layers=12, enc_seq=1536,
    block_unit=("xdec",),
    mlp_variant="gelu_mlp",
    frontend="audio",
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="seamless-m4t-medium-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        n_enc_layers=2, enc_seq=24, blockwise_threshold=64,
        attn_block_q=16, attn_block_kv=16)
