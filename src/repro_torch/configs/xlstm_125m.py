"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517]. 12 layers at an
~5:1 mLSTM:sLSTM ratio (2 x (5 mLSTM + 1 sLSTM)); d_ff=0 per the assignment
(mLSTM blocks carry their own 2x up/down projections; sLSTM blocks a 4/3
gated FFN, per the xLSTM paper's block design)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=192,
    conv_width=4,
    block_unit=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_chunk=256,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        name="xlstm-125m-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, vocab_size=512, mlstm_chunk=16,
        blockwise_threshold=64, attn_block_q=16, attn_block_kv=16)
