"""The llama-style LM of the port (``block_unit=("attn",)``)."""
