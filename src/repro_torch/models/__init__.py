"""The LM of the port: the block units ``attn``, ``global`` and ``moe``."""
