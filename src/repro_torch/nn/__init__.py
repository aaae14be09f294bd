"""Module-style layers of the port."""

from repro_torch.nn.linear import ButterflyLinear, DenseLinear

__all__ = ["ButterflyLinear", "DenseLinear"]
