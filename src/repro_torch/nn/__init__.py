"""Module-style layers of the port."""

from repro_torch.nn.linear import ButterflyLinear, DenseLinear, SandwichLinear

__all__ = ["ButterflyLinear", "SandwichLinear", "DenseLinear"]
