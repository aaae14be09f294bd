"""Entry points of the port."""

from __future__ import annotations


def ported_config(name: str):
    """The registry's config ``name`` for the command lines:
    ``SystemExit`` for an unknown name."""
    from repro_torch.configs import registry
    try:
        return registry.get(name)
    except KeyError as e:
        raise SystemExit(e.args[0])
