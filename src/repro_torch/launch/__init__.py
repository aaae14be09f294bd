"""Entry points of the port."""

from __future__ import annotations


def ported_config(name: str):
    """The registry's config ``name`` for the command lines: ``SystemExit``
    for an unknown name, or for an arch whose blocks the port does not
    build yet, naming the ROADMAP sub-item that brings them
    (:func:`repro_torch.models.lm.unported_reason`)."""
    from repro_torch.configs import registry
    from repro_torch.models.lm import unported_reason
    try:
        cfg = registry.get(name)
    except KeyError as e:
        raise SystemExit(e.args[0])
    reason = unported_reason(cfg)
    if reason is not None:
        raise SystemExit(reason)
    return cfg
