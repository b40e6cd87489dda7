"""Model zoo of the port: the counterparts of `edl_tpu.models`.

Ported so far: ``transformer`` (the dense decoder-only LM). Every model is a
`models.base.Model` bundle whose ``build`` returns an ``nn.Module``.
"""

from edl_tpu_torch.models import transformer
from edl_tpu_torch.models.base import Model

_MODULES = {"transformer": transformer}

#: default instances, keyed by each model's own name
_REGISTRY = {mod.MODEL.name: mod.MODEL for mod in _MODULES.values()}


def get(name: str) -> Model:
    """Look up a zoo model's default instance by name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def resolve(ref: str, config=None) -> Model:
    """Rebuild a zoo model from (module ref, make_model kwargs)."""
    if not config:
        if ref in _MODULES:
            return _MODULES[ref].MODEL
        return get(ref)
    if ref not in _MODULES:
        raise KeyError(f"unknown model module {ref!r}; have {sorted(_MODULES)}")
    return _MODULES[ref].make_model(**config)


__all__ = ["Model", "get", "resolve", "transformer"]
