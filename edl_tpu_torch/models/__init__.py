"""Model zoo of the port: the counterparts of `edl_tpu.models`.

All six of the JAX package's models: ``fit_a_line``, ``mnist``,
``word2vec``, ``ctr`` (the flagship), ``resnet`` (registered as
``resnet50``) and ``transformer``. Every model is a `models.base.Model`
bundle whose ``build`` returns an ``nn.Module``.
"""

from edl_tpu_torch.models import ctr, fit_a_line, mnist, resnet, transformer, word2vec
from edl_tpu_torch.models.base import Model

_MODULES = {
    "fit_a_line": fit_a_line,
    "mnist": mnist,
    "word2vec": word2vec,
    "ctr": ctr,
    "resnet": resnet,
    "transformer": transformer,
}

#: default instances, keyed by each model's own name (module name and model
#: name differ where one module serves a family: resnet -> resnet50)
_REGISTRY = {mod.MODEL.name: mod.MODEL for mod in _MODULES.values()}


def get(name: str) -> Model:
    """Look up a zoo model's default instance by name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def resolve(ref: str, config=None) -> Model:
    """Rebuild a zoo model from (module ref, make_model kwargs). ``ref``
    names a zoo module; with no config, registry names (``resnet50``) work
    too."""
    if not config:
        if ref in _MODULES:
            return _MODULES[ref].MODEL
        return get(ref)
    if ref not in _MODULES:
        raise KeyError(f"unknown model module {ref!r}; have {sorted(_MODULES)}")
    mod = _MODULES[ref]
    if not hasattr(mod, "make_model"):
        raise TypeError(f"model {ref!r} is not configurable (no make_model)")
    return mod.make_model(**config)


__all__ = ["Model", "ctr", "fit_a_line", "get", "mnist", "resnet", "resolve",
           "transformer", "word2vec"]
