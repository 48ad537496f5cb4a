"""Config loading for the PyTorch port.

The port's own copy of ``load_yaml`` and its ``_Loader``
(bifold_tpu/config/__init__.py:46-62, :132): a YAML file such as the
``config.yaml`` snapshot a training run leaves in its run dir, read with a
SafeLoader that also parses ``1e-4``-style scientific notation as a float
(YAML 1.1 would return a string; Hydra and OmegaConf return a float).

PyYAML is imported only when a YAML file is read: a host may lack it, and
every entry point of the port also takes the config as a dict.
"""

from __future__ import annotations

import re
from pathlib import Path

__all__ = ["load_yaml"]

_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_LOADER = None


def _loader():
    """The SafeLoader subclass with the float resolver, made on first use."""
    global _LOADER
    if _LOADER is None:
        import yaml

        class _Loader(yaml.SafeLoader):
            pass

        _Loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT,
                                      list("-+0123456789."))
        _LOADER = _Loader
    return _LOADER


def load_yaml(path: str | Path) -> dict:
    """The YAML file at ``path`` as a dict ({} for an empty file)."""
    import yaml

    with open(path) as f:
        data = yaml.load(f, Loader=_loader())
    return data or {}
