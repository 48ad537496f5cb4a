"""Hydra-style config composition for the PyTorch port.

The port's copy of bifold_tpu/config/__init__.py: :class:`Config`,
:func:`merge`, :func:`compose` (:220; group overrides ``model=siglip``,
``dataset@train_dataset`` remapping, value overrides ``optim.lr=1e-3``,
``+k=v`` additions and ``~k`` deletions), :func:`resolve` (``${a.b}``
absolute and ``${.sibling}`` relative interpolation, ``${oc.env:VAR}`` and
``${oc.env:VAR,default}``, the cycle check, escaped ``${``),
:func:`to_yaml` and :func:`save`, with the same errors
(:class:`MissingConfigError`, :class:`InterpolationError`). It composes the
port's own conf directory (``bifold_tpu_torch/conf``, the same files and
values as the JAX package's), so ``compose(overrides).to_dict()`` equals the
JAX package's for the same overrides.

YAML is read with PyYAML's SafeLoader plus the float resolver of the JAX
package's ``_Loader`` (:46-62), so ``1e-4`` is a float as in Hydra and
OmegaConf. PyYAML is imported only when YAML is read or written: a host may
lack it, and the port's serving entry points also take the config as a dict.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Iterator

__all__ = [
    "Config",
    "compose",
    "load_yaml",
    "save",
    "to_yaml",
    "resolve",
    "merge",
    "MissingConfigError",
    "InterpolationError",
]

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")
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


class MissingConfigError(KeyError):
    """A referenced config group/option/key does not exist."""


class InterpolationError(ValueError):
    """An interpolation could not be resolved (missing key or cycle)."""


class Config(dict):
    """A nested dict with attribute access. ``cfg.model.dim`` == ``cfg["model"]["dim"]``.

    Mutation is allowed (tests override freely); nested dicts are wrapped on
    access so attribute chains always work.
    """

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, key: str) -> Any:
        value = dict.__getitem__(self, key)
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            dict.__setitem__(self, key, value)
        return value

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def select(self, dotted: str, default: Any = None) -> Any:
        """Fetch ``a.b.c``-style path; returns ``default`` when absent."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part] if isinstance(node, Config) else node[part]
        return node

    def to_dict(self) -> dict:
        return _unwrap(self)

    def copy(self) -> "Config":  # type: ignore[override]
        return Config(copy.deepcopy(self.to_dict()))


def _unwrap(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _unwrap(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_unwrap(v) for v in node]
    return node


def merge(base: dict, override: dict) -> dict:
    """Recursive dict merge; ``override`` wins; dicts merge, everything else replaces."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML scalar semantics (``1e-4`` -> float, etc.)."""
    import yaml

    try:
        return yaml.load(text, Loader=_loader())
    except yaml.YAMLError:
        return text


def _set_dotted(tree: dict, dotted: str, value: Any, *, create: bool = True) -> None:
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            if not create:
                raise MissingConfigError(f"Could not override '{dotted}': '{part}' missing")
            node[part] = {}
        node = node[part]
    node[parts[-1]] = value


def _del_dotted(tree: dict, dotted: str) -> None:
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        if part not in node:
            return
        node = node[part]
    node.pop(parts[-1], None)


def _iter_defaults(defaults: list) -> Iterator[tuple[str, str, str]]:
    """Yield (group, target_key, option) triples from a Hydra-style defaults list."""
    for entry in defaults:
        if entry == "_self_":
            yield ("_self_", "_self_", "_self_")
            continue
        if not isinstance(entry, dict):
            continue
        for raw_key, option in entry.items():
            key = str(raw_key)
            if key.startswith("override "):
                key = key[len("override "):]
            if key.startswith("hydra"):
                continue  # hydra's own config groups are not part of our tree
            if "@" in key:
                group, target = key.split("@", 1)
            else:
                group, target = key, key
            yield (group, target, option)


def _load_group_option(config_dir: Path, group: str, option: Any) -> dict | None:
    if option is None or option == "null":
        # `dataset@test_dataset: none` style: load the group's none.yaml when it
        # exists, else an empty node.
        none_path = config_dir / group / "none.yaml"
        if none_path.exists():
            return load_yaml(none_path)
        return None
    path = config_dir / group / f"{option}.yaml"
    if not path.exists():
        available = sorted(p.stem for p in (config_dir / group).glob("*.yaml"))
        raise MissingConfigError(
            f"Config group '{group}' has no option '{option}'. Available: {available}"
        )
    return load_yaml(path)


DEFAULT_CONFIG_DIR = Path(__file__).resolve().parent.parent / "conf"


def compose(
    overrides: list[str] | None = None,
    config_name: str = "config",
    config_dir: str | Path | None = None,
) -> Config:
    """Compose the config tree the way ``hydra.main`` would for the reference CLI.

    Group overrides (``model=siglip``) swap which option file a defaults entry
    loads; value overrides (``optim.lr=1e-3``) are applied after composition;
    ``+a.b=c`` adds new keys, ``~a.b`` deletes.
    """
    config_dir = Path(config_dir) if config_dir is not None else DEFAULT_CONFIG_DIR
    overrides = list(overrides or [])

    primary = load_yaml(config_dir / f"{config_name}.yaml")
    defaults = primary.pop("defaults", [])
    primary.pop("hydra", None)

    # Partition overrides into group selections vs value overrides. A bare
    # key may name a group dir (``model=siglip``) or a defaults-entry target
    # (``train_dataset=synthetic`` for ``dataset@train_dataset``).
    group_dirs = {p.name for p in config_dir.iterdir() if p.is_dir()}
    target_keys = {target for _, target, _ in _iter_defaults(defaults)
                   if target != "_self_"}
    group_choice: dict[str, Any] = {}
    value_overrides: list[tuple[str, str, Any]] = []
    for ov in overrides:
        if ov.startswith("~"):
            value_overrides.append(("del", ov[1:], None))
            continue
        add = ov.startswith("+")
        if add:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Malformed override (expected key=value): {ov!r}")
        key, _, raw = ov.partition("=")
        key = key.strip()
        value = _parse_value(raw)
        head = key.split(".", 1)[0].split("@", 1)[0]
        if "." not in key and (head in group_dirs or key in target_keys):
            group_choice[key] = value
        else:
            value_overrides.append(("add" if add else "set", key, value))

    composed: dict = {}
    self_merged = False
    for group, target, option in _iter_defaults(defaults):
        if group == "_self_":
            composed = merge(composed, primary)
            self_merged = True
            continue
        # CLI may override the chosen option for this group (by group name or
        # by the `group@target` spelling).
        option = group_choice.pop(f"{group}@{target}", group_choice.pop(
            target if target != group else group, option))
        node = _load_group_option(config_dir, group, option)
        if node is not None:
            composed = merge(composed, {target: node})
        else:
            composed = merge(composed, {target: {"name": None}})
    if not self_merged:
        composed = merge(composed, primary)
    # Group selections for groups that were not in the defaults list at all.
    for key, option in group_choice.items():
        group = key.split("@", 1)[0]
        target = key.split("@", 1)[1] if "@" in key else group
        node = _load_group_option(config_dir, group, option)
        composed = merge(composed, {target: node if node is not None else {"name": None}})

    for kind, key, value in value_overrides:
        if kind == "del":
            _del_dotted(composed, key)
        else:
            _set_dotted(composed, key, value, create=True)

    resolve(composed)
    return Config(composed)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

_MISSING = object()


def _lookup(root: dict, parent_path: tuple[str, ...],
            expr: str) -> tuple[Any, tuple[str, ...]]:
    """Resolve ``expr`` to ``(value, target_parent_path)``.

    The target's OWN parent path rides along so interpolations inside the
    referenced value resolve relative to the *target's* location, not the
    referrer's — ``${a.y}`` with ``a.y = '${.x}'`` must read ``a.x``
    wherever the referrer sits (resolution used to be dict-order dependent
    without this)."""
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        payload = expr[len("oc.env:"):]
        if "," in payload:
            var, default = payload.split(",", 1)
            return os.environ.get(var.strip(), default.strip()), ()
        var = payload.strip()
        if var not in os.environ:
            raise InterpolationError(f"Environment variable '{var}' is not set")
        return os.environ[var], ()
    if expr.startswith("."):
        # Relative: one leading dot = sibling of the current node; each extra
        # dot walks one level further up.
        up = len(expr) - len(expr.lstrip("."))
        rel = expr.lstrip(".")
        base = parent_path[: len(parent_path) - (up - 1)] if up > 1 else parent_path
        path = list(base) + ([p for p in rel.split(".") if p])
    else:
        path = [p for p in expr.split(".") if p]
    node: Any = root
    for part in path:
        if not isinstance(node, dict) or part not in node:
            return _MISSING, ()
        node = node[part]
    return node, tuple(path)


# placeholder protecting ``\${`` escapes (literal "${" in a value) from the
# interpolation regex while a value is being resolved
_ESCAPED_DOLLAR = "\x00bifold_esc_dollar\x00"


def _resolve_value(root: dict, path: tuple[str, ...], value: Any, stack: tuple) -> Any:
    # ``_INTERP_RE`` matches only *innermost* ``${...}`` (no braces inside), so
    # looping resolves nested expressions inside-out, e.g.
    # ``${oc.env:ROOT,${oc.env:HOME}/data}``.
    if not (isinstance(value, str) and "${" in value):
        return value
    value = value.replace("\\${", _ESCAPED_DOLLAR)
    for _ in range(16):
        if not (isinstance(value, str) and "${" in value):
            break
        full = _INTERP_RE.fullmatch(value)
        if full:  # whole-string interpolation preserves the referenced type
            value = _resolve_expr(root, path, full.group(1), stack)
            continue

        def sub(m: re.Match) -> str:
            resolved = _resolve_expr(root, path, m.group(1), stack)
            return "" if resolved is None else str(resolved)

        new = _INTERP_RE.sub(sub, value)
        if new == value:
            # contains "${" but nothing the grammar can match: an
            # unterminated interpolation, not a nesting problem
            raise InterpolationError(
                f"Unterminated '${{' in {value!r} at "
                f"{'.'.join(path) or '<root>'} — escape a literal as \\${{")
        value = new
    else:
        raise InterpolationError(
            f"Interpolation nesting too deep at {'.'.join(path)}")
    if isinstance(value, str):
        value = value.replace(_ESCAPED_DOLLAR, "${")
    return value


def _resolve_expr(root: dict, path: tuple[str, ...], expr: str, stack: tuple) -> Any:
    target, target_path = _lookup(root, path, expr)
    if target is _MISSING:
        raise InterpolationError(
            f"Interpolation '${{{expr}}}' (at {'.'.join(path) or '<root>'}) not found"
        )
    # Cycle key = the target's absolute node path (two DIFFERENT nodes both
    # referenced as '${.x}' along one chain must not false-positive, and a
    # mixed relative/absolute cycle must still be caught).
    key = ("env:" + expr if expr.strip().startswith("oc.env:")
           else ".".join(target_path))
    if key in stack:
        raise InterpolationError(f"Interpolation cycle through '${{{expr}}}'")
    # The referenced value may itself contain interpolations — resolve them
    # against the TARGET's parent path, not the referrer's.
    return _resolve_value(root, target_path[:-1], target, stack + (key,))


def resolve(tree: dict) -> dict:
    """Resolve all ``${...}`` interpolations in-place (eager, cycle-checked)."""

    def walk(node: Any, path: tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            for k in list(node):
                node[k] = walk(node[k], path + (str(k),))
            return node
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return _resolve_value(tree, path[:-1], node, ())

    walk(tree, ())
    return tree


def to_yaml(cfg: Config | dict) -> str:
    import yaml

    data = cfg.to_dict() if isinstance(cfg, Config) else _unwrap(cfg)
    return yaml.safe_dump(data, default_flow_style=False, sort_keys=False)


def save(cfg: Config | dict, path: str | Path) -> None:
    """Snapshot the composed config into the run dir (reference: __main__.py:27-28)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(to_yaml(cfg))
