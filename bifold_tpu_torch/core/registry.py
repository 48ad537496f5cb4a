"""String-keyed component registries.

The port's copy of bifold_tpu/core/registry.py (:18 ``Registry``).
Mirrors the reference's factory pattern where config keys ARE constructor
signatures: registries consume a config node by popping ``name`` and splatting
the remaining keys as kwargs (reference: bifold/models/__init__.py:12-27,
bifold/losses/__init__.py:5-27, bifold/optim/__init__.py:4-25).
"""

from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")

__all__ = ["Registry"]


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Callable[..., T]] = {}

    def register(self, name: str | None = None) -> Callable[[Callable[..., T]], Callable[..., T]]:
        def deco(fn: Callable[..., T]) -> Callable[..., T]:
            key = name or getattr(fn, "__name__", str(fn))
            if key in self._entries:
                raise KeyError(f"{self.kind} '{key}' registered twice")
            self._entries[key] = fn
            return fn

        return deco

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> list[str]:
        return sorted(self._entries)

    def get(self, name: str) -> Callable[..., T]:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Available: {self.names()}"
            ) from None

    def build(self, cfg: dict, /, **extra: Any) -> T:
        """Instantiate from a config node: pop ``name``, splat the rest as kwargs."""
        node = {k: v for k, v in dict(cfg).items() if k != "name"}
        name = dict(cfg).get("name")
        if name is None:
            raise KeyError(f"{self.kind} config node has no 'name': {sorted(node)}")
        node.update(extra)
        return self.get(name)(**node)
