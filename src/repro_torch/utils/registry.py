"""A tiny string-keyed registry used for architectures, schedulers and kernels."""

from __future__ import annotations

from typing import Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, T] = {}

    def register(self, name: str, item: T | None = None):
        """Register ``item`` under ``name``; usable as a decorator."""
        if item is not None:
            self._set(name, item)
            return item

        def deco(fn: T) -> T:
            self._set(name, fn)
            return fn

        return deco

    def _set(self, name: str, item: T) -> None:
        if name in self._items:
            raise ValueError(f"duplicate {self.kind} registration: {name!r}")
        self._items[name] = item

    def get(self, name: str) -> T:
        if name not in self._items:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self) -> list[str]:
        return sorted(self._items)

    def items(self) -> Iterator[tuple[str, T]]:
        return iter(sorted(self._items.items()))
