"""Materialized batches ``B|_{T,A}`` (paper Def. 3.6).

A batch is a temporal slice of the graph enriched with a set of *attributes*
``A`` (tensors a model consumes). Hooks transform batches by producing new
attributes; the batch tracks which attributes are present so hook contracts
(requires ⊂ A) can be validated at runtime as well as at recipe-build time.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, KeysView, Set


class Batch:
    """Attribute-tracked batch container.

    Behaves like a dict of named tensors; ``attrs`` is the paper's ``A``.
    Base attributes after materialization: ``src, dst, time`` (+``edge_feats``
    etc. when present). ``meta`` carries non-tensor info (time window, sizes).
    """

    __slots__ = ("_data", "meta")

    def __init__(self, data: Dict[str, Any] | None = None, meta: Dict[str, Any] | None = None):
        self._data: Dict[str, Any] = dict(data or {})
        self.meta: Dict[str, Any] = dict(meta or {})

    # -- attribute set (paper's A) -----------------------------------------
    @property
    def attrs(self) -> Set[str]:
        return set(self._data.keys())

    def require(self, *names: str) -> None:
        missing = [n for n in names if n not in self._data]
        if missing:
            raise KeyError(
                f"batch is missing required attributes {missing}; "
                f"present: {sorted(self._data)}"
            )

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        if name not in self._data:
            raise KeyError(
                f"batch attribute {name!r} not present; available: {sorted(self._data)}"
            )
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def keys(self) -> KeysView[str]:
        return self._data.keys()

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def update(self, other: Dict[str, Any]) -> None:
        self._data.update(other)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    @property
    def num_events(self) -> int:
        src = self._data.get("src")
        return 0 if src is None else len(src)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Batch(attrs={sorted(self._data)}, meta={self.meta})"
