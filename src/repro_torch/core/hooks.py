"""Hooks and hook management (paper Defs. 3.7-3.8).

A hook ``phi_{R,P}`` is a transformation on a materialized batch that
declares a typed contract: the attributes it *requires* on input and the
attributes it *produces*. A set of hooks is a valid *recipe* iff the induced
dependency graph is acyclic and every requirement is satisfied by some
earlier producer (or by the base materialization); recipes are executed in
topological order.

The ``HookManager`` owns hook state, resolves the ordering once at build
time (invalid recipes fail fast with a precise diagnostic), supports keyed
activation groups (e.g. ``train`` vs ``eval`` hooks), and exposes a single
``reset_state`` for all stateful hooks. The hook/recipe formalism and the
``state_dict`` checkpoint contract are documented in
``docs/architecture.md``.
"""

from __future__ import annotations

from graphlib import CycleError, TopologicalSorter
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence

from repro_torch.core.batch import Batch

# Attributes present on every materialized batch before any hook runs.
BASE_ATTRS: FrozenSet[str] = frozenset({"src", "dst", "time"})


class Hook:
    """Base hook. Subclass and implement ``__call__``; declare the contract
    via class attributes or constructor arguments.

    ``name`` is the display identity (diagnostics, ``repr``);
    ``state_key`` is the checkpoint identity used by
    ``HookManager.state_dict`` and defaults to ``name``. Hooks whose state
    is interchangeable with a twin implementation (e.g. host/device sampler
    pairs) share a ``state_key`` so checkpoints restore across pipeline
    flavors, without masquerading in error messages.
    """

    requires: FrozenSet[str] = frozenset()
    produces: FrozenSet[str] = frozenset()
    name: str = ""

    def __init__(
        self,
        requires: Optional[Iterable[str]] = None,
        produces: Optional[Iterable[str]] = None,
        name: Optional[str] = None,
        state_key: Optional[str] = None,
    ):
        if requires is not None:
            self.requires = frozenset(requires)
        else:
            self.requires = frozenset(type(self).requires)
        if produces is not None:
            self.produces = frozenset(produces)
        else:
            self.produces = frozenset(type(self).produces)
        self.name = name or type(self).__name__
        self.state_key = state_key or self.name

    # Stateful hooks override these.
    def reset_state(self) -> None:
        pass

    # Checkpointable hooks override these (return/accept a dict of numpy
    # arrays; the default is stateless).
    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None:
        if state:
            raise ValueError(
                f"hook {self.name!r} is stateless but got state {sorted(state)}"
            )

    def __call__(self, batch: Batch) -> Batch:  # pragma: no cover - abstract
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.name}(R={sorted(self.requires)}, P={sorted(self.produces)})"


class LambdaHook(Hook):
    """Wrap a plain function as a hook."""

    def __init__(
        self,
        fn: Callable[[Batch], Batch],
        requires: Iterable[str] = (),
        produces: Iterable[str] = (),
        name: Optional[str] = None,
    ):
        super().__init__(requires, produces, name or getattr(fn, "__name__", "lambda"))
        self._fn = fn

    def __call__(self, batch: Batch) -> Batch:
        return self._fn(batch)


class RecipeError(ValueError):
    """Invalid hook recipe: unsatisfied requirement or dependency cycle."""


def resolve_order(hooks: Sequence[Hook], base_attrs: FrozenSet[str] = BASE_ATTRS) -> List[Hook]:
    """Topologically order ``hooks`` by their R/P contracts (paper Eq. 3).

    ``phi_i -> phi_j`` iff ``P_i ∩ R_j != ∅``. Raises ``RecipeError`` if a
    requirement is produced by no hook (and absent from ``base_attrs``) or if
    the dependency graph is cyclic. Ties are broken by registration order so
    execution is deterministic.
    """
    produced_by: Dict[str, List[int]] = {}
    for i, h in enumerate(hooks):
        for attr in h.produces:
            produced_by.setdefault(attr, []).append(i)

    all_available = set(base_attrs) | set(produced_by)
    for h in hooks:
        missing = h.requires - all_available
        if missing:
            raise RecipeError(
                f"hook {h.name!r} requires {sorted(missing)} which no hook "
                f"produces and is not a base attribute {sorted(base_attrs)}"
            )

    ts: TopologicalSorter = TopologicalSorter()
    for j, h in enumerate(hooks):
        deps = set()
        for attr in h.requires:
            for i in produced_by.get(attr, []):
                if i != j:
                    deps.add(i)
        ts.add(j, *sorted(deps))
    try:
        ts.prepare()
    except CycleError as e:
        cyc = [hooks[i].name for i in e.args[1] if isinstance(i, int)]
        raise RecipeError(f"hook dependency cycle: {cyc}") from e

    # Kahn's algorithm with registration-order tie-breaking for determinism.
    order: List[int] = []
    ready = sorted(ts.get_ready())
    while ready:
        n = ready.pop(0)
        order.append(n)
        ts.done(n)
        ready = sorted(set(ready) | set(ts.get_ready()))
    return [hooks[i] for i in order]


class HookManager:
    """Registry + executor for hooks, with keyed activation groups.

    Hooks are registered under string keys (default ``"shared"``); shared
    hooks always run. ``activate(key)`` selects which keyed group is live,
    e.g. negative-sampling under ``"train"`` vs fixed negatives under
    ``"eval"``. Ordering is (re)resolved lazily and cached per active key.
    """

    SHARED_KEY = "shared"

    def __init__(self, base_attrs: FrozenSet[str] = BASE_ATTRS):
        self._groups: Dict[str, List[Hook]] = {self.SHARED_KEY: []}
        self._active: Optional[str] = None
        self._order_cache: Dict[Optional[str], List[Hook]] = {}
        self._base_attrs = base_attrs

    # -- registration -------------------------------------------------------
    def register(self, hook: Hook, key: str = SHARED_KEY) -> "HookManager":
        self._groups.setdefault(key, []).append(hook)
        self._order_cache.clear()
        # Validate eagerly (optimistically) so a clearly-bad recipe fails at
        # registration time: every requirement must be producible by *some*
        # registered hook in any group, or be a base attribute. Strict
        # per-activation validation happens at resolve time.
        available = set(self._base_attrs)
        for group in self._groups.values():
            for h in group:
                available |= h.produces
        missing = hook.requires - available
        if missing:
            raise RecipeError(
                f"hook {hook.name!r} requires {sorted(missing)} which no "
                f"registered hook produces and is not a base attribute"
            )
        return self

    def register_all(self, hooks: Iterable[Hook], key: str = SHARED_KEY) -> "HookManager":
        for h in hooks:
            self.register(h, key)
        return self

    @property
    def keys(self) -> List[str]:
        return [k for k in self._groups if k != self.SHARED_KEY]

    def hooks(self, key: Optional[str] = None) -> List[Hook]:
        out = list(self._groups[self.SHARED_KEY])
        if key is not None:
            out += self._groups.get(key, [])
        return out

    # -- activation ----------------------------------------------------------
    def activate(self, key: str) -> "_Activation":
        if key != self.SHARED_KEY and key not in self._groups:
            # Activating an empty group is allowed (only shared hooks run).
            self._groups.setdefault(key, [])
            self._order_cache.clear()
        return _Activation(self, key)

    @property
    def active_key(self) -> Optional[str]:
        return self._active

    # -- execution ------------------------------------------------------------
    def _resolve(self, key: Optional[str]) -> List[Hook]:
        if key not in self._order_cache:
            self._order_cache[key] = resolve_order(self.hooks(key), self._base_attrs)
        return self._order_cache[key]

    def execute(self, batch: Batch) -> Batch:
        for hook in self._resolve(self._active):
            hook.require_ok = batch.require(*hook.requires)  # runtime contract
            batch = hook(batch)
            missing = hook.produces - batch.attrs
            if missing:
                raise RecipeError(
                    f"hook {hook.name!r} declared produces={sorted(hook.produces)} "
                    f"but did not produce {sorted(missing)}"
                )
        return batch

    # -- state ---------------------------------------------------------------
    def reset_state(self) -> None:
        """Single API to clear the state of all registered hooks (paper §4)."""
        for group in self._groups.values():
            for hook in group:
                hook.reset_state()

    def state_dict(self) -> Dict[str, Dict]:
        """Collect every stateful hook's state, keyed
        ``<group>/<idx>/<state_key>`` (registration position makes keys
        stable across rebuilds; ``state_key`` — not display ``name`` — so
        host/device hook twins interchange). Leaves are numpy arrays, so the
        result drops straight into ``distributed.checkpoint.save``."""
        out: Dict[str, Dict] = {}
        for key, group in self._groups.items():
            for i, hook in enumerate(group):
                state = hook.state_dict()
                if state:
                    out[f"{key}/{i}/{hook.state_key}"] = state
        return out

    def load_state_dict(self, state: Dict[str, Dict]) -> None:
        """Restore hook states collected by ``state_dict`` (matched by
        ``<group>/<idx>/<state_key>``, falling back to the display name for
        checkpoints written before ``state_key`` existed); unmatched
        entries raise."""
        seen = set()
        for key, group in self._groups.items():
            for i, hook in enumerate(group):
                for k in (f"{key}/{i}/{hook.state_key}",
                          f"{key}/{i}/{hook.name}"):
                    if k in state and k not in seen:
                        hook.load_state_dict(state[k])
                        seen.add(k)
                        break
        missing = set(state) - seen
        if missing:
            raise KeyError(f"no registered hook matches state {sorted(missing)}")


class _Activation:
    """Context manager for ``with manager.activate('train'):``."""

    def __init__(self, manager: HookManager, key: str):
        self._m = manager
        self._key = key
        self._prev: Optional[str] = None

    def __enter__(self) -> HookManager:
        self._prev = self._m._active
        self._m._active = self._key
        return self._m

    def __exit__(self, *exc) -> None:
        self._m._active = self._prev
