"""Filter registry: one functional protocol, many AMQ implementations.

The port of ``repro.filters.registry``.  Every implementation registers
a :class:`FilterImpl` record binding its config class (a hashable
NamedTuple) to the protocol's operations; the façade in
``repro_torch.filters`` dispatches on ``type(cfg)``.

Protocol (states are NamedTuples of tensors)::

    make(device=None, **spec)     -> (cfg, state)
    insert(cfg, state, keys, k)   -> state
    contains(cfg, state, keys)    -> bool[B]
    delete(cfg, state, keys, k)   -> state          (optional)
    merge(cfg, state_a, state_b)  -> state          (optional)
    probe(cfg, state, keys)       -> (state, bool[B])  # contains + I/O accounting
    stats(cfg, state)             -> dict[str, scalar]
    needs_resize(cfg, state)      -> bool[]         (optional, on the device)
    needs_shrink(cfg, state)      -> bool[]         (optional, on the device)
    grow / resize / shrink        -> (cfg, state)   (optional, host-level)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class UnsupportedOpError(NotImplementedError):
    """A filter family (or this particular config of it) rejects an op.

    Carries ``family``/``op``/``hint`` so callers can branch on
    capability rather than string-match a message.
    """

    def __init__(self, family: str, op: str, hint: str = ""):
        self.family = family
        self.op = op
        self.hint = hint
        msg = f"filter family {family!r} does not support {op!r}"
        if hint:
            msg = f"{msg} ({hint})"
        super().__init__(msg)


class FilterImpl(NamedTuple):
    name: str
    paper_section: str
    cfg_cls: type
    make: Callable  # (device=None, **spec) -> (cfg, state)
    insert: Optional[Callable]  # (cfg, state, keys, k=None) -> state
    contains: Callable  # (cfg, state, keys) -> bool[B]
    stats: Callable  # (cfg, state) -> dict
    delete: Optional[Callable] = None
    merge: Optional[Callable] = None
    probe: Optional[Callable] = None  # (cfg, state, keys) -> (state, bool[B])
    needs_resize: Optional[Callable] = None
    grow: Optional[Callable] = None
    resize: Optional[Callable] = None
    needs_shrink: Optional[Callable] = None
    shrink: Optional[Callable] = None
    # config-dependent capability; None means "delete works for every cfg"
    can_delete: Optional[Callable] = None  # (cfg) -> bool
    # hint strings surfaced in UnsupportedOpError, keyed by op name
    op_hints: dict = {}

    def deletable(self, cfg=None) -> bool:
        if self.delete is None:
            return False
        if cfg is None or self.can_delete is None:
            return True
        return bool(self.can_delete(cfg))

    def require(self, op: str, cfg=None) -> Callable:
        """The bound op, or a structured :class:`UnsupportedOpError`."""
        fn = getattr(self, op, None)
        if fn is None or (op == "delete" and not self.deletable(cfg)):
            raise UnsupportedOpError(self.name, op, self.op_hints.get(op, ""))
        return fn


_BY_NAME: dict[str, FilterImpl] = {}
_BY_CFG: dict[type, FilterImpl] = {}
_INTERNAL: set[str] = set()


def register(impl: FilterImpl, public: bool = True) -> FilterImpl:
    """Bind a family; ``public=False`` keeps it out of :func:`names` (the
    in-flight migration, which callers never construct by name)."""
    if impl.name in _BY_NAME:
        raise ValueError(f"filter {impl.name!r} already registered")
    _BY_NAME[impl.name] = impl
    _BY_CFG[impl.cfg_cls] = impl
    if not public:
        _INTERNAL.add(impl.name)
    return impl


def names() -> tuple[str, ...]:
    return tuple(sorted(set(_BY_NAME) - _INTERNAL))


def by_name(name: str) -> FilterImpl:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown filter {name!r}; registered: {', '.join(names())}"
        ) from None


def by_cfg(cfg) -> FilterImpl:
    try:
        return _BY_CFG[type(cfg)]
    except KeyError:
        raise TypeError(
            f"{type(cfg).__name__} is not a registered filter config"
        ) from None
