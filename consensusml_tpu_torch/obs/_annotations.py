"""The port's own copy of the reference's lock annotation
(``consensusml_tpu/analysis/annotations.py``): stdlib only, so the
instrumented modules import it at load without pulling in anything else.
"""

from __future__ import annotations

__all__ = ["guarded_by"]


def guarded_by(lock_attr: str, *attrs: str):
    """Declare that ``self.<attr>`` (for each attr) may only be read or
    written while holding ``self.<lock_attr>``::

        @guarded_by("_lock", "_value", "_count")
        class Counter:
            ...

    At runtime this only records the contract on the class
    (``__guarded_by__``: attr -> lock attr, merged across decorators and
    base classes), as the reference's does; its static lock pass reads it.
    ``__init__`` is exempt (the object is not shared before construction
    completes).
    """
    if not isinstance(lock_attr, str) or not lock_attr:
        raise ValueError("guarded_by needs the lock attribute name first")
    if not attrs:
        raise ValueError("guarded_by needs at least one guarded attribute")

    def deco(cls):
        merged = dict(getattr(cls, "__guarded_by__", {}) or {})
        for a in attrs:
            merged[a] = lock_attr
        cls.__guarded_by__ = merged
        return cls

    return deco
