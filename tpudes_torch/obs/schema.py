"""Shared primitive of the dependency-free obs schema validators: one
``need()`` closure per problems list, so every validator reports type and
presence violations in the same words.  A copy of
``tpudes/obs/schema.py`` (``:1-31``).
"""

from __future__ import annotations

__all__ = ["make_need"]


def make_need(problems: list[str]):
    """A ``need(obj, key, types, where)`` closure that appends a
    human-readable problem on failure and returns the value (or None)."""

    def need(obj, key, types, where):
        if not isinstance(obj, dict):
            problems.append(f"{where}: not an object")
            return None
        if key not in obj:
            problems.append(f"{where}: missing key {key!r}")
            return None
        if not isinstance(obj[key], types):
            problems.append(
                f"{where}.{key}: expected {types}, got "
                f"{type(obj[key]).__name__}"
            )
            return None
        return obj[key]

    return need
