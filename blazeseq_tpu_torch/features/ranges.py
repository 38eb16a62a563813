"""1-based genomic coordinates (reference: blazeseq/features/ranges.mojo,
noodles-aligned)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True, order=True)
class Position:
    """1-based genomic coordinate; values >= 1 (ranges.mojo:6-44)."""

    _value: int

    def __post_init__(self):
        if self._value < 1:
            raise ValueError("Position must be >= 1")

    def get(self) -> int:
        return self._value


@dataclass(frozen=True)
class Interval:
    """1-based closed interval [start, end] (ranges.mojo:52-103)."""

    _start: Position
    _end: Position

    def __post_init__(self):
        if self._start.get() > self._end.get():
            raise ValueError("Interval start must be <= end")

    def start(self) -> Position:
        return self._start

    def end(self) -> Position:
        return self._end

    def length(self) -> int:
        return self._end.get() - self._start.get() + 1

    def is_empty(self) -> bool:
        return self._start.get() > self._end.get()

    def contains(self, position: Position) -> bool:
        return self._start.get() <= position.get() <= self._end.get()

    def intersects(self, other: "Interval") -> bool:
        return (self._start.get() <= other._end.get()
                and other._start.get() <= self._end.get())


def position_try_from(value: int) -> Optional[Position]:
    """Position if value >= 1 else None (reference: _bed/record.mojo:82-87)."""
    if value < 1:
        return None
    return Position(value)


def interval_try_from_start_end(start: int, end: int) -> Optional[Interval]:
    """Interval from 1-based closed bounds, or None when invalid."""
    if start < 1 or end < 1 or start > end:
        return None
    return Interval(Position(start), Position(end))
