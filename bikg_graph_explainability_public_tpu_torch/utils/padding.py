"""Padding helpers: every ragged size is rounded to a capacity from a small
set of buckets, so plan and subgraph shapes repeat across queries."""

from __future__ import annotations


def round_up(n: int, multiple: int) -> int:
    """Round ``n`` up to the nearest positive multiple of ``multiple``."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def round_up_pow2(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to the nearest power of two (at least ``minimum``).

    A 2x geometric ladder bounds the number of distinct padded sizes at
    ``log2(N)`` while wasting at most 2x memory.
    """
    if n <= minimum:
        return minimum
    p = 1 << (n - 1).bit_length()
    return max(p, minimum)


def pad_budget(n: int, mode: str = "pow2", multiple: int = 8) -> int:
    """Select a padded capacity for an actual size ``n``."""
    if mode == "pow2":
        return round_up_pow2(n, minimum=multiple)
    if mode == "multiple":
        return round_up(n, multiple)
    if mode == "exact":
        return max(n, 1)
    raise ValueError(f"unknown padding mode: {mode!r}")
