"""Power-of-two shape quantization (port of ``repro/core/shapes.py``).

Every layer that picks an array dimension or a padded batch width uses
these helpers so that all layers land on the same small family of shapes.
"""
from __future__ import annotations


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= ``n`` (and >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def grow_capacity(need: int) -> int:
    """Capacity jump for organic growth: the next power of two with 2x
    headroom over ``need``, so repeated growth is geometric."""
    return pow2_at_least(2 * max(int(need), 1))


def bucket_width(n: int, batch_bucket: int) -> int:
    """Padded batch width: multiples of ``batch_bucket`` above it, else the
    next power of two (min 256)."""
    if n >= batch_bucket:
        return ((n + batch_bucket - 1) // batch_bucket) * batch_bucket
    return max(256, pow2_at_least(n))


def padded_width(n: int, floor: int = 256, ceiling: int | None = None) -> int:
    """Power-of-two padded width for a live-stream flush: the next power of
    two >= n, clamped to [floor, ceiling]. With a power-of-two floor and
    ceiling the reachable widths are exactly {floor, 2*floor, ...,
    ceiling}. ``MixedWave.pad_*`` widths come from here."""
    w = max(pow2_at_least(max(int(n), 1)), int(floor))
    if ceiling is not None:
        w = min(w, int(ceiling))
    return w
