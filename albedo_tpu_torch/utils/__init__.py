"""Device selection, the training watchdog, timing and small shared helpers."""


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (and >= 1): the shape-ladder rounding of
    the feature assembler's bag pads (``albedo_tpu/utils/__init__.py``)."""
    return 1 << max(0, int(n - 1).bit_length())
