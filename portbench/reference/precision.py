"""The number type the reference computes its non-integer quantities in.

Python floats (IEEE double) by default.  :func:`computed_in` switches the
type for the benchmark's lower-precision control: with ``numpy.float32``
every density, derived probability, word count and architecture scalar
becomes a float32 scalar, and NumPy's promotion rules carry float32
through the arithmetic that follows (integer counts of loop trips stay
exact integers until they meet one).
"""
from __future__ import annotations

import contextlib

_TYPE = float


def real(x):
    """``x`` in the current number type."""
    return _TYPE(x)


@contextlib.contextmanager
def computed_in(kind):
    """Compute in ``kind`` (``float`` or ``numpy.float32``) inside the
    block.  Not thread-safe: the reference runs on one thread."""
    global _TYPE
    prev, _TYPE = _TYPE, kind
    try:
        yield
    finally:
        _TYPE = prev
