"""Pure-Python emulation of glibc ``srand``/``rand`` (the TYPE_3 generator);
a copy of ``smoothed_particle_hydrodynamics_tpu/compat/crand.py``.

The reference seeds its initial conditions with ``srand(42)`` and draws
positions and velocities with ``rand()``.  glibc's default ``rand`` is
``random()`` with the TYPE_3 additive-feedback generator: a degree-31,
separation-3 lagged Fibonacci over uint32 seeded by a Lehmer LCG:

* ``r[0] = seed``; ``r[i] = 16807 * r[i-1] mod 2147483647`` for i in 1..30
  (Schrage's trick with the negative-adjust branch);
* the table wraps: ``r[31..33] = r[0..2]``;
* then ``r[i] = (r[i-31] + r[i-3]) mod 2^32`` with the first 310 outputs
  discarded; each ``rand()`` returns ``r[i] >> 1``.
"""

from __future__ import annotations


def rand_stream(seed: int, count: int) -> list[int]:
    """The first ``count`` values of glibc ``rand()`` after ``srand(seed)``."""
    s = [0] * 34
    s[0] = seed & 0xFFFFFFFF
    for i in range(1, 31):
        hi, lo = divmod(s[i - 1], 127773)
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        s[i] = word
    s[31], s[32], s[33] = s[0], s[1], s[2]

    buf = s
    append = buf.append
    mask = 0xFFFFFFFF
    for i in range(34, 344 + count):
        append((buf[i - 31] + buf[i - 3]) & mask)
    return [v >> 1 for v in buf[344:]]


class CRand:
    """Stream cursor over ``rand_stream`` that refills itself on demand."""

    def __init__(self, seed: int, prefetch: int = 1 << 20):
        self._seed = seed
        self._n = prefetch
        self._vals = rand_stream(seed, prefetch)
        self._pos = 0

    def next(self) -> int:
        if self._pos >= len(self._vals):
            self._n *= 2
            self._vals = rand_stream(self._seed, self._n)
        v = self._vals[self._pos]
        self._pos += 1
        return v
