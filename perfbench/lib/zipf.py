"""YCSB's zipfian key chooser, in NumPy.

YCSB's core workload, with ``requestdistribution=zipfian``, chooses a
key so (``CoreWorkload``, ``ScrambledZipfianGenerator``,
``ZipfianGenerator``, ``Utils.fnvhash64``):

1. a rank is drawn from a Zipfian over ``ITEM_COUNT + 1`` = 10^10 + 1
   items with constant 0.99, by Gray et al.'s closed form ("Quickly
   generating billion-record synthetic databases", SIGMOD 1994), with
   the precomputed ``ZETAN`` = zeta(10^10, 0.99) = 26.469... in place of
   the sum over the items;
2. the rank is hashed: ``fnvhash64(rank) % (recordcount + 1)``, with
   ``fnvhash64`` the 64-bit FNV-1a hash of the rank's eight octets
   followed by ``Math.abs`` (the chooser is built over
   ``recordcount + expectednewkeys`` keys, and workloads A and C insert
   none);
3. a key past the last loaded one (``== recordcount``) is drawn again.

So the hottest key takes ``1 / ZETAN`` of the draws (3.78 %), and the
hot ranks land on keys spread over the whole key space.
:class:`Zipfian` is the closed form for any item count; ``keys`` is the
chooser.  ``scrambled=False`` gives the repository's older form instead,
in which the ranks over the ``recordcount`` keys are the keys.
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
ITEM_COUNT = 10_000_000_000          # ScrambledZipfianGenerator.ITEM_COUNT
ZETAN = 26.46902820178302            # ScrambledZipfianGenerator.ZETAN
USED_ZIPFIAN_CONSTANT = 0.99


def zeta(n: int, theta: float) -> float:
    """``sum(i ** -theta for i in 1 .. n)``, in blocks."""
    total, block = 0.0, 1 << 22
    for a in range(1, n + 1, block):
        i = np.arange(a, min(a + block, n + 1), dtype=np.float64)
        total += float(np.sum(i ** -theta))
    return total


class Zipfian:
    """YCSB's ``ZipfianGenerator(0, items - 1, theta, zetan)``: ranks
    ``0 .. items - 1``, rank 0 the hottest."""

    def __init__(self, items: int, theta: float, zetan: float | None = None):
        self.items, self.theta = int(items), float(theta)
        self.zetan = zeta(self.items, theta) if zetan is None else zetan
        self.alpha = 1.0 / (1.0 - theta)
        zeta2 = zeta(2, theta)
        self.eta = ((1 - (2.0 / self.items) ** (1 - theta))
                    / (1 - zeta2 / self.zetan))

    def ranks(self, u) -> np.ndarray:
        """The ranks of uniform draws ``u`` in [0, 1) (int64), as
        ``ZipfianGenerator.nextLong`` computes them."""
        u = np.asarray(u, np.float64)
        uz = u * self.zetan
        r = (self.items * (self.eta * u - self.eta + 1) ** self.alpha
             ).astype(np.int64)
        r = np.where(uz < 1.0 + 0.5 ** self.theta, 1, r)
        return np.where(uz < 1.0, 0, r).astype(np.int64)


def fnvhash64(values) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` over int64 values, vectorised: FNV-1a
    over the eight octets (lowest first), then the absolute value of
    the signed result.  Returns int64."""
    v = np.asarray(values, np.int64).astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, np.uint64)
    prime = np.uint64(FNV_PRIME_64)
    low = np.uint64(0xFF)
    eight = np.uint64(8)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h = (h ^ (v & low)) * prime
            v = v >> eight
    return np.abs(h.view(np.int64))


def scramble(ranks, n: int) -> np.ndarray:
    """``fnvhash64(rank) % n`` with Java's remainder (only
    ``fnvhash64 = -2^63``, whose absolute value Java leaves negative,
    can give a negative one; it is folded back into ``0 .. n-1``)."""
    r = np.fmod(fnvhash64(ranks), np.int64(n))
    return np.where(r < 0, r + n, r)


class KeyChooser:
    """Keys ``0 .. recordcount - 1`` as YCSB's core workload chooses
    them under ``requestdistribution=zipfian``."""

    def __init__(self, recordcount: int, theta: float,
                 scrambled: bool = True):
        self.n = int(recordcount)
        self.scrambled = bool(scrambled)
        if not scrambled:
            self.zipf = Zipfian(self.n, theta)
        elif theta == USED_ZIPFIAN_CONSTANT:
            self.zipf = Zipfian(ITEM_COUNT + 1, theta, ZETAN)
        else:
            raise ValueError("YCSB precomputes zeta(10^10) for the "
                             "constant 0.99 only")

    def keys(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """``size`` keys (int64) drawn from ``rng``."""
        if not self.scrambled:
            return self.zipf.ranks(rng.random(size))
        keys = scramble(self.zipf.ranks(rng.random(size)), self.n + 1)
        past = np.flatnonzero(keys >= self.n)
        while past.size:
            keys[past] = scramble(self.zipf.ranks(rng.random(past.size)),
                                  self.n + 1)
            past = past[keys[past] >= self.n]
        return keys
