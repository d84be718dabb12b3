"""Bit-packed boolean masks (numpy copy of ``repro.core.bitset``).

``BitMask`` stores one element per *bit* in uint8 words, big-endian within
each byte as ``np.packbits`` writes them — the layout the scrutiny
engine's ``threshold_bitpack`` kernel emits and the checkpoint bitmap aux
encoding stores, so device words wrap without a repack.  OR/AND/equality
run as vectorized word ops over 1/8 of the bytes of a bool array.
"""

from __future__ import annotations

import numpy as np

# popcount lookup for uint8 words (np.bincount-free, vectorized gather).
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


class BitMask:
    """Fixed-length bitset over ``n`` elements, packed 8/byte (bitorder=big,
    matching ``np.packbits``).  Tail bits of the last word are always 0 so
    word-wise equality is element equality."""

    __slots__ = ("words", "n")

    def __init__(self, words: np.ndarray, n: int):
        self.words = words
        self.n = n

    # --- constructors ----------------------------------------------------

    @classmethod
    def zeros(cls, n: int) -> "BitMask":
        return cls(np.zeros((n + 7) // 8, dtype=np.uint8), n)

    @classmethod
    def full(cls, n: int, value: bool = True) -> "BitMask":
        if not value:
            return cls.zeros(n)
        words = np.full((n + 7) // 8, 0xFF, dtype=np.uint8)
        tail = n % 8
        if tail and len(words):
            words[-1] = (0xFF << (8 - tail)) & 0xFF  # zero the unused low bits
        return cls(words, n)

    @classmethod
    def from_bool(cls, arr: np.ndarray) -> "BitMask":
        arr = np.asarray(arr, dtype=bool).reshape(-1)
        return cls(np.packbits(arr), arr.size)

    @classmethod
    def from_words(cls, words, n: int) -> "BitMask":
        """Wrap already-packed words (e.g. the device scrutiny engine's
        ``threshold_bitpack`` output moved D2H) without a repack.  The
        words are not copied; tail bits past ``n`` must already be 0
        (guaranteed by ``threshold_bitpack`` and ``np.packbits``)."""
        words = np.asarray(words, dtype=np.uint8).reshape(-1)
        if words.size != (n + 7) // 8:
            raise ValueError(
                f"BitMask.from_words: {words.size} words cannot hold "
                f"{n} bits (expected {(n + 7) // 8})")
        return cls(words, n)

    # --- lattice ops (vectorized word ops) -------------------------------

    def ior(self, other: "BitMask") -> "BitMask":
        """In-place OR-join; returns self."""
        self.words |= other.words
        return self

    def iand(self, other: "BitMask") -> "BitMask":
        self.words &= other.words
        return self

    def __or__(self, other: "BitMask") -> "BitMask":
        return BitMask(self.words | other.words, self.n)

    def __and__(self, other: "BitMask") -> "BitMask":
        return BitMask(self.words & other.words, self.n)

    def __eq__(self, other) -> bool:
        if not isinstance(other, BitMask):
            return NotImplemented
        return self.n == other.n and np.array_equal(self.words, other.words)

    def __hash__(self):  # pragma: no cover - identity hashing only
        return id(self)

    def copy(self) -> "BitMask":
        return BitMask(self.words.copy(), self.n)

    # --- queries ----------------------------------------------------------

    def any(self) -> bool:
        return bool(self.words.any())

    def all(self) -> bool:
        return self.count() == self.n

    def count(self) -> int:
        """Popcount over the words (tail bits are zero by construction)."""
        if not len(self.words):
            return 0
        return int(_POPCOUNT[self.words].sum(dtype=np.int64))

    # --- conversion -------------------------------------------------------

    def to_bool(self) -> np.ndarray:
        return np.unpackbits(self.words, count=self.n).astype(bool) \
            if self.n else np.zeros(0, dtype=bool)

    @property
    def nbytes(self) -> int:
        return self.words.nbytes
