"""Semi-perfect hashing of JSON object keys (Blaze §4.1).

The hash output is 256 bits (32 bytes).  For strings of at most 31 bytes the
hash *is* the string: byte 0 is zero and the remaining 31 bytes are the string
bytes (zero padded).  Two short strings are therefore equal iff their hashes
are equal -- no string comparison is ever needed.  For longer strings byte 0
is ``(len + first + last) % 255 + 1`` (guaranteed non-zero, computed in
constant time) and a hash match must be confirmed with a full comparison.

Representation choices:

* The sequential executor uses a single Python ``int`` packing the 32 bytes
  big-endian, so byte 0 is the most significant byte.  Python ints compare in
  a handful of ns -- the analogue of the paper's two 128-bit compares.
* The tensorised executor unpacks the same 32 bytes into eight little-endian
  ``uint32`` lanes (TPUs have no 64-bit vector lanes); see :func:`hash_lanes`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SHORT_LIMIT",
    "shash",
    "shash_bytes",
    "is_short_hash",
    "hashed_equal",
    "hash_lanes",
    "lanes_to_int",
]

# Strings with byte-length <= SHORT_LIMIT hash perfectly (one-to-one).
SHORT_LIMIT = 31
_HASH_BYTES = 32
_HASH_BITS = _HASH_BYTES * 8

# Mask that isolates byte 0 (the discriminator byte) of the packed integer.
_DISCRIMINATOR_SHIFT = (_HASH_BYTES - 1) * 8


def shash_bytes(data: bytes) -> int:
    """Hash raw bytes to a 256-bit integer per Blaze's semi-perfect scheme."""
    n = len(data)
    if n <= SHORT_LIMIT:
        # Byte 0 = 0, bytes 1..31 = the string itself (zero padded on the
        # right).  Packing big-endian keeps byte 0 most significant.
        return int.from_bytes(data.ljust(SHORT_LIMIT, b"\x00"), "big")
    # Long string: constant-time 1-byte digest in byte 0, rest zero.
    digest = (n + data[0] + data[-1]) % 255 + 1
    return digest << _DISCRIMINATOR_SHIFT


def shash(key: str) -> int:
    """Hash a JSON key (UTF-8 encoded) to its 256-bit semi-perfect hash."""
    return shash_bytes(key.encode("utf-8"))


def is_short_hash(h: int) -> bool:
    """True when the hash belongs to a short (<=31 byte) string."""
    return (h >> _DISCRIMINATOR_SHIFT) == 0


def hashed_equal(h_a: int, a: str, h_b: int, b: str) -> bool:
    """Equality test using hashes first (Blaze §4.1 comparison procedure).

    Short/short: hash equality is definitive.  Anything involving a long
    string needs the hash as a cheap filter followed by a real comparison.
    """
    if h_a != h_b:
        return False
    if is_short_hash(h_a):  # both short: perfect hash, no string compare
        return True
    return a == b


def hash_lanes(h: int) -> np.ndarray:
    """Unpack a 256-bit hash into eight uint32 lanes (TPU-friendly form).

    Lane 0 holds the most-significant 4 bytes (so the discriminator byte is
    the top byte of lane 0); comparing all eight lanes is equivalent to
    comparing the packed integer.
    """
    raw = h.to_bytes(_HASH_BYTES, "big")
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32)


def lanes_to_int(lanes: np.ndarray) -> int:
    """Inverse of :func:`hash_lanes` (test helper)."""
    out = 0
    for lane in lanes:
        out = (out << 32) | int(lane)
    return out
