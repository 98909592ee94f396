"""Packed-bitset semimask primitives (port of ``repro.core.bitset``).

A semimask over ``n`` nodes is ``ceil(n/32)`` 32-bit words with the same
layout as the reference's ``uint32`` words: bit ``i`` of the mask is bit
``i % 32`` of word ``i // 32``. torch's ``uint32`` supports few operations,
so the words are held as ``int32`` carrying the same bit pattern (word
``0xFFFFFFFF`` is ``-1``). Bits are tested by AND with a mask from a
lookup table of the 32 powers of two and set by adding distinct powers, so
no shift ever overflows and bit 31 needs no special case.

ids < 0 are padding: they test as False and are never set.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WORD_BITS = 32

#: bit b of a word as an int32 with the same bit pattern (bit 31 -> -2**31)
_POW2_NP = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32)).view(np.int32)


def n_words(n: int) -> int:
    return -(-n // WORD_BITS)


@functools.lru_cache(maxsize=None)
def _pow2(device: torch.device) -> torch.Tensor:
    """The bit table on ``device``, copied there once (a host-to-device copy
    inside the search loop would stall the stream every iteration)."""
    return torch.from_numpy(_POW2_NP).to(device)


def pack_np(mask: np.ndarray) -> np.ndarray:
    """Host-side pack: bool[..., n] -> uint32[..., ceil(n/32)].

    Bit-identical to the reference ``bitset.pack_np``: ``np.packbits`` with
    little-endian bit order viewed as little-endian uint32.
    """
    m = np.asarray(mask, dtype=bool)
    n = m.shape[-1]
    pad = n_words(n) * WORD_BITS - n
    if pad:
        m = np.concatenate(
            [m, np.zeros(m.shape[:-1] + (pad,), bool)], axis=-1)
    packed = np.packbits(m, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view(np.uint32)


def from_words(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words (e.g. from :func:`pack_np`) -> int32 tensor, same bits."""
    w = np.ascontiguousarray(words)
    if w.dtype != np.uint32:
        raise TypeError(f"packed semimask words must be uint32, got {w.dtype}")
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


def to_words(bits: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy words (the reference's layout)."""
    return bits.cpu().numpy().astype(np.int32).view(np.uint32)


def pack(mask: torch.Tensor) -> torch.Tensor:
    """bool[..., n] -> int32[..., ceil(n/32)] (little-endian bits in words)."""
    n = mask.shape[-1]
    pad = n_words(n) * WORD_BITS - n
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    m = m.reshape(mask.shape[:-1] + (n_words(n), WORD_BITS))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    words = (m << shifts).sum(dim=-1)                       # [0, 2**32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack(bits: torch.Tensor, n: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., n]."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=bits.device)
    expanded = (bits[..., :, None] >> shifts) & 1
    flat = expanded.reshape(bits.shape[:-1] + (-1,))
    return flat[..., :n].to(torch.bool)


def locate(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Word index (int64) and in-word bit mask (int32) of each id.

    Padding ids (< 0) get mask 0, so they test False and set nothing. One
    location serves several bitsets tested on the same ids.
    """
    safe = ids.clamp(min=0)
    mask = torch.where(ids >= 0, _pow2(ids.device)[safe & 31], 0)
    return (safe >> 5).long(), mask


def test(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership bits of an int32 id vector against one [W] mask."""
    word, mask = locate(ids)
    return (bits[word] & mask) != 0


def test_located(bits: torch.Tensor, word: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """([B, W], located [B, K] ids) -> bool[B, K]; see :func:`locate`.

    ``bits`` may be a broadcast (stride-0) view of one shared mask.
    """
    return (torch.gather(bits, 1, word) & mask) != 0


def test_batch(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """([B, W], [B, K]) -> bool[B, K]: lane b tests its own bitset."""
    return test_located(bits, *locate(ids))


def _first_of_runs(s: torch.Tensor) -> torch.Tensor:
    """True at the first element of each run of equal values along dim -1
    of an ascending-sorted tensor."""
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    return first


def set_bits(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Return ``bits`` with the bits of ``ids`` set; ids < 0 ignored.

    Duplicate-safe: the per-word OR is an add of *distinct* powers of two
    (ids are sorted and only the first of each run that is not already set
    contributes), as in the reference.
    """
    s = torch.sort(ids).values
    word, mask = locate(s)
    fresh = _first_of_runs(s) & ((bits[word] & mask) == 0)
    return bits.index_add(0, word, torch.where(fresh, mask, 0))


def set_bits_batch_(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Lane-wise :func:`set_bits` IN PLACE: ([B, W], [B, K]) -> ``bits``.

    One scatter-add along the word axis (the reference flattens to one 1-D
    scatter over ``[B * W]`` because XLA lowers batched scatters to loops;
    torch's ``scatter_add_`` needs no such detour). ``bits`` must own its
    memory (not a broadcast view): it is updated where it lies, and the
    engines own their visited sets, so no other reference sees the update.
    """
    s = torch.sort(ids, dim=1).values
    word, mask = locate(s)
    fresh = _first_of_runs(s) & ~test_located(bits, word, mask)
    return bits.scatter_add_(1, word, torch.where(fresh, mask, 0))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (as int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def count(bits: torch.Tensor) -> torch.Tensor:
    """Total number of set bits (int32 scalar)."""
    return popcount(bits).sum().to(torch.int32)


def count_batch(bits: torch.Tensor) -> torch.Tensor:
    """Per-lane popcount total: int32[..., W] -> int32[...]."""
    return popcount(bits).sum(dim=-1).to(torch.int32)


def count_members(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """How many of the (padded) ids are set -- the sigma_l numerator."""
    return test(bits, ids).sum().to(torch.int32)


def count_members_batch(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-lane membership count: ([B, W], [B, K]) -> int32[B]."""
    return test_batch(bits, ids).sum(dim=1).to(torch.int32)


def broadcast_lanes(bits: torch.Tensor, bsz: int) -> torch.Tensor:
    """Normalize a semimask to per-lane form: [W] -> [B, W] (a stride-0
    view, no copy); [B, W] passes through after a lane-count check."""
    if bits.ndim == 1:
        return bits.expand(bsz, bits.shape[0])
    if bits.shape[0] != bsz:
        raise ValueError(f"per-lane semimask has {bits.shape[0]} lanes "
                         f"but the batch has {bsz}")
    return bits


def broadcast_shard_lanes(bits: torch.Tensor, bsz: int) -> torch.Tensor:
    """Normalize a shard-stacked semimask to per-lane form: [S, W] ->
    [S, B, W] (a stride-0 view, like :func:`broadcast_lanes`); [S, B, W]
    passes through after a lane-count check."""
    if bits.ndim == 2:
        s, w = bits.shape
        return bits[:, None, :].expand(s, bsz, w)
    if bits.shape[1] != bsz:
        raise ValueError(f"per-lane sharded semimask has {bits.shape[1]} "
                         f"lanes but the batch has {bsz}")
    return bits


def full_mask(n: int, device: torch.device, value: bool = True) -> torch.Tensor:
    """All-selected (or empty) mask over n nodes; tail padding bits clear."""
    w = n_words(n)
    if not value:
        return torch.zeros(w, dtype=torch.int32, device=device)
    words = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    tail = n - (w - 1) * WORD_BITS
    if tail < WORD_BITS:
        words[-1] = (1 << tail) - 1
    return from_words(words, device)
