"""Fixed-ratio per-block compression codecs for facet storage (PyTorch).

The irredundant-layout follow-up to the source paper (Ferry et al., 2024,
*An Irredundant and Compressed Data Layout to Optimize Bandwidth Utilization
of FPGA Accelerators*) pairs deduplicated facet storage with a *fixed-ratio*
block compression: every facet block is stored in a statically known number
of bits, so burst lengths — and the DMA descriptors that move them — stay
compile-time constants while each burst carries fewer bytes.  This module is
that codec:

* **XOR-delta + bit-pack** (:class:`BlockCodec` with ``bits`` in {8,16,32}):
  a block is flattened, consecutive raw words are XOR'd, each residual keeps
  its ``bits`` high-order bits, and residuals are packed densely into words.
  The first element of each block is stored raw (the per-block header), so
  the stored size is exactly ``elem_bits + (n-1) * bits`` — fixed ratio.
* **lossless iff the dropped low-order residual bits are zero**;
  :meth:`BlockCodec.exact` reports whether a block round-trips
  bit-identically, and :meth:`BlockCodec.roundtrip` is what the compressed
  execution pipeline stores.

The words are bit-identical to the reference package's codec.  PyTorch has
no shifts for unsigned 32/64-bit integers, so the words live in *signed*
integer tensors of the element's width (``header``/``packed`` are
``int32`` for float32 blocks, ``int64`` for float64): the same bit patterns
as the reference's ``uint32``/``uint64`` words.  Right shifts sign-extend,
so every one is masked; left shifts wrap, as unsigned shifts do.  The
reference's ``associative_scan`` over XOR becomes a log-step doubling
prefix-XOR (XOR is associative and exact, so the words agree).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["BlockCodec", "CODECS", "DEFAULT_CODEC", "get_codec", "stored_bits"]


def stored_bits(n_elems: int, elem_bits: int, bits: int | None) -> int:
    """Fixed-ratio stored size of an ``n_elems`` run of ``elem_bits`` words:
    one raw header word + ``bits``-wide residuals (``None``/0 =
    uncompressed).  The single size formula shared by the codec's footprint
    accounting and ``BurstModel``'s bytes-per-burst model — change the
    framing here and both stay consistent."""
    if n_elems <= 0:
        return 0
    if not bits:
        return n_elems * elem_bits
    return elem_bits + (n_elems - 1) * min(bits, elem_bits)


def _word_dtype(itemsize: int) -> torch.dtype:
    """The signed integer dtype whose words carry an element's bits."""
    try:
        return {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[itemsize]
    except KeyError:
        raise ValueError(f"unsupported element width: {itemsize} bytes") from None


def _low_mask(b: int, elem_bits: int) -> int:
    """``(1 << b) - 1`` as a signed ``elem_bits``-wide value (-1 = all ones)."""
    return -1 if b >= elem_bits else (1 << b) - 1


def _prefix_xor(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-XOR of a 1-D tensor (Hillis-Steele doubling)."""
    n, s = v.numel(), 1
    while s < n:
        v = torch.cat([v[:s], v[s:] ^ v[:-s]])
        s *= 2
    return v


@dataclasses.dataclass(frozen=True)
class BlockCodec:
    """Fixed-ratio XOR-delta bit-packing of one storage block.

    ``bits`` is the stored width of each residual (``0`` marks the identity
    codec ``raw``: no transform, ratio 1.0).  Residuals keep their *high*
    ``bits`` bits — the sign/exponent end of IEEE words — so truncation
    degrades mantissa tails first, and data whose XOR-deltas fit in ``bits``
    high bits round-trips exactly.
    """

    name: str
    bits: int

    def __post_init__(self) -> None:
        if self.bits < 0:
            raise ValueError(f"codec bits must be >= 0: {self.bits}")
        if self.bits and self.bits not in (8, 16, 32):
            raise ValueError(
                f"fixed-ratio packing needs bits in (8, 16, 32): {self.bits}"
            )

    # -- the model-side knob -------------------------------------------------

    def stored_bits(self, n_elems: int, elem_bits: int) -> int:
        """Exact stored size of an ``n_elems`` block of ``elem_bits`` words
        (one raw header word + fixed-width residuals)."""
        return stored_bits(n_elems, elem_bits, self.bits)

    def ratio(self, n_elems: int, elem_bits: int = 32) -> float:
        """stored bits / raw bits for an ``n_elems`` block (<= 1.0)."""
        if n_elems <= 0:
            return 1.0
        return self.stored_bits(n_elems, elem_bits) / (n_elems * elem_bits)

    def _widths(self, dtype: torch.dtype) -> tuple[int, int]:
        """(element bits, residual bits) for words of ``dtype``."""
        elem_bits = 8 * dtype.itemsize
        b = min(self.bits, elem_bits) if self.bits else elem_bits
        if elem_bits % b:
            raise ValueError(
                f"codec {self.name!r}: {b} residual bits do not pack into "
                f"{elem_bits}-bit words"
            )
        return elem_bits, b

    # -- encode / decode on tensors ------------------------------------------

    def encode(self, block: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (header, packed): the raw first word and the densely packed
        high-``bits`` XOR residuals of the flattened block, as signed words
        of the element's width on the block's device."""
        x = block.contiguous().view(_word_dtype(block.element_size())).reshape(-1)
        elem_bits, b = self._widths(block.dtype)
        header = x[:1]
        if not self.bits or x.numel() <= 1:
            return header, x[1:]
        shift = elem_bits - b
        resid = ((x[1:] ^ x[:-1]) >> shift) & _low_mask(b, elem_bits)  # high bits
        per = elem_bits // b  # residuals per packed word
        pad = (-resid.numel()) % per
        if pad:
            resid = torch.cat([resid, resid.new_zeros(pad)])
        resid = resid.reshape(-1, per)
        packed = torch.zeros_like(resid[:, 0])
        for i in range(per):
            packed = packed | (resid[:, i] << i * b)  # wraps like uint shifts
        return header, packed

    def decode(self, header: torch.Tensor, packed: torch.Tensor,
               shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """Inverse of :meth:`encode` (up to the dropped low-order bits)."""
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        elem_bits, b = self._widths(dtype)
        if not self.bits or n <= 1:
            words = torch.cat([header, packed])[:n]
            return words.view(dtype).reshape(shape)
        per = elem_bits // b
        mask = _low_mask(b, elem_bits)
        resid = torch.stack(
            [(packed >> i * b) & mask for i in range(per)], dim=1,
        ).reshape(-1)[: n - 1]
        deltas = resid << (elem_bits - b)  # low-order bits are lost
        words = _prefix_xor(torch.cat([header, deltas]))
        return words.view(dtype).reshape(shape)

    def roundtrip(self, block: torch.Tensor) -> torch.Tensor:
        """What storage retains: ``decode(encode(block))`` — bit-identical
        when the data's XOR-deltas fit the ratio, truncated otherwise."""
        if not self.bits:
            return block
        header, packed = self.encode(block)
        return self.decode(header, packed, tuple(block.shape), block.dtype)

    def exact(self, block: torch.Tensor) -> bool:
        """True iff the block survives the fixed ratio bit-identically."""
        a = torch.as_tensor(block)
        return bool((self.roundtrip(a) == a).all())


#: Registered codecs: ``raw`` is the identity (ratio 1.0, always exact);
#: ``deltapack{8,16,32}`` keep that many high residual bits per element.
CODECS: dict[str, BlockCodec] = {
    "raw": BlockCodec("raw", bits=0),
    "deltapack8": BlockCodec("deltapack8", bits=8),
    "deltapack16": BlockCodec("deltapack16", bits=16),
    "deltapack32": BlockCodec("deltapack32", bits=32),
}

DEFAULT_CODEC = "deltapack16"


def get_codec(codec: "BlockCodec | str | None") -> BlockCodec:
    """Resolve a codec name (or pass a :class:`BlockCodec` through);
    ``None`` means :data:`DEFAULT_CODEC`."""
    if codec is None:
        return CODECS[DEFAULT_CODEC]
    if isinstance(codec, BlockCodec):
        return codec
    try:
        return CODECS[codec]
    except KeyError:
        raise ValueError(
            f"unknown codec {codec!r}; registered: {sorted(CODECS)}"
        ) from None
