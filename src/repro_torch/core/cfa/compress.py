"""Fixed-ratio per-block compression codecs for facet storage — metadata.

The irredundant-layout follow-up to the source paper (Ferry et al., 2024,
*An Irredundant and Compressed Data Layout to Optimize Bandwidth Utilization
of FPGA Accelerators*) pairs deduplicated facet storage with a *fixed-ratio*
block compression: every facet block is stored in a statically known number
of bits, so burst lengths — and the DMA descriptors that move them — stay
compile-time constants while each burst carries fewer bytes.

This module holds the codec's size model: :func:`stored_bits`, the
:class:`BlockCodec` registry and its ratio/width accounting, which the burst
plans and ``BurstModel`` price transfers with.  The tensor-side
``encode``/``decode``/``roundtrip``/``exact`` arrive with the port's storage
slice (irredundant and compressed facet storage); until then they raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BlockCodec", "CODECS", "DEFAULT_CODEC", "get_codec", "stored_bits"]

_STORAGE_SLICE = (
    "BlockCodec.{} runs on facet blocks; it arrives with the storage slice "
    "of the PyTorch port (irredundant/compressed facet storage)"
)


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

    def _widths(self, dtype) -> tuple[int, int]:
        """(element bits, residual bits) for words of ``dtype``."""
        elem_bits = 8 * np.dtype(dtype).itemsize
        b = min(self.bits, elem_bits) if self.bits else elem_bits
        if elem_bits % b:
            raise ValueError(
                f"codec {self.name!r}: {b} residual bits do not pack into "
                f"{elem_bits}-bit words"
            )
        return elem_bits, b

    # -- the tensor side: the storage slice ---------------------------------

    def encode(self, block):
        raise NotImplementedError(_STORAGE_SLICE.format("encode"))

    def decode(self, header, packed, shape, dtype):
        raise NotImplementedError(_STORAGE_SLICE.format("decode"))

    def roundtrip(self, block):
        raise NotImplementedError(_STORAGE_SLICE.format("roundtrip"))

    def exact(self, block) -> bool:
        raise NotImplementedError(_STORAGE_SLICE.format("exact"))


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
