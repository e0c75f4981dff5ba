"""The subset of CBOR (RFC 8949) the chain's bytes use, in its shortest form.

Unsigned and negative integers, byte and text strings and definite-length
arrays.  `decode` returns the value and the offset past it, so a caller
can keep the raw bytes of an item (a transaction body, a block body) and
hash them as they were sent.
"""
from __future__ import annotations


def head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    for extra, width in ((24, 1), (25, 2), (26, 4), (27, 8)):
        if arg < 1 << (8 * width):
            return bytes([(major << 5) | extra]) + arg.to_bytes(width, "big")
    raise ValueError("integer too large for a CBOR head")


def encode(obj) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _encode(obj, out: bytearray) -> None:
    if isinstance(obj, bool):
        raise TypeError("booleans are not used by the chain format")
    if isinstance(obj, int):
        out += head(0, obj) if obj >= 0 else head(1, -1 - obj)
    elif isinstance(obj, (bytes, bytearray)):
        out += head(2, len(obj))
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode()
        out += head(3, len(raw))
        out += raw
    elif isinstance(obj, (list, tuple)):
        out += head(4, len(obj))
        for item in obj:
            _encode(item, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__}")


def _arg(raw: bytes, pos: int) -> tuple[int, int, int]:
    """(major type, argument, offset past the head) of the item at pos."""
    b = raw[pos]
    major, info = b >> 5, b & 31
    if info < 24:
        return major, info, pos + 1
    width = {24: 1, 25: 2, 26: 4, 27: 8}.get(info)
    if width is None:
        raise ValueError(f"unsupported CBOR head 0x{b:02x} at {pos}")
    end = pos + 1 + width
    if end > len(raw):
        raise ValueError("truncated CBOR head")
    return major, int.from_bytes(raw[pos + 1:end], "big"), end


def decode(raw: bytes, pos: int = 0):
    """(value, offset past it) of the item at pos: ints, bytes, str, list."""
    major, arg, pos = _arg(raw, pos)
    if major == 0:
        return arg, pos
    if major == 1:
        return -1 - arg, pos
    if major in (2, 3):
        end = pos + arg
        if end > len(raw):
            raise ValueError("truncated CBOR string")
        val = raw[pos:end]
        return (val if major == 2 else val.decode()), end
    if major == 4:
        items = []
        for _ in range(arg):
            item, pos = decode(raw, pos)
            items.append(item)
        return items, pos
    raise ValueError(f"unsupported CBOR major type {major}")


def array_head(raw: bytes, pos: int) -> tuple[int, int]:
    """(length, offset of the first element) of the array at pos."""
    major, n, pos = _arg(raw, pos)
    if major != 4:
        raise ValueError("not a CBOR array")
    return n, pos


def items(raw: bytes, pos: int) -> tuple[list, int]:
    """[(value, start, end) of each element] of the array at pos, and the
    offset past the array."""
    n, pos = array_head(raw, pos)
    out = []
    for _ in range(n):
        item, end = decode(raw, pos)
        out.append((item, pos, end))
        pos = end
    return out, pos
