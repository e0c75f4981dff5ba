"""Minimal CBOR (RFC 8949) encoder/decoder.

The reference serialises every protocol message and ledger snapshot as CBOR
(codecs under Protocol/*/Codec.hs; snapshots in Storage/LedgerDB/OnDisk.hs).
This is a compact self-contained implementation covering the subset those
formats need: uints/nints, byte/text strings, arrays, maps, tags, simple
values, floats, and indefinite-length arrays.

Ported from `ouroboros_tpu/utils/cbor.py` (the port imports nothing of the
JAX package). Copied whole.
"""
from __future__ import annotations

import struct
from typing import Any

__all__ = ["dumps", "loads", "CBORError", "CBORTruncated", "Tag"]


class CBORError(ValueError):
    pass


class CBORTruncated(CBORError):
    """Input ends mid-item — a partial message, not a corrupt stream.
    Framing layers catch this specifically and wait for more bytes."""


class Tag:
    __slots__ = ("tag", "value")

    def __init__(self, tag: int, value: Any):
        self.tag = tag
        self.value = value

    def __eq__(self, other):
        return (isinstance(other, Tag) and self.tag == other.tag
                and self.value == other.value)

    def __repr__(self):
        return f"Tag({self.tag}, {self.value!r})"


def _head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    if arg < 256:
        return bytes([(major << 5) | 24, arg])
    if arg < 65536:
        return bytes([(major << 5) | 25]) + arg.to_bytes(2, "big")
    if arg < 2**32:
        return bytes([(major << 5) | 26]) + arg.to_bytes(4, "big")
    if arg < 2**64:
        return bytes([(major << 5) | 27]) + arg.to_bytes(8, "big")
    raise CBORError("integer too large for CBOR head")


class IndefList(list):
    """A list encoded with indefinite length (0x9f ... 0xff) — some
    reference codecs REQUIRE this framing (e.g. TxSubmission's tsIdList,
    ouroboros-network/test/messages.cddl:78 note)."""


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int):
        if obj >= 0:
            out += _head(0, obj)
        else:
            out += _head(1, -1 - obj)
    elif isinstance(obj, bytes):
        out += _head(2, len(obj))
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _head(3, len(raw))
        out += raw
    elif isinstance(obj, IndefList):
        out.append(0x9F)
        for item in obj:
            _encode(item, out)
        out.append(0xFF)
    elif isinstance(obj, (list, tuple)):
        out += _head(4, len(obj))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        out += _head(5, len(obj))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, Tag):
        out += _head(6, obj.tag)
        _encode(obj.value, out)
    elif isinstance(obj, float):
        out.append(0xFB)
        out += struct.pack(">d", obj)
    else:
        raise CBORError(f"cannot CBOR-encode {type(obj).__name__}")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CBORTruncated("truncated CBOR")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def _arg(self, info: int) -> int:
        if info < 24:
            return info
        if info == 24:
            return self._take(1)[0]
        if info == 25:
            return int.from_bytes(self._take(2), "big")
        if info == 26:
            return int.from_bytes(self._take(4), "big")
        if info == 27:
            return int.from_bytes(self._take(8), "big")
        raise CBORError(f"unsupported additional info {info}")

    def decode(self) -> Any:
        b = self._take(1)[0]
        major, info = b >> 5, b & 0x1F
        if major == 0:
            return self._arg(info)
        if major == 1:
            return -1 - self._arg(info)
        if major == 2:
            return bytes(self._take(self._arg(info)))
        if major == 3:
            return self._take(self._arg(info)).decode("utf-8")
        if major == 4:
            if info == 31:                     # indefinite-length array
                items = []
                while True:
                    if self.data[self.pos:self.pos + 1] == b"\xff":
                        self.pos += 1
                        return items
                    items.append(self.decode())
            return [self.decode() for _ in range(self._arg(info))]
        if major == 5:
            n = self._arg(info)
            out = {}
            for _ in range(n):
                k = self.decode()
                v = self.decode()
                if isinstance(k, list):
                    # array map keys (Shelley tx bodies use them) become
                    # tuples so the dict stays usable; _encode re-emits
                    # tuples as arrays, preserving round-trips
                    k = _freeze(k)
                if k in out:
                    # RFC 8949 §5.6: maps with duplicate keys are invalid;
                    # silently keeping the last key let a peer smuggle
                    # conflicting entries past CDDL-unique-key rules
                    # (the handshake's versionTable)
                    raise CBORError(f"duplicate map key {k!r}")
                out[k] = v
            return out
        if major == 6:
            return Tag(self._arg(info), self.decode())
        # major 7
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22 or info == 23:
            return None
        if info == 25:
            # half float
            h = int.from_bytes(self._take(2), "big")
            return _decode_half(h)
        if info == 26:
            return struct.unpack(">f", self._take(4))[0]
        if info == 27:
            return struct.unpack(">d", self._take(8))[0]
        raise CBORError(f"unsupported simple value {info}")


def _freeze(obj):
    """Recursively convert lists to tuples (for use as map keys)."""
    if isinstance(obj, list):
        return tuple(_freeze(x) for x in obj)
    return obj


def _decode_half(h: int) -> float:
    sign = -1.0 if h & 0x8000 else 1.0
    exp = (h >> 10) & 0x1F
    frac = h & 0x3FF
    if exp == 0:
        return sign * frac * 2.0 ** -24
    if exp == 31:
        return sign * (float("inf") if frac == 0 else float("nan"))
    return sign * (1 + frac / 1024.0) * 2.0 ** (exp - 15)


def loads(data: bytes, allow_trailing: bool = False):
    dec = _Decoder(data)
    obj = dec.decode()
    if not allow_trailing and dec.pos != len(data):
        raise CBORError(f"trailing bytes after CBOR value at {dec.pos}")
    return obj


def unwrap_tag24(obj):
    """CBOR-in-CBOR unwrap (#6.24(bytes .cbor x), messages.cddl:34,55):
    returns the decoded inner value for a tag-24-over-bytes envelope,
    or the object unchanged otherwise."""
    if isinstance(obj, Tag) and obj.tag == 24 and isinstance(obj.value,
                                                             bytes):
        return loads(obj.value)
    return obj


def loads_prefix(data: bytes) -> tuple[Any, int]:
    """Decode one CBOR item, returning (value, bytes_consumed)."""
    dec = _Decoder(data)
    obj = dec.decode()
    return obj, dec.pos


# ---------------------------------------------------------------------------
# Structural span scanning: walk items WITHOUT building objects, so decode
# paths can keep raw-byte slices of sub-items (header bytes, tx bodies) and
# the hot sequential pass never re-encodes what it just decoded (re-encoding
# was 40% of the replay's host pass in a profile).
# ---------------------------------------------------------------------------

def skip_item(data: bytes, pos: int) -> int:
    """End offset of the CBOR item starting at `pos` (no object built)."""
    b = data[pos]
    major, info = b >> 5, b & 0x1F
    pos += 1
    if info < 24:
        arg = info
    elif info == 24:
        arg = data[pos]
        pos += 1
    elif info == 25:
        arg = int.from_bytes(data[pos:pos + 2], "big")
        pos += 2
    elif info == 26:
        arg = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4
    elif info == 27:
        arg = int.from_bytes(data[pos:pos + 8], "big")
        pos += 8
    elif info == 31 and major in (2, 3, 4, 5):
        # indefinite length: scan children to the break byte
        while data[pos] != 0xFF:
            pos = skip_item(data, pos)
            if major == 5:
                pos = skip_item(data, pos)
        return pos + 1
    else:
        if major == 7 and info in (20, 21, 22, 23):
            return pos
        raise CBORError(f"unsupported additional info {info}")
    if major in (0, 1):
        return pos
    if major in (2, 3):
        return pos + arg
    if major == 4:
        for _ in range(arg):
            pos = skip_item(data, pos)
        return pos
    if major == 5:
        for _ in range(2 * arg):
            pos = skip_item(data, pos)
        return pos
    if major == 6:
        return skip_item(data, pos)
    # major 7 with numeric arg encodings (float16/32/64 handled via info)
    return pos


def list_spans(data: bytes, pos: int = 0) -> list:
    """(start, end) spans of each element of the LIST item at `pos`."""
    b = data[pos]
    major, info = b >> 5, b & 0x1F
    if major != 4:
        raise CBORError(f"list_spans: item at {pos} is major {major}")
    pos += 1
    if info < 24:
        n = info
    elif info == 24:
        n = data[pos]
        pos += 1
    elif info == 25:
        n = int.from_bytes(data[pos:pos + 2], "big")
        pos += 2
    elif info == 26:
        n = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4
    elif info == 31:
        spans = []
        while data[pos] != 0xFF:
            end = skip_item(data, pos)
            spans.append((pos, end))
            pos = end
        return spans
    else:
        raise CBORError(f"unsupported list length info {info}")
    spans = []
    for _ in range(n):
        end = skip_item(data, pos)
        spans.append((pos, end))
        pos = end
    return spans
