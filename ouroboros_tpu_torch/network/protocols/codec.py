"""Generic CBOR message codec: msg <-> bytes as [tag, *args].

Reference pattern: Protocol/*/Codec.hs (CBOR per message, tag-discriminated).
Each message class declares `TAG` and implements encode_args()/decode_args().

Ported from `ouroboros_tpu/network/protocols/codec.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from typing import Any, Sequence, Type

from ...utils import cbor


class CodecError(Exception):
    pass


class Codec:
    def __init__(self, messages: Sequence[Type]):
        self.by_tag = {}
        for cls in messages:
            tag = cls.TAG
            if tag in self.by_tag:
                raise ValueError(f"duplicate tag {tag}")
            self.by_tag[tag] = cls

    def encode(self, msg) -> bytes:
        return cbor.dumps([msg.TAG] + list(msg.encode_args()))

    def decode(self, raw: bytes):
        try:
            obj = cbor.loads(raw)
        except cbor.CBORError as e:
            raise CodecError(str(e)) from e
        if not isinstance(obj, list) or not obj:
            raise CodecError("message must be a CBOR list [tag, ...]")
        cls = self.by_tag.get(obj[0])
        if cls is None:
            raise CodecError(f"unknown message tag {obj[0]}")
        try:
            return cls.decode_args(obj[1:])
        except (IndexError, TypeError, ValueError) as e:
            raise CodecError(f"bad args for {cls.__name__}: {e}") from e


def roundtrip_property(codec: Codec, msgs) -> bool:
    """Codec round-trip check used by per-protocol tests (SURVEY.md §4.4)."""
    for m in msgs:
        if codec.decode(codec.encode(m)) != m:
            return False
    return True
