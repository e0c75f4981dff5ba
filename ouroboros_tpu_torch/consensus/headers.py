"""Protocol-carrying header: concrete header + named protocol fields.

The reference attaches protocol evidence to headers via per-era header types
(e.g. mock Praos' `PraosFields` with VRF certs + KES signature,
ouroboros-consensus-mock/src/Ouroboros/Consensus/Mock/Protocol/Praos.hs;
BFT's `BftFields` DSIGN signature, Protocol/BFT.hs).  Here one generic
header type carries an ordered tuple of (name, value) protocol fields;
signatures cover the CBOR encoding with the signature fields dropped
(`bytes_dropping`), matching the reference's sign-the-header-minus-signature
convention.

Ported from `ouroboros_tpu/consensus/headers.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence

from ..chain.block import GENESIS_HASH
from ..utils import cbor


@dataclass(frozen=True)
class ProtocolHeader:
    """HasHeader + protocol evidence fields."""
    slot: int
    block_no: int
    prev_hash: bytes
    body_hash: bytes
    issuer: int = 0                     # index into the ledger view's keys
    fields: tuple = ()                  # ((name, bytes-or-int), ...)

    _cache: dict = field(default_factory=dict, repr=False, hash=False,
                         compare=False)

    def encode(self, drop: Sequence[str] = ()):
        fs = [[k, v] for k, v in self.fields if k not in drop]
        return [self.slot, self.block_no, self.prev_hash, self.body_hash,
                self.issuer, fs]

    @classmethod
    def decode(cls, obj) -> "ProtocolHeader":
        fs = tuple((str(k) if isinstance(k, str) else bytes(k).decode(),
                    bytes(v) if isinstance(v, (bytes, bytearray)) else int(v))
                   for k, v in obj[5])
        return cls(int(obj[0]), int(obj[1]), bytes(obj[2]), bytes(obj[3]),
                   int(obj[4]), fs)

    def bytes_dropping(self, *drop: str) -> bytes:
        """Serialisation with the named fields removed — what gets signed.

        When the header was decoded from stored bytes (ProtocolBlock.
        from_bytes), the result is assembled from raw-byte spans instead
        of re-encoding — re-encoding was ~40% of the replay host pass."""
        sp = self._cache.get("spans")
        if sp is not None:
            raw, helems, fpairs = sp
            keep = [s for k, s in fpairs if k not in drop]
            return (cbor._head(4, 6)
                    + raw[helems[0][0]:helems[4][1]]
                    + cbor._head(4, len(keep))
                    + b"".join(raw[a:b] for a, b in keep))
        return cbor.dumps(self.encode(drop))

    @property
    def bytes(self) -> bytes:
        c = self._cache
        b = c.get("bytes")
        if b is None:
            b = c["bytes"] = cbor.dumps(self.encode())
        return b

    @property
    def hash(self) -> bytes:
        c = self._cache
        if "h" not in c:
            c["h"] = hashlib.blake2b(self.bytes, digest_size=32).digest()
        return c["h"]

    def get(self, name: str, default: Any = None) -> Any:
        for k, v in self.fields:
            if k == name:
                return v
        return default

    def with_fields(self, **kw) -> "ProtocolHeader":
        merged = dict(self.fields)
        merged.update(kw)
        return replace(self, fields=tuple(sorted(merged.items())),
                       _cache={})


@dataclass(frozen=True)
class ProtocolBlock:
    """Block = protocol header + opaque tx body tuple."""
    header: ProtocolHeader
    body: tuple = ()

    @property
    def slot(self) -> int:
        return self.header.slot

    @property
    def block_no(self) -> int:
        return self.header.block_no

    @property
    def hash(self) -> bytes:
        return self.header.hash

    @property
    def prev_hash(self) -> bytes:
        return self.header.prev_hash

    def encode(self):
        return [self.header.encode(), [t.encode() if hasattr(t, "encode")
                                       else t for t in self.body]]

    @classmethod
    def decode(cls, obj, tx_decode=None) -> "ProtocolBlock":
        """tx_decode: per-ledger body-item decoder (default: raw values)."""
        body = tuple(tx_decode(t) if tx_decode else t for t in obj[1])
        return cls(ProtocolHeader.decode(obj[0]), body)

    @classmethod
    def from_bytes(cls, raw: bytes, tx_decode=None,
                   tx_body_elems: int | None = None) -> "ProtocolBlock":
        """Decode AND retain raw-byte spans so the hot sequential pass
        (header hash, KES signing bytes, tx ids) never re-encodes.

        tx_body_elems: when set, each tx item is a list whose first
        tx_body_elems elements form the tx BODY (ShelleyTx: 6 body
        fields + witnesses) — the body encoding is assembled from spans
        and stashed in the tx's _cache for txid."""
        obj = cbor.loads(raw)
        block = cls.decode(obj, tx_decode=tx_decode)
        try:
            outer = cbor.list_spans(raw, 0)          # [header, [txs]]
            hspan = outer[0]
            helems = cbor.list_spans(raw, hspan[0])
            fpairs_sp = cbor.list_spans(raw, helems[5][0])
            hdr = block.header
            hdr._cache["bytes"] = raw[hspan[0]:hspan[1]]
            hdr._cache["spans"] = (
                raw, helems,
                list(zip((k for k, _v in hdr.fields), fpairs_sp)))
            if tx_body_elems is not None and block.body:
                for tx, tsp in zip(block.body,
                                   cbor.list_spans(raw, outer[1][0])):
                    telems = cbor.list_spans(raw, tsp[0])
                    body_raw = (cbor._head(4, tx_body_elems) + raw[
                        telems[0][0]:telems[tx_body_elems - 1][1]])
                    cache = getattr(tx, "_cache", None)
                    if cache is not None:
                        cache["body_bytes"] = body_raw
        except (cbor.CBORError, IndexError):
            pass        # spans are an optimisation; decode stands alone
        return block

    @property
    def bytes(self) -> bytes:
        return cbor.dumps(self.encode())


def body_hash_of(body: Sequence) -> bytes:
    enc = [t.encode() if hasattr(t, "encode") else t for t in body]
    return hashlib.blake2b(cbor.dumps(enc), digest_size=32).digest()


def make_header(prev: Optional[ProtocolHeader], slot: int, body: Sequence,
                issuer: int) -> ProtocolHeader:
    """Unsigned header extending `prev`; protocols add evidence fields."""
    if prev is None:
        prev_hash, block_no = GENESIS_HASH, 0
    else:
        prev_hash, block_no = prev.hash, prev.block_no + 1
    return ProtocolHeader(slot=slot, block_no=block_no, prev_hash=prev_hash,
                          body_hash=body_hash_of(body), issuer=issuer)
