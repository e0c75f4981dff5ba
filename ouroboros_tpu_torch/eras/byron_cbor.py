"""Real Cardano Byron header/block CBOR — parse the reference's actual
Byron-era bytes.

Golden bytes: `ouroboros-consensus-byron-test/test/golden/
{ByronNodeToNodeVersion1,disk}/*` and the HFC-wrapped forms under
`ouroboros-consensus-cardano-test/test/golden/CardanoNodeToNodeVersion*/
{Header,Block}_Byron_{regular,EBB}`.

Encodings (cardano-ledger Byron dialect):

    block  = tag24( bytes( [0, ebb] / [1, main] ) )
    main   = [ header, body, extra ]
    header = [ protocol_magic, prev_hash(32), body_proof,
               [ [epoch, slot], issuer_xpub(64), [difficulty],
                 block_signature ],
               extra ]
    ebb hdr= [ protocol_magic, prev_hash(32), body_proof_hash(32),
               [ epoch, [difficulty] ], extra ]

and the node-to-node header wrapper is `[[tag, size_hint], tag24(bytes
header)]` (further wrapped in `[era_ix, ...]` by the HFC).

The header HASH is blake2b-256 of `CBOR([tag, header])` — the re-tagged
wrapper, NOT the bare header — verified bit-exactly against the
reference's golden `disk/HeaderHash` in tests/test_real_header.py.

Byron's signature scheme is Ed25519-BIP32 over extended keys
(cardano-crypto, outside this repo's scope); this module provides parse +
byte-identical re-encode + hash conformance, the interop surface the
storage layer needs (ImmutableDB Parser.hs reads exactly these bytes).

Ported from `ouroboros_tpu/eras/byron_cbor.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Optional

from ..utils import cbor


def _blake2b(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


@dataclass(frozen=True)
class RealByronHeader:
    is_ebb: bool
    magic: int
    prev_hash: bytes
    epoch: int
    slot: Optional[int]          # None for EBBs (epoch boundary)
    issuer_xpub: Optional[bytes]  # 64B extended public key; None for EBBs
    difficulty: int
    raw: bytes                   # exact header byte slice
    has_extra: bool = True       # 5-element form (disk/Cardano dialects)

    @property
    def header_hash(self) -> bytes:
        """blake2b-256 of the re-tagged wrapper [0|1, header]; defined
        for the full 5-element header form only (the node-to-node V1
        4-element codec is not the hashed representation)."""
        if not self.has_extra:
            raise ValueError("header hash needs the full (extra-bearing) "
                             "header form")
        tag = 0 if self.is_ebb else 1
        return _blake2b(bytes([0x82, tag]) + self.raw)

    def to_cbor(self) -> bytes:
        return self.raw


def _parse_header_obj(obj: Any, raw: bytes) -> RealByronHeader:
    """Field extraction: 5-element headers carry the extra-data section
    (disk / Cardano-wrapper dialect); the ByronNodeToNodeVersion1 header
    codec sends 4 elements (no extra).  The header HASH is only defined
    for the full 5-element form."""
    if not isinstance(obj, list):
        raise ValueError("Byron header must be an array")
    if len(obj) in (4, 5) and isinstance(obj[3], list) \
            and len(obj[3]) == 4 and isinstance(obj[3][1], bytes):
        # regular main-block header
        consensus = obj[3]
        epoch, slot = int(consensus[0][0]), int(consensus[0][1])
        return RealByronHeader(False, int(obj[0]), bytes(obj[1]),
                               epoch, slot, bytes(consensus[1]),
                               int(consensus[2][0]), raw,
                               has_extra=len(obj) == 5)
    if len(obj) in (4, 5) and isinstance(obj[3], list) \
            and len(obj[3]) == 2 and isinstance(obj[3][1], list):
        # epoch-boundary header
        return RealByronHeader(True, int(obj[0]), bytes(obj[1]),
                               int(obj[3][0]), None, None,
                               int(obj[3][1][0]), raw,
                               has_extra=len(obj) == 5)
    raise ValueError("unrecognised Byron header shape")


def parse_header(raw: bytes) -> RealByronHeader:
    """Parse from any encoding: bare header, tag-24 wrapped, the
    node-to-node [[tag, size], tag24(..)] wrapper, or the HFC
    [era_ix, ...] wrapper — tag 0 = EBB, 1 = regular."""
    obj = cbor.loads(raw)
    ebb_hint: Optional[bool] = None
    if isinstance(obj, list) and len(obj) == 2 and isinstance(obj[0], int) \
            and isinstance(obj[1], list) and obj[1] \
            and isinstance(obj[1][0], list):
        # HFC era wrapper [era_ix, [[tag, size], tag24(...)]] — the inner
        # pair's FIRST element is a list, distinguishing it from a bare
        # pre-tagged [0|1, header] whose first header field is the
        # protocol-magic int
        obj = obj[1]
    if isinstance(obj, list) and len(obj) == 2 \
            and isinstance(obj[0], list) and isinstance(obj[1], cbor.Tag):
        ebb_hint = int(obj[0][0]) == 0    # [[tag, size_hint], tag24(...)]
        obj = obj[1]
    if isinstance(obj, cbor.Tag):
        if obj.tag != 24 or not isinstance(obj.value, bytes):
            raise ValueError(f"expected tag 24 bytes, got tag {obj.tag}")
        raw = obj.value
        obj = cbor.loads(raw)
    if isinstance(obj, list) and len(obj) == 2 \
            and isinstance(obj[0], int) and obj[0] in (0, 1) \
            and isinstance(obj[1], list):
        # pre-tagged [0|1, header] (ByronNodeToNodeVersion1 codec)
        if ebb_hint is None:
            ebb_hint = obj[0] == 0
        _, used = cbor.loads_prefix(raw[2:])
        raw = raw[2:2 + used]
        obj = obj[1]
    hdr = _parse_header_obj(obj, raw)
    if ebb_hint is not None and hdr.is_ebb != ebb_hint:
        raise ValueError("EBB wrapper tag contradicts header shape")
    return hdr


@dataclass(frozen=True)
class RealByronBlock:
    header: RealByronHeader
    body: Any                    # decoded payload (txs / ssc / dlg / upd)
    raw: bytes                   # the [0|1, [hdr, body, extra]] bytes

    @property
    def n_txs(self) -> int:
        if self.header.is_ebb:
            return 0
        return len(self.body[0])

    def to_cbor(self) -> bytes:
        return self.raw

    def to_wrapped_cbor(self) -> bytes:
        return cbor.dumps(cbor.Tag(24, self.raw))


def parse_block(raw: bytes) -> RealByronBlock:
    """Parse a Byron block: tag24(bytes([0|1, [header, body, extra]]))
    or the bare tagged pair."""
    obj = cbor.loads(raw)
    if isinstance(obj, cbor.Tag):
        if obj.tag != 24 or not isinstance(obj.value, bytes):
            raise ValueError(f"expected tag 24 bytes, got tag {obj.tag}")
        raw = obj.value
        obj = cbor.loads(raw)
    if not (isinstance(obj, list) and len(obj) == 2
            and isinstance(obj[0], int)):
        raise ValueError("Byron block must be [0|1, [...]]")
    tag, payload = int(obj[0]), obj[1]
    if tag not in (0, 1) or not isinstance(payload, list) \
            or len(payload) != 3:
        raise ValueError("unrecognised Byron block shape")
    # slice the header bytes out of the raw pair:
    # 0x82, tag byte, payload array head, header
    info = raw[2] & 0x1F
    hdr_start = 3 + {24: 1, 25: 2, 26: 4, 27: 8}.get(info, 0)
    _, used = cbor.loads_prefix(raw[hdr_start:])
    hdr_raw = raw[hdr_start:hdr_start + used]
    hdr = _parse_header_obj(payload[0], hdr_raw)
    if hdr.is_ebb != (tag == 0):
        raise ValueError("block tag contradicts header shape")
    return RealByronBlock(hdr, payload[1], raw)
