"""Real Cardano Shelley header CBOR — parse + validate the reference's
actual wire/disk bytes, not this repo's dialect.

The reference serialises a Shelley header as (cardano-ledger BHeader via
`ouroboros-consensus-shelley/src/Ouroboros/Consensus/Shelley/Node/Serialisation.hs`,
golden bytes in `ouroboros-consensus-shelley-test/test/golden/
ShelleyNodeToNodeVersion1/Header`):

    tag 24 ( bytes ( [ BHBody , KES-signature(448) ] ) )

with BHBody a flat 15-element array:

    [ block_no, slot, prev_hash(32), issuer_vkey(32), vrf_vkey(32),
      nonce_vrf_cert  = [output(64), proof(80)],
      leader_vrf_cert = [output(64), proof(80)],
      body_size, body_hash(32),
      ocert_hot_vkey(32), ocert_counter, ocert_kes_period, ocert_sigma(64),
      protover_major, protover_minor ]

and the HFC-wrapped form (`CardanoNodeToNodeVersion*/Header_Shelley`) is
`[era_index, tag 24 (bytes ...)]`.

Everything here is validated bit-exactly against those golden files in
tests/test_real_header.py: parse -> re-encode round-trips byte-identical,
and the FULL header crypto (both VRF proofs through the verify equation,
the Sum6 KES signature over the exact BHBody byte slice, the OCert
Ed25519 signature over its signable representation) passes on the real
libsodium-generated bytes with every backend (external conformance).

The KES signed message is the BHBody CBOR slice itself; the OCert
signable representation is `hot_vkey || counter:u64be || period:u64be`
(cardano-ledger `OCertSignable`).

Ported from `ouroboros_tpu/eras/shelley_cbor.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

from ..crypto.backend import Ed25519Req, KesReq, VrfReq
from ..utils import cbor

KES_DEPTH = 6                    # Sum6KES: 2^6 = 64 periods
KES_SIG_LEN = 64 + KES_DEPTH * 64


@dataclass(frozen=True)
class VrfCert:
    """CertifiedVRF: claimed output (proof_to_hash) + the 80-byte proof."""
    output: bytes
    proof: bytes

    def to_obj(self):
        return [self.output, self.proof]


@dataclass(frozen=True)
class RealBHBody:
    block_no: int
    slot: int
    prev_hash: bytes
    issuer_vkey: bytes
    vrf_vkey: bytes
    nonce_vrf: VrfCert
    leader_vrf: VrfCert
    body_size: int
    body_hash: bytes
    ocert_vkey: bytes            # KES hot verification key (tree root hash)
    ocert_counter: int
    ocert_kes_period: int        # first KES period the hot key covers
    ocert_sigma: bytes           # cold-key sig over the signable rep
    protover_major: int
    protover_minor: int

    def to_obj(self):
        return [self.block_no, self.slot, self.prev_hash, self.issuer_vkey,
                self.vrf_vkey, self.nonce_vrf.to_obj(),
                self.leader_vrf.to_obj(), self.body_size, self.body_hash,
                self.ocert_vkey, self.ocert_counter, self.ocert_kes_period,
                self.ocert_sigma, self.protover_major, self.protover_minor]

    def to_cbor(self) -> bytes:
        return cbor.dumps(self.to_obj())

    @classmethod
    def from_obj(cls, obj) -> "RealBHBody":
        if not isinstance(obj, list) or len(obj) != 15:
            raise ValueError("BHBody must be a 15-element array")
        return cls(
            int(obj[0]), int(obj[1]), bytes(obj[2]), bytes(obj[3]),
            bytes(obj[4]),
            VrfCert(bytes(obj[5][0]), bytes(obj[5][1])),
            VrfCert(bytes(obj[6][0]), bytes(obj[6][1])),
            int(obj[7]), bytes(obj[8]), bytes(obj[9]), int(obj[10]),
            int(obj[11]), bytes(obj[12]), int(obj[13]), int(obj[14]))

    def ocert_signable(self) -> bytes:
        """cardano-ledger OCertSignable: raw hot vkey || counter and
        period as big-endian Word64 (NOT CBOR)."""
        return self.ocert_vkey + struct.pack(
            ">QQ", self.ocert_counter, self.ocert_kes_period)


@dataclass(frozen=True)
class RealShelleyHeader:
    body: RealBHBody
    kes_sig: bytes               # 448B Sum6 KES signature
    body_bytes: bytes            # exact CBOR slice the KES sig covers

    def to_cbor(self) -> bytes:
        """Canonical inner header bytes (array [body, sig]); splices the
        exact body slice so the KES-signed bytes survive round-trips."""
        return b"\x82" + self.body_bytes + cbor.dumps(self.kes_sig)

    def to_wrapped_cbor(self) -> bytes:
        """tag-24 wrapped form, as the golden file stores it."""
        return cbor.dumps(cbor.Tag(24, self.to_cbor()))


def _unwrap(raw: bytes):
    """Strip the generic envelopes around any Shelley-family item:
    the HFC [era_ix, tag24(...)] wrapper, a bare tag-24 CBOR-in-CBOR
    envelope, and the network dialect that nests the era index INSIDE
    the tag (tag24(bytes([era_ix, item]))).  Returns (raw, obj) of the
    innermost item."""
    obj = cbor.loads(raw)
    if isinstance(obj, list) and len(obj) == 2 and isinstance(obj[0], int) \
            and isinstance(obj[1], cbor.Tag):
        obj = obj[1]                       # HFC era wrapper
    if isinstance(obj, cbor.Tag):
        if obj.tag != 24 or not isinstance(obj.value, bytes):
            raise ValueError(f"expected tag 24 bytes, got tag {obj.tag}")
        raw = obj.value
        obj = cbor.loads(raw)
        if isinstance(obj, list) and len(obj) == 2 \
                and isinstance(obj[0], int) and isinstance(obj[1], list):
            # era index nested inside the tag: [era_ix, item]
            _, used = cbor.loads_prefix(raw[1:])
            raw = raw[1 + used:]
            obj = obj[1]
    return raw, obj


def _vkey_witnesses(wset) -> tuple:
    """((vkey, sig), ...) from a decoded witness-set map (key 0)."""
    if not isinstance(wset, dict):
        return ()
    return tuple((bytes(w[0]), bytes(w[1])) for w in wset.get(0, ()))


def parse_header(raw: bytes) -> RealShelleyHeader:
    """Parse a real Shelley header from any of its encodings: bare
    [body, sig], tag-24-wrapped bytes, or the HFC [era_ix, tag24(...)]
    wrapper the Cardano golden headers use."""
    raw, obj = _unwrap(raw)
    if not (isinstance(obj, list) and len(obj) == 2):
        raise ValueError("header must be [BHBody, kes_sig]")
    if raw[0] != 0x82:
        raise ValueError("header array must be definite-length 2")
    _, body_len = cbor.loads_prefix(raw[1:])
    body_bytes = raw[1:1 + body_len]
    body = RealBHBody.from_obj(obj[0])
    kes_sig = bytes(obj[1])
    if len(kes_sig) != KES_SIG_LEN:
        raise ValueError(f"KES signature must be {KES_SIG_LEN} bytes")
    return RealShelleyHeader(body, kes_sig, body_bytes)


def header_proof_requests(hdr: RealShelleyHeader, alpha_nonce: bytes,
                          alpha_leader: bytes,
                          slots_per_kes_period: int = 129600):
    """The header's four crypto checks as batch-backend requests, in the
    order [nonce VRF, leader VRF, KES, OCert] — the per-header proof
    extraction of the PRTCL rule (Shelley/Protocol.hs:433-442) on REAL
    header bytes.

    alpha_* are the VRF inputs (mkSeed of slot and epoch nonce for a real
    chain; the golden example uses fixed seeds).  The KES evolution index
    is the header slot's KES period minus the OCert's start period."""
    b = hdr.body
    t = b.slot // slots_per_kes_period - b.ocert_kes_period
    return [
        VrfReq(b.vrf_vkey, alpha_nonce, b.nonce_vrf.proof),
        VrfReq(b.vrf_vkey, alpha_leader, b.leader_vrf.proof),
        KesReq(KES_DEPTH, b.ocert_vkey, t, hdr.body_bytes, hdr.kes_sig),
        Ed25519Req(b.issuer_vkey, b.ocert_signable(), b.ocert_sigma),
    ]


def validate_header(hdr: RealShelleyHeader, alpha_nonce: bytes,
                    alpha_leader: bytes, backend,
                    slots_per_kes_period: int = 129600) -> bool:
    """Full crypto validation of a real header on the given backend:
    2x VRF verify (and output == claimed output), KES, OCert."""
    reqs = header_proof_requests(hdr, alpha_nonce, alpha_leader,
                                 slots_per_kes_period)
    if not all(backend.verify_mixed(reqs)):
        return False
    outs = backend.vrf_betas_batch([hdr.body.nonce_vrf.proof,
                                    hdr.body.leader_vrf.proof])
    return outs[0] == hdr.body.nonce_vrf.output \
        and outs[1] == hdr.body.leader_vrf.output


# ---------------------------------------------------------------------------
# Real Shelley BLOCKS — the CBOR-in-CBOR block parser
# (ouroboros-consensus .../ImmutableDB/Impl/Parser.hs reads exactly these
# bytes out of chunk files; golden bytes in
# ouroboros-consensus-shelley-test/test/golden/disk/Block)
# ---------------------------------------------------------------------------

def _blake2b(data: bytes) -> bytes:
    import hashlib
    return hashlib.blake2b(data, digest_size=32).digest()


@dataclass(frozen=True)
class RealShelleyTx:
    """One transaction: decoded body map + the exact body byte slice the
    vkey witnesses sign (over its blake2b-256 hash), + witness set."""
    body: dict                    # {0: inputs, 1: outputs, 2: fee, ...}
    body_bytes: bytes
    witnesses: tuple              # ((vkey(32), sig(64)), ...)

    @property
    def body_hash(self) -> bytes:
        return _blake2b(self.body_bytes)


@dataclass(frozen=True)
class RealShelleyBlock:
    """[header, tx bodies, witness sets, metadata] with the section byte
    slices retained: the BBODY hash is
    blake2b(blake2b(bodies) || blake2b(wits) || blake2b(metadata))
    (verified bit-exactly against the golden header's claim)."""
    header: RealShelleyHeader
    txs: tuple                    # (RealShelleyTx, ...)
    bodies_bytes: bytes           # the three raw section slices
    wits_bytes: bytes
    meta_bytes: bytes

    def computed_body_hash(self) -> bytes:
        return _blake2b(_blake2b(self.bodies_bytes)
                        + _blake2b(self.wits_bytes)
                        + _blake2b(self.meta_bytes))

    def to_cbor(self) -> bytes:
        return b"\x84" + self.header.to_cbor() + self.bodies_bytes \
            + self.wits_bytes + self.meta_bytes


def _array_head_len(raw: bytes) -> int:
    """Byte length of a CBOR array head (definite or indefinite)."""
    info = raw[0] & 0x1F
    if info < 24 or info == 31:
        return 1
    return {24: 2, 25: 3, 26: 5, 27: 9}[info]


def parse_block(raw: bytes) -> RealShelleyBlock:
    """Parse a real Shelley block from bare, tag-24-wrapped, or HFC
    [era_ix, tag24(...)] encodings (incl. the network dialect nesting the
    era index inside the tag)."""
    raw, _obj = _unwrap(raw)
    if raw[0] != 0x84:
        raise ValueError("block must be a definite 4-element array")
    pos = 1
    sections = []
    for _ in range(4):
        obj, used = cbor.loads_prefix(raw[pos:])
        sections.append((obj, raw[pos:pos + used]))
        pos += used
    (_hdr_obj, hdr_bytes), (bodies, bodies_bytes), (wits, wits_bytes), \
        (_meta, meta_bytes) = sections
    header = parse_header(hdr_bytes)
    if not isinstance(bodies, list) or not isinstance(wits, list):
        raise ValueError("tx bodies / witness sets must be arrays")
    if len(wits) != len(bodies):
        raise ValueError("witness-set count != tx count")
    # per-tx body byte slices (the witnesses sign their hashes); skip the
    # array head
    txs = []
    bpos = _array_head_len(bodies_bytes)
    for i, body in enumerate(bodies):
        _, used = cbor.loads_prefix(bodies_bytes[bpos:])
        body_bytes = bodies_bytes[bpos:bpos + used]
        bpos += used
        txs.append(RealShelleyTx(body, body_bytes,
                                 _vkey_witnesses(wits[i])))
    return RealShelleyBlock(header, tuple(txs), bodies_bytes, wits_bytes,
                            meta_bytes)


def parse_tx(raw: bytes) -> RealShelleyTx:
    """Parse a standalone real Shelley transaction ([body, witness_set,
    metadata], optionally tag-24 / [era_ix, tag24(...)] wrapped — the
    GenTx wire form).  tx.body_hash is the txid: blake2b-256 of the exact
    body bytes, matching the reference's own GenTxId golden."""
    raw, obj = _unwrap(raw)
    if not (isinstance(obj, list) and len(obj) == 3
            and isinstance(obj[0], dict)):
        raise ValueError("tx must be [body, witness_set, metadata]")
    body_start = _array_head_len(raw)
    _, used = cbor.loads_prefix(raw[body_start:])
    body_bytes = raw[body_start:body_start + used]
    return RealShelleyTx(obj[0], body_bytes, _vkey_witnesses(obj[1]))


def validate_tx(tx: RealShelleyTx, backend) -> bool:
    """The witness multi-verify of a standalone tx: every vkey witness is
    Ed25519 over the txid (blake2b-256 of the body bytes)."""
    if not tx.witnesses:
        return True
    h = tx.body_hash
    return all(backend.verify_ed25519_batch(
        [Ed25519Req(vk, h, sig) for vk, sig in tx.witnesses]))


@dataclass(frozen=True)
class RealChainDepState:
    """The reference's serialised TPraos chain-dependent state (the
    protocol-state snapshot written to disk; golden bytes in
    `ouroboros-consensus-shelley-test/test/golden/disk/ChainDepState`):

        [ version, [ last_slot, [ PRTCL, TICKN, lab_nonce ] ] ]
        PRTCL = [ {pool_keyhash(28): ocert_counter}, eta_v, eta_c ]
        TICKN = [ eta0, eta_ph ]

    where a nonce encodes as [0] (neutral) or [1, hash32].  These are
    exactly the fields our TPraosState tracks (eras/shelley.py:
    eta0/eta_v/eta_c/eta_ph + counters), so the reference's protocol
    snapshots are readable for resume interop."""
    last_slot: Optional[int]     # None = Origin
    counters: tuple              # ((pool_keyhash, counter), ...) sorted
    eta_v: Optional[bytes]
    eta_c: Optional[bytes]
    eta0: Optional[bytes]
    eta_ph: Optional[bytes]
    lab: Optional[bytes]


def _nonce(obj) -> Optional[bytes]:
    if isinstance(obj, list):
        if obj == [0]:
            return None          # NeutralNonce
        if len(obj) == 2 and obj[0] == 1 and isinstance(obj[1], bytes):
            return bytes(obj[1])
    raise ValueError("nonce must be [0] or [1, hash]")


def parse_chain_dep_state(raw: bytes) -> RealChainDepState:
    obj = cbor.loads(raw)
    if not (isinstance(obj, list) and len(obj) == 2 and obj[0] == 1):
        raise ValueError("unsupported ChainDepState version")
    last_slot_obj, st = obj[1]
    if last_slot_obj == [0]:
        last_slot = None                          # Origin
    elif isinstance(last_slot_obj, list) and len(last_slot_obj) == 2 \
            and last_slot_obj[0] == 1:
        last_slot = int(last_slot_obj[1])         # At slot
    else:
        raise ValueError("last_slot must be [0] or [1, slot]")
    prtcl, tickn, lab = st
    counters, eta_v, eta_c = prtcl
    eta0, eta_ph = tickn
    return RealChainDepState(
        last_slot,
        tuple(sorted((bytes(k), int(v)) for k, v in counters.items())),
        _nonce(eta_v), _nonce(eta_c), _nonce(eta0), _nonce(eta_ph),
        _nonce(lab))


def block_proof_requests(blk: RealShelleyBlock, alpha_nonce: bytes,
                         alpha_leader: bytes,
                         slots_per_kes_period: int = 129600):
    """Header crypto + every vkey witness of the BBODY as one mixed batch
    (the witness multi-verify of Shelley/Ledger/Ledger.hs:279-284 on real
    bytes: each witness is Ed25519 over blake2b-256 of its tx body)."""
    reqs = header_proof_requests(blk.header, alpha_nonce, alpha_leader,
                                 slots_per_kes_period)
    for tx in blk.txs:
        h = tx.body_hash
        for vk, sig in tx.witnesses:
            reqs.append(Ed25519Req(vk, h, sig))
    return reqs


def validate_block(blk: RealShelleyBlock, alpha_nonce: bytes,
                   alpha_leader: bytes, backend,
                   slots_per_kes_period: int = 129600,
                   check_body_size: bool = True) -> bool:
    """Full block validation on real bytes: header crypto + BBODY hash +
    witness multi-verify.  check_body_size=False for the golden example,
    whose bsize field is a hand-written constant (Examples.hs:448)."""
    if blk.computed_body_hash() != blk.header.body.body_hash:
        return False
    if check_body_size and blk.header.body.body_size != \
            len(blk.bodies_bytes) + len(blk.wits_bytes) \
            + len(blk.meta_bytes):
        return False
    reqs = block_proof_requests(blk, alpha_nonce, alpha_leader,
                                slots_per_kes_period)
    if not all(backend.verify_mixed(reqs)):
        return False
    outs = backend.vrf_betas_batch([blk.header.body.nonce_vrf.proof,
                                    blk.header.body.leader_vrf.proof])
    return outs[0] == blk.header.body.nonce_vrf.output \
        and outs[1] == blk.header.body.leader_vrf.output
