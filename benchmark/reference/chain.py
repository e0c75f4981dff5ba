"""The chain's byte format: Shelley-analog blocks of a TPraos chain.

    block  = [header, [tx, ...]]
    header = [slot, block_no, prev_hash, body_hash, issuer, fields]
    fields = [[name, bytes], ...], sorted by name:
             tp_eta_vrf     the nonce VRF proof (80 bytes)
             tp_issuer_vk   the pool's cold key
             tp_kes_sig     the KES signature over the header without
                            this field (64 + 64 depth bytes)
             tp_leader_vrf  the leader VRF proof
             tp_ocert       CBOR [kes_vk, counter, kes_period_start, sigma],
                            sigma the cold key's signature of the first three
    tx     = [inputs, outputs, certs, validity, mint, withdrawals, witnesses]
             inputs [[txid, ix]], outputs [[addr, amount, []]], the next
             four empty here, witnesses [[vk, sig]] over the transaction id
    txid   = Blake2b-256 of the CBOR of the tx's first six elements
    body_hash = Blake2b-256 of the CBOR of the tx list
    block hash = Blake2b-256 of the header's CBOR

An address is the 32-byte key that must witness a spend from it.  The
genesis outputs are (0^32, i), i in the order of their sorted addresses.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import cbor
from .kes import b2b256

ETA = "tp_eta_vrf"
ISSUER = "tp_issuer_vk"
KES = "tp_kes_sig"
LEADER = "tp_leader_vrf"
OCERT = "tp_ocert"
GENESIS_HASH = b"\x00" * 32
GENESIS_TXID = b"\x00" * 32


def b2b224(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=28).digest()


def pool_id(cold_vk: bytes) -> bytes:
    return b2b224(cold_vk)


def vrf_alpha(domain: bytes, slot: int, eta0: bytes) -> bytes:
    return b2b256(domain + slot.to_bytes(8, "big") + eta0)


def ocert_body(kes_vk: bytes, counter: int, start: int) -> bytes:
    return cbor.encode([kes_vk, counter, start])


# -- encoding (the forger) ----------------------------------------------------

def tx_body(inputs, outputs) -> list:
    return [[list(i) for i in inputs], [[a, m, []] for a, m in outputs],
            [], [], [], []]


def txid_of(body: list) -> bytes:
    return b2b256(cbor.encode(body))


def header_list(slot, block_no, prev_hash, body_hash, fields: dict,
                drop=()) -> list:
    return [slot, block_no, prev_hash, body_hash, 0,
            [[k, fields[k]] for k in sorted(fields) if k not in drop]]


def block_bytes(header: list, txs: list) -> bytes:
    return cbor.encode([header, txs])


# -- decoding (the reference) -------------------------------------------------

@dataclass
class Tx:
    txid: bytes
    inputs: list          # [(txid, ix)]
    outputs: list         # [(addr, amount)]
    witnesses: list       # [(vk, sig)]
    extra: bool           # certs, validity, mint or withdrawals present


@dataclass
class Block:
    slot: int
    block_no: int
    prev_hash: bytes
    body_hash: bytes
    issuer: int
    fields: dict
    hash: bytes
    kes_msg: bytes        # the header's CBOR without the KES field
    body_hash_ok: bool
    txs: list


def decode_block(raw: bytes) -> Block:
    _two, h0 = cbor.array_head(raw, 0)
    header, b0 = cbor.decode(raw, h0)
    slot, block_no, prev_hash, body_hash, issuer, pairs = header
    fields = {k: v for k, v in pairs}
    kes_msg = cbor.encode(header[:5] + [[[k, v] for k, v in pairs
                                         if k != KES]])
    txs = []
    n_txs, pos = cbor.array_head(raw, b0)
    for _ in range(n_txs):
        elems, pos = cbor.items(raw, pos)
        body_raw = cbor.head(4, 6) + raw[elems[0][1]:elems[5][2]]
        ins, outs, certs, validity, mint, wdrl, wits = (e[0] for e in elems)
        txs.append(Tx(b2b256(body_raw), [(t, i) for t, i in ins],
                      [(o[0], o[1]) for o in outs],
                      [(vk, sig) for vk, sig in wits],
                      bool(certs or validity or mint or wdrl
                           or any(o[2] for o in outs))))
    return Block(slot, block_no, prev_hash, body_hash, issuer, fields,
                 b2b256(raw[h0:b0]), kes_msg, b2b256(raw[b0:pos]) == body_hash,
                 txs)
