"""Full validation of the chain, block by block: TPraos and the UTxO ledger.

What `db-analyser --validate full` checks of a Shelley block, on this
chain's format (chain.py), within one epoch:

- the envelope: block number, slot and the previous hash follow the tip,
  and the body hash is the body's;
- the header: the issuer's pool has stake, the leader VRF output lies
  below 1 - (1 - f)^sigma, the KES period lies in the operational
  certificate's window, the certificate's issue number neither regresses
  nor jumps by more than one; both VRF proofs, the certificate's
  signature and the KES signature verify;
- the body: each transaction spends distinct existing outputs, each
  spent address witnesses it, it produces no more than it spends, and
  every witness signature verifies over the transaction id;
- nonce evolution (TPraos UPDN): eta_v <- H(eta_v || H(beta_eta)),
  eta_c follows eta_v until the stability window, the last header's
  hash H("lab:" || hash) and the pool's issue number are kept.

`crypto=False` leaves out the proof and signature checks of a block (the
rest is always checked): the harness verifies a sample of blocks in full
and computes every other block's state all the same.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal, localcontext
from fractions import Fraction
from functools import lru_cache

from . import chain, ed25519, kes, vrf
from .cbor import decode
from .kes import b2b256


class Invalid(Exception):
    """A block that full validation rejects."""


@dataclass(frozen=True)
class Genesis:
    seed: bytes
    f: Fraction
    k: int
    epoch_length: int
    slots_per_kes_period: int
    kes_depth: int
    max_kes_evolutions: int
    pools: tuple          # ((cold_vk, vrf_vk), ...)
    utxo: tuple           # ((addr, amount), ...)
    delegs: tuple         # ((addr, pool_id), ...)

    @property
    def stability_window(self) -> int:
        f = self.f
        return (3 * self.k * f.denominator + f.numerator - 1) // f.numerator

    def stake(self) -> dict:
        """pool_id -> (vrf_vk, sigma) over the pools with stake."""
        amounts = dict(self.utxo)
        vrf_of = {chain.pool_id(cold): v for cold, v in self.pools}
        by_pool: dict = {}
        for addr, pid in self.delegs:
            if pid in vrf_of:
                by_pool[pid] = by_pool.get(pid, 0) + amounts.get(addr, 0)
        total = sum(s for s in by_pool.values() if s > 0)
        return {pid: (vrf_of[pid], Fraction(s, total))
                for pid, s in by_pool.items() if s > 0}


@dataclass
class State:
    utxo: dict            # (txid, ix) -> (addr, amount)
    counters: dict        # pool_id -> issue number
    eta0: bytes
    eta_v: bytes
    eta_c: bytes
    eta_ph: bytes
    tip: tuple = None     # (slot, block_no, hash)
    blocks_made: dict = field(default_factory=dict)

    @classmethod
    def genesis(cls, g: Genesis) -> "State":
        eta = b2b256(b"eta0:" + g.seed)
        utxo = {(chain.GENESIS_TXID, ix): (addr, amount)
                for ix, (addr, amount) in enumerate(sorted(g.utxo))}
        return cls(utxo, {}, eta, eta, eta, b"\x00" * 32)

    def copy(self) -> "State":
        return State(dict(self.utxo), dict(self.counters), self.eta0,
                     self.eta_v, self.eta_c, self.eta_ph, self.tip,
                     dict(self.blocks_made))

    def digest(self) -> dict:
        """The state as plain values, the form the harness compares."""
        return {
            "utxo": frozenset((t, i, a, m)
                              for (t, i), (a, m) in self.utxo.items()),
            "counters": tuple(sorted(self.counters.items())),
            "eta0": self.eta0, "eta_v": self.eta_v, "eta_c": self.eta_c,
            "eta_ph": self.eta_ph, "epoch": 0,
            "tip_slot": self.tip[0], "tip_hash": self.tip[2],
            "blocks_made": tuple(sorted(self.blocks_made.items())),
        }


@lru_cache(maxsize=64)
def _threshold(sigma: Fraction, f: Fraction) -> Decimal:
    with localcontext() as ctx:
        ctx.prec = 80
        one = Decimal(1)
        ln = (one - Decimal(f.numerator) / Decimal(f.denominator)).ln()
        s = Decimal(sigma.numerator) / Decimal(sigma.denominator)
        return one - (s * ln).exp()


def is_leader(beta: bytes, sigma: Fraction, f: Fraction) -> bool:
    """beta / 2^512 < 1 - (1 - f)^sigma."""
    with localcontext() as ctx:
        ctx.prec = 80
        p = Decimal(int.from_bytes(beta, "big")) / Decimal(2 ** 512)
        return p < _threshold(sigma, f)


def apply_block(g: Genesis, stake: dict, st: State, b: chain.Block,
                crypto: bool, beta=vrf.proof_to_hash) -> State:
    """The state after block b, or Invalid.  `st` is left unchanged."""
    if b.slot >= g.epoch_length:
        raise ValueError("the reference covers the first epoch only")
    want_no, min_slot, want_prev = ((0, 0, chain.GENESIS_HASH)
                                    if st.tip is None else
                                    (st.tip[1] + 1, st.tip[0] + 1, st.tip[2]))
    if (b.block_no, b.prev_hash) != (want_no, want_prev) \
            or b.slot < min_slot:
        raise Invalid("envelope")
    if not b.body_hash_ok:
        raise Invalid("body hash")
    f = b.fields
    try:
        issuer = f[chain.ISSUER]
        kes_vk, counter, start, sigma = decode(f[chain.OCERT])[0]
        pi_eta, pi_leader, kes_sig = f[chain.ETA], f[chain.LEADER], \
            f[chain.KES]
    except (KeyError, ValueError, TypeError) as e:
        raise Invalid(f"header fields: {e}") from e
    pid = chain.pool_id(issuer)
    if pid not in stake:
        raise Invalid("issuer has no stake")
    vrf_vk, pool_sigma = stake[pid]
    beta_leader, beta_eta = beta(pi_leader), beta(pi_eta)
    if beta_leader is None or beta_eta is None:
        raise Invalid("VRF proof does not decode")
    if not is_leader(beta_leader, pool_sigma, g.f):
        raise Invalid("leader VRF value above the threshold")
    evolution = b.slot // g.slots_per_kes_period - start
    if not 0 <= evolution < min(g.max_kes_evolutions, 1 << g.kes_depth):
        raise Invalid("KES period outside the certificate's window")
    current = st.counters.get(pid, -1)
    if counter < current or counter > max(current, 0) + 1:
        raise Invalid("operational certificate issue number")
    if crypto:
        if not vrf.verify(vrf_vk, chain.vrf_alpha(b"eta", b.slot, st.eta0),
                          pi_eta):
            raise Invalid("nonce VRF proof")
        if not vrf.verify(vrf_vk, chain.vrf_alpha(b"leader", b.slot,
                                                  st.eta0), pi_leader):
            raise Invalid("leader VRF proof")
        if not ed25519.verify(issuer, chain.ocert_body(kes_vk, counter,
                                                       start), sigma):
            raise Invalid("operational certificate signature")
        if not kes.verify(g.kes_depth, kes_vk, evolution, b.kes_msg,
                          kes_sig):
            raise Invalid("KES signature")
    out = st.copy()
    utxo = out.utxo
    for tx in b.txs:
        if tx.extra:
            raise Invalid("certificates, validity, assets or withdrawals")
        if len(set(tx.inputs)) != len(tx.inputs):
            raise Invalid("duplicate inputs")
        wit_vks = {vk for vk, _sig in tx.witnesses}
        spent = 0
        for key in tx.inputs:
            entry = utxo.get(key)
            if entry is None:
                raise Invalid("missing input")
            if entry[0] not in wit_vks:
                raise Invalid("input without its witness")
            spent += entry[1]
        if any(m < 0 for _a, m in tx.outputs) \
                or sum(m for _a, m in tx.outputs) > spent:
            raise Invalid("outputs exceed inputs")
        if crypto:
            for vk, sig in tx.witnesses:
                if not ed25519.verify(vk, tx.txid, sig):
                    raise Invalid("witness signature")
        for key in tx.inputs:
            del utxo[key]
        for ix, out_ in enumerate(tx.outputs):
            utxo[(tx.txid, ix)] = out_
    out.eta_v = b2b256(st.eta_v + b2b256(beta_eta))
    if b.slot < g.epoch_length - g.stability_window:
        out.eta_c = out.eta_v
    out.eta_ph = b2b256(b"lab:" + b.hash)
    out.counters[pid] = counter
    out.blocks_made[pid] = out.blocks_made.get(pid, 0) + 1
    out.tip = (b.slot, b.block_no, b.hash)
    return out
