"""Shelley-analog era: TPraos protocol + stake-pool UTxO ledger.

Reference: ouroboros-consensus-shelley/src/Ouroboros/Consensus/Shelley/
- Protocol.hs:355-453  — TPraos instance: `checkIsLeader` runs TWO VRF
  evaluations per slot (nonce eta and leader), `updateChainDepState` runs
  the PRTCL rule: KES header signature verify, both VRF verifies, and the
  operational-certificate Ed25519 verify, plus nonce evolution and ocert
  counter bookkeeping.
- Protocol.hs:472-491  — `checkLeaderValue` fixed-point threshold check
  (here eras/nonintegral.py).
- Protocol.hs:281-310  — `TPraosChainSelectView` tie-breaking: chain
  length, then ocert issue number (same issuer), then lower leader-VRF.
- Protocol/Crypto.hs:15-23 — StandardCrypto = Ed25519 + Sum6KES + PraosVRF;
  the crypto routes through the CryptoBackend batch seam instead.
- Protocol/HotKey.hs:48-149 — evolving KES hot key (crypto/kes.py +
  consensus/protocols/praos.py HotKey, reused here).
- Ledger/Ledger.hs:238-284 — applyLedgerBlock = BBODY incl. the Ed25519
  tx-witness multi-verify; here the witness proofs are extracted for one
  device batch per block window (the BASELINE config #4 primitive).

TPU-first shape: all state-DEPENDENT work (nonce evolution, thresholds,
counters, stake snapshots) is cheap host arithmetic in `sequential_checks` /
`reupdate_chain_dep_state`; every expensive proof (2 VRF + KES + OCert-sig
per header, N witness sigs per body) is emitted via `extract_proofs` so a
window of headers/blocks becomes ONE batched device call
(consensus/batch.py).

Ledger depth:
mark->set->go 3-deep stake snapshots (SNAP); reserves/treasury monetary
expansion with per-pool rewards by go-snapshot stake share x apparent
performance, claimed through exact-balance withdrawals (RUPD/WDRL); a
pool-retirement queue processed at epoch boundaries (POOLREAP); and the
full TICKN nonce rule mixing the previous epoch's last header hash into
the active nonce.  The independent spec oracle in testing/dual.py
recomputes the three ledger rules; the nonce rule is covered by direct
unit tests (tests/test_shelley_depth.py TestFullNonceRule).

Ported from `ouroboros_tpu/eras/shelley.py` (the port imports nothing of
the JAX package). Copied whole. Every request it builds is the port's
`Ed25519Req` / `VrfReq` / `KesReq`.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from fractions import Fraction
from functools import lru_cache
from typing import Any, Optional, Sequence

from ..chain.block import Point, point_of
from ..consensus.ledger import LedgerError, LedgerRules, OutsideForecastRange
from ..consensus.protocol import ConsensusProtocol, ProtocolError
from ..consensus.protocols.praos import HotKey
from ..crypto import ed25519_ref, kes as kes_mod, vrf_ref
from ..crypto.backend import (
    Ed25519Req, GLOBAL_BETA_CACHE, KesReq, VrfReq,
)
from ..utils import cbor

# header protocol-evidence fields (sign-the-header-minus-KES-sig convention)
ETA_VRF_FIELD = "tp_eta_vrf"
LEADER_VRF_FIELD = "tp_leader_vrf"
KES_FIELD = "tp_kes_sig"
OCERT_FIELD = "tp_ocert"
ISSUER_FIELD = "tp_issuer_vk"

POOL_ID_BYTES = 28                     # Blake2b-224 of the cold vk


def _b2b(data: bytes, n: int = 32) -> bytes:
    return hashlib.blake2b(data, digest_size=n).digest()


@lru_cache(maxsize=4096)
def pool_id_of(cold_vk: bytes) -> bytes:
    """KeyHash of a pool's cold key (Blake2b-224, as in Shelley).
    Memoized: the replay hot path derives it three times per header from
    a handful of distinct keys."""
    return _b2b(cold_vk, POOL_ID_BYTES)


# ---------------------------------------------------------------------------
# Operational certificates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OCert:
    """Operational certificate: the cold key delegates block issuance to a
    KES hot key (OCert in the PRTCL rule; verified per header)."""
    kes_vk: bytes                      # hot-key root verification key
    counter: int                       # issue number (monotone per pool)
    kes_period_start: int              # first KES period the hot key covers
    sigma: bytes                       # cold-key Ed25519 sig over the body

    def body_bytes(self) -> bytes:
        return cbor.dumps([self.kes_vk, self.counter, self.kes_period_start])

    def to_bytes(self) -> bytes:
        return cbor.dumps([self.kes_vk, self.counter, self.kes_period_start,
                           self.sigma])

    @classmethod
    def from_bytes(cls, raw: bytes) -> "OCert":
        obj = cbor.loads(raw)
        return cls(bytes(obj[0]), int(obj[1]), int(obj[2]), bytes(obj[3]))


def make_ocert(cold_sk: bytes, kes_vk: bytes, counter: int,
               kes_period_start: int) -> OCert:
    body = cbor.dumps([kes_vk, counter, kes_period_start])
    return OCert(kes_vk, counter, kes_period_start,
                 ed25519_ref.sign(cold_sk, body))


# ---------------------------------------------------------------------------
# Protocol configuration / ledger view
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TPraosConfig:
    k: int = 5                         # security parameter
    f: Fraction = Fraction(1, 2)       # active slot coefficient
    epoch_length: int = 100
    slots_per_kes_period: int = 10
    kes_depth: int = 6                 # Sum6KES -> 64 periods
    max_kes_evolutions: int = 62
    # monetary expansion / treasury cut (the rho and tau protocol
    # parameters of the reward calculation)
    rho: Fraction = Fraction(1, 10)
    tau: Fraction = Fraction(1, 5)

    @property
    def stability_window(self) -> int:
        """3k/f slots — the randomness-stabilisation window after which the
        candidate nonce freezes (and the ledger-view forecast horizon)."""
        f = self.f
        return (3 * self.k * f.denominator + f.numerator - 1) // f.numerator


@dataclass(frozen=True)
class PoolInfo:
    stake_num: int
    stake_den: int
    vrf_vk: bytes

    @property
    def sigma(self) -> Fraction:
        return Fraction(self.stake_num, self.stake_den) \
            if self.stake_den else Fraction(0)


@dataclass
class TPraosLedgerView:
    """What TPraos needs from the ledger: the pool stake distribution of
    the snapshot used for leader election (PoolDistr in the reference)."""
    pools: dict                        # pool_id -> PoolInfo

    def get(self, pool_id: bytes) -> Optional[PoolInfo]:
        return self.pools.get(pool_id)


# ---------------------------------------------------------------------------
# Chain-dependent state
# ---------------------------------------------------------------------------


def _fast_replace(obj, **kw):
    """dataclasses.replace for the hot sequential pass: ~25us -> ~2us per
    call by skipping the kwargs->__init__ round-trip (and __post_init__'s
    UtxoMap coercion, which hot callers already guarantee).  Only used
    where every field value is already in its canonical type."""
    new = object.__new__(type(obj))
    d = dict(obj.__dict__)
    d.update(kw)
    new.__dict__.update(d)
    return new


@dataclass(frozen=True)
class TPraosState:
    """PrtclState + TICKN analog: epoch nonces and per-pool ocert counters.

    eta0   — active nonce: seeds both VRF inputs all epoch
    eta_v  — evolving nonce: folds in every block nonce
    eta_c  — candidate: trails eta_v until the stability window, then frozen
    eta_ph — previous-header nonce: hash of the last applied header (the
             PRTCL "lab"); at the epoch boundary it is the hash of the
             previous epoch's final header, mixed into eta0 (the full
             TICKN rule the reference applies)
    counters — ((pool_id, issue_no), ...) sorted
    """
    epoch: int
    eta0: bytes
    eta_v: bytes
    eta_c: bytes
    counters: tuple = ()
    eta_ph: bytes = b"\x00" * 32

    @classmethod
    def genesis(cls, seed: bytes = b"shelley-genesis") -> "TPraosState":
        eta = _b2b(b"eta0:" + seed)
        return cls(0, eta, eta, eta, ())

    def counter_of(self, pool_id: bytes) -> int:
        for p, c in self.counters:
            if p == pool_id:
                return c
        return -1

    def with_counter(self, pool_id: bytes, counter: int) -> "TPraosState":
        d = dict(self.counters)
        d[pool_id] = counter
        return _fast_replace(self, counters=tuple(sorted(d.items())))


@dataclass(frozen=True)
class TPraosIsLeader:
    """IsLeader evidence: both VRF proofs for the slot."""
    eta_proof: bytes
    leader_proof: bytes


@dataclass(frozen=True)
class TPraosCanBeLeader:
    """Forging credentials (TPraosCanBeLeader analog)."""
    cold_sk: bytes
    vrf_sk: bytes
    ocert: OCert

    @property
    def cold_vk(self) -> bytes:
        return ed25519_ref.public_key(self.cold_sk)

    @property
    def pool_id(self) -> bytes:
        return pool_id_of(self.cold_vk)


@dataclass(frozen=True)
class TPraosSelectView:
    """Chain comparison projection (TPraosChainSelectView,
    Protocol.hs:281-310)."""
    block_no: int
    slot: int
    issuer_vk: bytes
    issue_no: int
    leader_vrf: int                    # lower wins ties


def _vrf_alpha(domain: bytes, slot: int, eta0: bytes) -> bytes:
    """mkSeed analog: VRF input = H(domain || slot || eta0)."""
    return _b2b(domain + slot.to_bytes(8, "big") + eta0)


def _leader_value(beta: bytes) -> int:
    return int.from_bytes(beta, "big")


class TPraos(ConsensusProtocol):
    """The TPraos consensus protocol over a TPraosLedgerView."""

    def __init__(self, config: TPraosConfig,
                 genesis_seed: bytes = b"shelley-genesis"):
        self.config = config
        self.genesis_seed = genesis_seed
        self.security_param = config.k
        self._betas = GLOBAL_BETA_CACHE

    # -- epochs / periods ----------------------------------------------------
    def epoch_of(self, slot: int) -> int:
        return slot // self.config.epoch_length

    def first_slot_of(self, epoch: int) -> int:
        return epoch * self.config.epoch_length

    def kes_period_of(self, slot: int) -> int:
        return slot // self.config.slots_per_kes_period

    def _freeze_slot(self, epoch: int) -> int:
        """Slot at which this epoch's candidate nonce freezes."""
        return self.first_slot_of(epoch + 1) - self.config.stability_window

    # -- state ---------------------------------------------------------------
    def initial_chain_dep_state(self) -> TPraosState:
        return TPraosState.genesis(self.genesis_seed)

    def tick_chain_dep_state(self, state: TPraosState, ledger_view,
                             slot: int) -> TPraosState:
        """Cross epoch boundaries (TICKN): the candidate nonce combines
        with the previous epoch's last header hash (eta_ph) to become the
        active nonce — the full rule (candidate ⭒ prev-hash nonce)."""
        target = self.epoch_of(slot)
        while state.epoch < target:
            nxt = state.epoch + 1
            eta0 = _b2b(b"tickn:" + state.eta_c + state.eta_ph
                        + nxt.to_bytes(8, "big"))
            state = replace(state, epoch=nxt, eta0=eta0)
        return state

    # -- header decoding -----------------------------------------------------
    def _decode_header(self, header):
        """Parse the protocol fields; memoized on the header's own cache —
        the hot path (sequential_checks + extract_proofs +
        reupdate_chain_dep_state) decodes each header three times."""
        got = header._cache.get("tp_dec")
        if got is not None:
            return got
        issuer_vk = header.get(ISSUER_FIELD)
        ocert_raw = header.get(OCERT_FIELD)
        pi_eta = header.get(ETA_VRF_FIELD)
        pi_leader = header.get(LEADER_VRF_FIELD)
        kes_sig = header.get(KES_FIELD)
        if None in (issuer_vk, ocert_raw, pi_eta, pi_leader, kes_sig):
            raise ProtocolError("TPraos: header missing protocol fields")
        try:
            ocert = OCert.from_bytes(ocert_raw)
        except Exception as e:
            raise ProtocolError(f"TPraos: malformed OCert: {e}") from e
        got = (issuer_vk, ocert, pi_eta, pi_leader, kes_sig)
        header._cache["tp_dec"] = got
        return got

    # -- validation ----------------------------------------------------------
    def sequential_checks(self, ticked: TPraosState, header,
                          ledger_view: TPraosLedgerView) -> None:
        cfg = self.config
        # defense-in-depth: validate_envelope / the HFC era gate reject this
        # first on every production path; kept so TPraos is safe standalone
        if header.get("ebb"):
            raise ProtocolError("TPraos: Shelley admits no EBBs")
        issuer_vk, ocert, pi_eta, pi_leader, _ = self._decode_header(header)
        pid = pool_id_of(issuer_vk)
        pool = ledger_view.get(pid)
        if pool is None:
            raise ProtocolError(
                f"TPraos: issuer pool {pid.hex()[:12]} not in the stake "
                f"distribution")
        try:
            beta_leader = self._betas.get(pi_leader)
        except ValueError as e:
            raise ProtocolError(f"TPraos: malformed leader VRF: {e}") from e
        from .nonintegral import check_leader_value
        if not check_leader_value(_leader_value(beta_leader),
                                  8 * vrf_ref.OUTPUT_LEN,
                                  pool.sigma, cfg.f):
            raise ProtocolError(
                f"TPraos: leader VRF value above stake threshold at slot "
                f"{header.slot} (sigma={pool.sigma})")
        period = self.kes_period_of(header.slot)
        evolutions = period - ocert.kes_period_start
        if not 0 <= evolutions < min(cfg.max_kes_evolutions,
                                     kes_mod.total_periods(cfg.kes_depth)):
            raise ProtocolError(
                f"TPraos: KES period {period} outside OCert window "
                f"[{ocert.kes_period_start}, +{cfg.max_kes_evolutions})")
        if ocert.counter < ticked.counter_of(pid):
            raise ProtocolError(
                f"TPraos: OCert issue number {ocert.counter} regressed "
                f"below {ticked.counter_of(pid)}")
        # OCERT rule bounds the new issue number: m <= n <= m+1, where a
        # pool with no recorded counter defaults to m=0 (so n in {0, 1})
        current = max(ticked.counter_of(pid), 0)
        if ocert.counter > current + 1:
            raise ProtocolError(
                f"TPraos: OCert issue number {ocert.counter} jumps past "
                f"{current} + 1")

    def extract_proofs(self, ticked: TPraosState, header,
                       ledger_view: TPraosLedgerView) -> list:
        cfg = self.config
        try:
            issuer_vk, ocert, pi_eta, pi_leader, kes_sig = \
                self._decode_header(header)
        except ProtocolError:
            return []
        pool = ledger_view.get(pool_id_of(issuer_vk))
        if pool is None:
            return []
        period = self.kes_period_of(header.slot)
        c = header._cache
        kes_msg = c.get("tp_kes_msg")
        if kes_msg is None:
            kes_msg = c["tp_kes_msg"] = header.bytes_dropping(KES_FIELD)
        ocert_body = c.get("tp_ocert_body")
        if ocert_body is None:
            ocert_body = c["tp_ocert_body"] = ocert.body_bytes()
        return [
            VrfReq(vk=pool.vrf_vk,
                   alpha=_vrf_alpha(b"eta", header.slot, ticked.eta0),
                   proof=pi_eta),
            VrfReq(vk=pool.vrf_vk,
                   alpha=_vrf_alpha(b"leader", header.slot, ticked.eta0),
                   proof=pi_leader),
            Ed25519Req(vk=issuer_vk, msg=ocert_body, sig=ocert.sigma),
            KesReq(depth=cfg.kes_depth, vk=ocert.kes_vk,
                   period=period - ocert.kes_period_start,
                   msg=kes_msg, sig_bytes=kes_sig),
        ]

    def vrf_proofs_of(self, headers) -> list:
        proofs = []
        for h in headers:
            for field_name in (ETA_VRF_FIELD, LEADER_VRF_FIELD):
                pi = h.get(field_name)
                if pi is not None:
                    proofs.append(pi)
        return proofs

    def reupdate_chain_dep_state(self, ticked: TPraosState, header,
                                 ledger_view) -> TPraosState:
        """Nonce evolution (UPDN) + lab tracking + ocert counter
        bookkeeping — the cheap sequential pass."""
        issuer_vk, ocert, pi_eta, _, _ = self._decode_header(header)
        block_nonce = _b2b(self._betas.get(pi_eta))
        eta_v = _b2b(ticked.eta_v + block_nonce)
        eta_c = eta_v if header.slot < self._freeze_slot(ticked.epoch) \
            else ticked.eta_c
        return _fast_replace(ticked, eta_v=eta_v, eta_c=eta_c,
                             eta_ph=_b2b(b"lab:" + header.hash)).with_counter(
            pool_id_of(issuer_vk), ocert.counter)

    # -- leadership ----------------------------------------------------------
    def check_is_leader(self, can_be_leader: TPraosCanBeLeader, slot: int,
                        ticked: TPraosState,
                        ledger_view: TPraosLedgerView
                        ) -> Optional[TPraosIsLeader]:
        """checkIsLeader (Protocol.hs:366-415): evaluate both VRFs, compare
        the leader output to the stake threshold."""
        pool = ledger_view.get(can_be_leader.pool_id)
        if pool is None:
            return None
        pi_leader = vrf_ref.prove(
            can_be_leader.vrf_sk, _vrf_alpha(b"leader", slot, ticked.eta0))
        beta = vrf_ref.proof_to_hash(pi_leader)
        from .nonintegral import check_leader_value
        if not check_leader_value(_leader_value(beta),
                                  8 * vrf_ref.OUTPUT_LEN,
                                  pool.sigma, self.config.f):
            return None
        pi_eta = vrf_ref.prove(
            can_be_leader.vrf_sk, _vrf_alpha(b"eta", slot, ticked.eta0))
        return TPraosIsLeader(eta_proof=pi_eta, leader_proof=pi_leader)

    # -- chain ordering ------------------------------------------------------
    def select_view(self, header) -> TPraosSelectView:
        issuer_vk, ocert, _, pi_leader, _ = self._decode_header(header)
        return TPraosSelectView(
            block_no=header.block_no, slot=header.slot, issuer_vk=issuer_vk,
            issue_no=ocert.counter,
            leader_vrf=_leader_value(self._betas.get(pi_leader)))

    def prefer_candidate(self, ours: TPraosSelectView,
                         candidate: TPraosSelectView) -> bool:
        """Protocol.hs:281-310: longer chain; tie on length -> same issuer
        decides by issue number (doppelganger defence), different issuers
        by lower leader-VRF value."""
        if candidate.block_no != ours.block_no:
            return candidate.block_no > ours.block_no
        if candidate.issuer_vk == ours.issuer_vk \
                and candidate.issue_no != ours.issue_no:
            return candidate.issue_no > ours.issue_no
        return candidate.leader_vrf < ours.leader_vrf


def forge_tpraos_fields(protocol: TPraos, hot_key: HotKey,
                        can_be_leader: TPraosCanBeLeader,
                        is_leader: TPraosIsLeader, header):
    """Attach the TPraos evidence and KES-sign the header (the forging half
    of Protocol.hs:355-453 + HotKey.hs signing)."""
    h = header.with_fields(**{
        ISSUER_FIELD: can_be_leader.cold_vk,
        OCERT_FIELD: can_be_leader.ocert.to_bytes(),
        ETA_VRF_FIELD: is_leader.eta_proof,
        LEADER_VRF_FIELD: is_leader.leader_proof,
    })
    period = protocol.kes_period_of(header.slot) \
        - can_be_leader.ocert.kes_period_start
    sig = hot_key.sign_at(period, h.bytes_dropping(KES_FIELD))
    return h.with_fields(**{KES_FIELD: sig})


# ---------------------------------------------------------------------------
# The Shelley ledger: UTxO + stake pools + delegation
# ---------------------------------------------------------------------------

# certificates carried in tx bodies (CBOR-friendly tuples):
#   ("pool",  cold_vk, vrf_vk)  — register/update a stake pool
#   ("deleg", addr, pool_id)    — delegate addr's stake to a pool
#   ("retire", cold_vk, epoch8) — schedule the pool's retirement at the
#                                 named epoch (POOLREAP; epoch as 8 bytes BE)
CERT_POOL = "pool"
CERT_DELEG = "deleg"
CERT_RETIRE = "retire"


@dataclass(frozen=True)
class ShelleyTx:
    """Tx = inputs + outputs + certificates, Ed25519-witnessed over txid.

    One tx type serves the whole Shelley family, feature-gated per era
    (the reference's era-indexed tx types over shared machinery):
    - validity: () or (invalid_before, invalid_after) slots, -1 = unbounded
      — Allegra+ (timelock validity intervals)
    - mint: ((asset_id, qty), ...), qty<0 burns — Mary+ (multi-asset);
      outputs are (addr, amount[, assets]) with assets ((asset_id, qty),...)
    - withdrawals: ((pool_id, amount), ...) — claim a reward balance into
      the tx's spendable value (must match the balance exactly, as in the
      reference's WDRL rule; witnessed by the pool's cold key)
    """
    inputs: tuple                      # TxIn-like (txid, ix) pairs
    outputs: tuple                     # (addr, amount, assets) triples
    certs: tuple = ()
    witnesses: tuple = ()              # (vk, sig) pairs
    validity: tuple = ()
    mint: tuple = ()
    withdrawals: tuple = ()            # ((pool_id, amount), ...)

    _cache: dict = field(default_factory=dict, repr=False, hash=False,
                         compare=False)

    def body_encode(self):
        return [[list(i) for i in self.inputs],
                [[a, m, [list(av) for av in assets]]
                 for a, m, assets in self.outputs],
                [list(c) for c in self.certs],
                list(self.validity),
                [list(mv) for mv in self.mint],
                [list(w) for w in self.withdrawals]]

    @property
    def txid(self) -> bytes:
        c = self._cache
        if "id" not in c:
            # span-assembled body bytes from ProtocolBlock.from_bytes,
            # when present — skips re-encoding the body
            bb = c.pop("body_bytes", None)
            c["id"] = _b2b(bb if bb is not None
                           else cbor.dumps(self.body_encode()))
        return c["id"]

    def encode(self):
        return self.body_encode() + [[[vk, sig] for vk, sig in self.witnesses]]

    @classmethod
    def decode(cls, obj) -> "ShelleyTx":
        outputs = tuple((bytes(o[0]), int(o[1]),
                         tuple((bytes(a), int(q)) for a, q in o[2]))
                        for o in obj[1])
        if any(m < 0 for _a, m, _assets in outputs):
            raise ValueError("negative output amount")
        return cls(
            tuple((bytes(t), int(i)) for t, i in obj[0]),
            outputs,
            tuple((str(c[0]), bytes(c[1]), bytes(c[2])) for c in obj[2]),
            tuple((bytes(vk), bytes(sig)) for vk, sig in obj[6]),
            tuple(int(v) for v in obj[3]),
            tuple((bytes(a), int(q)) for a, q in obj[4]),
            tuple((bytes(p), int(q)) for p, q in obj[5]))


def _norm_output(o) -> tuple:
    """(addr, amount) or (addr, amount, assets) -> canonical triple."""
    if len(o) == 2:
        return (o[0], o[1], ())
    return (o[0], o[1], tuple(sorted(tuple(av) for av in o[2])))


def make_shelley_tx(inputs: Sequence, outputs: Sequence, certs: Sequence,
                    signing_keys: Sequence[bytes], validity: tuple = (),
                    mint: Sequence = (),
                    withdrawals: Sequence = ()) -> ShelleyTx:
    tx = ShelleyTx(tuple(tuple(i) for i in inputs),
                   tuple(_norm_output(o) for o in outputs),
                   tuple(tuple(c) for c in certs),
                   validity=tuple(validity),
                   mint=tuple(sorted(tuple(mv) for mv in mint)),
                   withdrawals=tuple(sorted(tuple(w) for w in withdrawals)))
    wits = tuple((ed25519_ref.public_key(sk), ed25519_ref.sign(sk, tx.txid))
                 for sk in signing_keys)
    return replace(tx, witnesses=wits)


@dataclass(frozen=True)
class ShelleyLedgerState:
    """UTxO + delegation map + registered pools + mark/set/go stake
    snapshots + the accounting pots (reserves/treasury/rewards) + the
    pool-retirement queue — the NEWEPOCH state surface of
    Shelley/Ledger/Ledger.hs:238-284's `applyBlock` rules."""
    utxo: Any                # UtxoMap: (txid, ix) -> (addr, amount, assets)
    delegs: tuple                      # sorted ((addr, pool_id), ...)
    pools: tuple                       # sorted ((pool_id, vrf_vk), ...)
    epoch: int
    snap_mark: tuple                   # ((pool_id, stake, vrf_vk), ...)
    snap_set: tuple                    # snapshot used for leader election
    slot: int
    tip: Point
    snap_go: tuple = ()                # snapshot rewards are computed from
    reserves: int = 0                  # undistributed coin (shrinks by rho)
    treasury: int = 0
    rewards: tuple = ()                # sorted ((pool_id, claimable), ...)
    retiring: tuple = ()               # sorted ((pool_id, epoch), ...)
    blocks_made: tuple = ()            # sorted ((pool_id, n)) this epoch

    def __post_init__(self):
        if not isinstance(self.utxo, UtxoMap):
            # decoders/tests build states from plain 5-tuple sequences
            object.__setattr__(self, "utxo",
                               UtxoMap.from_items(self.utxo))

    def utxo_dict(self) -> dict:
        return self.utxo.to_dict()

    def reward_of(self, pid: bytes) -> int:
        for p, amt in self.rewards:
            if p == pid:
                return amt
        return 0

    def state_hash(self) -> bytes:
        enc = cbor.dumps([
            [[t, i, a, m, [list(av) for av in assets]]
             for t, i, a, m, assets in self.utxo],
            [[a, p] for a, p in self.delegs],
            [[p, v] for p, v in self.pools],
            self.epoch,
            [[p, s, v] for p, s, v in self.snap_mark],
            [[p, s, v] for p, s, v in self.snap_set],
            self.slot, self.tip.encode(),
            [[p, s, v] for p, s, v in self.snap_go],
            self.reserves, self.treasury,
            [[p, a] for p, a in self.rewards],
            [[p, e] for p, e in self.retiring],
            [[p, n] for p, n in self.blocks_made]])
        return _b2b(enc)


class UtxoMap:
    """Persistent UTxO set: immutable view over a shared base dict plus an
    overlay (adds + deletes), so extending the chain by one block is
    O(inputs + outputs) instead of O(|UTxO|) — the tuple-freeze
    representation made a mainnet-scale replay quadratic.  The overlay is
    flattened into a fresh base every ~|base|/4 mutations, keeping lookup
    chains one level deep while old states (LedgerDB's k snapshots) stay
    valid because bases are never mutated in place.

    Iteration yields sorted (txid, ix, addr, amount, assets) 5-tuples —
    the exact order of the old sorted-tuple representation, so
    state_hash()es are unchanged."""

    __slots__ = ("_base", "_adds", "_dels")

    def __init__(self, base: dict, adds: dict, dels: frozenset):
        self._base = base
        self._adds = adds
        self._dels = dels

    @classmethod
    def from_dict(cls, d: dict) -> "UtxoMap":
        return cls(dict(d), {}, frozenset())

    @classmethod
    def from_items(cls, items) -> "UtxoMap":
        return cls({(t, i): (a, m, assets)
                    for t, i, a, m, assets in items}, {}, frozenset())

    def get(self, key, default=None):
        v = self._adds.get(key)
        if v is not None:
            return v
        if key in self._dels:
            return default
        return self._base.get(key, default)

    def __contains__(self, key) -> bool:
        if key in self._adds:
            return True
        return key not in self._dels and key in self._base

    def to_dict(self) -> dict:
        d = {k: v for k, v in self._base.items() if k not in self._dels}
        d.update(self._adds)
        return d

    def __iter__(self):
        return iter(sorted((t, i, a, m, assets)
                           for (t, i), (a, m, assets)
                           in self.to_dict().items()))

    def __len__(self) -> int:
        # adds that shadow a live base entry are overwrites, not new keys
        extra = sum(1 for k in self._adds
                    if k not in self._base or k in self._dels)
        return (len(self._base) + extra
                - sum(1 for k in self._dels if k in self._base))

    def __eq__(self, other) -> bool:
        if isinstance(other, UtxoMap):
            return self.to_dict() == other.to_dict()
        return NotImplemented

    __hash__ = None

    def apply(self, spent, added) -> "UtxoMap":
        """New map with `spent` keys removed and `added` (key, value)
        pairs inserted — O(delta) amortized."""
        adds = dict(self._adds)
        dels = set(self._dels)
        for k in spent:
            # ALWAYS record the delete: popping only the overlay entry
            # would resurrect a stale base entry if the same outpoint was
            # deleted, re-created, and spent again
            adds.pop(k, None)
            dels.add(k)
        for k, v in added:
            adds[k] = v
            dels.discard(k)
        if len(adds) + len(dels) > max(64, len(self._base) // 4):
            base = {k: v for k, v in self._base.items() if k not in dels}
            base.update(adds)
            return UtxoMap(base, {}, frozenset())
        return UtxoMap(self._base, adds, frozenset(dels))


def _freeze_utxo(utxo: dict) -> UtxoMap:
    return UtxoMap.from_dict(utxo)


# Shelley-family eras in order; later eras accept earlier features
SHELLEY_FAMILY = ("shelley", "allegra", "mary")


class ShelleyLedger(LedgerRules):
    """LedgerRules over ShelleyLedgerState, parameterized by era.

    era="shelley" | "allegra" | "mary" gates tx features (the reference's
    ShelleyBasedEra reuse across Allegra/Mary): validity intervals from
    Allegra, multi-asset values + minting from Mary.

    Stake distribution: at every epoch boundary the snapshots rotate
    go <- set <- mark <- live (SNAP); leader election (ledger_view) reads
    `set`, so a delegation change needs two boundaries to affect
    leadership, and rewards are computed from `go` — the full
    mark/set/go pipeline of the reference.
    """

    GENESIS_TXID = b"\x00" * 32

    def __init__(self, genesis: dict, config: TPraosConfig,
                 initial_pools: Optional[dict] = None,
                 initial_delegs: Optional[dict] = None,
                 era: str = "shelley",
                 initial_reserves: int = 1_000_000):
        """genesis: {addr: amount}; initial_pools: {pool_id: vrf_vk};
        initial_delegs: {addr: pool_id}; initial_reserves seeds the
        monetary-expansion pot the reward calculation draws from."""
        if era not in SHELLEY_FAMILY:
            raise ValueError(f"unknown Shelley-family era {era!r}")
        self.genesis = dict(genesis)
        self.config = config
        self.initial_pools = dict(initial_pools or {})
        self.initial_delegs = dict(initial_delegs or {})
        self.era = era
        self._era_ix = SHELLEY_FAMILY.index(era)
        self.initial_reserves = initial_reserves

    def with_era(self, era: str) -> "ShelleyLedger":
        """Same genesis/config under a later era's feature gates — how the
        HFC composes Allegra/Mary over the shared Shelley machinery (the
        reference's ShelleyBasedEra reuse, CanHardFork.hs:365-422)."""
        return ShelleyLedger(self.genesis, self.config, self.initial_pools,
                             self.initial_delegs, era=era,
                             initial_reserves=self.initial_reserves)

    @property
    def supports_validity(self) -> bool:
        return self._era_ix >= SHELLEY_FAMILY.index("allegra")

    @property
    def supports_multiasset(self) -> bool:
        return self._era_ix >= SHELLEY_FAMILY.index("mary")

    # -- state construction --------------------------------------------------
    def initial_state(self) -> ShelleyLedgerState:
        utxo = {(self.GENESIS_TXID, ix): (addr, amount, ())
                for ix, (addr, amount) in enumerate(
                    sorted(self.genesis.items()))}
        utxo_f = _freeze_utxo(utxo)
        delegs = tuple(sorted(self.initial_delegs.items()))
        pools = tuple(sorted(self.initial_pools.items()))
        snap = self._stake_distr(utxo_f, delegs, pools)
        return ShelleyLedgerState(utxo_f, delegs, pools, 0, snap, snap,
                                  -1, Point.genesis(), snap_go=snap,
                                  reserves=self.initial_reserves)

    @staticmethod
    def _stake_distr(utxo: "UtxoMap", delegs: tuple, pools: tuple) -> tuple:
        """Aggregate UTxO lovelace per pool through the delegation map
        (native assets carry no stake)."""
        by_addr: dict = {}
        for addr, amount, _assets in utxo.to_dict().values():
            by_addr[addr] = by_addr.get(addr, 0) + amount
        registered = dict(pools)
        by_pool: dict = {}
        for addr, pid in delegs:
            if pid in registered:
                by_pool[pid] = by_pool.get(pid, 0) + by_addr.get(addr, 0)
        return tuple(sorted((pid, stake, registered[pid])
                            for pid, stake in by_pool.items() if stake > 0))

    def tip(self, state: ShelleyLedgerState) -> Point:
        return state.tip

    # -- ticking (epoch boundary: rewards, rotation, retirement) -------------
    def _epoch_rewards(self, state: ShelleyLedgerState
                       ) -> tuple[int, int, tuple]:
        """One epoch's reward calculation (the RUPD/NEWEPOCH pulse):
        rho of the reserves becomes the pot, tau of the pot goes to the
        treasury, the rest is split over the GO snapshot's pools by stake
        share scaled by apparent performance (blocks made / expected);
        the undistributed remainder returns to the reserves.  All integer
        arithmetic — every node computes the identical result."""
        cfg = self.config
        pot = state.reserves * cfg.rho.numerator // cfg.rho.denominator
        if pot == 0:
            return state.reserves, state.treasury, state.rewards
        to_treasury = pot * cfg.tau.numerator // cfg.tau.denominator
        distributable = pot - to_treasury
        total_go = sum(s for _p, s, _v in state.snap_go)
        made = dict(state.blocks_made)
        total_blocks = sum(made.values())
        rewards = dict(state.rewards)
        paid = 0
        for pid, stake, _vrf in state.snap_go:
            if total_go == 0 or total_blocks == 0:
                break
            base = distributable * stake // total_go
            expected = max(1, total_blocks * stake // total_go)
            r = base * min(made.get(pid, 0), expected) // expected
            if r:
                rewards[pid] = rewards.get(pid, 0) + r
                paid += r
        reserves = state.reserves - to_treasury - paid
        return reserves, state.treasury + to_treasury, \
            tuple(sorted(rewards.items()))

    def tick(self, state: ShelleyLedgerState, slot: int) -> ShelleyLedgerState:
        target = slot // self.config.epoch_length
        while state.epoch < target:
            nxt = state.epoch + 1
            # 1. rewards from the (pre-rotation) GO snapshot and the
            #    blocks made in the ending epoch
            reserves, treasury, rewards = self._epoch_rewards(state)
            # 2. snapshot rotation go <- set <- mark <- live (SNAP)
            live = self._stake_distr(state.utxo, state.delegs, state.pools)
            # 3. pool retirement (POOLREAP): pools due at the new epoch
            #    leave the registry; their delegations lapse; accrued
            #    rewards stay claimable
            due = {p for p, e in state.retiring if e <= nxt}
            pools = tuple((p, v) for p, v in state.pools if p not in due)
            delegs = (tuple((a, p) for a, p in state.delegs
                            if p not in due) if due else state.delegs)
            state = replace(
                state, epoch=nxt, snap_go=state.snap_set,
                snap_set=state.snap_mark, snap_mark=live,
                pools=pools, delegs=delegs,
                retiring=tuple((p, e) for p, e in state.retiring
                               if p not in due),
                reserves=reserves, treasury=treasury, rewards=rewards,
                blocks_made=())
        return _fast_replace(state, slot=slot)

    # -- protocol support ----------------------------------------------------
    def ledger_view(self, state: ShelleyLedgerState) -> TPraosLedgerView:
        # identity-cached on the snap_set tuple: within an epoch every
        # state shares the same snapshot object, so the per-header replay
        # path reuses one view instead of rebuilding dict + totals
        cached = getattr(self, "_view_cache", None)
        if cached is not None and cached[0] is state.snap_set:
            return cached[1]
        total = sum(s for _p, s, _v in state.snap_set)
        view = TPraosLedgerView({
            pid: PoolInfo(stake, total, vrf_vk)
            for pid, stake, vrf_vk in state.snap_set})
        self._view_cache = (state.snap_set, view)
        return view

    def forecast_view(self, state: ShelleyLedgerState,
                      slot: int) -> TPraosLedgerView:
        """Ledger view at a future slot; the horizon is the stability
        window past the tip (ledgerViewForecastAt for Shelley)."""
        if slot > state.slot + self.config.stability_window:
            raise OutsideForecastRange(
                f"slot {slot} beyond horizon "
                f"{state.slot + self.config.stability_window}")
        if slot // self.config.epoch_length == state.epoch:
            # same epoch: no snapshot rotation, the view is the state's own
            return self.ledger_view(state)
        return self.ledger_view(self.tick(state, max(slot, state.slot)))

    # -- block application ---------------------------------------------------
    def _check_features(self, tx: ShelleyTx, slot: int) -> None:
        """Era gating + validity-interval check (cheap, sequential)."""
        if tx.validity:
            if not self.supports_validity:
                raise LedgerError(
                    f"validity intervals need allegra+, era is {self.era}")
            before, after = tx.validity
            if (before >= 0 and slot < before) or \
                    (after >= 0 and slot > after):
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} outside validity interval "
                    f"[{before}, {after}] at slot {slot}")
        if (tx.mint or any(assets for _a, _m, assets in tx.outputs)) \
                and not self.supports_multiasset:
            raise LedgerError(
                f"multi-asset values need mary, era is {self.era}")

    def _apply_txs(self, state: ShelleyLedgerState,
                   block) -> ShelleyLedgerState:
        utxo = state.utxo
        delegs = pools = None          # copied lazily: certs are rare
        rewards = retiring = None      # likewise
        for tx in block.body:
            self._check_features(tx, block.slot)
            if len(set(tx.inputs)) != len(tx.inputs):
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} has duplicate inputs")
            spent = 0
            consumed_assets: dict = {}
            for txid, ix in tx.inputs:
                entry = utxo.get((txid, ix))
                if entry is None:
                    raise LedgerError(
                        f"missing input {txid.hex()[:12]}#{ix}")
                _addr, amount, assets = entry
                spent += amount
                for aid, qty in assets:
                    consumed_assets[aid] = consumed_assets.get(aid, 0) + qty
            for pid, amount in tx.withdrawals:
                if rewards is None:
                    rewards = dict(state.rewards)
                bal = rewards.get(pid, 0)
                # WDRL: the claim must match the reward balance exactly
                if amount <= 0 or amount != bal:
                    raise LedgerError(
                        f"tx {tx.txid.hex()[:12]}: withdrawal {amount} != "
                        f"reward balance {bal} of {pid.hex()[:12]}")
                del rewards[pid]
                spent += amount
            for aid, qty in tx.mint:
                consumed_assets[aid] = consumed_assets.get(aid, 0) + qty
            produced = 0
            produced_assets: dict = {}
            for _addr, amount, assets in tx.outputs:
                # Coin is non-negative by construction in the reference
                if amount < 0:
                    raise LedgerError(
                        f"tx {tx.txid.hex()[:12]} has a negative output")
                produced += amount
                for aid, qty in assets:
                    if qty <= 0:
                        raise LedgerError("output asset quantity must be "
                                          "positive")
                    produced_assets[aid] = produced_assets.get(aid, 0) + qty
            if produced > spent:
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} produces {produced} > "
                    f"spends {spent}")
            consumed_assets = {a: q for a, q in consumed_assets.items()
                               if q != 0}
            if produced_assets != consumed_assets:
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]}: asset balance mismatch "
                    f"(consumed+minted != produced)")
            for kind, a, b in tx.certs:
                if pools is None:
                    delegs = dict(state.delegs)
                    pools = dict(state.pools)
                if kind == CERT_POOL:
                    pid = pool_id_of(a)
                    pools[pid] = b
                    if retiring is None:
                        retiring = dict(state.retiring)
                    # re-registration cancels a pending retirement
                    retiring.pop(pid, None)
                elif kind == CERT_DELEG:
                    if b not in pools:
                        raise LedgerError(
                            f"delegation to unregistered pool "
                            f"{b.hex()[:12]}")
                    delegs[a] = b
                elif kind == CERT_RETIRE:
                    pid = pool_id_of(a)
                    if pid not in pools:
                        raise LedgerError(
                            f"retirement of unregistered pool "
                            f"{pid.hex()[:12]}")
                    epoch = int.from_bytes(b, "big")
                    if epoch <= state.epoch:
                        raise LedgerError(
                            f"retirement epoch {epoch} not after the "
                            f"current epoch {state.epoch}")
                    if retiring is None:
                        retiring = dict(state.retiring)
                    retiring[pid] = epoch
                else:
                    raise LedgerError(f"unknown certificate kind {kind!r}")
            utxo = utxo.apply(
                tx.inputs,
                [((tx.txid, ix), (addr, amount, assets))
                 for ix, (addr, amount, assets) in enumerate(tx.outputs)])
        # block production accounting for the reward calculation (the
        # BlocksMade map); the mempool's header-less pseudo-blocks skip it
        blocks_made = state.blocks_made
        header = getattr(block, "header", None)
        issuer_vk = header.get(ISSUER_FIELD) if header is not None \
            and hasattr(header, "get") else None
        if issuer_vk is not None:
            made = dict(blocks_made)
            pid = pool_id_of(issuer_vk)
            made[pid] = made.get(pid, 0) + 1
            blocks_made = tuple(sorted(made.items()))
        return _fast_replace(
            state, utxo=utxo,
            delegs=state.delegs if delegs is None
            else tuple(sorted(delegs.items())),
            pools=state.pools if pools is None
            else tuple(sorted(pools.items())),
            rewards=state.rewards if rewards is None
            else tuple(sorted(rewards.items())),
            retiring=state.retiring if retiring is None
            else tuple(sorted(retiring.items())),
            blocks_made=blocks_made,
            tip=point_of(block))

    def check_tx_witnesses(self, state: ShelleyLedgerState,
                           tx: ShelleyTx) -> None:
        """Structural check: every spender, certificate authoriser, and
        minting policy has a witness (validity of the signatures is the
        batchable proof)."""
        utxo = state.utxo
        wit_vks = {vk for vk, _ in tx.witnesses}
        for txid, ix in tx.inputs:
            entry = utxo.get((txid, ix))
            if entry is not None and entry[0] not in wit_vks:
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} spends from "
                    f"{entry[0].hex()[:12]} without a witness")
        for kind, a, _b in tx.certs:
            if kind == CERT_POOL and a not in wit_vks:
                raise LedgerError(
                    "pool registration without the cold-key witness")
            if kind == CERT_DELEG and a not in wit_vks:
                raise LedgerError(
                    "delegation without the staking-key witness")
            if kind == CERT_RETIRE and a not in wit_vks:
                raise LedgerError(
                    "pool retirement without the cold-key witness")
        # withdrawals: the pool's cold key must witness the claim
        wit_pids = {pool_id_of(vk) for vk in wit_vks}
        for pid, _amt in tx.withdrawals:
            if pid not in wit_pids:
                raise LedgerError(
                    f"withdrawal from {pid.hex()[:12]} without the pool "
                    f"cold-key witness")
        # minting: asset_id is the key-hash of the policy key, which must
        # witness the tx (the Mary "policy script = key" base case)
        policy_hashes = {pool_id_of(vk) for vk in wit_vks}
        for aid, _qty in tx.mint:
            if aid not in policy_hashes:
                raise LedgerError(
                    f"minting asset {aid.hex()[:12]} without its policy-key "
                    f"witness")

    def sequential_checks(self, ticked: ShelleyLedgerState, block) -> None:
        for tx in block.body:
            self._check_features(tx, block.slot)
            self.check_tx_witnesses(ticked, tx)

    def extract_proofs(self, ticked: ShelleyLedgerState, block) -> list:
        """The BBODY Ed25519 witness multi-verify, batched
        (Shelley/Ledger/Ledger.hs:279-284)."""
        return [Ed25519Req(vk=vk, msg=tx.txid, sig=sig)
                for tx in block.body for vk, sig in tx.witnesses]

    def apply_block(self, ticked: ShelleyLedgerState, block,
                    backend=None) -> ShelleyLedgerState:
        from ..crypto.backend import default_backend
        backend = backend or default_backend()
        self.sequential_checks(ticked, block)
        reqs = self.extract_proofs(ticked, block)
        if reqs:
            ok = backend.verify_ed25519_batch(reqs)
            if not all(ok):
                raise LedgerError(
                    f"invalid tx witness in block at slot {block.slot}")
        return self._apply_txs(ticked, block)

    def reapply_block(self, ticked: ShelleyLedgerState,
                      block) -> ShelleyLedgerState:
        return self._apply_txs(ticked, block)

    # -- mempool support -----------------------------------------------------
    def apply_tx(self, state: ShelleyLedgerState, tx: ShelleyTx,
                 backend=None) -> ShelleyLedgerState:
        """Validate one tx against `state` without moving the chain tip
        (mempool revalidation semantics)."""
        blk = _OneTxBlock(tx, state.tip)
        self.check_tx_witnesses(state, tx)
        from ..crypto.backend import default_backend
        ok = (backend or default_backend()).verify_ed25519_batch(
            self.extract_proofs(state, blk))
        if not all(ok):
            raise LedgerError(f"tx {tx.txid.hex()[:12]}: bad witness")
        return replace(self._apply_txs(state, blk), tip=state.tip)

    def tx_proofs(self, state: ShelleyLedgerState, tx: ShelleyTx) -> list:
        """One tx's witness obligations (the batching-service admission
        seam): same requests apply_tx verifies inline."""
        return self.extract_proofs(state, _OneTxBlock(tx, state.tip))


class _OneTxBlock:
    """Body-only pseudo-block anchored at an existing tip point so
    _apply_txs can run without a real header (mempool path)."""

    def __init__(self, tx: ShelleyTx, tip: Point):
        self.body = (tx,)
        self.slot = tip.slot
        self.hash = tip.hash
        self.header = self


# ---------------------------------------------------------------------------
# Network setup helper (genesis with working leader election from slot 0)
# ---------------------------------------------------------------------------

@dataclass
class ShelleyPoolKeys:
    cold_sk: bytes
    vrf_sk: bytes
    kes_seed: bytes
    addr_sk: bytes                     # the pool owner's staking/payment key

    @property
    def cold_vk(self) -> bytes:
        return ed25519_ref.public_key(self.cold_sk)

    @property
    def pool_id(self) -> bytes:
        return pool_id_of(self.cold_vk)

    @property
    def vrf_vk(self) -> bytes:
        return vrf_ref.public_key(self.vrf_sk)


def shelley_genesis_setup(n_pools: int, config: TPraosConfig,
                          stake_per_pool: int = 1000,
                          seed: bytes = b"shelley-net"):
    """Keys + protocol + ledger for an n-pool network where every pool has
    equal stake and leader election works from slot 0.  Returns
    (protocol, ledger, [per-pool dict with keys/ocert/hot_key])."""
    pools = []
    genesis, initial_pools, initial_delegs = {}, {}, {}
    for i in range(n_pools):
        tag = seed + b":%d" % i
        keys = ShelleyPoolKeys(
            cold_sk=_b2b(b"cold:" + tag),
            vrf_sk=_b2b(b"vrf:" + tag),
            kes_seed=_b2b(b"kes:" + tag),
            addr_sk=_b2b(b"addr:" + tag))
        kes_key = kes_mod.KesSignKey(config.kes_depth, keys.kes_seed)
        ocert = make_ocert(keys.cold_sk, kes_key.verification_key,
                           counter=0, kes_period_start=0)
        addr = ed25519_ref.public_key(keys.addr_sk)
        genesis[addr] = stake_per_pool
        initial_pools[keys.pool_id] = keys.vrf_vk
        initial_delegs[addr] = keys.pool_id
        pools.append({
            "keys": keys,
            "hot_key": HotKey(kes_key),
            "ocert": ocert,
            "can_be_leader": TPraosCanBeLeader(
                cold_sk=keys.cold_sk, vrf_sk=keys.vrf_sk, ocert=ocert),
            "addr": addr,
        })
    protocol = TPraos(config)
    ledger = ShelleyLedger(genesis, config, initial_pools, initial_delegs)
    return protocol, ledger, pools
