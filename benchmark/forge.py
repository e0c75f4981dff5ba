"""Forge a cell's chain from the seed: the benchmark's data.

A chain of `chainBlocks` blocks from genesis, all in the first epoch and
the first KES period, in the byte format of reference/chain.py:

- `stakePools` pools of equal stake, each checking leadership slot by
  slot with its VRF key (pools in turn; the first leader forges);
- `txsPerBlock` transactions a block, each one input, one output and one
  witness, the whole amount moved on (no fee); who witnesses them is the
  traffic's `witness_keys`: "owners" (the pool owners' keys in turn, each
  spending its own latest output back to itself, as db-synthesizer
  does), "fresh" (transaction t witnessed by key t, spending what
  transaction t - 1 paid to it and paying key t + 1), or a number n of
  hot keys taken in turn, each with an output of its own at genesis;
- the header signed at its KES period by the pool's Sum KES key, with an
  operational certificate of issue number 0.

Besides the chain, `variants`: tampered forms of blocks at positions
drawn from the seed, one for each kind in TAMPER, each the same block
with one check made to fail, re-signed wherever the tampered bytes are
signed over, so that only that check fails.  The later blocks of its
window are re-chained onto it (their headers re-signed over the new
previous hash), so a replay checks the whole window as it would a valid
one and has to stop at the tampered block; one that missed the fault
stops at the next window's first block, whose previous hash no longer
matches.  The positions cover every window of the chain and both
halves of each (`positions`), so that a replay that leaves out part of
a window's requests, or a whole window, misses a tampered lane.

The seed draws the keys, the amounts, the leader schedule and the
tampered positions and lanes; the work of a block (transactions,
witnesses, proofs) is the configuration's whatever the seed.  Signing is RFC 8032,
deterministic, so `cryptography`'s Ed25519 (where it is installed) and
reference/ed25519.py give the same bytes; the VRF prover is the
reference's.  Work is spread over worker processes; a chain is kept in
`.cache/chains/` inside the benchmark's folder, keyed by configuration,
traffic and seed, and read back by later runs of the same seed.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import random
import time
from fractions import Fraction

from reference import cbor, chain, kes
from reference import ed25519 as ref_ed
from reference import vrf
from reference.ledger import Genesis, is_leader

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".cache", "chains")
FORMAT = 3
SLOTS_PER_TASK = 128
KEYS_PER_TASK = 2048
# the checks made to fail, one tampered form each, in this order
TAMPER = ("witness", "vrf_leader", "kes", "witness", "ocert", "vrf_eta")


def _fast_ed25519():
    """(public_key, sign) through OpenSSL when `cryptography` is there."""
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey)
    except ImportError:
        return ref_ed.public_key, ref_ed.sign

    def public_key(sk: bytes) -> bytes:
        return Ed25519PrivateKey.from_private_bytes(sk) \
            .public_key().public_bytes_raw()

    def sign(sk: bytes, msg: bytes) -> bytes:
        return Ed25519PrivateKey.from_private_bytes(sk).sign(msg)
    return public_key, sign


PUBLIC_KEY, SIGN = _fast_ed25519()


def _h(seed: int, *tags) -> bytes:
    data = b"|".join([b"ouroboros-bench", str(seed).encode()]
                     + [str(t).encode() for t in tags])
    return hashlib.blake2b(data, digest_size=32).digest()


def _amount(seed: int, tag: str) -> int:
    return (1 << 40) + int.from_bytes(_h(seed, tag), "big") % (1 << 40)


# -- worker tasks (module level, so that spawned workers can run them) -------

def _public_keys(sks: list) -> list:
    return [PUBLIC_KEY(sk) for sk in sks]


def _signatures(pairs: list) -> list:
    return [SIGN(sk, msg) for sk, msg in pairs]


def _leaders(task: tuple) -> list:
    """(slot, pool index, eta proof, leader proof) of each slot in
    [lo, hi) that a pool leads, the pools asked in turn."""
    lo, hi, eta0, pools, f = task
    out = []
    for slot in range(lo, hi):
        for ix, (vrf_sk, sigma) in enumerate(pools):
            pi_leader = vrf.prove(vrf_sk, chain.vrf_alpha(b"leader", slot,
                                                          eta0))
            if is_leader(vrf.proof_to_hash(pi_leader), sigma, f):
                out.append((slot, ix, vrf.prove(
                    vrf_sk, chain.vrf_alpha(b"eta", slot, eta0)), pi_leader))
                break
    return out


def _chunks(items: list, n: int) -> list:
    return [items[i:i + n] for i in range(0, len(items), n)]


class _Workers:
    """A spawn pool, or the calling process when one worker is asked."""

    def __init__(self, n: int):
        self.pool = (multiprocessing.get_context("spawn").Pool(n)
                     if n > 1 else None)

    def map(self, fn, tasks: list) -> list:
        if self.pool is None:
            return [fn(t) for t in tasks]
        return self.pool.map(fn, tasks)

    def imap(self, fn, tasks):
        if self.pool is None:
            return map(fn, tasks)
        return self.pool.imap(fn, tasks)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
            self.pool.join()


def _flat_map(workers, fn, items: list, per_task: int) -> list:
    return [y for part in workers.map(fn, _chunks(items, per_task))
            for y in part]


# -- the chain ------------------------------------------------------------

def genesis_of(config: dict, traffic: dict, seed: int) -> tuple:
    """(Genesis, pool secrets [(cold_sk, vrf_sk, kes_seed)], the wallet's
    secret keys: the owners', the first fresh key, or the hot keys)."""
    n_pools = config["stakePools"]
    pools = [(_h(seed, "cold", i), _h(seed, "vrf", i), _h(seed, "kes", i))
             for i in range(n_pools)]
    owners = [_h(seed, "owner", i) for i in range(n_pools)]
    stake = _amount(seed, "stake")
    utxo = {PUBLIC_KEY(sk): stake for sk in owners}
    delegs = {PUBLIC_KEY(sk): chain.pool_id(ref_ed.public_key(cold))
              for sk, (cold, _v, _k) in zip(owners, pools)}
    mode = traffic["witness_keys"]
    if mode == "owners":
        wallet = owners
    elif mode == "fresh":
        wallet = [_h(seed, "wallet", 0)]
        utxo[PUBLIC_KEY(wallet[0])] = _amount(seed, "wallet")
    else:
        wallet = [_h(seed, "hot", i) for i in range(int(mode))]
        for i, sk in enumerate(wallet):
            utxo[PUBLIC_KEY(sk)] = _amount(seed, f"hot{i}")
    g = Genesis(
        seed=_h(seed, "genesis"),
        f=Fraction(config["activeSlotsCoeff"]).limit_denominator(1000),
        k=config["securityParam"], epoch_length=config["epochLength"],
        slots_per_kes_period=config["slotsPerKESPeriod"],
        kes_depth=config["kesDepth"],
        max_kes_evolutions=config["maxKESEvolutions"],
        pools=tuple((ref_ed.public_key(c), vrf.public_key(v))
                    for c, v, _k in pools),
        utxo=tuple(sorted(utxo.items())), delegs=tuple(sorted(
            delegs.items())))
    return g, pools, wallet


def _transactions(config, traffic, seed, g: Genesis, wallet, workers):
    """The chain's transactions in order, as (body, witness sk, its vk)."""
    n = config["chainBlocks"] * config["txsPerBlock"]
    amounts = dict(g.utxo)
    gen_ix = {addr: ix for ix, (addr, _m) in enumerate(g.utxo)}
    mode = traffic["witness_keys"]
    if mode == "fresh":
        sks = [wallet[0]] + [_h(seed, "wallet", t) for t in range(1, n + 1)]
        vks = [PUBLIC_KEY(wallet[0])] + _flat_map(
            workers, _public_keys, sks[1:], KEYS_PER_TASK)
        amount = amounts[vks[0]]
        prev = (chain.GENESIS_TXID, gen_ix[vks[0]])
        out = []
        for t in range(n):
            body = chain.tx_body([prev], [(vks[t + 1], amount)])
            prev = (chain.txid_of(body), 0)
            out.append((body, sks[t], vks[t]))
        return out
    vks = [PUBLIC_KEY(sk) for sk in wallet]
    latest = [(chain.GENESIS_TXID, gen_ix[vk]) for vk in vks]
    out = []
    for t in range(n):
        j = t % len(wallet)
        body = chain.tx_body([latest[j]], [(vks[j], amounts[vks[j]])])
        latest[j] = (chain.txid_of(body), 0)
        out.append((body, wallet[j], vks[j]))
    return out


def _flip(raw: bytes, seed: int, tag: str, lo: int, hi: int) -> bytes:
    """raw with one bit flipped in a byte of [lo, hi) drawn from seed."""
    h = _h(seed, "tamper", tag)
    at = lo + h[0] % (hi - lo)
    return raw[:at] + bytes([raw[at] ^ (1 << (h[1] % 8))]) + raw[at + 1:]


def positions(seed: int, n_blocks: int, window: int, count: int) -> list:
    """The block of each of `count` tampered forms.  The seed orders the
    windows and draws the offsets; the first forms take every window
    once, in halves that alternate, the next ones every window's other
    half, and so on round."""
    rng = random.Random(f"tamper-positions:{seed}")
    n_windows = -(-n_blocks // window)
    order = rng.sample(range(n_windows), n_windows)
    first = rng.randrange(2)
    out = []
    for n in range(count):
        w = order[n % n_windows]
        half = (first + n % n_windows + n // n_windows) % 2
        lo = w * window
        size = min(window, n_blocks - lo)
        mid = lo + size // 2
        a, b = ((lo, max(mid, lo + 1)) if half == 0
                else (min(mid, lo + size - 1), lo + size))
        out.append(rng.randrange(a, b))
    return out


class _Forger:
    def __init__(self, g: Genesis, pools: list, depth: int):
        self.g = g
        self.pools = pools
        self.depth = depth
        self.ocerts = []
        for cold, _v, kes_seed in pools:
            kes_vk = kes.vk_of(depth, kes_seed)
            sigma = SIGN(cold, chain.ocert_body(kes_vk, 0, 0))
            self.ocerts.append(cbor.encode([kes_vk, 0, 0, sigma]))

    def block(self, lead: tuple, block_no: int, prev_hash: bytes,
              txs: list, **tamper) -> tuple:
        """(bytes, header hash) of one block; the keyword arguments put
        tampered fields in place of the forged ones (`header`)."""
        header = self.header(lead, block_no, prev_hash, txs, **tamper)
        return (chain.block_bytes(header, txs),
                kes.b2b256(cbor.encode(header)))

    def header(self, lead: tuple, block_no: int, prev_hash: bytes,
               txs: list, ocert: bytes = None, eta: bytes = None,
               leader: bytes = None, kes_flip=None) -> list:
        slot, ix, pi_eta, pi_leader = lead
        fields = {chain.ETA: eta or pi_eta,
                  chain.LEADER: leader or pi_leader,
                  chain.ISSUER: self.g.pools[ix][0],
                  chain.OCERT: ocert or self.ocerts[ix]}
        body_hash = kes.b2b256(cbor.encode(txs))
        msg = cbor.encode(chain.header_list(slot, block_no, prev_hash,
                                            body_hash, fields))
        fields[chain.KES] = kes.sign(
            self.depth, self.pools[ix][2],
            slot // self.g.slots_per_kes_period, msg, leaf_sign=SIGN)
        if kes_flip is not None:
            fields[chain.KES] = kes_flip(fields[chain.KES])
        return chain.header_list(slot, block_no, prev_hash, body_hash,
                                 fields)


def with_header(raw: bytes, header: bytes) -> bytes:
    """Block bytes `raw` with its header replaced by `header` (CBOR)."""
    _n, h0 = cbor.array_head(raw, 0)
    _old, b0 = cbor.decode(raw, h0)
    return raw[:h0] + header + raw[b0:]


def _tampered_form(task: tuple) -> tuple:
    """(the tampered block's bytes, the header bytes of each later block
    of its window, re-chained onto it)."""
    g, pools, depth, kind, n, seed, i, (lead, prev, txs), rest = task
    forger = _Forger(g, pools, depth)
    raw, prev = _variant(forger, kind, n, seed, lead, i, prev, txs)
    headers = []
    for j, (lead_j, txs_j) in enumerate(rest, i + 1):
        enc = cbor.encode(forger.header(lead_j, j, prev, txs_j))
        headers.append(enc)
        prev = kes.b2b256(enc)
    return raw, headers


def _variant(forger: _Forger, kind: str, n: int, seed: int, lead,
             block_no: int, prev_hash: bytes, txs: list) -> tuple:
    tag = f"{kind}{n}"
    args = {}
    if kind == "witness":
        t = _h(seed, "tamper-tx", n)[0] % len(txs)
        vk, sig = txs[t][6][0]
        txs = list(txs)
        txs[t] = txs[t][:6] + [[[vk, _flip(sig, seed, tag, 32, 60)]]]
    elif kind == "kes":
        args["kes_flip"] = lambda s: _flip(s, seed, tag, 32, 60)
    elif kind == "ocert":
        kes_vk, counter, start, sigma = cbor.decode(forger.ocerts[lead[1]])[0]
        args["ocert"] = cbor.encode([kes_vk, counter, start,
                                     _flip(sigma, seed, tag, 32, 60)])
    elif kind in ("vrf_eta", "vrf_leader"):
        pi = lead[2] if kind == "vrf_eta" else lead[3]
        args["eta" if kind == "vrf_eta" else "leader"] = _flip(
            pi, seed, tag, 48, 76)
    else:
        raise ValueError(f"unknown tamper kind {kind!r}")
    return forger.block(lead, block_no, prev_hash, txs, **args)


def forge(config: dict, traffic: dict, seed: int, workers: int) -> dict:
    """{"genesis", "blocks": [bytes], "variants": [(kind, block index,
    tampered bytes, [re-chained header bytes])]}: the tampered block
    replaces the chain's block there, and the headers those after it, to
    the end of its window (`with_header`)."""
    g, pools, wallet = genesis_of(config, traffic, seed)
    n_blocks, window = config["chainBlocks"], config["window"]
    run = _Workers(workers)
    try:
        txs = _transactions(config, traffic, seed, g, wallet, run)
        sigs = _flat_map(run, _signatures,
                         [(sk, chain.txid_of(body)) for body, sk, _vk in txs],
                         KEYS_PER_TASK)
        stake = g.stake()
        eta0 = kes.b2b256(b"eta0:" + g.seed)
        pool_args = [(vrf_sk, stake[chain.pool_id(g.pools[i][0])][1])
                     for i, (_c, vrf_sk, _k) in enumerate(pools)]
        leads: list = []
        lo = 0
        while len(leads) < n_blocks:
            span = max(SLOTS_PER_TASK, int((n_blocks - len(leads))
                                           / float(g.f) * 1.1))
            tasks = [(s, min(s + SLOTS_PER_TASK, lo + span), eta0,
                      pool_args, g.f)
                     for s in range(lo, lo + span, SLOTS_PER_TASK)]
            for part in run.imap(_leaders, tasks):
                leads.extend(part)
            lo += span
        leads = leads[:n_blocks]
        if leads[-1][0] >= min(g.epoch_length, g.slots_per_kes_period):
            raise ValueError("the chain leaves the first epoch or KES "
                             "period: lengthen them or shorten the chain")
        forger = _Forger(g, pools, config["kesDepth"])
        per = config["txsPerBlock"]
        at = positions(seed, n_blocks, window, len(TAMPER))
        ends = [min(n_blocks, (i // window + 1) * window) for i in at]
        wanted = {j for i, e in zip(at, ends) for j in range(i, e)}
        kept = {}
        blocks = []
        prev = chain.GENESIS_HASH
        for i, lead in enumerate(leads):
            body = [b + [[[vk, sig]]] for (b, _sk, vk), sig
                    in zip(txs[i * per:(i + 1) * per],
                           sigs[i * per:(i + 1) * per])]
            if i in wanted:
                kept[i] = (lead, prev, body)
            raw, prev = forger.block(lead, i, prev, body)
            blocks.append(raw)
        forms = run.map(_tampered_form, [
            (g, pools, config["kesDepth"], kind, n, seed, i, kept[i],
             [kept[j][::2] for j in range(i + 1, e)])
            for n, (kind, i, e) in enumerate(zip(TAMPER, at, ends))])
    finally:
        run.close()
    variants = [(kind, i, raw, headers)
                for kind, i, (raw, headers) in zip(TAMPER, at, forms)]
    return {"genesis": g, "blocks": blocks, "variants": variants}


# -- the cache --------------------------------------------------------------

def _key(config: dict, traffic: dict, seed: int) -> str:
    text = json.dumps([FORMAT, config, traffic], sort_keys=True)
    digest = hashlib.blake2b(text.encode(), digest_size=8).hexdigest()
    return f"{config['name']}.{traffic['name']}.{seed}.{digest}.cbor"


def _encode_genesis(g: Genesis) -> list:
    return [g.seed, g.f.numerator, g.f.denominator, g.k, g.epoch_length,
            g.slots_per_kes_period, g.kes_depth, g.max_kes_evolutions,
            [list(p) for p in g.pools], [list(u) for u in g.utxo],
            [list(d) for d in g.delegs]]


def _decode_genesis(obj: list) -> Genesis:
    (seed, num, den, k, epoch, spkp, depth, max_evo, pools, utxo,
     delegs) = obj
    return Genesis(seed, Fraction(num, den), k, epoch, spkp, depth, max_evo,
                   tuple(tuple(p) for p in pools),
                   tuple(tuple(u) for u in utxo),
                   tuple(tuple(d) for d in delegs))


def load_or_forge(config: dict, traffic: dict, seed: int,
                  workers: int) -> tuple:
    """(chain dict, seconds, whether it was read from the cache)."""
    t0 = time.perf_counter()
    path = os.path.join(CACHE_DIR, _key(config, traffic, seed))
    if os.path.exists(path):
        with open(path, "rb") as fh:
            g, blocks, variants = cbor.decode(fh.read())[0]
        return ({"genesis": _decode_genesis(g), "blocks": blocks,
                 "variants": [tuple(v) for v in variants]},
                time.perf_counter() - t0, True)
    out = forge(config, traffic, seed, workers)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.partial"
    with open(tmp, "wb") as fh:
        fh.write(cbor.encode([_encode_genesis(out["genesis"]), out["blocks"],
                              [list(v) for v in out["variants"]]]))
    os.replace(tmp, path)
    return out, time.perf_counter() - t0, False
