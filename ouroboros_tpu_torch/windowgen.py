"""Shelley-shaped validation windows made from a seed, for `validate`.

Each block carries the proofs a Shelley header and body bring to the
crypto seam (SURVEY.md §3.3, `bench.py`'s TXS = 2):

- two VRF proofs by the slot leader's pool key (nonce and leader value);
- one OCert Ed25519 signature by the pool's cold key over its KES key;
- one Sum6 KES signature over the header body (depth 6, as on mainnet);
- two transaction witnesses by fresh payment keys.

Pools are reused across windows at the same KES period, so the first
window is KES-cold and later ones are KES-warm, with fresh witness keys
in every window.  Everything is pure Python (the port's CPU references),
deterministic in the seed, and can be spread over a process pool: a
worker makes every block of one pool.  Importing this module imports no
torch, so workers start quickly.  `signatures`, `proofs` and
`kes_signatures` make the standalone batch APIs' and the field
microbenchmark's data (one key, many inputs) the same way.
"""
from __future__ import annotations

import hashlib
import multiprocessing

from .crypto import ed25519_ref, kes, vrf_ref
from .crypto.backend import Ed25519Req, KesReq, VrfReq

KES_DEPTH = 6
KES_PERIOD = 0
TXS = 2
REQS_PER_BLOCK = 2 + 1 + 1 + TXS
# positions in a block's request list: the leader-value VRF proof, the
# KES signature and the first transaction witness
LEADER_VRF = 1
KES_SIG = 3
FIRST_WITNESS = 4


def _h(seed: int, *parts) -> bytes:
    m = hashlib.sha256(b"ouroboros-window-gen")
    m.update(seed.to_bytes(8, "little"))
    for p in parts:
        m.update(p if isinstance(p, bytes) else str(p).encode())
        m.update(b"|")
    return m.digest()


def pool_blocks(seed: int, pool: int, blocks: list[int]) -> list:
    """[(global block index, request list)] for every block `pool` makes."""
    cold_sk = _h(seed, "cold", pool)
    vrf_sk = _h(seed, "vrf", pool)
    cold_vk = ed25519_ref.public_key(cold_sk)
    vrf_vk = vrf_ref.public_key(vrf_sk)
    kes_sk = kes.KesSignKey(KES_DEPTH, _h(seed, "kes", pool))
    kes_vk = kes_sk.verification_key
    ocert = kes_vk + (0).to_bytes(8, "big") + KES_PERIOD.to_bytes(8, "big")
    ocert_sig = ed25519_ref.sign(cold_sk, ocert)
    nonce = _h(seed, "epoch-nonce")
    out = []
    for g in blocks:
        slot = g.to_bytes(8, "big")
        body = b"header-body" + slot + _h(seed, "body", g)
        reqs = [VrfReq(vrf_vk, b"nonce" + slot + nonce,
                       vrf_ref.prove(vrf_sk, b"nonce" + slot + nonce)),
                VrfReq(vrf_vk, b"leader" + slot + nonce,
                       vrf_ref.prove(vrf_sk, b"leader" + slot + nonce)),
                Ed25519Req(cold_vk, ocert, ocert_sig),
                KesReq(KES_DEPTH, kes_vk, KES_PERIOD, body,
                       kes_sk.sign(body).to_bytes())]
        for t in range(TXS):
            wsk = _h(seed, "witness", g, t)
            tx = _h(seed, "tx", g, t)
            reqs.append(Ed25519Req(ed25519_ref.public_key(wsk), tx,
                                   ed25519_ref.sign(wsk, tx)))
        out.append((g, reqs))
    return out


def _pool_job(args):
    return pool_blocks(*args)


def _map(fn, jobs: list, workers: int) -> list:
    """[fn(job) for job in jobs], over `workers` spawned processes when
    there is more than one."""
    if workers > 1 and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(jobs))) as pool:
            return pool.map(fn, jobs, chunksize=1)
    return [fn(j) for j in jobs]


def make_windows(seed: int, n_windows: int, window: int, pools: int,
                 workers: int = 1) -> list:
    """n_windows lists of `window` blocks, each block its request list;
    block g (counted over all windows) is made by pool g mod pools."""
    total = n_windows * window
    jobs = [(seed, p, list(range(p, total, pools)))
            for p in range(min(pools, total))]
    parts = _map(_pool_job, jobs, workers)
    blocks: list = [None] * total
    for part in parts:
        for g, reqs in part:
            blocks[g] = reqs
    return [blocks[w * window:(w + 1) * window] for w in range(n_windows)]


def _replace(block: list, pos: int, req) -> list:
    return block[:pos] + [req] + block[pos + 1:]


def tamper_witness(block: list) -> list:
    """The block with one byte of its first witness signature flipped."""
    r = block[FIRST_WITNESS]
    sig = r.sig[:40] + bytes([r.sig[40] ^ 1]) + r.sig[41:]
    return _replace(block, FIRST_WITNESS, Ed25519Req(r.vk, r.msg, sig))


def tamper_vrf_alpha(block: list) -> list:
    """The block with its leader VRF proof held against another input: the
    proof decodes, and only its challenge check fails."""
    r = block[LEADER_VRF]
    return _replace(block, LEADER_VRF, VrfReq(r.vk, r.alpha + b"!", r.proof))


def tamper_kes_node(block: list) -> list:
    """The block with one byte of its KES signature's top Merkle node
    flipped: the path is well formed, and its top Blake2b check fails."""
    r = block[KES_SIG]
    sig = r.sig_bytes[:-1] + bytes([r.sig_bytes[-1] ^ 1])
    return _replace(block, KES_SIG,
                    KesReq(r.depth, r.vk, r.period, r.msg, sig))


# -- one key, many inputs (the standalone batch APIs' probe data) ------------

def _sign_job(args):
    sk, msgs = args
    return [ed25519_ref.sign(sk, m) for m in msgs]


def _prove_job(args):
    sk, alphas = args
    return [vrf_ref.prove(sk, a) for a in alphas]


def _kes_sign_job(args):
    seed, msgs = args
    sk = kes.KesSignKey(KES_DEPTH, seed)
    return [sk.sign(m).to_bytes() for m in msgs]


# items per worker job at least, so that a small batch (the CPU tests')
# signs in this process instead of paying for spawned workers' start-up
_MIN_CHUNK = 128


def _chunked(fn, sk: bytes, items: list, workers: int) -> list:
    step = max(_MIN_CHUNK, -(-len(items) // max(workers, 1)))
    parts = _map(fn, [(sk, items[i:i + step])
                      for i in range(0, len(items), step)], workers)
    return [x for part in parts for x in part]


def signatures(sk: bytes, msgs: list, workers: int = 1) -> list:
    """Ed25519 signatures of every message by one key."""
    return _chunked(_sign_job, sk, msgs, workers)


def proofs(sk: bytes, alphas: list, workers: int = 1) -> list:
    """ECVRF proofs of every input by one key."""
    return _chunked(_prove_job, sk, alphas, workers)


def kes_signatures(seed: bytes, msgs: list, workers: int = 1) -> list:
    """Sum6 KES signature bytes of every message by the key of `seed`, at
    period 0 (each worker derives the key again)."""
    return _chunked(_kes_sign_job, seed, msgs, workers)
