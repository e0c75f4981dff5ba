"""The port's wire grammar (`ouroboros_tpu_torch.network.cddl`, the
reference's messages.cddl as validator combinators): the cases of
tests/test_cddl_conformance.py on the port's grammar and codecs, over
tests/test_golden_wire.py's sample corpus built from the port's classes;
and the port's grammar against the JAX package's on numpy-seeded CBOR
values of every covered protocol, valid and mutated (a tag changed, an
element dropped or added, an array turned into a map, a leaf's type
changed, the tag-24 wrapping removed): the same values accepted, the
same rejected.

Reference: ouroboros-network/test-cddl/Main.hs, test/messages.cddl.

Tolerance: none.  Verdicts compare exactly.
"""
import hashlib
import importlib

import numpy as np
import pytest

from ouroboros_tpu_torch.chain.block import Point, Tip
from ouroboros_tpu_torch.network import cddl
from ouroboros_tpu_torch.network.protocols import (
    blockfetch as bf, chainsync as cs, handshake as hs,
    localtxsubmission as lts, txsubmission as txs,
)
from ouroboros_tpu_torch.utils import cbor


# -- tests/test_golden_wire.py's corpus of the covered protocols --------------

H = lambda tag: hashlib.blake2b(tag, digest_size=32).digest()
P1 = Point(slot=7, hash=H(b"p1"))
P2 = Point(slot=9, hash=H(b"p2"))
TIP = Tip(P2, 4)


def _corpus():
    from ouroboros_tpu_torch.consensus.headers import ProtocolBlock, make_header
    hdr = make_header(None, 7, (), issuer=1).with_fields(demo=b"\x01\x02")
    return {
        "chainsync": [
            cs.MsgRequestNext(), cs.MsgAwaitReply(),
            cs.MsgRollForward(hdr, TIP), cs.MsgRollBackward(P1, TIP),
            cs.MsgFindIntersect((P1, P2)), cs.MsgIntersectFound(P1, TIP),
            cs.MsgIntersectNotFound(TIP), cs.MsgDone()],
        "blockfetch": [
            bf.MsgRequestRange(P1, P2), bf.MsgClientDone(),
            bf.MsgStartBatch(), bf.MsgNoBlocks(),
            bf.MsgBlock(ProtocolBlock(make_header(None, 1, (), issuer=0),
                                      ())),
            bf.MsgBatchDone()],
        "txsubmission": [
            txs.MsgRequestTxIds(True, 2, 5),
            txs.MsgReplyTxIds(((H(b"tx1"), 123), (H(b"tx2"), 456))),
            txs.MsgRequestTxs((H(b"tx1"),)),
            txs.MsgReplyTxs((b"\x01\x02\x03",)), txs.MsgDone()],
        "handshake": [
            hs.MsgProposeVersions(((7, b"\x0a"), (8, b"\x0b"))),
            hs.MsgAcceptVersion(8, b"\x0b"),
            hs.MsgRefuse(hs.RefuseVersionMismatch((7, 8)))],
        "localtxsubmission": [
            lts.MsgSubmitTx(b"\x01\x02"), lts.MsgAcceptTx(),
            lts.MsgRejectTx("bad witness"), lts.MsgDone()],
    }


_CODECS = {"chainsync": cs.CODEC, "blockfetch": bf.CODEC,
           "txsubmission": txs.CODEC, "handshake": hs.CODEC,
           "localtxsubmission": lts.CODEC}


# -- tests/test_cddl_conformance.py ------------------------------------------

# our leaf instantiations (see module docstring)
G = cddl.grammar(
    header_hash=cddl.bstr,
    tx_id=cddl.bstr,
    transaction=cddl.bstr,
    reject_reason=cddl.tstr,
)

# protocols covered by messages.cddl (allMessages, messages.cddl:4-10);
# the others (keepalive, LSQ, tipsample, txmonitor) have no CDDL in this
# snapshot of the reference — they are pinned by the golden corpus only
RULES = {
    "chainsync": G["chainsync"](cddl.any_),
    "blockfetch": G["blockfetch"](cddl.any_),
    "txsubmission": G["txsubmission"],
    "handshake": G["handshake"],
    "localtxsubmission": G["localtxsubmission"],
}


def _messages(name):
    return [(m, _CODECS[name].encode(m)) for m in _corpus()[name]]


@pytest.mark.parametrize("proto", sorted(RULES))
def test_corpus_matches_reference_grammar(proto):
    rule = RULES[proto]
    for msg, raw in _messages(proto):
        obj = cbor.loads(raw)
        try:
            rule.check(obj)
        except cddl.Mismatch as e:
            pytest.fail(f"{proto} {type(msg).__name__}: {e}")


def test_mismatches_are_caught():
    """The validator is not a rubber stamp: wrong tag, wrong arity, map
    where the grammar wants an array, missing tag-24 all fail."""
    cs = RULES["chainsync"]
    assert not cs.matches([99])                     # unknown tag
    assert not cs.matches([0, 1])                   # wrong arity
    assert not cs.matches([2, b"hdr", [[], 0]])     # header not tag-24
    hs = RULES["handshake"]
    assert not hs.matches([0, [[1, None]]])         # table must be a map
    assert not hs.matches([2, ["huh"]])             # unstructured reason
    tx = RULES["txsubmission"]
    assert not tx.matches([0, 1, 2, 3])             # blocking must be bool


def test_points_and_tips_reference_shape():
    """origin = [], point = [slot, hash], tip = [point, uint]
    (messages.cddl:36,152-155)."""
    assert Point.genesis().encode() == []
    assert Point.decode([]) == Point.genesis()
    p = Point(7, b"\x01" * 32)
    assert G["point"].matches(p.encode())
    assert G["point"].matches(Point.genesis().encode())
    assert G["tip"].matches(Tip(p, 3).encode())
    assert G["tip"].matches(Tip.genesis().encode())
    assert Tip.decode(Tip.genesis().encode()) == Tip.genesis()
    assert Tip.decode(Tip(p, 3).encode()) == Tip(p, 3)


def test_ts_id_list_indefinite_framing():
    """messages.cddl:78: 'The codec only accepts infinite-length list
    encoding for tsIdList!' — byte-level check of the 0x9f framing."""
    raw = _CODECS["txsubmission"].encode(
        txs.MsgRequestTxs((b"\x01" * 32, b"\x02" * 32)))
    # [2, tsIdList] -> 0x82 0x02 0x9f ... 0xff
    assert raw[:3] == b"\x82\x02\x9f" and raw[-1:] == b"\xff"
    raw2 = _CODECS["txsubmission"].encode(txs.MsgReplyTxs((b"\x05\x06",)))
    assert raw2[:3] == b"\x82\x03\x9f" and raw2[-1:] == b"\xff"


def test_handshake_version_table_is_ascending_map():
    raw = _CODECS["handshake"].encode(
        hs.MsgProposeVersions(((8, b"\x0b"), (7, b"\x0a"))))
    obj = cbor.loads(raw)
    assert isinstance(obj[1], dict) and list(obj[1]) == [7, 8]


# -- the port's grammar against the JAX package's -----------------------------

_COVERED = ("chainsync", "blockfetch", "txsubmission", "handshake",
            "localtxsubmission")


def _rules(pkg: str) -> dict:
    g = importlib.import_module(f"{pkg}.network.cddl")
    gr = g.grammar(header_hash=g.bstr, tx_id=g.bstr, transaction=g.bstr,
                   reject_reason=g.tstr)
    return {"chainsync": gr["chainsync"](g.any_),
            "blockfetch": gr["blockfetch"](g.any_),
            "txsubmission": gr["txsubmission"],
            "handshake": gr["handshake"],
            "localtxsubmission": gr["localtxsubmission"],
            "point": gr["point"], "tip": gr["tip"]}


def _seeded_wire(seed: int) -> dict:
    """Encoded messages of the covered protocols with numpy-seeded fields
    (tests/test_torch_network.py's corpus, which both packages encode to
    the same bytes, and seeded LocalTxSubmission messages)."""
    from test_torch_network import _seeded_corpus
    msgs = _seeded_corpus("ouroboros_tpu_torch", seed)
    rng = np.random.default_rng(seed + 100)
    out = {n: [_CODECS[n].encode(m) for m in msgs[n]]
           for n in _COVERED if n in msgs}
    out["localtxsubmission"] = [_CODECS["localtxsubmission"].encode(m) for m in (
        lts.MsgSubmitTx(rng.integers(0, 256, int(rng.integers(1, 300)),
                                     dtype=np.uint8).tobytes()),
        lts.MsgAcceptTx(),
        lts.MsgRejectTx("".join(chr(97 + int(c))
                                for c in rng.integers(0, 26, 12))),
        lts.MsgDone())]
    return out


def _leaf_paths(obj, path=()):
    """Paths of the leaves (non-container values) of a decoded value."""
    if isinstance(obj, list):
        for i, x in enumerate(obj):
            yield from _leaf_paths(x, path + (i,))
    elif isinstance(obj, dict):
        for k in obj:
            yield from _leaf_paths(obj[k], path + (k,))
    else:
        yield path


def _mutants(obj, cb, rng) -> list:
    """The value itself and mutated copies, the mutation picked by `rng`
    alone, so both packages mutate alike: the tag changed, the last
    element dropped, an element added, the array made a map, one leaf
    given another type, the tag-24 wrapping removed (or a bstr wrapped)."""
    def copy(o):
        if isinstance(o, list):
            return [copy(x) for x in o]
        if isinstance(o, dict):
            return {k: copy(v) for k, v in o.items()}
        if isinstance(o, cb.Tag):
            return cb.Tag(o.tag, copy(o.value))
        return o

    def at(o, path):
        for p in path[:-1]:
            o = o[p]
        return o

    out = [copy(obj)]
    m = copy(obj)
    m[0] = int(rng.integers(0, 10))
    out.append(m)
    out.append(copy(obj)[:-1])
    out.append(copy(obj) + [int(rng.integers(0, 5))])
    out.append({i: x for i, x in enumerate(copy(obj))})
    paths = list(_leaf_paths(obj))
    if paths:
        path = paths[int(rng.integers(0, len(paths)))]
        m = copy(obj)
        leaf = at(m, path)[path[-1]] if path else m
        swap = (b"x" if isinstance(leaf, (int, str)) and
                not isinstance(leaf, bool) else
                "x" if isinstance(leaf, bytes) else 7)
        if path:
            at(m, path)[path[-1]] = swap
            out.append(m)
    m = copy(obj)
    for i, x in enumerate(m):
        if isinstance(x, cb.Tag):
            m[i] = x.value
            break
        if isinstance(x, bytes):
            m[i] = cb.Tag(24, x)
            break
    out.append(m)
    return out


def _verdicts(pkg: str, seed: int) -> dict:
    cb = importlib.import_module(f"{pkg}.utils.cbor")
    rules = _rules(pkg)
    rng = np.random.default_rng(seed)
    return {name: [[rules[name].matches(m)
                    for m in _mutants(cb.loads(raw), cb, rng)]
                   for raw in wires]
            for name, wires in _seeded_wire(seed).items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grammar_verdicts_equal_the_jax_packages(seed):
    port = _verdicts("ouroboros_tpu_torch", seed)
    ref = _verdicts("ouroboros_tpu", seed)
    assert port == ref
    for name, groups in port.items():
        # every unmutated message matches; mutations are caught
        assert all(g[0] for g in groups), name
        assert all(len(g) >= 6 for g in groups), name
        assert not all(x for g in groups for x in g[1:]), name


@pytest.mark.parametrize("seed", [0, 1])
def test_points_and_tips_verdicts_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    values = [[], [int(rng.integers(0, 2 ** 32)),
                   rng.integers(0, 256, 32, dtype=np.uint8).tobytes()]]
    values += [[v, int(rng.integers(0, 2 ** 20))] for v in list(values)]
    values += [[1], [b"x", b"y"], [[], -1], {0: 1}, "point", [[1, 2], 3]]
    for kind in ("point", "tip"):
        port = [_rules("ouroboros_tpu_torch")[kind].matches(v)
                for v in values]
        ref = [_rules("ouroboros_tpu")[kind].matches(v) for v in values]
        assert port == ref and any(port) and not all(port)
