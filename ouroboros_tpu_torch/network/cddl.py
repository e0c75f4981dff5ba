"""The reference's wire grammar (messages.cddl) as executable schema rules.

The reference pins its codecs against a published CDDL spec
(`ouroboros-network/test-cddl/Main.hs` generating messages and checking
them with the `cddl` tool against `ouroboros-network/test/messages.cddl`,
itself checked against docs/network-spec/miniprotocols.tex).  This module
is a rule-for-rule port of that grammar into small validator combinators,
so our golden corpus can be checked against the REFERENCE grammar rather
than a self-hash.

Every rule name below mirrors the CDDL rule it ports, with the
messages.cddl line cited.  The grammar's polymorphic leaves (headerHash,
block, transaction, rejectReason — messages.cddl:137-158 "the codecs are
polymorphic in the underlying data types"; the CDDL pins the *test*
instantiation, e.g. `transaction = int`) are parameterised here so our
instantiation (32-byte hashes, CBOR tx bodies) validates through the same
structural skeleton.  Structural rules — message tags, arities, tag-24
wrapping, map-vs-array — are checked exactly.

Ported from `ouroboros_tpu/network/cddl.py` (the port imports nothing of the
JAX package). Copied whole.
"""
from __future__ import annotations

from ..utils import cbor


class Mismatch(Exception):
    """Value does not match the grammar rule."""


# -- combinators -------------------------------------------------------------

class Rule:
    name = "?"

    def check(self, obj) -> None:
        raise NotImplementedError

    def matches(self, obj) -> bool:
        try:
            self.check(obj)
            return True
        except Mismatch:
            return False

    def __truediv__(self, other) -> "Alt":
        return Alt(self, other)


class _Pred(Rule):
    def __init__(self, name, fn):
        self.name, self._fn = name, fn

    def check(self, obj):
        if not self._fn(obj):
            raise Mismatch(f"{obj!r} is not {self.name}")


uint = _Pred("uint", lambda o: isinstance(o, int) and not isinstance(o, bool)
             and o >= 0)
int_ = _Pred("int", lambda o: isinstance(o, int) and not isinstance(o, bool))
tstr = _Pred("tstr", lambda o: isinstance(o, str))
bstr = _Pred("bstr", lambda o: isinstance(o, bytes))
bool_ = _Pred("bool", lambda o: isinstance(o, bool))
any_ = _Pred("any", lambda o: True)
word16 = uint    # messages.cddl:159-161: word16/32/64 = uint
word32 = uint
word64 = uint


class Lit(Rule):
    def __init__(self, value):
        self.value = value
        self.name = repr(value)

    def check(self, obj):
        if obj != self.value or isinstance(obj, bool) != isinstance(
                self.value, bool):
            raise Mismatch(f"expected literal {self.value!r}, got {obj!r}")


class Arr(Rule):
    """Fixed-shape array; a trailing Star rule matches zero-or-more."""

    def __init__(self, *rules, name="array"):
        self.rules = rules
        self.name = name

    def check(self, obj):
        if not isinstance(obj, list):
            raise Mismatch(f"{self.name}: expected array, got "
                           f"{type(obj).__name__}")
        rules = list(self.rules)
        star = rules.pop() if rules and isinstance(rules[-1], Star) else None
        if star is None and len(obj) != len(rules):
            raise Mismatch(f"{self.name}: expected {len(rules)} elements, "
                           f"got {len(obj)}")
        if star is not None and len(obj) < len(rules):
            raise Mismatch(f"{self.name}: expected >= {len(rules)} "
                           f"elements, got {len(obj)}")
        for r, item in zip(rules, obj):
            r.check(item)
        if star is not None:
            for item in obj[len(rules):]:
                star.rule.check(item)


class Star(Rule):
    """`*rule` inside an Arr."""

    def __init__(self, rule):
        self.rule = rule
        self.name = f"*{rule.name}"

    def check(self, obj):     # only meaningful inside Arr
        self.rule.check(obj)


class Alt(Rule):
    def __init__(self, *rules, name=None):
        flat = []
        for r in rules:
            flat.extend(r.rules if isinstance(r, Alt) else [r])
        self.rules = flat
        self.name = name or " / ".join(r.name for r in flat)

    def check(self, obj):
        errs = []
        for r in self.rules:
            try:
                return r.check(obj)
            except Mismatch as e:
                errs.append(str(e))
        raise Mismatch(f"no alternative of ({self.name}) matched "
                       f"{obj!r}: {errs}")


class Tag24Cbor(Rule):
    """#6.24(bytes .cbor inner) — CBOR-in-CBOR (messages.cddl:34,55)."""

    def __init__(self, inner: Rule):
        self.inner = inner
        self.name = f"#6.24(bytes .cbor {inner.name})"

    def check(self, obj):
        if not isinstance(obj, cbor.Tag) or obj.tag != 24:
            raise Mismatch(f"expected tag 24, got {obj!r}")
        if not isinstance(obj.value, bytes):
            raise Mismatch("tag 24 payload must be bytes")
        self.inner.check(cbor.loads(obj.value))


class VersionTable(Rule):
    """versionTable: CBOR map, unique keys in ascending order
    (messages.cddl:104-115)."""

    def __init__(self, key_rule: Rule, value_rule: Rule):
        self.key_rule, self.value_rule = key_rule, value_rule
        self.name = "versionTable"

    def check(self, obj):
        if not isinstance(obj, dict):
            raise Mismatch(f"versionTable must be a map, got "
                           f"{type(obj).__name__}")
        keys = list(obj)
        if keys != sorted(keys):
            raise Mismatch("versionTable keys must be ascending")
        for k, v in obj.items():
            self.key_rule.check(k)
            self.value_rule.check(v)


def named(name: str, rule: Rule) -> Rule:
    rule.name = name
    return rule


# -- the grammar, rule for rule (messages.cddl) ------------------------------

def grammar(header_hash: Rule = int_, block_body: Rule = any_,
            tx_id: Rule = int_, transaction: Rule = int_,
            reject_reason: Rule = int_, version_number: Rule = uint,
            params: Rule = any_):
    """Build the messages.cddl rule set.  Defaults are the CDDL's own test
    instantiation; pass our leaves to validate this repo's dialect through
    the same structure."""
    g = {}
    # messages.cddl:152-155
    origin = named("origin", Arr(name="origin"))
    block_header_hash = named("blockHeaderHash",
                              Arr(word64, header_hash,
                                  name="blockHeaderHash"))
    point = named("point", origin / block_header_hash)
    g["point"] = point
    g["points"] = named("points", Arr(Star(point), name="points"))
    tip = named("tip", Arr(point, uint, name="tip"))
    g["tip"] = tip
    # blockHeader (messages.cddl:142) — test instantiation; ours differs,
    # callers pass their own rule through wrapped_header
    g["blockHeader"] = named(
        "blockHeader", Arr(int_, Arr(Star(int_)), word64, word64, int_,
                           name="blockHeader"))
    g["block"] = named("block", Arr(g["blockHeader"], block_body,
                                    name="block"))

    # ChainSync (messages.cddl:16-33)
    def chainsync(wrapped_header: Rule):
        return named("chainSyncMessage", Alt(
            Arr(Lit(0), name="msgRequestNext"),
            Arr(Lit(1), name="msgAwaitReply"),
            Arr(Lit(2), Tag24Cbor(wrapped_header), tip,
                name="msgRollForward"),
            Arr(Lit(3), point, tip, name="msgRollBackward"),
            Arr(Lit(4), g["points"], name="msgFindIntersect"),
            Arr(Lit(5), point, tip, name="msgIntersectFound"),
            Arr(Lit(6), tip, name="msgIntersectNotFound"),
            Arr(Lit(7), name="chainSyncMsgDone")))
    g["chainsync"] = chainsync

    # BlockFetch (messages.cddl:42-56)
    def blockfetch(block_rule: Rule):
        return named("blockFetchMessage", Alt(
            Arr(Lit(0), point, point, name="msgRequestRange"),
            Arr(Lit(1), name="msgClientDone"),
            Arr(Lit(2), name="msgStartBatch"),
            Arr(Lit(3), name="msgNoBlocks"),
            Arr(Lit(4), Tag24Cbor(block_rule), name="msgBlock"),
            Arr(Lit(5), name="msgBatchDone")))
    g["blockfetch"] = blockfetch

    # TxSubmission (messages.cddl:62-82)
    tx_id_and_size = named("txIdAndSize", Arr(tx_id, word32,
                                              name="txIdAndSize"))
    ts_id_list = named("tsIdList", Arr(Star(tx_id), name="tsIdList"))
    ts_tx_list = named("tsTxList", Arr(Star(transaction), name="tsTxList"))
    g["txsubmission"] = named("txSubmissionMessage", Alt(
        Arr(Lit(0), bool_, word16, word16, name="msgRequestTxIds"),
        Arr(Lit(1), Arr(Star(tx_id_and_size)), name="msgReplyTxIds"),
        Arr(Lit(2), ts_id_list, name="msgRequestTxs"),
        Arr(Lit(3), ts_tx_list, name="msgReplyTxs"),
        Arr(Lit(4), name="tsMsgDone"),
        Arr(Lit(5), name="msgReplyKTnxBye")))

    # Handshake (messages.cddl:88-123)
    refuse_reason = named("refuseReason", Alt(
        Arr(Lit(0), Arr(Star(version_number)),
            name="refuseReasonVersionMismatch"),
        Arr(Lit(1), version_number, tstr,
            name="refuseReasonHandshakeDecodeError"),
        Arr(Lit(2), version_number, tstr, name="refuseReasonRefused")))
    g["handshake"] = named("handshakeMessage", Alt(
        Arr(Lit(0), VersionTable(version_number, params),
            name="msgProposeVersions"),
        Arr(Lit(1), version_number, any_, name="msgAcceptVersion"),
        Arr(Lit(2), refuse_reason, name="msgRefuse")))

    # LocalTxSubmission (messages.cddl:126-135)
    g["localtxsubmission"] = named("localTxSubmissionMessage", Alt(
        Arr(Lit(0), transaction, name="msgSubmitTx"),
        Arr(Lit(1), name="msgAcceptTx"),
        Arr(Lit(2), reject_reason, name="msgRejectTx"),
        Arr(Lit(3), name="ltMsgDone")))
    return g
