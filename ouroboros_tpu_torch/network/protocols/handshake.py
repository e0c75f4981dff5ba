"""Handshake — version negotiation, the first protocol on every connection.

Reference: ouroboros-network-framework/src/Ouroboros/Network/Protocol/
Handshake/Type.hs:43-126 (StPropose/StConfirm; propose map -> accept or
refuse) and Version.hs:19-86 (Versions map, acceptableVersion policy).

Ported from `ouroboros_tpu/network/protocols/handshake.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgProposeVersions:
    TAG = 0
    versions: tuple   # ((version_number, params_cbor), ...) ascending

    def encode_args(self):
        # versionTable is a CBOR MAP with unique ascending keys
        # (messages.cddl:108-115; Handshake/Codec.hs)
        nums = [v for v, _p in self.versions]
        if len(set(nums)) != len(nums):
            raise ValueError("duplicate version numbers in proposal")
        return [{v: p for v, p in sorted(self.versions)}]

    @classmethod
    def decode_args(cls, a):
        # the CBOR layer already rejects duplicate keys; enforce the
        # CDDL's ascending-order requirement here (the reference codec
        # rejects misordered version tables too)
        keys = [int(v) for v in a[0].keys()]
        if keys != sorted(keys):
            raise ValueError("version table keys not ascending")
        return cls(tuple((int(v), p) for v, p in a[0].items()))


@dataclass(frozen=True)
class MsgAcceptVersion:
    TAG = 1
    version: int
    params: Any

    def encode_args(self):
        return [self.version, self.params]

    @classmethod
    def decode_args(cls, a):
        return cls(int(a[0]), a[1])


# refuseReason variants (messages.cddl:117-123)

@dataclass(frozen=True)
class RefuseVersionMismatch:
    """[0, [*versionNumber]] — no common version; carries ours."""
    TAG = 0
    versions: tuple = ()

    def encode(self):
        return [0, list(self.versions)]


@dataclass(frozen=True)
class RefuseHandshakeDecodeError:
    """[1, versionNumber, tstr]."""
    TAG = 1
    version: int = 0
    message: str = ""

    def encode(self):
        return [1, self.version, self.message]


@dataclass(frozen=True)
class RefuseRefused:
    """[2, versionNumber, tstr] — version acceptable but params refused."""
    TAG = 2
    version: int = 0
    message: str = ""

    def encode(self):
        return [2, self.version, self.message]


def _decode_reason(obj):
    tag = int(obj[0])
    if tag == 0:
        return RefuseVersionMismatch(tuple(int(v) for v in obj[1]))
    if tag == 1:
        return RefuseHandshakeDecodeError(int(obj[1]), str(obj[2]))
    if tag == 2:
        return RefuseRefused(int(obj[1]), str(obj[2]))
    raise ValueError(f"unknown refuse reason tag {tag}")


@dataclass(frozen=True)
class MsgRefuse:
    TAG = 2
    reason: Any       # one of the Refuse* dataclasses

    def encode_args(self):
        return [self.reason.encode()]

    @classmethod
    def decode_args(cls, a):
        return cls(_decode_reason(a[0]))


SPEC = ProtocolSpec(
    name="handshake",
    init_state="StPropose",
    agency={"StPropose": CLIENT, "StConfirm": SERVER, "StDone": NOBODY},
    transitions={
        ("StPropose", "MsgProposeVersions"): "StConfirm",
        ("StConfirm", "MsgAcceptVersion"): "StDone",
        ("StConfirm", "MsgRefuse"): "StDone",
    })

CODEC = Codec([MsgProposeVersions, MsgAcceptVersion, MsgRefuse])


class Versions:
    """Map of version number -> (params, application); mirrors Version.hs."""

    def __init__(self):
        self._vs: dict[int, tuple] = {}

    def add(self, number: int, params, application=None) -> "Versions":
        self._vs[number] = (params, application)
        return self

    def numbers(self):
        return sorted(self._vs)

    def get(self, number: int):
        return self._vs.get(number)


def accept_highest_common(local: Versions, proposed) -> Optional[int]:
    """Default acceptableVersion policy: highest common version number."""
    proposed_numbers = {v for v, _ in proposed}
    common = [v for v in local.numbers() if v in proposed_numbers]
    return common[-1] if common else None


async def client_propose(session, versions: Versions):
    """Returns ("accepted", version, params) or ("refused", reason)."""
    await session.send(MsgProposeVersions(
        tuple((v, versions.get(v)[0]) for v in versions.numbers())))
    reply = await session.recv()
    if isinstance(reply, MsgRefuse):
        return ("refused", reply.reason)
    return ("accepted", reply.version, reply.params)


async def server_accept(session, versions: Versions,
                        policy: Callable = accept_highest_common):
    msg = await session.recv()
    chosen = policy(versions, msg.versions)
    if chosen is None:
        reason = RefuseVersionMismatch(tuple(versions.numbers()))
        await session.send(MsgRefuse(reason))
        return ("refused", reason)
    params, _app = versions.get(chosen)
    await session.send(MsgAcceptVersion(chosen, params))
    return ("accepted", chosen, dict(msg.versions).get(chosen))
