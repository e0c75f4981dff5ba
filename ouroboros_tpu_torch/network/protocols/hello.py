"""Hello — protocol transformer reversing initial agency.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/Trans/Hello/
Type.hs (StHello / StTalk embedding) and Codec.hs:75-134 (flat encoding:
MsgHello gets its own tag, MsgTalk is invisible on the wire).

The wrapped protocol gains one extra initial state in which the CLIENT must
send MsgHello; afterwards the inner protocol runs unchanged.  This is how
TxSubmission2 fixes TxSubmission's inverted initial agency: the outbound
side announces itself before the inbound side starts asking for tx ids.

Ported from `ouroboros_tpu/network/protocols/hello.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..typed import CLIENT, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgHello:
    TAG = None  # assigned per instantiation via make_hello_msg

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


def make_hello_msg(tag: int):
    """A MsgHello class carrying the instantiation-specific wire tag
    (codecHello's helloTag argument, Trans/Hello/Codec.hs:88)."""
    return type("MsgHello", (MsgHello,), {"TAG": tag})


def wrap(spec: ProtocolSpec, codec: Codec, hello_tag: int,
         name: str | None = None):
    """Hello-transform a protocol: returns (spec', codec', MsgHello class).

    spec': initial state "Hello" with client agency; MsgHello moves to the
    inner protocol's initial state; all inner states/transitions unchanged
    (the StTalk embedding is the identity on state names).
    codec': flat — inner messages keep their tags, MsgHello adds hello_tag.
    """
    hello_cls = make_hello_msg(hello_tag)
    spec2 = ProtocolSpec(
        name=name or f"hello-{spec.name}",
        init_state="Hello",
        agency={"Hello": CLIENT, **spec.agency},
        transitions={("Hello", "MsgHello"): spec.init_state,
                     **spec.transitions})
    codec2 = Codec(list(codec.by_tag.values()) + [hello_cls])
    return spec2, codec2, hello_cls
