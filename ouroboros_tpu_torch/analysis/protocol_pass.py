"""Pass 1 — protocol soundness for ProtocolSpec registries.

The static rendering of what typed-protocols proves with GADTs
(Network/TypedProtocol/Core.hs): every ProtocolSpec discovered under
ouroboros_tpu_torch.network.protocols (import walk, not a hand list) is
checked
for agency totality, transition well-formedness, reachability, and codec
coverage both ways.

Rules:
- PROTO001 agency-totality: a state named anywhere in the spec (init,
  transition source/target, declared targets of a branch callable) has no
  agency entry, or an agency entry names an unknown role.
- PROTO002 terminal-agency: a state with no outgoing transitions must have
  NOBODY agency, and a NOBODY state must have no outgoing transitions.
- PROTO003 reachability: every declared state is reachable from init_state.
- PROTO004 opaque-branch: a callable transition carries no statically
  declared `targets` (see typed.branch), so the graph can't be checked.
- PROTO005 codec-missing: a message named in `transitions` has no
  encode/decode registration in the paired codec.
- PROTO006 codec-orphan: a codec registration for a message no transition
  ever names (dead wire vocabulary).
- PROTO007 no-codec: a spec has no module codec paired by the
  SPEC/CODEC (or X_SPEC/X_CODEC) naming convention.
"""
from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, List, Optional, Tuple

from . import Finding, register, relpath
from .astutil import assignment_line, parse_file

PROTOCOLS_PACKAGE = "ouroboros_tpu_torch.network.protocols"
ROLES = ("client", "server", "nobody")


def spec_states(spec) -> set:
    """Every state the spec names anywhere."""
    states = set(spec.agency) | {spec.init_state}
    for (src, _msg), dst in spec.transitions.items():
        states.add(src)
        states.update(_dsts(dst))
    return states


def _dsts(dst) -> Tuple[str, ...]:
    """Static target states of one transition entry."""
    if callable(dst):
        return tuple(getattr(dst, "targets", ()))
    return (dst,)


def message_inventory(spec) -> set:
    """Message type names the transition relation uses — the wire
    vocabulary the codec must cover (and tests must roundtrip)."""
    return {msg for (_src, msg) in spec.transitions}


def check_spec(spec, codec, file: str, line: int, symbol: str
               ) -> List[Finding]:
    """Pure soundness check for one (spec, codec) pair; codec may be None.
    Usable directly on synthetic specs (the seeded-violation tests)."""
    f: List[Finding] = []

    def add(rule, message):
        f.append(Finding(file=file, line=line, rule=rule, symbol=symbol,
                         message=f"{spec.name}: {message}"))

    states = spec_states(spec)
    nobody = "nobody"

    # PROTO001 agency totality
    for st in sorted(states):
        if st not in spec.agency:
            add("PROTO001", f"state {st!r} has no agency entry")
    for st, role in sorted(spec.agency.items()):
        if role not in ROLES:
            add("PROTO001", f"state {st!r} has unknown agency {role!r}")

    outgoing: Dict[str, list] = {st: [] for st in states}
    for (src, msg), dst in spec.transitions.items():
        outgoing.setdefault(src, []).append((msg, dst))

    # PROTO002 terminal states <-> NOBODY agency
    for st in sorted(states):
        has_out = bool(outgoing.get(st))
        role = spec.agency.get(st)
        if not has_out and role is not None and role != nobody:
            add("PROTO002", f"terminal state {st!r} has agency {role!r}, "
                            f"expected 'nobody'")
        if has_out and role == nobody:
            add("PROTO002", f"state {st!r} has NOBODY agency but "
                            f"{len(outgoing[st])} outgoing transition(s)")

    # PROTO004 opaque branch callables
    for (src, msg), dst in sorted(spec.transitions.items(),
                                  key=lambda kv: (kv[0][0], kv[0][1])):
        if callable(dst) and not getattr(dst, "targets", ()):
            add("PROTO004", f"transition ({src!r}, {msg!r}) is a callable "
                            f"with no declared targets (use typed.branch)")

    # PROTO003 reachability from init_state
    seen = {spec.init_state}
    frontier = [spec.init_state]
    while frontier:
        st = frontier.pop()
        for _msg, dst in outgoing.get(st, ()):
            for nxt in _dsts(dst):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
    for st in sorted(states - seen):
        add("PROTO003", f"state {st!r} unreachable from init state "
                        f"{spec.init_state!r}")

    # PROTO005/006/007 codec coverage both ways
    if codec is None:
        add("PROTO007", "no codec paired with this spec "
                        "(SPEC/CODEC naming convention)")
    else:
        registered = {cls.__name__ for cls in codec.by_tag.values()}
        inventory = message_inventory(spec)
        for msg in sorted(inventory - registered):
            add("PROTO005", f"message {msg!r} used in transitions has no "
                            f"codec registration")
        for msg in sorted(registered - inventory):
            add("PROTO006", f"codec registers {msg!r} but no transition "
                            f"names it")
    return f


def discover(package: str = PROTOCOLS_PACKAGE
             ) -> List[Tuple[object, Optional[object], str, int, str]]:
    """Import-walk the protocols package; yield
    (spec, codec, repo-relative file, line, symbol) per ProtocolSpec."""
    from ouroboros_tpu_torch.network.protocols.codec import Codec
    from ouroboros_tpu_torch.network.typed import ProtocolSpec

    pkg = importlib.import_module(package)
    found = []
    seen_ids = set()
    for info in sorted(pkgutil.iter_modules(pkg.__path__),
                       key=lambda i: i.name):
        mod = importlib.import_module(f"{package}.{info.name}")
        tree = None
        for attr, val in sorted(vars(mod).items()):
            if not isinstance(val, ProtocolSpec) or id(val) in seen_ids:
                continue
            seen_ids.add(id(val))
            codec_attr = ("CODEC" if attr == "SPEC"
                          else attr[:-5] + "_CODEC"
                          if attr.endswith("_SPEC") else None)
            codec = getattr(mod, codec_attr, None) if codec_attr else None
            if codec is not None and not isinstance(codec, Codec):
                codec = None
            if tree is None:
                tree = parse_file(mod.__file__)
            found.append((val, codec, relpath(mod.__file__),
                          assignment_line(tree, attr),
                          f"{info.name}.{attr}"))
    return found


@register("protocol")
def run() -> List[Finding]:
    findings: List[Finding] = []
    for spec, codec, file, line, symbol in discover():
        findings.extend(check_spec(spec, codec, file, line, symbol))
    return findings
