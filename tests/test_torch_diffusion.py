"""The port's diffusion layer (`ouroboros_tpu_torch.network.{snocket,
socket_bearer,subscription,peer_selection,error_policy}`,
`ouroboros_tpu_torch.node.diffusion`, `ouroboros_tpu_torch.simharness.faults`):
the cases of tests/test_snocket.py (all but the ping-tool case, which waits
for a port of tools/ping.py), tests/test_subscription.py,
tests/test_peer_selection.py, tests/test_diffusion.py and
tests/test_governed_diffusion.py, run against the port's copies; and, in
both packages, one FaultPlan seed and spec over a scripted write sequence,
one seed's subscription backoff windows and suspensions, the governor's
decisions over numpy-seeded views and its trace over a scripted peer
universe, and the 3-node `run_data_diffusion` composition of
tests/test_diffusion.py.

Reference: ouroboros-network's Snocket, Subscription worker, PeerSelection
governor and Diffusion tests.

Tolerance: none.  Events, windows, decisions, heights and chains compare
exactly.
"""
import importlib
import random

import numpy as np
import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.network.error_policy import (
    THROW, ErrorPolicy, SuspendDecision, default_node_policies,
    eval_error_policies, suspend_consumer, suspend_peer,
)
from ouroboros_tpu_torch.network.mux import INITIATOR, RESPONDER, Mux, SDU
from ouroboros_tpu_torch.network.peer_selection import (
    Decision, GovernorView, KnownPeers, PeerSelectionActions,
    PeerSelectionGovernor, PeerSelectionTargets, governor_decisions,
    ledger_peer_sample,
)
from ouroboros_tpu_torch.network.snocket import (
    AcceptLimits, ConnectionTable, SimSnocket, SnocketError, TcpSnocket,
    UnixSnocket, run_server, snocket_for,
)
from ouroboros_tpu_torch.network.subscription import (
    DictResolver, PeerState, SubscriptionFatal, SubscriptionWorker,
)
from ouroboros_tpu_torch.node.diffusion import (
    INITIATOR_ONLY, Diffusion, DiffusionArguments, SimNetwork,
    connect_local_client_via, run_data_diffusion, run_governed_diffusion,
    run_sim_diffusion,
)
from ouroboros_tpu_torch.simharness import io_run
from ouroboros_tpu_torch.testing import PraosNetworkFactory, ThreadNetConfig


# -- tests/test_snocket.py ---------------------------------------------------

async def _echo_handler(bearer, remote):
    """SDU-level echo: read one SDU, send it back."""
    sdu = await bearer.read()
    await bearer.write(SDU(0, sdu.mode, sdu.num, sdu.payload))


async def _dial_echo(snocket, addr, payload=b"hello"):
    bearer = await snocket.connect(addr)
    await bearer.write(SDU(0, 0, 2, payload))
    back = await bearer.read()
    return back.payload


def test_sim_snocket_dial_serve():
    sn = SimSnocket()

    async def main():
        lst = await sn.listen("nodeA")
        sim.spawn(run_server(lst, _echo_handler), label="server")
        out = await _dial_echo(sn, "nodeA", b"ping-sim")
        # unknown address refused
        try:
            await sn.connect("nowhere")
            refused = False
        except SnocketError:
            refused = True
        return out, refused

    out, refused = sim.run(main())
    assert out == b"ping-sim" and refused


def test_connection_table_duplicate_refused():
    table = ConnectionTable()
    assert table.include("peer1")
    assert not table.include("peer1")
    assert len(table) == 1
    table.remove("peer1")
    assert table.include("peer1")


def test_accept_rate_limiting_paces_accepts():
    """Above the soft limit every accept is delayed; below it accepts are
    immediate (RateLimiting.hs)."""
    sn = SimSnocket()
    accepted = []

    async def handler(bearer, remote):
        accepted.append((sim.now(), remote))
        await sim.sleep(100.0)          # hold the table slot

    async def main():
        lst = await sn.listen("srv")
        limits = AcceptLimits(hard_limit=10, soft_limit=2, delay=5.0)
        sim.spawn(run_server(lst, handler, limits=limits), label="server")
        for i in range(4):
            await sn.connect("srv")
        await sim.sleep(30.0)
        return list(accepted)

    acc = sim.run(main())
    assert len(acc) == 4
    # first two accepts immediate, later ones paced by the 5s delay
    assert acc[1][0] - acc[0][0] < 1.0
    assert acc[3][0] - acc[2][0] >= 5.0


def test_snocket_for_dispatch():
    sn = SimSnocket()
    assert isinstance(snocket_for(("127.0.0.1", 80)), TcpSnocket)
    assert isinstance(snocket_for("/tmp/x.sock"), UnixSnocket)
    assert snocket_for("nodeB", sim_registry=sn) is sn


def test_tcp_and_unix_snocket_echo(tmp_path):
    """The SAME dial/serve code over real TCP and Unix sockets (IO
    runtime)."""
    from ouroboros_tpu_torch.simharness import io_run

    async def tcp_main():
        sn = TcpSnocket()
        lst = await sn.listen(("127.0.0.1", 0))
        sim.spawn(run_server(lst, _echo_handler), label="tcp-server")
        await sim.sleep(0.05)
        return await _dial_echo(sn, lst.addr, b"over-tcp")

    assert io_run(tcp_main()) == b"over-tcp"

    path = str(tmp_path / "node.sock")

    async def unix_main():
        sn = UnixSnocket()
        lst = await sn.listen(path)
        sim.spawn(run_server(lst, _echo_handler), label="unix-server")
        await sim.sleep(0.05)
        return await _dial_echo(sn, path, b"over-unix")

    assert io_run(unix_main()) == b"over-unix"


# -- tests/test_subscription.py ----------------------------------------------

_SAMPLES = [
    THROW,
    suspend_peer(0.0), suspend_peer(3.0), suspend_peer(7.0),
    suspend_consumer(0.0), suspend_consumer(5.0), suspend_consumer(11.0),
]


class TestSuspendDecisionSemigroup:
    def test_throw_dominates_both_sides(self):
        for d in _SAMPLES:
            assert (THROW | d).kind == "throw"
            assert (d | THROW).kind == "throw"

    def test_kind_ordering_peer_over_consumer(self):
        assert (suspend_peer(1) | suspend_consumer(9)).kind == "suspend-peer"
        assert (suspend_consumer(9) | suspend_peer(1)).kind == "suspend-peer"
        assert (suspend_consumer(1) | suspend_consumer(2)).kind \
            == "suspend-consumer"
        assert (suspend_peer(1) | suspend_peer(2)).kind == "suspend-peer"

    def test_duration_combines_by_max(self):
        assert (suspend_peer(3) | suspend_consumer(9)).duration == 9
        assert (suspend_consumer(9) | suspend_peer(3)).duration == 9
        assert (suspend_peer(7) | suspend_peer(3)).duration == 7

    def test_associative_and_commutative_on_samples(self):
        for a in _SAMPLES:
            for b in _SAMPLES:
                assert a | b == b | a
                for c in _SAMPLES:
                    assert (a | b) | c == a | (b | c)

    def test_idempotent(self):
        for d in _SAMPLES:
            combined = d | d
            assert combined.kind == d.kind
            if d.kind != "throw":
                assert combined.duration == d.duration


# ---------------------------------------------------------------------------
# reconnect-policy unit tests (drive _on_conn_end directly inside the sim)
# ---------------------------------------------------------------------------

def _worker(**kw):
    kw.setdefault("error_policies", default_node_policies())
    kw.setdefault("base_backoff", 2.0)
    return SubscriptionWorker(["a"], valency=1, dial=None, **kw)


def _in_sim(fn, seed=0):
    async def main():
        return fn()
    return sim.run(main(), seed=seed)


def test_clean_end_resets_fail_count():
    """REGRESSION: clean endings used to increment fail_count forever."""
    def body():
        w = _worker()
        st = w.states["a"]
        w._on_conn_end("a", ConnectionError("boom"))
        w._on_conn_end("a", ConnectionError("boom"))
        assert st.fail_count == 2
        w._on_conn_end("a", None)            # clean session
        assert st.fail_count == 0
        return True

    assert _in_sim(body)


def test_clean_churn_never_escalates():
    """REGRESSION: a peer that cleanly churns N times must keep paying the
    base backoff (plus jitter), never the exponential ladder."""
    def body():
        w = _worker(jitter=0.25)
        ceiling = w.base_backoff * 1.25 + 1e-9
        for _ in range(10):
            w._on_conn_end("a", None)
            window = w.states["a"].suspended_until - sim.now()
            assert w.base_backoff <= window <= ceiling, window
        return True

    assert _in_sim(body)


def test_failure_backoff_is_exponential_and_capped():
    def body():
        w = _worker(jitter=0.0)
        windows = []
        for _ in range(8):
            w._on_conn_end("a", ConnectionError("boom"))
            windows.append(w.states["a"].consumer_until - sim.now())
        # ConnectionError -> suspend_consumer(20.0); exponent is
        # min(fail_count - 1, 5), so 20*1, 20*2, ... capped at 20*32
        assert windows[0] == pytest.approx(20.0)
        assert windows[1] == pytest.approx(40.0)
        assert windows[5] == pytest.approx(20.0 * 32)
        assert windows[7] == pytest.approx(20.0 * 32)   # capped
        return True

    assert _in_sim(body)


def test_fail_count_reset_makes_next_backoff_small_again():
    def body():
        w = _worker(jitter=0.0)
        for _ in range(4):
            w._on_conn_end("a", ConnectionError("boom"))
        w._on_conn_end("a", None)
        w._on_conn_end("a", ConnectionError("boom"))
        # back to the first rung of the ladder, not 2^4
        window = w.states["a"].consumer_until - sim.now()
        assert window == pytest.approx(20.0)
        return True

    assert _in_sim(body)


def test_suspend_peer_sets_both_clocks_consumer_only_one():
    class Violation(Exception):
        pass

    policies = [
        ErrorPolicy(Violation, lambda e: suspend_peer(50.0)),
        ErrorPolicy(ConnectionError, lambda e: suspend_consumer(20.0)),
    ]

    def body():
        w = _worker(error_policies=policies, jitter=0.0)
        st = w.states["a"]
        w._on_conn_end("a", ConnectionError("transport"))
        assert st.consumer_until > sim.now()
        assert st.peer_until == 0.0
        assert not w.peer_suspended("a")
        w._on_conn_end("a", Violation("bad header"))
        assert w.peer_suspended("a")
        assert st.peer_until > sim.now()
        # the dial-side clock is the max of both windows
        assert st.suspended_until == max(st.consumer_until, st.peer_until)
        return True

    assert _in_sim(body)


def test_backoff_jitter_is_seeded_and_deterministic():
    def body():
        w1 = SubscriptionWorker(["a"], 1, None, base_backoff=2.0, seed=7)
        w2 = SubscriptionWorker(["a"], 1, None, base_backoff=2.0, seed=7)
        w3 = SubscriptionWorker(["a"], 1, None, base_backoff=2.0, seed=8)
        s1 = [w1._backoff(2.0, n) for n in range(6)]
        s2 = [w2._backoff(2.0, n) for n in range(6)]
        s3 = [w3._backoff(2.0, n) for n in range(6)]
        assert s1 == s2
        assert s1 != s3
        return True

    assert _in_sim(body)


# ---------------------------------------------------------------------------
# THROW propagation out of run() (the eval_error_policies verdict kind
# must not be ignored at this call site)
# ---------------------------------------------------------------------------

class _Poison(Exception):
    pass


def test_throw_verdict_is_fatal_not_backoff():
    policies = [
        ErrorPolicy(_Poison, lambda e: THROW),
        ErrorPolicy(Exception, lambda e: suspend_consumer(5.0)),
    ]

    def dial(addr):
        async def conn():
            await sim.sleep(1.0)
            raise _Poison("unrecoverable")
        return sim.spawn(conn(), label=f"conn-{addr}")

    w = SubscriptionWorker(["a"], valency=1, dial=dial,
                           error_policies=policies, base_backoff=1.0)

    async def main():
        await w.run()

    with pytest.raises(SubscriptionFatal) as ei:
        sim.run(main(), seed=1)
    assert isinstance(ei.value.__cause__, _Poison)


def test_non_throw_verdict_still_backs_off_and_redials():
    """The fatal path must not have broken ordinary suspension."""
    dial_log = []

    def dial(addr):
        dial_log.append(sim.now())

        async def conn():
            await sim.sleep(0.5)
            raise ConnectionError("flaky")
        return sim.spawn(conn(), label=f"conn-{addr}")

    w = SubscriptionWorker(["a"], valency=1, dial=dial,
                           error_policies=default_node_policies(),
                           base_backoff=1.0, jitter=0.0)

    async def main():
        h = sim.spawn(w.run(), label="worker")
        await sim.sleep(200.0)
        h.cancel()

    sim.run(main(), seed=1)
    assert len(dial_log) >= 3
    # gaps grow: each redial waits the (exponentially larger) window
    gaps = [b - a for a, b in zip(dial_log, dial_log[1:])]
    assert gaps[1] > gaps[0]


def test_peer_state_default_clocks():
    st = PeerState()
    assert st.suspended_until == 0.0
    assert st.fail_count == 0


# -- tests/test_peer_selection.py --------------------------------------------

class TestErrorPolicy:
    def test_semigroup(self):
        assert (suspend_consumer(5) | suspend_peer(3)).kind == "suspend-peer"
        assert (suspend_consumer(5) | suspend_peer(3)).duration == 5
        assert (THROW | suspend_peer(9)).kind == "throw"

    def test_eval_matches_type(self):
        from ouroboros_tpu_torch.node.chain_sync import ChainSyncClientError
        pol = default_node_policies()
        v = eval_error_policies(pol, ChainSyncClientError("bad header"))
        assert v is not None and v.kind == "suspend-peer"
        v2 = eval_error_policies(pol, ConnectionError("refused"))
        assert v2 is not None and v2.kind == "suspend-consumer"


class TestGovernorDecisions:
    def _view(self, known=(), established=(), active=(), known_total=None,
              targets=PeerSelectionTargets(4, 3, 2)):
        return GovernorView(
            now=0.0, targets=targets, known=tuple(known),
            known_total=len(known) if known_total is None else known_total,
            established=tuple(established), active=tuple(active))

    def test_empty_state_requests_peers(self):
        ds = governor_decisions(self._view())
        assert ds == [Decision("request-more-peers")]

    def test_promotes_toward_targets(self):
        ds = governor_decisions(self._view(known=("a", "b", "c", "d")))
        kinds = [d.kind for d in ds]
        assert kinds.count("promote-cold-to-warm") == 3

    def test_promote_warm_to_hot(self):
        ds = governor_decisions(self._view(
            known=("a", "b", "c", "d"), established=("a", "b", "c")))
        kinds = [d.kind for d in ds]
        assert kinds.count("promote-warm-to-hot") == 2

    def test_steady_state_no_decisions(self):
        ds = governor_decisions(self._view(
            known=("a", "b", "c", "d"), established=("a", "b", "c"),
            active=("a", "b")))
        assert ds == []          # no oscillation at exact targets

    def test_demotes_overshoot(self):
        ds = governor_decisions(self._view(
            known=("a", "b", "c", "d"), established=("a", "b", "c", "d"),
            active=("a", "b", "c")))
        kinds = [d.kind for d in ds]
        assert "demote-hot-to-warm" in kinds
        assert "demote-warm-to-cold" in kinds


def test_ledger_peer_sample_stake_weighted():
    rng = random.Random(0)
    stake = {"whale": 900, "small": 50, "tiny": 50}
    firsts = [ledger_peer_sample(stake, 1, random.Random(s))[0]
              for s in range(200)]
    assert firsts.count("whale") > 140          # ~90% expected
    # without replacement: sampling all returns all
    assert sorted(ledger_peer_sample(stake, 3, rng)) == \
        ["small", "tiny", "whale"]


class _ScriptedActions(PeerSelectionActions):
    """Discovery returns a fixed universe; connect fails for flaky addrs
    the first `fail_times` attempts."""

    def __init__(self, universe, flaky=(), fail_times=1):
        self.universe = list(universe)
        self.flaky = dict.fromkeys(flaky, fail_times)
        self.log = []

    async def request_peers(self):
        return self.universe

    async def connect(self, addr):
        self.log.append(("connect", addr))
        if self.flaky.get(addr, 0) > 0:
            self.flaky[addr] -= 1
            return False
        return True

    async def activate(self, addr):
        self.log.append(("activate", addr))
        return True


def test_governor_reaches_targets():
    targets = PeerSelectionTargets(6, 4, 2)
    acts = _ScriptedActions([f"p{i}" for i in range(8)])
    gov = PeerSelectionGovernor(targets, acts, seed=1)

    async def main():
        h = sim.spawn(gov.run(), label="governor")
        await sim.sleep(30.0)
        h.cancel()
        return (len(gov.known), len(gov.established), len(gov.active))

    known, est, act = sim.run(main(), seed=1)
    assert known >= targets.target_known - 2 or known == 8
    assert est == targets.target_established
    assert act == targets.target_active


def test_governor_retries_after_suspension():
    targets = PeerSelectionTargets(2, 2, 1)
    acts = _ScriptedActions(["a", "b"], flaky=("a", "b"), fail_times=1)
    gov = PeerSelectionGovernor(targets, acts, seed=2, retry_interval=2.0,
                                suspend_base=1.0)

    async def main():
        h = sim.spawn(gov.run(), label="governor")
        await sim.sleep(60.0)
        h.cancel()
        return set(gov.established)

    est = sim.run(main(), seed=2)
    # both eventually connected despite first-attempt failures
    assert est == {"a", "b"}
    # each flaky addr was attempted at least twice
    attempts = [a for op, a in acts.log if op == "connect"]
    assert attempts.count("a") >= 2 and attempts.count("b") >= 2


def test_subscription_worker_valency_and_redial():
    """Connections that die are redialled after backoff; valency held."""
    dial_log = []

    def dial(addr):
        dial_log.append((sim.now(), addr))

        async def conn():
            await sim.sleep(5.0)
            if addr == "bad":
                raise ConnectionError("link dropped")
            await sim.sleep(1e9)             # healthy: stays up
        return sim.spawn(conn(), label=f"conn-{addr}")

    w = SubscriptionWorker(["good1", "good2", "bad"], valency=3, dial=dial,
                           error_policies=default_node_policies(),
                           base_backoff=2.0)

    async def main():
        h = sim.spawn(w.run(), label="worker")
        await sim.sleep(120.0)
        h.cancel()
        return list(dial_log)

    log = sim.run(main(), seed=3)
    addrs = [a for _, a in log]
    assert addrs.count("bad") >= 2, f"bad peer not redialled: {log}"
    assert addrs.count("good1") == 1 and addrs.count("good2") == 1


def test_diffusion_joins_network_and_syncs():
    """A node wired purely through run_data_diffusion syncs the chain of
    the nodes it subscribes to."""
    cfg = ThreadNetConfig(n_nodes=3, n_slots=30, k=10, f=0.5, seed=9)
    factory = PraosNetworkFactory(cfg)

    async def main():
        snk = SimSnocket(delay=0.02)
        kernels = [factory.make_node(i) for i in range(3)]
        for i, kern in enumerate(kernels):
            kern.start()
        # nodes 0,1 forge and interconnect via diffusion; node 2 has no
        # forging rights exercised (it still forges — fine) and subscribes
        # to both
        await run_data_diffusion(kernels[0], DiffusionArguments(
            addresses=["addr0"], ip_producers=["addr1"], ip_valency=1), snk)
        await run_data_diffusion(kernels[1], DiffusionArguments(
            addresses=["addr1"], ip_producers=["addr0"], ip_valency=1), snk)
        await run_data_diffusion(kernels[2], DiffusionArguments(
            addresses=["addr2"], ip_producers=["addr0", "addr1"],
            ip_valency=2), snk)
        await sim.sleep(30.0)
        tips = [k.chain_db.tip_point() for k in kernels]
        heights = [k.chain_db.current_chain.head_block_no for k in kernels]
        for k in kernels:
            k.stop()
        return tips, heights

    tips, heights = sim.run(main(), seed=9)
    assert min(heights) >= 5
    assert max(heights) - min(heights) <= 3


# ---------------------------------------------------------------------------
# gossip, churn, and governor properties (Governor.hs:427-557,
# PeerSelection/Test.hs property style)
# ---------------------------------------------------------------------------

class _GossipActions(PeerSelectionActions):
    """A peer graph: roots are returned by discovery, the rest only via
    gossip from connected peers."""

    def __init__(self, roots, graph):
        self.roots = list(roots)
        self.graph = dict(graph)        # addr -> [addr its gossip returns]
        self.log = []

    async def request_peers(self):
        return self.roots

    async def gossip(self, addr):
        self.log.append(("gossip", addr))
        return self.graph.get(addr, [])

    async def connect(self, addr):
        return True

    async def activate(self, addr):
        return True


def test_gossip_discovers_transitively():
    """From one root peer, gossip rounds populate KnownPeers across the
    whole reachable graph and targets are met."""
    graph = {"root": ["a", "b"], "a": ["c", "d"], "b": ["e"],
             "c": ["f", "g"], "d": ["h"]}
    targets = PeerSelectionTargets(8, 6, 2)
    acts = _GossipActions(["root"], graph)
    gov = PeerSelectionGovernor(targets, acts, seed=3,
                                gossip_interval=1.0, retry_interval=1.0)

    async def main():
        h = sim.spawn(gov.run(), label="governor")
        await sim.sleep(60.0)
        h.cancel()
        return dict(gov.known.peers), len(gov.established), len(gov.active)

    known, est, act = sim.run(main(), seed=3)
    assert len(known) >= 8, sorted(known)
    assert {"c", "d", "e", "f", "h"} <= set(known), \
        "transitive peers not gossiped"
    assert est == 6 and act == 2
    # provenance recorded
    assert known["root"].source == "root"
    assert known["e"].source == "gossip"


def test_churn_rotates_active_peers_and_targets_recover():
    """The churn cycle demotes a hot peer; the governor promotes a
    replacement and targets re-converge — active membership changes over
    time (no eclipse-by-staleness)."""
    targets = PeerSelectionTargets(6, 3, 2)
    acts = _ScriptedActions([f"p{i}" for i in range(6)])
    gov = PeerSelectionGovernor(targets, acts, seed=4, retry_interval=2.0)

    async def main():
        h = sim.spawn(gov.run(), label="governor")
        c = sim.spawn(gov.run_churn(interval=5.0), label="churn")
        seen_active = []
        for _ in range(8):
            await sim.sleep(5.0)
            seen_active.append(frozenset(gov.active))
        h.cancel()
        c.cancel()
        return seen_active

    seen = sim.run(main(), seed=4)
    # targets held at each observation (after initial convergence)
    assert all(len(s) == 2 for s in seen[1:])
    # rotation happened: not always the same hot set
    assert len(set(seen)) >= 3, seen
    churns = [t for t in gov.trace if t[1] == "churn"]
    assert len(churns) >= 5


def test_governor_no_oscillation_at_steady_state():
    """Once targets are met and nothing fails, the governor makes NO
    further promote/demote decisions (PeerSelection/Test.hs no-oscillation
    property)."""
    targets = PeerSelectionTargets(4, 3, 2)
    acts = _ScriptedActions([f"p{i}" for i in range(4)])
    gov = PeerSelectionGovernor(targets, acts, seed=5, retry_interval=1.0)

    async def main():
        h = sim.spawn(gov.run(), label="governor")
        await sim.sleep(20.0)            # converge
        mark = len(gov.trace)
        await sim.sleep(60.0)            # steady window
        h.cancel()
        return [t for t in gov.trace[mark:]
                if t[1] not in ("request-more-peers",)]

    late = sim.run(main(), seed=5)
    assert late == [], f"oscillation: {late}"


def test_targets_hold_under_repeated_failures():
    """Random peer failures: suspended peers back off, replacements are
    promoted, and targets re-converge after each failure."""
    import random as _random
    targets = PeerSelectionTargets(8, 4, 2)
    acts = _ScriptedActions([f"p{i}" for i in range(8)])
    gov = PeerSelectionGovernor(targets, acts, seed=6, retry_interval=1.0,
                                suspend_base=2.0)
    rng = _random.Random(99)

    async def main():
        h = sim.spawn(gov.run(), label="governor")
        await sim.sleep(10.0)
        for _ in range(6):
            if gov.established:
                victim = rng.choice(sorted(gov.established, key=str))
                gov.report_failure(victim)
            await sim.sleep(8.0)
        h.cancel()
        return (len(gov.established), len(gov.active),
                [i.fail_count for i in gov.known.peers.values()])

    est, act, fails = sim.run(main(), seed=6)
    assert est == 4 and act == 2
    assert any(f > 0 for f in fails)     # failures were recorded


# ---------------------------------------------------------------------------
# DNS resolution + A/AAAA racing (Subscription/Dns.hs:239-292)
# ---------------------------------------------------------------------------

def test_dns_race_prefers_fast_aaaa():
    from ouroboros_tpu_torch.network.subscription import (
        DictResolver, resolve_racing,
    )

    async def main():
        r = DictResolver({"relay": (["1.2.3.4"], ["::1", "::2"])},
                         a_delay=0.01, aaaa_delay=0.02)
        return await resolve_racing(r, "relay", prefer_delay=0.05)

    addrs = sim.run(main())
    # AAAA answered within the preference window: v6 leads, v4 fallback
    assert addrs == ["::1", "::2", "1.2.3.4"]


def test_dns_race_falls_back_to_a_when_aaaa_slow_or_empty():
    from ouroboros_tpu_torch.network.subscription import (
        DictResolver, resolve_racing,
    )

    async def main():
        slow6 = DictResolver({"relay": (["1.2.3.4"], ["::1"])},
                             a_delay=0.0, aaaa_delay=1.0)
        first = await resolve_racing(slow6, "relay", prefer_delay=0.05)
        no6 = DictResolver({"relay": (["5.6.7.8"], [])})
        second = await resolve_racing(no6, "relay")
        return first, second

    first, second = sim.run(main())
    # slow AAAA loses the race AND misses the preference window: it is
    # dropped rather than awaited (a hung family must not stall dialling)
    assert first == ["1.2.3.4"]
    assert second == ["5.6.7.8"]


def test_dns_targets_feed_subscription_worker():
    """Resolved names become the worker's dial targets; valency held."""
    from ouroboros_tpu_torch.network.subscription import (
        DictResolver, SubscriptionWorker, dns_subscription_targets,
    )

    dialled = []

    def dial(addr):
        dialled.append(addr)

        async def conn():
            await sim.sleep(100.0)
        return sim.spawn(conn(), label=f"conn-{addr}")

    async def main():
        r = DictResolver({"relay1": (["10.0.0.1"], ["fd::1"]),
                          "relay2": (["10.0.0.2"], [])})
        targets = await dns_subscription_targets(r, ["relay1", "relay2"])
        w = SubscriptionWorker(targets, valency=2, dial=dial)
        h = sim.spawn(w.run(), label="worker")
        await sim.sleep(5.0)
        h.cancel()
        return targets

    targets = sim.run(main())
    assert set(targets) == {"fd::1", "10.0.0.1", "10.0.0.2"}
    assert len(dialled) == 2            # valency respected


# -- tests/test_diffusion.py -------------------------------------------------

def test_full_composition_in_sim():
    """One diffusion record per node: node 0 listens on TWO addresses and
    serves wallets on a local address; node 1 subscribes via IP producers;
    node 2 subscribes via a DNS name resolving to both of node 0's
    addresses.  A wallet connects through node 0's local server and
    queries the tip — every box of Diffusion.hs:175-245 in one run."""
    cfg = ThreadNetConfig(n_nodes=3, n_slots=30, k=10, f=0.5, seed=4)
    factory = PraosNetworkFactory(cfg)

    async def main():
        snk = SimSnocket(delay=0.02)
        local_snk = SimSnocket(delay=0.0)     # the unix-socket analog
        resolver = DictResolver({"node0.example": (["addr0a", "addr0b"], [])})
        kernels = [factory.make_node(i) for i in range(3)]
        for k in kernels:
            k.start()
        d0 = await run_data_diffusion(
            kernels[0],
            DiffusionArguments(addresses=["addr0a", "addr0b"],
                               local_address="wallet.sock",
                               ip_producers=["addr1"], ip_valency=1),
            snk, local_snocket=local_snk)
        await run_data_diffusion(
            kernels[1],
            DiffusionArguments(addresses=["addr1"],
                               ip_producers=["addr0a"], ip_valency=1),
            snk)
        await run_data_diffusion(
            kernels[2],
            DiffusionArguments(dns_producers=["node0.example"],
                               dns_valency=2, mode=INITIATOR_ONLY),
            snk, resolver=resolver)
        await sim.sleep(30.0)

        heights = [k.chain_db.current_chain.head_block_no for k in kernels]
        # the wallet connects through the diffusion's local server
        client = await connect_local_client_via(
            local_snk, "wallet.sock",
            (kernels[0].network_magic, kernels[0].block_decode_obj))
        assert client is not None
        tip = await client.query(["tip"])
        assert isinstance(d0, Diffusion)
        n_accepted = len(d0.tables["remote"])
        for k in kernels:
            k.stop()
        return heights, tip, n_accepted

    heights, tip, n_accepted = sim.run(main(), seed=4)
    # all three nodes converge (node 2 is initiator-only via DNS)
    assert min(heights) >= 5
    assert max(heights) - min(heights) <= 3
    assert tip is not None
    # node 0's accept servers saw inbound connections
    assert n_accepted >= 1


def test_initiator_only_opens_no_listeners():
    cfg = ThreadNetConfig(n_nodes=1, n_slots=5, k=10, f=0.5, seed=1)
    factory = PraosNetworkFactory(cfg)

    async def main():
        snk = SimSnocket()
        k = factory.make_node(0)
        k.start()
        d = await run_data_diffusion(
            k, DiffusionArguments(addresses=["a0"], mode=INITIATOR_ONLY),
            snk)
        ok = len(d.listeners) == 0 and "a0" not in snk._listeners
        k.stop()
        return ok

    assert sim.run(main())


def test_diffusion_over_real_sockets():
    """Smoke test: the same composition over loopback TCP under the IO
    runtime — forger A serves two addresses, B reaches A through the
    diffusion's subscription worker and syncs A's chain."""
    from ouroboros_tpu_torch.network.snocket import TcpSnocket

    cfg = ThreadNetConfig(n_nodes=2, n_slots=20, slot_length=0.1, k=10,
                          f=1.0, chain_sync_window=4)
    factory = PraosNetworkFactory(cfg)

    async def main():
        snk = TcpSnocket()
        a = factory.make_node(0)
        b = factory.make_node(1)
        b.forgings = []                    # B only syncs
        a.start()
        b.start()
        da = await run_data_diffusion(
            a, DiffusionArguments(addresses=[("127.0.0.1", 0)]), snk)
        addr_a = da.listeners[0].addr      # resolved ephemeral port
        await run_data_diffusion(
            b, DiffusionArguments(ip_producers=[addr_a], ip_valency=1,
                                  mode=INITIATOR_ONLY), snk)
        await sim.sleep(cfg.n_slots * cfg.slot_length)
        tip_a = a.chain_db.tip_point()
        for _ in range(100):
            if b.chain_db.contains_point(tip_a):
                break
            await sim.sleep(0.05)
        out = (tip_a, b.chain_db.contains_point(tip_a),
               a.chain_db.current_chain.head_block_no)
        a.stop()
        b.stop()
        da.stop()
        return out

    tip_a, synced, head_a = io_run(main())
    assert head_a >= 3, f"forger made no progress: {head_a}"
    assert not tip_a.is_genesis
    assert synced, "B did not sync A's tip through the diffusion"


# -- tests/test_governed_diffusion.py ----------------------------------------

def _mesh(factory, network, n, start=1):
    """n plain listener nodes addr1..addrN serving the governed node."""
    kernels = []
    for i in range(start, start + n):
        k = factory.make_node(i)
        k.start()
        network.listen(f"addr{i}", k)
        kernels.append(k)
    return kernels


def test_governor_reaches_all_targets_from_cold():
    cfg = ThreadNetConfig(n_nodes=6, n_slots=40, k=10, f=0.5, seed=9)
    factory = PraosNetworkFactory(cfg)
    targets = PeerSelectionTargets(target_known=5, target_established=3,
                                   target_active=2)

    async def main():
        network = SimNetwork(link_delay=0.01)
        peers = _mesh(factory, network, 5)
        gk = factory.make_node(0)
        gk.start()
        all_addrs = [f"addr{i}" for i in range(1, 6)]
        d = run_governed_diffusion(
            gk, network, "addr0", root_peers=all_addrs[:2],
            targets=targets, seed=3,
            # peer sharing: an established peer gossips the whole mesh
            gossip_fn=lambda addr: all_addrs)
        await sim.sleep(30.0)
        gov = d.tables["governor"]
        sizes = (len(gov.known), len(gov.established), len(gov.active))
        # the governed node's chain must actually follow the mesh (hot
        # peers run real ChainSync/BlockFetch)
        height = gk.chain_db.current_chain.head_block_no
        peer_height = max(p.chain_db.current_chain.head_block_no
                          for p in peers)
        for k in peers + [gk]:
            k.stop()
        return sizes, height, peer_height, list(gov.active)

    sizes, height, peer_height, active = sim.run(main(), seed=9)
    assert sizes[0] >= 5                      # known target reached
    assert sizes[1] == 3                      # established target
    assert sizes[2] == 2                      # active target
    assert height >= peer_height - 3          # actually syncing


def test_governor_recovers_after_active_peer_kill():
    cfg = ThreadNetConfig(n_nodes=6, n_slots=60, k=10, f=0.5, seed=11)
    factory = PraosNetworkFactory(cfg)
    targets = PeerSelectionTargets(target_known=5, target_established=3,
                                   target_active=2)

    async def main():
        network = SimNetwork(link_delay=0.01)
        peers = _mesh(factory, network, 5)
        gk = factory.make_node(0)
        gk.start()
        all_addrs = [f"addr{i}" for i in range(1, 6)]
        d = run_governed_diffusion(
            gk, network, "addr0", root_peers=all_addrs,
            targets=targets, seed=5)
        await sim.sleep(20.0)
        gov = d.tables["governor"]
        actions = d.tables["actions"]
        assert len(gov.active) == 2
        victim = sorted(gov.active)[0]
        # kill the connection out from under the governor: the hot job's
        # ChainSync dies, on_down fires, the governor demotes + suspends
        # the victim and promotes a replacement
        actions.conns[victim].mux_i.stop()
        # within the failure-backoff window: the replacement must be a
        # DIFFERENT peer (the victim is suspended); re-admission later is
        # legitimate governor behavior
        await sim.sleep(8.0)
        not_victim = victim not in gov.active
        await sim.sleep(30.0)
        recovered = (len(gov.active), len(gov.established))
        trace_kinds = {k for _t, k, _a in gov.trace}
        for k in peers + [gk]:
            k.stop()
        return recovered, not_victim, trace_kinds

    recovered, not_victim, kinds = sim.run(main(), seed=11)
    assert recovered[0] == 2 and recovered[1] == 3   # targets re-reached
    assert not_victim                                # replacement differs
    assert "promote-warm-to-hot" in kinds


def test_governor_churn_rotates_active_set():
    cfg = ThreadNetConfig(n_nodes=5, n_slots=80, k=10, f=0.5, seed=13)
    factory = PraosNetworkFactory(cfg)
    targets = PeerSelectionTargets(target_known=4, target_established=3,
                                   target_active=1)

    async def main():
        network = SimNetwork(link_delay=0.01)
        peers = _mesh(factory, network, 4)
        gk = factory.make_node(0)
        gk.start()
        d = run_governed_diffusion(
            gk, network, "addr0",
            root_peers=[f"addr{i}" for i in range(1, 5)],
            targets=targets, seed=7, churn_interval=15.0)
        await sim.sleep(70.0)
        gov = d.tables["governor"]
        churned = [a for t, k, a in gov.trace if k == "churn"]
        ever_active = {a for t, k, a in gov.trace
                       if k == "promote-warm-to-hot"}
        for k in peers + [gk]:
            k.stop()
        return churned, ever_active, len(gov.active)

    churned, ever_active, n_active = sim.run(main(), seed=13)
    assert len(churned) >= 3                 # rotation actually happened
    assert len(ever_active) >= 2             # different peers got promoted
    assert n_active == 1                     # target held through churn


# -- the same schedules, decisions and chains in both packages ----------------

_PKGS = ("ouroboros_tpu", "ouroboros_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _fault_run(pkg: str, seed: int, spec_kw: dict) -> dict:
    """In package `pkg`: one FaultPlan (seed, spec, a partition and an
    `until`) wrapping both directions of a bearer pair; each side writes
    a scripted sequence of 40 SDUs 0.1 s apart while a reader on the
    other side records what arrives.  Returns the plan's events, what
    each side received and the fault trace."""
    s = _mod(pkg, "simharness")
    mux = _mod(pkg, "network.mux")
    plan = s.FaultPlan(seed, s.FaultSpec(**spec_kw),
                       partitions=(s.Partition(1.0, 1.5,
                                               (("a",), ("b",))),),
                       until=3.5)
    got = {"a": [], "b": []}

    async def main():
        ba, bb = mux.bearer_pair(sdu_size=1024, delay=0.01)
        wa = plan.wrap_bearer(ba, "a", "b")
        wb = plan.wrap_bearer(bb, "b", "a")

        async def writer(bearer, tag):
            for i in range(40):
                payload = bytes([tag, i]) * (1 + i % 7)
                try:
                    await bearer.write(mux.SDU(0, 0, 2 + i % 3, payload))
                except s.LinkDown:
                    return i
                await s.sleep(0.1)
            return 40

        async def reader(bearer, side):
            while True:
                sdu = await bearer.read()
                got[side].append((round(s.now(), 9), sdu.num, sdu.payload))

        readers = [s.spawn(reader(wb, "b"), label="read-b"),
                   s.spawn(reader(wa, "a"), label="read-a")]
        ta = s.spawn(writer(wa, 1), label="write-a")
        tb = s.spawn(writer(wb, 2), label="write-b")
        out = (await ta.wait(), await tb.wait())
        await s.sleep(5.0)
        for r in readers:
            r.cancel()
        return out

    written, trace = s.run_trace(main(), seed=seed)
    return {"written": written, "events": list(plan.events), "got": got,
            "faults": [(e.time, e.payload) for e in trace
                       if e.kind == "fault"]}


@pytest.mark.parametrize("seed,spec_kw", [
    (1, {"jitter": 0.05, "drop_prob": 0.2, "corrupt_prob": 0.2}),
    (2, {"stall_prob": 0.1, "stall_for": 0.3, "drop_prob": 0.1}),
    (3, {"disconnect_prob": 0.05, "jitter": 0.02}),
])
def test_fault_plan_events_equal_the_jax_packages(seed, spec_kw):
    want, got = (_fault_run(pkg, seed, spec_kw) for pkg in _PKGS)
    assert want["events"], "the plan injected nothing"
    assert got == want


def _subscription_run(pkg: str, seed: int) -> dict:
    """In package `pkg`: a worker's jittered backoff windows, then a
    scripted sequence of connection endings (a transport error, a
    ChainSync violation, a watchdog kill, a clean end) through the
    default policies; returns every window, state and trace entry."""
    sub = _mod(pkg, "network.subscription")
    ep = _mod(pkg, "network.error_policy")
    cs = _mod(pkg, "node.chain_sync")
    wd = _mod(pkg, "node.watchdog")
    s = _mod(pkg, "simharness")
    endings = [ConnectionError("refused"), cs.ChainSyncClientError("bad"),
               wd.WatchdogTimeout("chain-sync", "StNext", 10.0),
               None, ConnectionError("again"), RuntimeError("unknown")]

    async def main():
        w = sub.SubscriptionWorker(["a", "b"], 1, None, base_backoff=2.0,
                                   seed=seed, label=f"w{seed}",
                                   error_policies=ep.default_node_policies())
        windows = [w._backoff(3.0, n) for n in range(8)]
        states = []
        for i, exc in enumerate(endings):
            await s.sleep(1.0)
            w._on_conn_end("ab"[i % 2], exc)
            states.append({a: (st.fail_count, st.consumer_until,
                               st.peer_until) for a, st in w.states.items()})
        return windows, states, list(w.trace)

    (windows, states, wtrace), trace = s.run_trace(main(), seed=seed)
    return {"windows": windows, "states": states, "trace": wtrace,
            "sim": [(e.time, e.payload) for e in trace
                    if e.kind == "subscription"]}


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_subscription_backoff_equals_the_jax_packages(seed):
    want, got = (_subscription_run(pkg, seed) for pkg in _PKGS)
    assert len(want["sim"]) == 6
    assert got == want


def _views(pkg: str, seed: int, n: int = 60) -> list:
    """`n` numpy-seeded GovernorViews over a 10-peer universe, built from
    package `pkg`'s classes."""
    ps = _mod(pkg, "network.peer_selection")
    rng = np.random.default_rng(seed)
    peers = [f"p{i}" for i in range(10)]
    out = []
    for _ in range(n):
        known = [p for p in peers if rng.random() < 0.6]
        est = [p for p in known if rng.random() < 0.5]
        act = [p for p in est if rng.random() < 0.5]
        t_act = int(rng.integers(0, 4))
        t_est = t_act + int(rng.integers(0, 4))
        targets = ps.PeerSelectionTargets(t_est + int(rng.integers(0, 4)),
                                          t_est, t_act)
        out.append(ps.GovernorView(
            now=float(rng.integers(0, 100)), targets=targets,
            known=tuple(known), known_total=len(known)
            + int(rng.integers(0, 3)), established=tuple(est),
            active=tuple(act)))
    return out


def _governor_run(pkg: str, seed: int) -> dict:
    """In package `pkg`: governor_decisions over seeded views, and a
    governor's trace over a scripted peer universe with flaky peers."""
    ps = _mod(pkg, "network.peer_selection")
    s = _mod(pkg, "simharness")
    decisions = [[(d.kind, d.addr) for d in ps.governor_decisions(v)]
                 for v in _views(pkg, seed)]

    class Scripted(ps.PeerSelectionActions):
        def __init__(self):
            self.flaky = {"p1": 2, "p4": 1}
            self.log = []

        async def request_peers(self):
            return [f"p{i}" for i in range(8)]

        async def connect(self, addr):
            self.log.append(("connect", addr, s.now()))
            if self.flaky.get(addr, 0) > 0:
                self.flaky[addr] -= 1
                return False
            return True

        async def activate(self, addr):
            self.log.append(("activate", addr, s.now()))
            return True

    acts = Scripted()
    gov = ps.PeerSelectionGovernor(ps.PeerSelectionTargets(6, 4, 2), acts,
                                   seed=seed, retry_interval=2.0,
                                   suspend_base=1.0)

    async def main():
        h = s.spawn(gov.run(), label="governor")
        await s.sleep(40.0)
        h.cancel()

    s.run(main(), seed=seed)
    return {"decisions": decisions, "trace": list(gov.trace),
            "log": acts.log, "sets": (sorted(gov.known.peers),
                                      sorted(gov.established),
                                      sorted(gov.active))}


@pytest.mark.parametrize("seed", [1, 2])
def test_governor_decisions_equal_the_jax_packages(seed):
    want, got = (_governor_run(pkg, seed) for pkg in _PKGS)
    assert any(want["decisions"]) and want["trace"]
    assert got == want


def _composition(pkg: str) -> dict:
    """tests/test_diffusion.py's in-sim composition in package `pkg`:
    node 0 on two addresses with a local server, node 1 by IP, node 2
    initiator-only by DNS; every node's height and chain, the wallet's
    tip and node 0's accepted connections."""
    s = _mod(pkg, "simharness")
    tn = _mod(pkg, "testing")
    sn = _mod(pkg, "network.snocket")
    sub = _mod(pkg, "network.subscription")
    dif = _mod(pkg, "node.diffusion")
    cfg = tn.ThreadNetConfig(n_nodes=3, n_slots=30, k=10, f=0.5, seed=4)
    factory = tn.PraosNetworkFactory(cfg)

    async def main():
        snk = sn.SimSnocket(delay=0.02)
        local_snk = sn.SimSnocket(delay=0.0)
        resolver = sub.DictResolver(
            {"node0.example": (["addr0a", "addr0b"], [])})
        kernels = [factory.make_node(i) for i in range(3)]
        for k in kernels:
            k.start()
        d0 = await dif.run_data_diffusion(
            kernels[0],
            dif.DiffusionArguments(addresses=["addr0a", "addr0b"],
                                   local_address="wallet.sock",
                                   ip_producers=["addr1"], ip_valency=1),
            snk, local_snocket=local_snk)
        await dif.run_data_diffusion(
            kernels[1],
            dif.DiffusionArguments(addresses=["addr1"],
                                   ip_producers=["addr0a"], ip_valency=1),
            snk)
        await dif.run_data_diffusion(
            kernels[2],
            dif.DiffusionArguments(dns_producers=["node0.example"],
                                   dns_valency=2, mode=dif.INITIATOR_ONLY),
            snk, resolver=resolver)
        await s.sleep(30.0)
        out = {"heights": [k.chain_db.current_chain.head_block_no
                           for k in kernels],
               "chains": [[p.encode() for p in
                           k.chain_db.current_chain.points()]
                          for k in kernels],
               "accepted": sorted(map(str, d0.tables["remote"]._conns))}
        client = await dif.connect_local_client_via(
            local_snk, "wallet.sock",
            (kernels[0].network_magic, kernels[0].block_decode_obj))
        out["tip"] = await client.query(["tip"])
        for k in kernels:
            k.stop()
        return out

    return s.run(main(), seed=4)


def test_data_diffusion_composition_equals_the_jax_packages():
    want, got = (_composition(pkg) for pkg in _PKGS)
    assert min(want["heights"]) >= 5 and want["accepted"]
    assert got == want
