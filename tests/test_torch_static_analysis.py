"""ouro-lint on the port (ouroboros_tpu_torch.analysis) — the cases of
tests/test_static_analysis.py: live-tree gates + seeded-violation
fixtures, the JAX rules' fixtures replaced by the torch pass's.

Two test surfaces:
(a) the passes run over the port's live tree as tier-1 assertions: the
    protocol pass must be clean with NO baseline help, the torch/sim/conc
    passes clean modulo the committed baseline;
(b) fixture snippets with seeded violations prove every rule actually
    fires (no false-negative lint) and that the allowlisted idioms don't
    (no cheap false positives).
"""
import json
import os
import subprocess
import sys

import pytest

from ouroboros_tpu_torch.analysis import Baseline, Finding, run_passes
from ouroboros_tpu_torch.analysis.conc_pass import lint_source as conc_lint
from ouroboros_tpu_torch.analysis.obs_pass import lint_source as obs_lint
from ouroboros_tpu_torch.analysis.protocol_pass import (
    check_spec, discover, message_inventory,
)
from ouroboros_tpu_torch.analysis.sim_pass import lint_source as sim_lint
from ouroboros_tpu_torch.analysis.torch_pass import lint_source as torch_lint
from ouroboros_tpu_torch.network.protocols.codec import Codec
from ouroboros_tpu_torch.network.typed import (
    CLIENT, NOBODY, SERVER, ProtocolSpec, branch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "ouroboros_tpu_torch", "analysis",
                        "baseline.json")


# --- (a) live tree ----------------------------------------------------------

def test_protocol_pass_live_tree_clean_without_baseline():
    """Acceptance: every discovered ProtocolSpec is sound with an empty
    protocol baseline section."""
    report = run_passes(["protocol"], Baseline())
    assert report.new == [], "\n".join(f.render() for f in report.new)
    assert Baseline.load().entries.get("protocol") == []


def test_protocol_pass_discovers_enough_specs():
    found = discover()
    assert len(found) >= 10, [sym for *_rest, sym in found]
    # every spec must have a paired codec on the live tree
    assert all(codec is not None for _s, codec, *_r in found)


def test_torch_and_sim_passes_clean_modulo_baseline():
    report = run_passes(["torch", "sim"], Baseline.load())
    assert report.new == [], "\n".join(f.render() for f in report.new)
    assert report.stale == [], report.stale


def test_conc_pass_live_tree_clean_modulo_baseline():
    """Acceptance (ISSUE 4): the CONC pass gates the live tree with an
    empty-or-justified baseline — every suppression names why the
    unordered access commutes."""
    report = run_passes(["conc"], Baseline.load())
    assert report.new == [], "\n".join(f.render() for f in report.new)
    assert report.stale == [], report.stale
    for e in Baseline.load().entries.get("conc", []):
        assert e["justification"].strip() and "TODO" not in \
            e["justification"], e


def test_baseline_entries_all_carry_justifications():
    for name, entries in Baseline.load().entries.items():
        for e in entries:
            assert e["justification"].strip(), (name, e)
            assert "TODO" not in e["justification"], (name, e)


# --- (b) protocol-pass fixtures --------------------------------------------

def _msg(name, tag):
    return type(name, (), {
        "TAG": tag,
        "encode_args": lambda self: [],
        "decode_args": classmethod(lambda cls, a: cls()),
    })


def _rules(findings):
    return {f.rule for f in findings}


def _check(spec, codec):
    return check_spec(spec, codec, file="fixture.py", line=1, symbol="FX")


def _codec(*names):
    return Codec([_msg(n, i) for i, n in enumerate(names)])


def test_proto001_fires_on_missing_agency_entry():
    spec = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "Done": NOBODY},       # "B" missing
        transitions={("A", "MsgGo"): "B", ("B", "MsgBack"): "A",
                     ("A", "MsgDone"): "Done"})
    f = _check(spec, _codec("MsgGo", "MsgBack", "MsgDone"))
    assert "PROTO001" in _rules(f)
    assert any("'B'" in x.message for x in f if x.rule == "PROTO001")


def test_proto001_fires_on_unknown_role():
    spec = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": "anyone", "Done": NOBODY},
        transitions={("A", "MsgDone"): "Done"})
    f = _check(spec, _codec("MsgDone"))
    assert "PROTO001" in _rules(f)


def test_proto002_fires_on_non_nobody_terminal_state():
    spec = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "Done": SERVER},       # terminal but SERVER
        transitions={("A", "MsgDone"): "Done"})
    f = _check(spec, _codec("MsgDone"))
    assert "PROTO002" in _rules(f)


def test_proto002_fires_on_transition_out_of_nobody_state():
    spec = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "Done": NOBODY},
        transitions={("A", "MsgDone"): "Done",
                     ("Done", "MsgZombie"): "A"})   # NOBODY may not send
    f = _check(spec, _codec("MsgDone", "MsgZombie"))
    assert "PROTO002" in _rules(f)


def test_proto003_fires_on_unreachable_state():
    spec = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "Lost": SERVER, "Done": NOBODY},
        transitions={("A", "MsgDone"): "Done",
                     ("Lost", "MsgBack"): "A"})     # nothing reaches Lost
    f = _check(spec, _codec("MsgDone", "MsgBack"))
    assert "PROTO003" in _rules(f)


def test_proto004_fires_on_opaque_branch_and_branch_helper_clears_it():
    opaque = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "B": SERVER, "Done": NOBODY},
        transitions={("A", "MsgGo"): lambda m: "B",
                     ("B", "MsgBack"): "A", ("A", "MsgDone"): "Done"})
    f = _check(opaque, _codec("MsgGo", "MsgBack", "MsgDone"))
    assert "PROTO004" in _rules(f)
    declared = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "B": SERVER, "Done": NOBODY},
        transitions={("A", "MsgGo"): branch(lambda m: "B", "B"),
                     ("B", "MsgBack"): "A", ("A", "MsgDone"): "Done"})
    assert _check(declared, _codec("MsgGo", "MsgBack", "MsgDone")) == []


def test_proto005_006_007_codec_coverage_both_ways():
    spec = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "Done": NOBODY},
        transitions={("A", "MsgDone"): "Done"})
    missing = _check(spec, _codec())                 # MsgDone unregistered
    assert "PROTO005" in _rules(missing)
    orphan = _check(spec, _codec("MsgDone", "MsgGhost"))
    assert "PROTO006" in _rules(orphan)
    assert "PROTO007" in _rules(_check(spec, None))


def test_protocol_pass_accepts_a_sound_spec():
    spec = ProtocolSpec(
        name="fx", init_state="A",
        agency={"A": CLIENT, "B": SERVER, "Done": NOBODY},
        transitions={("A", "MsgGo"): "B", ("B", "MsgBack"): "A",
                     ("A", "MsgDone"): "Done"})
    assert _check(spec, _codec("MsgGo", "MsgBack", "MsgDone")) == []


# --- (b) torch-pass fixtures ------------------------------------------------

def test_torch001_host_syncs_in_a_launch_path_fire():
    f = torch_lint(
        "import torch\n"
        "from . import kernels as K\n"
        "def verify(args):\n"
        "    out = K.ed25519_split(*args)\n"
        "    n = int(out.sum())\n"
        "    torch.cuda.synchronize()\n"
        "    return out.cpu(), out.item(), out.tolist(), n\n", "fx.py")
    assert _rules(f) == {"TORCH001"}
    assert len(f) == 5 and {x.symbol for x in f} == {"verify"}


def test_torch001_static_metadata_allowed():
    f = torch_lint(
        "from . import kernels as K\n"
        "def launch(a):\n"
        "    n = int(a.shape[1])\n"
        "    ok = bool(a.ndim - 1) and int(len(a.shape)) == 2\n"
        "    return K.gamma8(a, n), ok, int(a.device.index)\n", "fx.py")
    assert f == []


def test_torch001_fires_in_same_module_callee_of_a_wrapper():
    f = torch_lint(
        "import torch\n"
        "def _check(t):\n"
        "    return t.numpy()\n"
        "def kes_hash(mw, ew):\n"
        "    _check(mw)\n"
        "    out = torch.empty(3)\n"
        "    return _launch('kes_hash', (mw, ew), out, 3)\n",
        "ouroboros_tpu_torch/crypto/kernels.py")
    assert [(x.rule, x.symbol) for x in f] == [("TORCH001", "_check")]


def test_torch001_self_method_callee_and_getattr_launch():
    f = torch_lint(
        "from . import kernels as K\n"
        "class B:\n"
        "    def _host(self, t):\n"
        "        return t.cpu()\n"
        "    def _launch_lanes(self, kernel, args):\n"
        "        out = getattr(K, kernel)(*args)\n"
        "        return self._host(out)\n", "fx.py")
    assert [(x.rule, x.symbol) for x in f] == [("TORCH001", "_host")]


def test_torch001_nested_def_reported_once():
    # a def nested in a launch-path def yields ONE finding, under the
    # qualified symbol
    f = torch_lint(
        "from . import kernels as K\n"
        "def outer(a):\n"
        "    def inner(y):\n"
        "        return y.item()\n"
        "    return inner(K.gamma8(a))\n", "fx.py")
    assert [(x.rule, x.symbol) for x in f] == [("TORCH001", "outer.inner")]


def test_torch001_readback_outside_a_launch_path_is_fine():
    # the caller of a launch-path function reads back: not its launch path
    f = torch_lint(
        "from . import kernels as K\n"
        "def launch(a):\n"
        "    return K.vrf_verify(*a)\n"
        "def verdicts(a):\n"
        "    return launch(a).cpu().numpy()\n"
        "def host_prep(x):\n"
        "    return x.numpy(), int(x[0])\n", "fx.py")
    assert f == []


def test_torch002_cuda_work_at_import_fires():
    f = torch_lint(
        "import torch\n"
        "from . import kernels as K\n"
        "STREAM = torch.cuda.Stream()\n"
        "EV = torch.cuda.Event(enable_timing=True)\n"
        "ZERO = torch.zeros(4, device='cuda')\n"
        "ONE = torch.ones(4).to(torch.device('cuda:0'))\n"
        "TWO = torch.ones(4).cuda()\n"
        "LIB = K.library()\n"
        "if True:\n"
        "    build()\n", "fx.py")
    assert _rules(f) == {"TORCH002"}
    assert len(f) == 7 and {x.symbol for x in f} == {"<module>"}


def test_torch002_work_at_first_use_and_cpu_tensors_allowed():
    f = torch_lint(
        "import torch\n"
        "from . import kernels as K\n"
        "HOST = torch.zeros(4, device='cpu')\n"
        "DEV = torch.device('cuda')\n"
        "def stream():\n"
        "    K.library()\n"
        "    return torch.cuda.Stream(), torch.zeros(4, device='cuda')\n"
        "LAZY = lambda: torch.cuda.Event()\n", "fx.py")
    assert "TORCH002" not in _rules(f)


def test_torch003_build_and_stream_in_a_loop_fire():
    f = torch_lint(
        "import ctypes\n"
        "import torch\n"
        "from . import kernels as K\n"
        "def per_window(windows):\n"
        "    for w in windows:\n"
        "        K.build()\n"
        "        s = torch.cuda.Stream()\n"
        "        lib = ctypes.CDLL('x.so')\n", "fx.py")
    assert [x.rule for x in f] == ["TORCH003"] * 3
    f2 = torch_lint(
        "from . import kernels as K\n"
        "def reps(k):\n"
        "    while k:\n"
        "        K.library()\n"
        "        k -= 1\n", "fx.py")
    assert _rules(f2) == {"TORCH003"}


def test_torch003_hoisted_and_nested_builders_allowed():
    good = torch_lint(
        "import torch\n"
        "from . import kernels as K\n"
        "def per_window(windows):\n"
        "    K.library()\n"
        "    s = torch.cuda.Stream()\n"
        "    return [K.gamma8(w) for w in windows]\n", "fx.py")
    assert "TORCH003" not in _rules(good)
    # a def nested inside a loop runs at call time, not per iteration
    nested = torch_lint(
        "import torch\n"
        "def outer(items):\n"
        "    for it in items:\n"
        "        def later():\n"
        "            return torch.cuda.Stream()\n"
        "        use(later)\n", "fx.py")
    assert "TORCH003" not in _rules(nested)


def test_torch_pass_scans_crypto_and_parallel():
    """The scan covers the counterparts of the JAX pass's crypto/ and
    parallel/, and the live tree builds no library or stream in a loop
    and does no CUDA work at import."""
    from ouroboros_tpu_torch.analysis.torch_pass import SCAN_DIRS, run
    assert SCAN_DIRS == ("ouroboros_tpu_torch/crypto",
                         "ouroboros_tpu_torch/parallel")
    findings = run()
    assert not [f for f in findings if f.rule in ("TORCH002",
                                                  "TORCH003")], findings


def test_torch_launch_path_wrappers_are_kernels_pys():
    """WRAPPERS names every function of crypto/kernels.py that reaches
    `_launch`, so a new wrapper cannot leave the launch path unlinted."""
    import ast
    from ouroboros_tpu_torch.analysis.torch_pass import WRAPPERS
    path = os.path.join(REPO, "ouroboros_tpu_torch", "crypto",
                        "kernels.py")
    tree = ast.parse(open(path).read())
    calls = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            calls[node.name] = {c.func.id for c in ast.walk(node)
                                if isinstance(c, ast.Call)
                                and isinstance(c.func, ast.Name)}
    reach = {"_launch"}
    while True:
        more = {n for n, cs in calls.items() if cs & reach} - reach
        if not more:
            break
        reach |= more
    assert reach - {"batch_verify_ed25519"} == set(WRAPPERS)


def test_branch_enforces_declared_targets_at_runtime():
    from ouroboros_tpu_torch.network.typed import ProtocolError
    good = branch(lambda m: "B" if m else "C", "B", "C")
    assert good(True) == "B" and good(False) == "C"
    lying = branch(lambda m: "Typo", "B")
    with pytest.raises(ProtocolError):
        lying(object())


# --- (b) sim-pass fixtures --------------------------------------------------

def test_sim001_time_sleep_in_async_fires_sync_allowed():
    f = sim_lint(
        "import time\n"
        "async def poll():\n"
        "    time.sleep(1)\n", "fx.py")
    assert _rules(f) == {"SIM001"}
    assert sim_lint(
        "import time\n"
        "def host_only():\n"
        "    time.sleep(1)\n", "fx.py") == []


def test_sim002_global_rng_fires_seeded_instance_allowed():
    f = sim_lint(
        "import random\n"
        "async def pick(xs):\n"
        "    return random.choice(xs)\n", "fx.py")
    assert _rules(f) == {"SIM002"}
    assert sim_lint(
        "import random\n"
        "async def pick(xs, seed):\n"
        "    rng = random.Random(seed)\n"
        "    return rng.choice(xs)\n", "fx.py") == []


def test_sim003_threading_fires():
    f = sim_lint(
        "import threading\n"
        "async def go(fn):\n"
        "    threading.Thread(target=fn).start()\n", "fx.py")
    assert "SIM003" in _rules(f)


def test_sim004_socket_call_fires_constants_allowed():
    f = sim_lint(
        "import socket\n"
        "async def dial(addr):\n"
        "    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
        "    return s\n", "fx.py")
    assert _rules(f) == {"SIM004"} and len(f) == 1
    assert sim_lint(
        "import socket\n"
        "async def family(addr):\n"
        "    return socket.AF_INET6 if ':' in addr else socket.AF_INET\n",
        "fx.py") == []


def test_sim006_unbounded_receive_fires_in_node_scope_only():
    src = (
        "async def client(session):\n"
        "    return await session.recv()\n")
    f = sim_lint(src, "ouroboros_tpu_torch/node/fx.py")
    assert _rules(f) == {"SIM006"}
    # same code outside node/ is out of scope (servers, tests, tools)
    assert sim_lint(src, "ouroboros_tpu_torch/network/fx.py") == []


def test_sim006_collect_and_stm_queue_get_fire():
    f = sim_lint(
        "async def drain(session, q, sim):\n"
        "    await session.collect()\n"
        "    await sim.atomically(lambda tx: q.get(tx))\n"
        "    await sim.atomically(q.get)\n",
        "ouroboros_tpu_torch/node/fx.py")
    assert [x.rule for x in f] == ["SIM006"] * 3


def test_sim006_bounded_receives_allowed():
    # the watchdog helpers and sim.timeout wrappers are the sanctioned
    # bounded forms; unrelated awaits must not fire either
    assert sim_lint(
        "from ouroboros_tpu_torch.node.watchdog import recv_with_limit\n"
        "async def client(session, limits, sim):\n"
        "    msg = await recv_with_limit(session, limits)\n"
        "    ok = await sim.timeout(5.0, noop())\n"
        "    await sim.sleep(1.0)\n"
        "    return msg, ok\n",
        "ouroboros_tpu_torch/node/fx.py") == []


def test_sim005_blocking_open_fires_in_nested_helper_too():
    f = sim_lint(
        "async def load(path):\n"
        "    def slurp():\n"
        "        with open(path) as fh:\n"
        "            return fh.read()\n"
        "    return slurp()\n", "fx.py")
    assert _rules(f) == {"SIM005"}
    assert f[0].symbol == "load.slurp"


# --- (b) conc-pass fixtures --------------------------------------------------

def test_conc001_set_notify_and_value_write_fire():
    f = conc_lint(
        "async def poke(tv):\n"
        "    tv.set_notify(1)\n"
        "    tv._value = 2\n", "fx.py")
    assert [x.rule for x in f] == ["CONC001", "CONC001"]


def test_conc001_own_private_attr_allowed():
    # `self._value = ...` defines one's OWN attribute (the standard
    # Python idiom) — TVars are never `self` outside the runtime impl
    assert conc_lint(
        "class Box:\n"
        "    def __init__(self, v):\n"
        "        self._value = v\n", "fx.py") == []


def test_conc002_blocking_in_atomic_fires():
    f = conc_lint(
        "import time\n"
        "async def go(sim, q):\n"
        "    await sim.atomically(lambda tx: time.sleep(1))\n", "fx.py")
    assert _rules(f) == {"CONC002"}
    # a named local tx fn is resolved and linted too, await included
    f2 = conc_lint(
        "async def go(sim, session):\n"
        "    async def tx_fn(tx):\n"
        "        return await session.recv()\n"
        "    await sim.atomically(tx_fn)\n", "fx.py")
    assert "CONC002" in _rules(f2)


def test_conc002_retry_and_check_allowed():
    assert conc_lint(
        "async def go(sim, q, v):\n"
        "    def tx_fn(tx):\n"
        "        tx.check(tx.read(v) > 0)\n"
        "        return q.get(tx)\n"
        "    return await sim.atomically(tx_fn)\n", "fx.py") == []


def test_conc003_global_mutation_in_async_fires_sync_allowed():
    f = conc_lint(
        "COUNT = 0\n"
        "async def bump():\n"
        "    global COUNT\n"
        "    COUNT += 1\n", "fx.py")
    assert _rules(f) == {"CONC003"}
    assert conc_lint(
        "COUNT = 0\n"
        "def host_side():\n"
        "    global COUNT\n"
        "    COUNT += 1\n", "fx.py") == []


def test_conc003_nested_local_shadow_not_flagged():
    # a nested helper's local binding of the same name is a FRESH scope,
    # not the declared global — must not fire
    assert conc_lint(
        "COUNT = 0\n"
        "async def f():\n"
        "    global COUNT\n"
        "    def helper():\n"
        "        COUNT = 5\n"
        "        return COUNT\n"
        "    return helper()\n", "fx.py") == []


def test_conc004_bare_spawn_fires_supervised_allowed():
    f = conc_lint(
        "async def go(sim, work):\n"
        "    sim.spawn(work())\n", "fx.py")
    assert _rules(f) == {"CONC004"}
    assert conc_lint(
        "async def go(sim, work, threads):\n"
        "    t = sim.spawn(work())\n"
        "    threads.append(sim.spawn(work()))\n"
        "    await t.wait()\n", "fx.py") == []


def test_conc005_nested_atomically_fires_or_else_allowed():
    f = conc_lint(
        "async def go(sim, v):\n"
        "    def tx_fn(tx):\n"
        "        return sim.atomically(lambda t2: t2.read(v))\n"
        "    await sim.atomically(tx_fn)\n", "fx.py")
    assert "CONC005" in _rules(f)
    assert conc_lint(
        "async def go(sim, v, w):\n"
        "    def tx_fn(tx):\n"
        "        return tx.or_else(lambda t: t.read(v),\n"
        "                          lambda t: t.read(w))\n"
        "    await sim.atomically(tx_fn)\n", "fx.py") == []


# --- (b) obs-pass fixtures ---------------------------------------------------

def test_obs001_unguarded_dataclass_build_fires():
    f = obs_lint(
        "def submit(tracer, ne, nv):\n"
        "    tracer.trace(WindowDispatched(ne, nv))\n", "fx.py")
    assert _rules(f) == {"OBS001"}
    assert f[0].symbol == "submit"


def test_obs001_unguarded_fstring_fires_including_trace_event():
    f = obs_lint(
        "def submit(key):\n"
        "    sim.trace_event(f'window {key}', label='crypto')\n", "fx.py")
    assert _rules(f) == {"OBS001"}
    f = obs_lint(
        "def submit(tracer, key):\n"
        "    tracer.trace('shape %s' % (key,))\n", "fx.py")
    assert _rules(f) == {"OBS001"}


def test_obs001_active_guard_clears_it():
    assert obs_lint(
        "def submit(tracer, ne, nv):\n"
        "    if tracer.active:\n"
        "        tracer.trace(WindowDispatched(ne, nv))\n", "fx.py") == []
    # guard on a tracer held in an attribute chain counts too
    assert obs_lint(
        "def submit(self, ne):\n"
        "    if self.tracers.fetch.active:\n"
        "        self.tracers.fetch.trace(Ev(ne))\n", "fx.py") == []


def test_obs001_cheap_payloads_allowed():
    """Constants, names and plain tuple builds are as cheap as the
    guard itself — no finding."""
    assert obs_lint(
        "def submit(tracer, ne, nv):\n"
        "    tracer.trace((ne, nv, 'window'))\n"
        "    tracer.trace(EVENT_CONSTANT)\n", "fx.py") == []


def test_obs002_unbound_histogram_observe_fires():
    """`histogram(...).observe(v)` pays a registry lookup per
    observation — the hot-path form is a pre-bound handle (ISSUE 9)."""
    f = obs_lint(
        "def drain(dt):\n"
        "    _metrics.histogram('pipeline.lat').observe(dt)\n", "fx.py")
    assert _rules(f) == {"OBS002"}
    assert f[0].symbol == "drain"
    # the latency convenience and registry-method forms fire too
    f = obs_lint(
        "def drain(reg, dt):\n"
        "    reg.latency_histogram('x').observe(dt)\n"
        "    reg.counter('n').inc()\n"
        "    reg.gauge('g').set(dt)\n", "fx.py")
    assert _rules(f) == {"OBS002"} and len(f) == 3


def test_obs002_prebound_handle_clears_it():
    assert obs_lint(
        "_LAT = _metrics.latency_histogram('pipeline.lat')\n"
        "def drain(dt):\n"
        "    _LAT.observe(dt)\n", "fx.py") == []
    # creation alone (bind-at-init) is not a finding — only the chained
    # write is; nor are reads on a fresh lookup (cold by nature)
    assert obs_lint(
        "def init(self):\n"
        "    self.h = _metrics.histogram('x')\n"
        "def report(reg):\n"
        "    return reg.histogram('x').quantiles()\n", "fx.py") == []


def test_obs003_dynamic_name_fires():
    """A metric name built from a runtime value at the factory call is
    the registry-cardinality bomb OBS003 exists for (ISSUE 14); the old
    watchdog per-protocol counter shape fires both OBS003 (dynamic
    name) and OBS002 (write chained onto the fresh lookup)."""
    f = obs_lint(
        "def fire(p):\n"
        "    _metrics.counter(f'watchdog.firings.{p}').inc()\n", "fx.py")
    assert _rules(f) == {"OBS002", "OBS003"}
    # %-format, .format and str() name builds fire too
    f = obs_lint(
        "def series(reg, peer, num):\n"
        "    h = reg.histogram('lat.%s' % peer)\n"
        "    c = reg.counter('bytes.{}'.format(peer))\n"
        "    g = reg.gauge(str(num))\n", "fx.py")
    assert _rules(f) == {"OBS003"} and len(f) == 3


def test_obs003_helper_and_static_names_clear():
    """The sanctioned forms: the bounded-label helper (whose factory
    leaf is not a registry factory) and static literal names."""
    assert obs_lint(
        "def fire(p):\n"
        "    _net.labeled_counter('watchdog.firings_by_protocol',\n"
        "                         protocol=p).inc()\n", "fx.py") == []
    assert obs_lint(
        "_C = _metrics.counter('watchdog.firings')\n"
        "def fire():\n"
        "    _C.inc()\n", "fx.py") == []
    # a plain variable as the name is not flagged (the rule targets
    # construction at the call site)
    assert obs_lint(
        "def bind(reg, name):\n"
        "    return reg.counter(name)\n", "fx.py") == []


def test_obs003_exempts_the_helper_itself():
    """observe/netmetrics.py builds labeled names BY DESIGN: the
    package scan must not flag the helper's own implementation."""
    from ouroboros_tpu_torch.analysis.obs_pass import run_files
    import os
    path = os.path.join(REPO, "ouroboros_tpu_torch", "observe",
                        "netmetrics.py")
    assert [f for f in run_files([path])
            if f.rule == "OBS003"] == []


def test_obs_pass_live_tree_clean_modulo_baseline():
    """Acceptance (ISSUE 7 + 9 + 14): the only tolerated unguarded
    construction / unbound instrument-write / dynamic-name sites carry
    justifications."""
    report = run_passes(["obs"], Baseline.load())
    assert report.new == [], "\n".join(f.render() for f in report.new)
    assert report.stale == [], report.stale
    entries = Baseline.load().entries.get("obs", [])
    for e in entries:
        assert e["justification"].strip() and "TODO" not in \
            e["justification"], e
    # the OBS003 satellite's justified-baseline contract is exercised by
    # real entries (the bounded-by-construction span-category and
    # event-class vocabularies); the old watchdog OBS002 entry is
    # retired — its dynamic name now routes through the bounded-label
    # helper
    assert any(e["rule"] == "OBS003" for e in entries)
    assert not any(e["rule"] == "OBS002"
                   and e["file"] == "ouroboros_tpu_torch/node/watchdog.py"
                   for e in entries)


# --- baseline canonical form -------------------------------------------------

def test_baseline_load_dump_round_trips_byte_identically(tmp_path):
    """--write-baseline on an unchanged tree must be a zero-line diff:
    dump emits the canonical (file, rule, symbol, justification) key
    order the committed file uses."""
    committed = BASELINE
    out = tmp_path / "bl.json"
    Baseline.load().dump(str(out))
    assert out.read_bytes() == open(committed, "rb").read()


def test_write_baseline_on_unchanged_tree_is_noop(tmp_path):
    committed = BASELINE
    bl = tmp_path / "bl.json"
    import shutil
    shutil.copy(committed, bl)
    r = _cli("--write-baseline", "--baseline", str(bl))
    assert r.returncode == 0, r.stdout + r.stderr
    assert bl.read_bytes() == open(committed, "rb").read()


# --- machine-readable output (--format json/sarif) ---------------------------

def test_cli_format_json_schema_and_exit_code():
    r = _cli("--format", "json", "--strict")
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["tool"] == "ouro-lint" and doc["schema_version"] == 1
    assert doc["blocking"] is False and doc["new"] == []
    assert set(doc["summary"]) == {"conc", "obs", "protocol", "sim",
                                   "torch"}
    assert doc["baselined"], "committed baseline findings must surface"
    for f in doc["baselined"]:
        assert set(f) == {"file", "line", "rule", "symbol", "message"}


def test_cli_format_json_blocking_on_no_baseline():
    r = _cli("--format", "json", "--no-baseline")
    assert r.returncode == 1
    doc = json.loads(r.stdout)
    assert doc["blocking"] is True and doc["new"]


def test_cli_format_sarif_minimal_valid():
    r = _cli("--format", "sarif")
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "ouro-lint"
    rules = {x["id"] for x in run["tool"]["driver"]["rules"]}
    results = run["results"]
    assert results, "baselined findings must appear as notes"
    for res in results:
        assert res["ruleId"] in rules
        assert res["level"] in ("error", "note")
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith(".py")
        assert loc["region"]["startLine"] >= 1
        if res["level"] == "note":
            assert res["suppressions"]


# --- CLI exit-code semantics ------------------------------------------------

def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "ouroboros_tpu_torch.analysis", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_strict_clean_on_live_tree():
    r = _cli("--strict")
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_exit_1_when_baseline_ignored():
    # the committed baseline is non-empty, so --no-baseline must block
    assert Baseline.load().entries["torch"] or Baseline.load().entries["sim"]
    r = _cli("--no-baseline")
    assert r.returncode == 1, r.stdout + r.stderr


def test_cli_write_baseline_merges_and_preserves_other_sections(tmp_path):
    import shutil
    bl = tmp_path / "bl.json"
    shutil.copy(BASELINE, bl)
    r = _cli("--passes", "protocol", "--write-baseline",
             "--baseline", str(bl))
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.loads(bl.read_text())
    assert data["protocol"] == []
    # sections of passes that did NOT run survive, justifications intact
    assert data["torch"] and data["sim"]
    assert all("TODO" not in e["justification"]
               for e in data["torch"] + data["sim"])


def test_cli_exit_2_on_missing_explicit_baseline():
    r = _cli("--baseline", "ouroboros_tpu_torch/analysis/nope.json")
    assert r.returncode == 2, r.stdout + r.stderr


def test_cli_exit_2_on_internal_error():
    r = _cli("--baseline", "ouroboros_tpu_torch/analysis/nope.json",
             "--passes", "nosuchpass")
    assert r.returncode == 2, r.stdout + r.stderr
