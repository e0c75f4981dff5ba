"""The field microbenchmark's chains against the JAX package, on the CPU.

- field.limbs_from_radix13 carries the JAX field's radix-2^13 limbs
  across by value (edge values and seeded random limbs, against Python
  integers);
- field.field_chain_core (the `field_chain` kernel's plain version) and
  ed25519.point_chain_core (that of `point_chain` and `point_chain_x4`)
  against the bodies of the two TPU kernels of
  experiments/microbench_field.py, run as those bodies run them:
  field_jax.mul / sqr-as-mul / add / carry_round under
  mul_impl("columns"), and ed25519_jax.pt_double / pt_add(Q, P, n), op by
  op (no compiled composite), on 8 lanes from default_rng(0), compared
  by value mod p with tolerance 0 (port and JAX limbs differ);
- the bodies themselves through pl.pallas_call(interpret=True) (slow);
- the chain wrappers' CPU side and the entry point on the CPU.

The CUDA kernels run against the same plain versions in
test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ouroboros_tpu.crypto import ed25519_jax as JE
from ouroboros_tpu.crypto import field_jax as JF
from ouroboros_tpu_torch import microbench_field as MB
from ouroboros_tpu_torch.crypto import ed25519 as E
from ouroboros_tpu_torch.crypto import edwards as ed
from ouroboros_tpu_torch.crypto import field as F
from ouroboros_tpu_torch.crypto import kernels as K

N = 8
KS = (1, 3, 5)
P = F.P


def _radix13(x: int) -> list[int]:
    return [(x >> (13 * i)) & 8191 for i in range(20)]


def _value13(col) -> int:
    return sum(int(v) << (13 * i) for i, v in enumerate(col)) % P


@pytest.fixture(scope="module")
def raw():
    """The JAX script's draw at 8 lanes: a, then b, (20, 8) int32."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 8191, size=(20, N), dtype=np.int32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def port_in(raw):
    return tuple(F.limbs_from_radix13(r).to(torch.int32) for r in raw)


def _port_values(t: torch.Tensor) -> list[int]:
    return F.unpack(t)


def _jax_values(arr) -> list[int]:
    return [int(v) for v in JF.unpack(np.asarray(arr))]


# -- limbs_from_radix13 -------------------------------------------------------

@pytest.mark.parametrize("x", [0, 1, P - 1, P, 2**255 - 1, 2**260 - 1],
                         ids=["0", "1", "p-1", "p", "2^255-1", "2^260-1"])
def test_limbs_from_radix13_edge_values(x):
    h = F.limbs_from_radix13(np.array([_radix13(x)], dtype=np.int32).T)
    assert h.shape == (10, 1) and h.dtype == torch.int64
    assert F.limbs_to_int(h[:, 0].tolist()) == x % P
    half = torch.tensor([1 << (w - 1) for w in F.WIDTHS])[:, None]
    assert bool((h.abs() <= half + 2**8).all())          # carried


def test_limbs_from_radix13_random_limbs(raw):
    rng = np.random.default_rng(13)
    r = rng.integers(-2**31, 2**31, size=(20, 64), dtype=np.int64)
    r = np.concatenate([r.astype(np.int32), raw[0], raw[1]], axis=1)
    h = F.limbs_from_radix13(r)
    assert F.unpack(h) == [_value13(r[:, j]) for j in range(r.shape[1])]
    half = torch.tensor([1 << (w - 1) for w in F.WIDTHS])[:, None]
    assert bool((h.abs() <= half + 2**8).all())


# -- the chains against the JAX kernel bodies' functions ----------------------

@pytest.fixture(scope="module")
def jax_field_chains(raw):
    """{op: {k: values}} of a <- op(a, b), the TPU kernel's body
    (microbench_field.py:164-173) op by op under mul_impl("columns")."""
    a0, b = (jnp.asarray(r) for r in raw)
    out = {}
    with JF.mul_impl("columns"):
        for op in F.FIELD_OPS:
            a, out[op] = a0, {}
            for i in range(1, max(KS) + 1):
                if op == "mul":
                    a = JF.mul(a, b)
                elif op == "sqr":
                    a = JF.mul(a, a)
                elif op == "add":
                    a = JF.add(a, b)
                else:
                    a = JF.carry_round(a)
                if i in KS:
                    out[op][i] = _jax_values(a)
    return out


@pytest.fixture(scope="module")
def jax_point_chains(raw):
    """{kind: {k: values}} of X + Y + Z + T from P = (a, b, a, b), the TPU
    kernel's body (microbench_field.py:186-195) op by op."""
    a, b = (jnp.asarray(r) for r in raw)
    P0 = (a, b, a, b)
    out = {}
    with JF.mul_impl("columns"):
        for kind in E.POINT_OPS:
            Q, out[kind] = P0, {}
            for i in range(1, max(KS) + 1):
                Q = JE.pt_double(Q) if kind == "dbl" else JE.pt_add(Q, P0, N)
                if i in KS:
                    out[kind][i] = _jax_values(Q[0] + Q[1] + Q[2] + Q[3])
    return out


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("op", F.FIELD_OPS)
def test_field_chain_core_matches_field_jax(port_in, jax_field_chains, op, k):
    got = F.field_chain_core(*port_in, op, k)
    assert got.shape == (10, N) and got.dtype == torch.int32
    assert _port_values(got) == jax_field_chains[op][k]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", E.POINT_OPS)
def test_point_chain_core_matches_ed25519_jax(port_in, jax_point_chains, kind,
                                              k):
    got = E.point_chain_core(*port_in, kind, k)
    assert got.shape == (10, N) and got.dtype == torch.int32
    assert _port_values(got) == jax_point_chains[kind][k]


def test_point_chain_core_matches_edwards_formulas(port_in):
    """The same chains in Python integers (edwards.pt_double / pt_add mod
    p), at a longer chain than the JAX comparison."""
    ai, bi = (_port_values(t) for t in port_in)
    for kind in E.POINT_OPS:
        want = []
        for x, y in zip(ai, bi):
            P0 = Q = (x, y, x, y)
            for _ in range(16):
                Q = ed.pt_double(Q) if kind == "dbl" else ed.pt_add(Q, P0)
            want.append(sum(Q) % P)
        assert _port_values(E.point_chain_core(*port_in, kind, 16)) == want


def test_ops_per_step_counts_the_plain_versions_products(port_in):
    """The bound's per-step count of the product chains is the plain
    versions' own field-product count (100 a product, 55 a square)."""
    one = [t[:, :1] for t in port_in]
    for op, fn in (("mul", F.field_chain_core), ("sqr", F.field_chain_core),
                   ("dbl", E.point_chain_core), ("addc", E.point_chain_core)):
        F.COUNTS.update(mul=0, sqr=0)
        fn(*one, op, 1)
        assert 100 * F.COUNTS["mul"] + 55 * F.COUNTS["sqr"] == \
            MB.OPS_PER_STEP[op], op


# -- the TPU kernels themselves, through the Pallas interpreter ---------------

@pytest.mark.slow
def test_pallas_kernel_bodies_match_the_port(raw, port_in):
    """The two kernel bodies of experiments/microbench_field.py:160-174
    and :186-195, copied here, through pl.pallas_call(interpret=True) at
    one tile of 8 lanes and k = 3, against the port's plain chains."""
    import jax
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    k = 3

    def make_chain(op_name):
        def kernel(a_ref, b_ref, o_ref):
            a = a_ref[:]
            b = b_ref[:]

            def body(i, a):
                if op_name == "mul":
                    return JF.mul(a, b)
                if op_name == "sqr":
                    return JF.mul(a, a)
                if op_name == "add":
                    return JF.add(a, b)
                if op_name == "carry":
                    return JF.carry_round(a)
                raise ValueError(op_name)
            o_ref[:] = lax.fori_loop(0, k, body, a)
        return kernel

    def make_pt_chain(kind):
        def kernel(x_ref, y_ref, z_ref, t_ref, o_ref):
            P0 = (x_ref[:], y_ref[:], z_ref[:], t_ref[:])
            Q = P0

            def body(i, Q):
                if kind == "dbl":
                    return JE.pt_double(Q)
                return JE.pt_add(Q, P0, N)
            Q = lax.fori_loop(0, k, body, Q)
            o_ref[:] = Q[0] + Q[1] + Q[2] + Q[3]
        return kernel

    spec = pl.BlockSpec((JF.NLIMBS, N), lambda i: (0, i),
                        memory_space=pltpu.VMEM)
    shape = jax.ShapeDtypeStruct((JF.NLIMBS, N), jnp.int32)
    a, b = (jnp.asarray(r) for r in raw)
    with JF.mul_impl("columns"):
        for op in F.FIELD_OPS:
            got = pl.pallas_call(make_chain(op), grid=(1,),
                                 in_specs=[spec, spec], out_specs=spec,
                                 out_shape=shape, interpret=True)(a, b)
            assert _jax_values(got) == _port_values(
                F.field_chain_core(*port_in, op, k)), op
        for kind in E.POINT_OPS:
            got = pl.pallas_call(make_pt_chain(kind), grid=(1,),
                                 in_specs=[spec] * 4, out_specs=spec,
                                 out_shape=shape, interpret=True)(a, b, a, b)
            assert _jax_values(got) == _port_values(
                E.point_chain_core(*port_in, kind, k)), kind


# -- the wrappers' CPU side and the entry point -------------------------------

def test_chain_wrappers_run_the_plain_version_on_cpu_tensors(port_in):
    K.reset_launches()
    for op in F.FIELD_OPS:
        assert torch.equal(K.field_chain(*port_in, op, 3),
                           F.field_chain_core(*port_in, op, 3))
    for op in F.FIELD_LP_OPS:
        assert torch.equal(K.field_chain_lp(*port_in, op, 3),
                           F.field_chain_core(*port_in, op, 3))
    for kind in E.POINT_OPS:
        want = E.point_chain_core(*port_in, kind, 3)
        assert torch.equal(K.point_chain(*port_in, kind, 3), want)
        assert torch.equal(K.point_chain_x4(*port_in, kind, 3), want)
    assert K.LAUNCHES == {name: 0 for name in K.KERNELS}
    with pytest.raises(ValueError):
        K.field_chain(*port_in, "div", 3)
    with pytest.raises(ValueError):
        K.field_chain_lp(*port_in, "add", 3)      # mul and sqr only
    with pytest.raises(ValueError):
        K.point_chain_x4(*port_in, "dbl", -1)


@pytest.fixture(scope="module")
def ops_run():
    """One `--ops` run of the entry point on the CPU at 8 lanes: its
    returned dict and its standard output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = MB.main(["--device", "cpu", "--ops", "--lanes", "8", "--reps",
                       "1"])
    return out, buf.getvalue()


def test_entry_point_on_the_cpu_prints_one_line_per_operation(ops_run):
    out, text = ops_run
    lines = [ln for ln in text.splitlines() if "per batched op" in ln]
    want = [(name, op) for name, ops, _k in MB.CHAINS for op in ops]
    assert len(lines) == len(want) == 10
    for ln, (name, op) in zip(lines, want):
        assert ln.split()[:2] == [name, op + ":"]
    assert [(r["kernel"], r["op"]) for r in out["ops"]] == want
    assert all(r["time_from"] == "host" and r["cycles_per_op"] is None
               for r in out["ops"])


def test_entry_point_lists_the_limb_parallel_rows_and_their_bound(ops_run):
    """field_chain_lp's rows (mul and sqr, eight threads a lane) are
    listed after field_chain's, and every row's bound counts
    OPS_PER_STEP a lane: the plain versions' multiply-adds for the
    products (test_ops_per_step_counts_the_plain_versions_products).  Off
    the card there is no integer rate, so no bound time."""
    out, text = ops_run
    lp = [r for r in out["ops"] if r["kernel"] == "field_chain_lp"]
    assert [r["op"] for r in lp] == list(F.FIELD_LP_OPS) == ["mul", "sqr"]
    assert all(r["threads_per_lane"] == 8 and r["k"] == list(MB.FIELD_K)
               for r in lp)
    assert [r["kernel"] for r in out["ops"]].index("field_chain_lp") == \
        len(F.FIELD_OPS)
    for r in out["ops"]:
        assert r["int_ops_per_op"] == MB.OPS_PER_STEP[r["op"]] * N == \
            MB.int_ops(r["op"], 1, N)
        assert r["bound_us_per_op"] is None
    assert MB.int_ops("mul", 192, 4096) == 4096 * 192 * 100
    assert MB.int_rate(torch.device("cpu"), 1980.0) is None
    assert "field_chain_lp times" in text.splitlines()[0]


def test_inputs_are_the_jax_scripts_draw(raw, port_in):
    a, b = MB.inputs(N, "cpu")
    assert torch.equal(a, port_in[0]) and torch.equal(b, port_in[1])
    assert _port_values(a) == [_value13(raw[0][:, j]) for j in range(N)]


def test_entry_point_e2e_on_the_cpu(capsys):
    """--e2e at a few requests: every row's data verifies through the
    plain versions, one row per JAX row."""
    out = MB.main(["--device", "cpu", "--e2e", "--n-ed", "4", "--n-vrf",
                   "2", "--n-kes", "2", "--reps", "1"])
    names = [r["name"].split(" n=")[0] for r in out["e2e"]]
    assert names == ["ed prepare_words_batch", "ed ed25519_verify",
                     "ed h2d transfer", "vrf _prepare_words",
                     "vrf vrf_verify", "vrf _finish",
                     "beta _prepare_betas_words", "beta gamma8",
                     "beta _finish_betas", "kes split_mixed (host hash path)"]
    assert all(r["time_from"] == "host" and r["ms"] > 0 for r in out["e2e"])
    assert "ops" not in out


def test_csrc_compare_needs_the_card_and_feeds_every_kernel():
    """The source-variant comparison raises without a card before it
    builds anything, and its random inputs suit every kernel: each
    tensor is of the wrapper's type and lane count (the chains, kes_hash
    and the fold run through their plain versions here; the fold's n
    lanes are its VRF lanes, beside its buffer's other parts)."""
    from ouroboros_tpu_torch import csrc_compare as CC
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CC.main(["no-such-dir"])
    assert set(CC.CHAIN_OPS) == {name for name, _o, _k in MB.CHAINS}
    rng = np.random.default_rng(3)
    for name in K.KERNELS:
        args = CC.random_args(name, rng, "cpu", 5)
        tensors = [a for a in args if torch.is_tensor(a)]
        if name == "window_fold":
            _packed, ne, nv, nb, nk = args[:5]
            assert nv == 5
            assert [(t.dtype, tuple(t.shape)) for t in tensors] == [
                (torch.uint8, (ne + 130 * nv + 33 * nb + nk,)),
                (torch.int32, (ne,)), (torch.int32, (nv,)),
                (torch.uint8, (nv, 32)), (torch.uint8, (nv, 16))]
            assert torch.equal(K.window_fold(*args),
                               K.KERNELS[name].plain(*args))
            continue
        assert all(t.shape[-1] == 5 for t in tensors), name
        assert all(t.dtype in (torch.uint32, torch.int32)
                   for t in tensors), name
        if name in CC.CHAIN_OPS or name == "kes_hash":
            got = getattr(K, name)(*args)
            assert torch.equal(got, K.KERNELS[name].plain(*args)), name


def test_sass_counts_splits_chain_kernels_and_counts_kes_hash():
    """`sass_counts` reads the chain kernels (keyed by their mangled
    names) and kes_hash_kernel out of a `cuobjdump -sass` listing, splits
    a kernel at its CALL.REL targets, and leaves out NOPs and every other
    function."""
    from ouroboros_tpu_torch import csrc_compare as CC

    def ins(addr, text):
        return f"        /*{addr:04x}*/                   {text} ;"
    listing = "\n".join([
        "\t\tFunction : _Z15kes_hash_kernelPKjS0_Pii",
        ins(0x0, "LDG.E R2, desc[UR4][R2.64]"),
        ins(0x10, "IADD3 R4, P0, P1, R2, R6, R8"),
        ins(0x20, "SHF.R.W.U32.HI R5, R4, 0x18, R7"),
        ins(0x30, "@!P0 SHFL.BFLY PT, R9, R4, 0x1, 0x1f"),
        ins(0x40, "NOP"),
        ins(0x50, "IMAD.X R5, RZ, RZ, R7, P0"),
        "\t\tFunction : _Z18field_chain_kernelPKiS0_Piiii",
        ins(0x0, "CALL.REL.NOINC 0x20"),
        ins(0x10, "EXIT"),
        ins(0x20, "IMAD.WIDE R2, R4, R5, RZ"),
        ins(0x30, "RET.REL.NODEC R20 0x0"),
        "\t\tFunction : _Z12other_kernelv",
        ins(0x0, "IADD3 R1, R1, 0x1, RZ"),
    ])
    got = CC.sass_counts(listing)
    assert set(got) == {"kes_hash_kernel", "_Z18field_chain_kernel"}
    (start, n, cls), = got["kes_hash_kernel"]
    assert (start, n) == (0, 5)
    assert (cls["LDG"], cls["IADD3"], cls["SHF"], cls["SHFL"],
            cls["IMAD.X"], cls["IMAD.WIDE"]) == (1, 1, 1, 1, 1, 0)
    assert [(a, k) for a, k, _c in got["_Z18field_chain_kernel"]] == \
        [(0, 2), (0x20, 2)]
    assert got["_Z18field_chain_kernel"][1][2]["IMAD.WIDE"] == 1
