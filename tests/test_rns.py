"""RNS field engine tests (za_tpu.engine.rns): differential against
exact Python integers, including the bound contracts, the approximate
(ext1) and exact (ext2) CRT base extensions, and the RNS-backed
complete EC group law. All eager (see test_engine.py header)."""

import random
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest

jax = pytest.importorskip("jax")


@contextmanager
def eager():
    prev = jax.config.jax_disable_jit
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", prev)


@pytest.fixture(autouse=True)
def _eager_by_default(request):
    if request.node.get_closest_marker("compiled"):
        yield
        return
    with eager():
        yield


import za_tpu.engine.ec as EC
import za_tpu.engine.rns as RNS
from za_tpu.curve import (
    G1_GEN, G2_GEN, Q, R, g1_add, g1_mul, g1_neg, g2_add, g2_mul,
)
from za_tpu.engine.rns import RQ, RR

rng = random.Random(99)
N = Q
BOUND = 512 * N  # mont_mul input contract


def test_conversion_roundtrip():
    vals = [0, 1, N - 1, 2**255 - 19, BOUND - 1] + [
        rng.randrange(BOUND) for _ in range(5)
    ]
    assert RQ.rns_to_ints(RQ.ints_to_rns(vals)) == vals
    assert RR.rns_to_ints(RR.ints_to_rns(vals[:4])) == vals[:4]


@pytest.mark.parametrize("ctx", [RQ, RR], ids=["fq", "fr"])
def test_mont_mul_matches_ints(ctx):
    mod, M1 = ctx.modulus, ctx.m1
    tests = [(rng.randrange(BOUND), rng.randrange(BOUND)) for _ in range(40)]
    tests += [(0, 0), (1, 1), (BOUND - 1, BOUND - 1), (mod, mod),
              (0, BOUND - 1), (M1 % mod, 1)]
    a = ctx.ints_to_rns([t[0] for t in tests])
    b = ctx.ints_to_rns([t[1] for t in tests])
    got = ctx.rns_to_ints(np.asarray(RNS.mont_mul_rns(a, b, ctx)))
    m1inv = pow(M1, -1, mod)
    for (A, B), G in zip(tests, got):
        assert G % mod == A * B * m1inv % mod
        assert G < 4 * mod, "output bound contract violated"


def test_add_sub_semantics():
    x = RQ.ints_to_rns([5 * N + 3, 7])
    y = RQ.ints_to_rns([2 * N + 1, 30 * N])
    assert RQ.rns_to_ints(np.asarray(RNS.ch_add(x, y, RQ))) == [
        7 * N + 4, 30 * N + 7
    ]
    assert RQ.rns_to_ints(np.asarray(RNS.ch_sub_off(x, y, RQ))) == [
        35 * N + 2, 2 * N + 7
    ]
    # the 8N-offset variant used inside the Fq2 multiply
    z = RQ.ints_to_rns([4 * N])
    w = RQ.ints_to_rns([N + 5])
    assert RQ.rns_to_ints(
        np.asarray(RNS.ch_sub_off(z, w, RQ, off_vec=RQ.sub_off8))
    ) == [11 * N - 5]


def test_mont_form_roundtrip():
    vs = [0, 1, N - 1] + [rng.randrange(N) for _ in range(5)]
    m = RNS.to_mont_rns(RQ.ints_to_rns(vs), RQ)
    got = RQ.rns_to_ints(np.asarray(m))
    assert all(g % N == v * RQ.m1 % N for g, v in zip(got, vs))
    p = RNS.from_mont_rns(m, RQ)
    assert all(
        g % N == v for g, v in zip(RQ.rns_to_ints(np.asarray(p)), vs)
    )


def test_limbs_to_rns_matches_host():
    import za_tpu.engine.field as F

    vals = [0, 1, 2**256 - 1] + [rng.randrange(2**256) for _ in range(5)]
    got = np.asarray(RNS.limbs_to_rns(F.ints_to_limbs(vals), RQ))
    assert np.array_equal(got, RQ.ints_to_rns(vals))


def test_mont_mul_stress():
    """Batch stress incl. the Kawamura alpha-hat boundary behavior."""
    n = 512
    As = [rng.randrange(BOUND) for _ in range(n)]
    Bs = [rng.randrange(BOUND) for _ in range(n)]
    got = RQ.rns_to_ints(
        np.asarray(
            RNS.mont_mul_rns(RQ.ints_to_rns(As), RQ.ints_to_rns(Bs), RQ)
        )
    )
    m1inv = pow(RQ.m1, -1, N)
    for A, B, G in zip(As, Bs, got):
        assert G % N == A * B * m1inv % N and G < 4 * N


# -- RNS EC group law ---------------------------------------------------------


def _g1_from(X, Y, Z, j):
    return EC.g1_point_from_rns(
        np.asarray(X)[:, j], np.asarray(Y)[:, j], np.asarray(Z)[:, j]
    )


def test_g1_rns_complete_add_and_chain():
    ops = EC.make_g1_ops_rns()
    ks = [rng.randrange(1, R) for _ in range(8)]
    ls = [rng.randrange(1, R) for _ in range(8)]
    P = [g1_mul(G1_GEN, k) for k in ks]
    Qp = [g1_mul(G1_GEN, l) for l in ls]
    P[0] = None
    Qp[1] = None
    Qp[2] = P[2]
    Qp[3] = g1_neg(P[3])
    A = EC.g1_points_to_rns(P)
    B = EC.g1_points_to_rns(Qp)
    X, Y, Z = EC.point_add(A, B, ops)
    for j in range(8):
        assert _g1_from(X, Y, Z, j) == g1_add(P[j], Qp[j])

    # 10 chained adds: the stationary-bound argument in rns.py holds
    acc = (X, Y, Z)
    exp = [g1_add(P[j], Qp[j]) for j in range(8)]
    for _ in range(10):
        acc = EC.point_add(acc, B, ops)
        exp = [g1_add(e, q) for e, q in zip(exp, Qp)]
    for j in range(8):
        assert _g1_from(*acc, j) == exp[j]


def test_g2_rns_complete_add_and_chain():
    ops = EC.make_g2_ops_rns()
    P = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(4)]
    Qp = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(4)]
    P[0] = None
    Qp[1] = None
    Qp[2] = P[2]
    A = EC.g2_points_to_rns(P)  # flat-Fq2 leaves (35, 2, 4)
    B = EC.g2_points_to_rns(Qp)
    pt = EC.point_add(A, B, ops)

    def from_j(pt, j):
        X, Y, Z = pt
        return EC.g2_point_from_rns(
            np.asarray(X)[:, :, j], np.asarray(Y)[:, :, j],
            np.asarray(Z)[:, :, j],
        )

    exp = [g2_add(P[j], Qp[j]) for j in range(4)]
    for j in range(4):
        assert from_j(pt, j) == exp[j]

    for _ in range(6):
        pt = EC.point_add(pt, B, ops)
        exp = [g2_add(e, q) for e, q in zip(exp, Qp)]
    for j in range(4):
        assert from_j(pt, j) == exp[j]


def test_point_identity_like_rns():
    ops = EC.make_g1_ops_rns()
    coord = np.zeros((RNS.N_CH, 3), dtype=np.uint32)
    X, Y, Z = EC.point_identity_like(coord, ops, is_g2=False)
    assert _g1_from(X, Y, Z, 0) is None
    P = [g1_mul(G1_GEN, 5)]
    A = EC.g1_points_to_rns(P)
    ident = EC.point_identity_like(A[0][:, :1], ops, is_g2=False)
    S = EC.point_add(A, ident, ops)
    assert _g1_from(*S, 0) == P[0]


@pytest.mark.compiled
@pytest.mark.slow
def test_rns_engine_prove_matches_host():
    """TpuEngine(msm_style='rns'): the full RNS prover pipeline
    (RNS matvec + RNS coset NTTs + exact CRT-out scalars + signed-dense
    RNS MSMs) produces the host engine's deterministic proof."""
    from za_tpu.algebra import FS, Value
    from za_tpu.compiler import Evaluator, Mode
    from za_tpu.compiler.evaluator import Scope
    from za_tpu.engine.engine import TpuEngine
    from za_tpu.groth16 import (
        R1CS, generate_parameters, prove, verify_proof,
    )
    from za_tpu.groth16.domain import Domain
    from za_tpu.groth16.prove import HostEngine

    circuit = """
    template chain(N) {
        signal input x;
        signal output out;
        signal t[N];
        t[0] <== x * x;
        for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * x + i; }
        out <== t[N-1];
    }
    component main = chain(13);
    """
    ev = Evaluator(Mode.GEN_CONSTRAINTS)
    ev.eval_inline(Scope(True, None, "root"), circuit)
    r1cs = R1CS.from_constraints(ev.signals, ev.constraints, [])
    evw = Evaluator(Mode.GEN_WITNESS)
    evw.set_deferred_value("main.x", Value(FS(3)))
    evw.eval_inline(Scope(True, None, "root"), circuit)
    z = r1cs.assignment_from_signals(evw.signals)
    params = generate_parameters(r1cs, tau=11, alpha=3, beta=5, gamma=7,
                                 delta=9)
    dom = Domain(params.domain_size)
    host = HostEngine()
    eng = TpuEngine(msm_style="rns", lanes=8)
    assert eng.h_coeffs(r1cs, z, dom) == host.h_coeffs(r1cs, z, dom)
    p1 = prove(params, r1cs, z, r=13, s=17, engine=eng)
    p2 = prove(params, r1cs, z, r=13, s=17, engine=host)
    assert (p1.a, p1.b, p1.c) == (p2.a, p2.b, p2.c)
    assert verify_proof(params.vk, p1, z[1 : r1cs.num_inputs])


def test_rns_to_limbs_exact():
    """Device CRT-out: exact S-K conversion incl. the mod-r descent."""
    vals = [0, 1, RR.m1 - 1, 2**255] + [
        rng.randrange(RR.m1) for _ in range(8)
    ]
    import za_tpu.curve as C

    out = np.asarray(RNS.rns_to_limbs_exact(RR.ints_to_rns(vals), RR,
                                            nlimbs=18))
    got = [sum(int(out[i, j]) << (16 * i) for i in range(18))
           for j in range(len(vals))]
    assert got == vals
    vals2 = [0, C.R - 1, C.R, 8 * C.R - 1] + [
        rng.randrange(8 * C.R) for _ in range(8)
    ]
    out2 = np.asarray(RNS.rns_to_limbs_exact(
        RR.ints_to_rns(vals2), RR, nlimbs=16, reduce_mod=C.R))
    got2 = [sum(int(out2[i, j]) << (16 * i) for i in range(16))
            for j in range(len(vals2))]
    assert got2 == [v % C.R for v in vals2]


def test_rns_ntt_matches_host():
    import za_tpu.engine.ntt_rns as NR
    from za_tpu.curve import R as FR_MOD
    from za_tpu.groth16.domain import Domain

    m = 32
    dom = Domain(m)
    rd = NR.RnsDomain(m)
    coeffs = [rng.randrange(FR_MOD) for _ in range(m)]
    cm = RR.ints_to_rns([c * RR.m1 % FR_MOD for c in coeffs])

    def demont(x):
        vals = RR.rns_to_ints(np.asarray(x))
        return [RR.from_mont_int(v) % FR_MOD for v in vals]

    fwd = NR.ntt(rd, cm)
    assert demont(fwd) == dom.ntt(coeffs)
    assert demont(NR.intt(rd, fwd)) == coeffs
    cf = NR.coset_ntt(rd, cm)
    assert demont(cf) == dom.coset_ntt(coeffs)
    assert demont(NR.coset_intt(rd, cf)) == coeffs


def test_rns_fourstep_matches_unrolled():
    """The four-step RNS NTT core (the gpu profile's layout) computes the same
    transform as the 2D unrolled core, forward and inverse."""
    import za_tpu.engine.ntt_rns as NR
    from za_tpu.curve import R as FR_MOD
    from za_tpu.groth16.domain import Domain

    m = 64
    dom = Domain(m)
    fs = NR.RnsFourStep(m, dom.omega, dom.size_inv)
    rd = NR.RnsDomain(m)
    coeffs = [rng.randrange(FR_MOD) for _ in range(m)]
    cm = RR.ints_to_rns([c * RR.m1 % FR_MOD for c in coeffs])

    def demont(x):
        vals = RR.rns_to_ints(np.asarray(x))
        return [RR.from_mont_int(v) % FR_MOD for v in vals]

    fwd = NR._fourstep_core(
        jnp.asarray(cm), fs.t2_fwd, fs.t1_fwd, fs.inter_fwd, fs.n1, fs.n2
    )
    assert demont(fwd) == dom.ntt(coeffs)
    inv = NR._fourstep_core(
        jnp.asarray(fwd), fs.t2_inv, fs.t1_inv, fs.inter_inv, fs.n1, fs.n2
    )
    assert demont(inv) == coeffs  # 1/n folded into inter_inv


def test_geom_table_matches_pow_list():
    """Device-built geometric tables == host big-int tables (the 2^21
    domain builds these on device; correctness pinned here)."""
    import numpy as np

    import za_tpu.engine.ntt_rns as NR
    from za_tpu.curve import R

    g = 22222
    want = NR._mont_table(NR._pow_list(g, 100))
    got = np.asarray(NR.geom_table(g, 100))
    assert np.array_equal(got, want)
    # with a scale factor (the non-fourstep inverse coset table)
    s = 987654321
    want = NR._mont_table([s * pow(g, i, R) % R for i in range(33)])
    got = np.asarray(NR.geom_table(g, 33, scale=s))
    assert np.array_equal(got, want)


def test_fourstep_inter_table_device_build():
    import numpy as np

    import za_tpu.engine.ntt_rns as NR
    from za_tpu.curve import R
    from za_tpu.groth16.domain import Domain

    size = 1 << 6
    h = Domain(size)
    fs = NR.RnsFourStep.__new__(NR.RnsFourStep)
    fs.n1 = 8
    fs.n2 = 8
    got = np.asarray(fs._inter(h.omega, 1))
    for k2 in range(8):
        row = NR._mont_table(
            [pow(h.omega, k2 * j1, R) for j1 in range(8)]
        )
        assert np.array_equal(got[:, k2, :], row), k2


@pytest.mark.gpu
def test_mont_mul_small_batches_on_card(gpu_backend):
    """Op-by-op and jitted RNS multiplies at small batches match
    XLA:CPU on the GPU (XLA:GPU's int8 dot got these wrong)."""
    import jax

    cpu = jax.devices("cpu")[0]
    vals = [rng.randrange(512 * RR.modulus) for _ in range(64)]
    a, b = RR.ints_to_rns(vals), RR.ints_to_rns(vals[::-1])
    fn = jax.jit(lambda x, y: RNS.mont_mul_rns(x, y, RR))
    for k in (1, 2, 3, 8, 64):
        want = np.asarray(fn(jax.device_put(a[:, :k], cpu),
                             jax.device_put(b[:, :k], cpu)))
        assert np.array_equal(np.asarray(fn(a[:, :k], b[:, :k])), want)
        eager = RNS.mont_mul_rns(jnp.asarray(a[:, :k]), jnp.asarray(b[:, :k]),
                                 RR)
        assert np.array_equal(np.asarray(eager), want)
