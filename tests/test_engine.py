"""JAX engine tests (CPU backend, 8 virtual devices): limb field
arithmetic, complete EC formulas, NTT, MSM, h(x) pipeline -- all
cross-checked against the exact host implementations.

XLA:CPU compiles these kernel graphs pathologically slowly (~30s for a
handful of Montgomery muls), so pure-correctness tests run in EAGER
mode (identical numerics, no compile); the compiled path keeps two
jitted canaries here plus the slow-marked kernel suite (--runslow)."""

import random
from contextlib import contextmanager

import numpy as np
import pytest

jax = pytest.importorskip("jax")


@contextmanager
def eager():
    """Disable jit within a block: correctness without XLA compiles."""
    prev = jax.config.jax_disable_jit
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", prev)


@pytest.fixture(autouse=True)
def _eager_by_default(request):
    """Every test in this module runs eager unless marked 'compiled'."""
    if request.node.get_closest_marker("compiled"):
        yield
        return
    with eager():
        yield

import za_tpu.engine.ec as EC
import za_tpu.engine.field as F
import za_tpu.engine.ntt as NTT
from za_tpu.curve import (
    G1_GEN, G2_GEN, Q, R, g1_add, g1_mul, g1_neg, g2_add, g2_mul,
)
from za_tpu.engine.ec import G1_OPS, G2_OPS, point_add
from za_tpu.engine.engine import TpuEngine
from za_tpu.groth16.domain import Domain
from za_tpu.groth16.prove import HostEngine

rng = random.Random(1234)


def rand_fr(n):
    return [rng.randrange(R) for _ in range(n)]


# -- field -------------------------------------------------------------------


def test_limb_roundtrip():
    vals = [0, 1, R - 1, 2**255 - 1, 12345678901234567890]
    limbs = F.ints_to_limbs(vals)
    assert F.limbs_to_ints(limbs) == vals


@pytest.mark.compiled
def test_mont_mul_matches_host():
    n = 33
    a_v, b_v = rand_fr(n), rand_fr(n)
    a, b = F.ints_to_limbs(a_v), F.ints_to_limbs(b_v)

    @jax.jit
    def run(a, b):
        return F.from_mont(
            F.mont_mul(F.to_mont(a, F.FR), F.to_mont(b, F.FR), F.FR), F.FR
        )

    assert F.limbs_to_ints(np.asarray(run(a, b))) == [
        x * y % R for x, y in zip(a_v, b_v)
    ]


def test_add_sub_neg_edges():
    vals = [0, 1, R - 1, R - 2, (R - 1) // 2]
    a = F.ints_to_limbs(vals)
    b = F.ints_to_limbs(list(reversed(vals)))
    got_add = F.limbs_to_ints(np.asarray(jax.jit(
        lambda x, y: F.add_mod(x, y, F.FR))(a, b)))
    assert got_add == [(x + y) % R for x, y in zip(vals, reversed(vals))]
    got_sub = F.limbs_to_ints(np.asarray(jax.jit(
        lambda x, y: F.sub_mod(x, y, F.FR))(a, b)))
    assert got_sub == [(x - y) % R for x, y in zip(vals, reversed(vals))]
    got_neg = F.limbs_to_ints(np.asarray(jax.jit(
        lambda x: F.neg_mod(x, F.FR))(a)))
    assert got_neg == [(-x) % R for x in vals]


def test_mont_inv():
    vals = [1, 2, R - 1, 987654321]
    a = F.ints_to_limbs(vals)

    @jax.jit
    def run(a):
        return F.from_mont(F.mont_inv(F.to_mont(a, F.FR), F.FR), F.FR)

    assert F.limbs_to_ints(np.asarray(run(a))) == [pow(v, -1, R) for v in vals]


def test_fq2_mul():
    n = 9
    a0, a1 = rand_fr(n), rand_fr(n)
    b0, b1 = rand_fr(n), rand_fr(n)

    @jax.jit
    def run(a0, a1, b0, b1):
        A = (F.to_mont(a0, F.FQ), F.to_mont(a1, F.FQ))
        B = (F.to_mont(b0, F.FQ), F.to_mont(b1, F.FQ))
        C = F.fq2_mul(A, B)
        return F.from_mont(C[0], F.FQ), F.from_mont(C[1], F.FQ)

    c0, c1 = run(*(F.ints_to_limbs(v) for v in (a0, a1, b0, b1)))
    assert F.limbs_to_ints(np.asarray(c0)) == [
        (x0 * y0 - x1 * y1) % Q for x0, x1, y0, y1 in zip(a0, a1, b0, b1)
    ]
    assert F.limbs_to_ints(np.asarray(c1)) == [
        (x0 * y1 + x1 * y0) % Q for x0, x1, y0, y1 in zip(a0, a1, b0, b1)
    ]


# -- EC ----------------------------------------------------------------------


def test_g1_complete_add():
    ks = [rng.randrange(1, R) for _ in range(8)]
    ls = [rng.randrange(1, R) for _ in range(8)]
    P = [g1_mul(G1_GEN, k) for k in ks]
    Qp = [g1_mul(G1_GEN, l) for l in ls]
    P[0] = None          # O + Q
    Qp[1] = None         # P + O
    Qp[2] = P[2]         # doubling
    Qp[3] = g1_neg(P[3])  # P + (-P) = O
    X, Y, Z = jax.jit(lambda a, b: point_add(a, b, G1_OPS))(
        EC.g1_points_to_device(P), EC.g1_points_to_device(Qp)
    )
    for j in range(8):
        got = EC.g1_point_from_device(
            np.asarray(X)[:, j], np.asarray(Y)[:, j], np.asarray(Z)[:, j]
        )
        assert got == g1_add(P[j], Qp[j])


def test_g2_complete_add():
    ks = [rng.randrange(1, R) for _ in range(4)]
    ls = [rng.randrange(1, R) for _ in range(4)]
    P = [g2_mul(G2_GEN, k) for k in ks]
    Qp = [g2_mul(G2_GEN, l) for l in ls]
    P[0] = None
    Qp[1] = None
    Qp[2] = P[2]
    X, Y, Z = jax.jit(lambda a, b: point_add(a, b, G2_OPS))(
        EC.g2_points_to_device(P), EC.g2_points_to_device(Qp)
    )

    def sf(c, j):
        return (np.asarray(c[0])[:, j], np.asarray(c[1])[:, j])

    for j in range(4):
        got = EC.g2_point_from_device(sf(X, j), sf(Y, j), sf(Z, j))
        assert got == g2_add(P[j], Qp[j])


# -- NTT ---------------------------------------------------------------------


def test_device_ntt_matches_host():
    m = 32
    dom = Domain(m)
    ddom = NTT.DeviceDomain(m)
    coeffs = rand_fr(m)
    cm = F.ints_to_limbs([F.FR.to_mont_int(c) for c in coeffs])

    def demont(x):
        return [F.FR.from_mont_int(v) for v in F.limbs_to_ints(np.asarray(x))]

    fwd = jax.jit(lambda x: NTT.ntt(ddom, x))(cm)
    assert demont(fwd) == dom.ntt(coeffs)
    inv = jax.jit(lambda x: NTT.intt(ddom, x))(fwd)
    assert demont(inv) == coeffs
    cf = jax.jit(lambda x: NTT.coset_ntt(ddom, x))(cm)
    assert demont(cf) == dom.coset_ntt(coeffs)
    ci = jax.jit(lambda x: NTT.coset_intt(ddom, x))(cf)
    assert demont(ci) == coeffs


# -- MSM ---------------------------------------------------------------------


@pytest.mark.compiled
def test_msm_g1_matches_host():
    host = HostEngine()
    n = 40
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[3] = None
    scs = rand_fr(n)
    scs[5] = 0
    eng = TpuEngine(lanes=8)
    assert eng.msm_g1(pts, scs) == host.msm_g1(pts, scs)


@pytest.mark.compiled
@pytest.mark.slow
def test_msm_g2_matches_host():
    host = HostEngine()
    n = 10
    pts = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(n)]
    scs = rand_fr(n)
    eng = TpuEngine(lanes=8)
    assert eng.msm_g2(pts, scs) == host.msm_g2(pts, scs)


@pytest.mark.compiled
@pytest.mark.slow
def test_msm_grouped_matches_host():
    """Window-parallel grouped MSM (the grouped prove path: all four G1
    queries in one kernel) against the host golden model, including
    identity points, zero scalars, staged arrays, and limb scalars."""
    host = HostEngine()
    n = 24
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[2] = None
    scs = rand_fr(n)
    scs[7] = 0
    eng = TpuEngine(lanes=8, window=8)
    staged = eng.stage_g1(pts)
    scs_limbs = F.ints_to_limbs(scs[:16])
    got = eng.msm_g1_many(
        [pts, staged, pts[:16]], [scs, scs, scs_limbs]
    )
    assert got[0] == host.msm_g1(pts, scs)
    assert got[1] == host.msm_g1(pts, scs)
    assert got[2] == host.msm_g1(pts[:16], scs[:16])


@pytest.mark.compiled
@pytest.mark.slow
def test_msm_grouped_g2_matches_host():
    host = HostEngine()
    n = 6
    pts = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(n)]
    scs = rand_fr(n)
    eng = TpuEngine(lanes=8, window=8)
    got = eng.msm_g2_many([pts], [scs])
    assert got[0] == host.msm_g2(pts, scs)


@pytest.mark.compiled
@pytest.mark.slow
def test_msm_dense_matches_host():
    """Scatter-free dense radix-4 limb MSM."""
    host = HostEngine()
    n = 20
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[4] = None
    scs = rand_fr(n)
    scs[1] = 0
    scs[2] = R - 1
    eng = TpuEngine(msm_style="dense")
    eng.use_grouped = True
    got = eng.msm_g1_many([pts, pts[:12]], [scs, scs[:12]])
    assert got[0] == host.msm_g1(pts, scs)
    assert got[1] == host.msm_g1(pts[:12], scs[:12])


@pytest.mark.compiled
@pytest.mark.slow
def test_msm_dense_g2_matches_host():
    host = HostEngine()
    n = 5
    pts = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(n)]
    scs = rand_fr(n)
    eng = TpuEngine(msm_style="dense")
    eng.use_grouped = True
    got = eng.msm_g2_many([pts], [scs])
    assert got[0] == host.msm_g2(pts, scs)


# -- full prover pipeline ----------------------------------------------------


@pytest.mark.compiled
@pytest.mark.slow
def test_tpu_engine_prove_matches_host():
    from za_tpu.algebra import FS, Value
    from za_tpu.compiler import Evaluator, Mode
    from za_tpu.compiler.evaluator import Scope
    from za_tpu.groth16 import R1CS, generate_parameters, prove, verify_proof

    circuit = """
    template chain(N) {
        signal input x;
        signal output out;
        signal t[N];
        t[0] <== x * x;
        for (var i=1;i<N;i+=1) {
            t[i] <== t[i-1] * x + i;
        }
        out <== t[N-1];
    }
    component main = chain(6);
    """
    ev = Evaluator(Mode.GEN_CONSTRAINTS)
    ev.eval_inline(Scope(True, None, "root"), circuit)
    r1cs = R1CS.from_constraints(ev.signals, ev.constraints, [])
    evw = Evaluator(Mode.GEN_WITNESS)
    evw.set_deferred_value("main.x", Value(FS(3)))
    evw.eval_inline(Scope(True, None, "root"), circuit)
    z = r1cs.assignment_from_signals(evw.signals)

    params = generate_parameters(r1cs, tau=11, alpha=3, beta=5, gamma=7, delta=9)
    dom = Domain(params.domain_size)
    host = HostEngine()
    eng = TpuEngine(lanes=8)

    assert eng.h_coeffs(r1cs, z, dom) == host.h_coeffs(r1cs, z, dom)

    p_dev = prove(params, r1cs, z, r=13, s=17, engine=eng)
    p_host = prove(params, r1cs, z, r=13, s=17, engine=host)
    assert (p_dev.a, p_dev.b, p_dev.c) == (p_host.a, p_host.b, p_host.c)
    assert verify_proof(params.vk, p_dev, z[1 : r1cs.num_inputs])


# -- fixed-base scalar multiplication (setup path) ---------------------------


@pytest.mark.compiled
@pytest.mark.slow
def test_fixed_base_g1():
    import za_tpu.engine.msm as MSM
    from za_tpu.engine.ec import G1_OPS

    base = EC.g1_points_to_device([G1_GEN])
    c = 5
    tbl = jax.jit(lambda b: MSM.fixed_base_table(b, G1_OPS, c))(base)
    scs = [0, 1, 2, R - 1, 123456789]
    X, Y, Z = jax.jit(
        lambda t, s: MSM.fixed_base_msm(t, s, G1_OPS, c)
    )(tbl, F.ints_to_limbs(scs))
    for j, s in enumerate(scs):
        got = EC.g1_point_from_device(
            np.asarray(X)[:, j], np.asarray(Y)[:, j], np.asarray(Z)[:, j]
        )
        assert got == g1_mul(G1_GEN, s)


@pytest.mark.compiled
@pytest.mark.slow
def test_device_setup_matches_host():
    from za_tpu.algebra import FS, Value
    from za_tpu.compiler import Evaluator, Mode
    from za_tpu.compiler.evaluator import Scope
    from za_tpu.groth16 import R1CS, generate_parameters

    circuit = """
    template t() {
        signal private input a;
        signal private input b;
        signal output c;
        c <== a * b;
    }
    component main = t();
    """
    ev = Evaluator(Mode.GEN_CONSTRAINTS)
    ev.eval_inline(Scope(True, None, "root"), circuit)
    r1cs = R1CS.from_constraints(ev.signals, ev.constraints, [])
    eng = TpuEngine(lanes=8)
    kw = dict(tau=11, alpha=3, beta=5, gamma=7, delta=9)
    p_dev = generate_parameters(r1cs, engine=eng, **kw)
    p_host = generate_parameters(r1cs, **kw)
    assert p_dev.a == p_host.a
    assert p_dev.b_g2 == p_host.b_g2
    assert p_dev.h == p_host.h
    assert p_dev.l == p_host.l
    assert p_dev.vk.ic == p_host.vk.ic
    assert p_dev.vk.alpha_g1 == p_host.vk.alpha_g1


def test_stacked_staging_msm_matches_host():
    """stage_g1_stacked / stage_g2_stacked + the pre-stacked msm path
    (zero per-call staging) agree with the exact host engine."""
    import jax.numpy as jnp

    from za_tpu.groth16.prove import HostEngine

    rng2 = random.Random(21)
    n, M = 64, 2
    pts = [g1_mul(G1_GEN, rng2.randrange(1, R)) for _ in range(n)]
    scs = [[rng2.randrange(R) for _ in range(n)] for _ in range(M)]

    eng = TpuEngine(msm_style="rns", lanes=16)
    stacked = eng.stage_g1_stacked([pts, pts])
    got = eng.msm_g1_many(stacked, scs)
    host = HostEngine()
    for i in range(M):
        assert got[i] == host.msm_g1(pts, scs[i])

    from za_tpu.curve import G2_GEN, g2_mul

    pts2 = [g2_mul(G2_GEN, rng2.randrange(1, R)) for _ in range(16)]
    pts2 = [pts2[i % 16] for i in range(n)]
    st2 = eng.stage_g2_stacked([pts2])
    got2 = eng.msm_g2_many(st2, [scs[0]])[0]
    assert got2 == host.msm_g2(pts2, scs[0])
