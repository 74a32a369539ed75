"""Differential tests for the batch-affine tree MSM (engine/msm_tree).

Golden model: exact host curve arithmetic (za_tpu.curve) -- the same
oracle the signed-dense MSM tests use.  Runs on the virtual-CPU
backend (the tree path is pure XLA, no Pallas)."""

import random

import numpy as np
import pytest

import jax.numpy as jnp

import za_tpu.engine.ec as EC
import za_tpu.engine.field as F
import za_tpu.engine.msm_tree as MT
import za_tpu.engine.rns as RNS
from za_tpu.curve import (
    G1_GEN, G2_GEN, Q, R, Fq2, g1_add, g1_mul, g2_add, g2_mul,
)


def _mont_rns(vals, ctx):
    return ctx.ints_to_rns([ctx.to_mont_int(v % ctx.modulus) for v in vals])


def test_fermat_inv_fq():
    ctx = RNS.RQ
    fld = MT.FqAdapter(ctx)
    rng = random.Random(1)
    vals = [rng.randrange(1, Q) for _ in range(8)]
    x = jnp.asarray(_mont_rns(vals, ctx))
    inv = np.asarray(fld.fermat_inv(x))
    got = [ctx.from_mont_int(v) % Q for v in ctx.rns_to_ints(inv)]
    assert got == [pow(v, -1, Q) for v in vals]


def test_fermat_inv_fq2():
    ctx = RNS.RQ
    fld = MT.Fq2Adapter(ctx)
    rng = random.Random(2)
    pairs = [(rng.randrange(1, Q), rng.randrange(0, Q)) for _ in range(6)]
    c0 = _mont_rns([a for a, _ in pairs], ctx)
    c1 = _mont_rns([b for _, b in pairs], ctx)
    x = jnp.stack([jnp.asarray(c0), jnp.asarray(c1)], axis=1)
    inv = np.asarray(fld.fermat_inv(x))
    for i, (a, b) in enumerate(pairs):
        want = Fq2(a, b).inv()
        g0 = ctx.from_mont_int(ctx.rns_to_ints(inv[:, 0, i:i + 1])[0]) % Q
        g1 = ctx.from_mont_int(ctx.rns_to_ints(inv[:, 1, i:i + 1])[0]) % Q
        assert (g0, g1) == (want.c0, want.c1)


@pytest.mark.parametrize("k", [16, 64, 1 << 13])
def test_batch_inv(k):
    ctx = RNS.RQ
    fld = MT.FqAdapter(ctx)
    rng = random.Random(3)
    vals = [rng.randrange(1, Q) for _ in range(k)]
    x = jnp.asarray(_mont_rns(vals, ctx))
    inv = np.asarray(MT.batch_inv(x, fld, tail=32))
    got = [ctx.from_mont_int(v) % Q for v in ctx.rns_to_ints(inv)]
    assert got == [pow(v, -1, Q) for v in vals]


def _host_msm_g1(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        if p is None or s % R == 0:
            continue
        t = g1_mul(p, s % R)
        acc = t if acc is None else g1_add(acc, t)
    return acc


def _host_msm_g2(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        if p is None or s % R == 0:
            continue
        t = g2_mul(p, s % R)
        acc = t if acc is None else g2_add(acc, t)
    return acc


def _stage_g1(points, chunk):
    staged = EC.g1_points_to_rns(points)
    staged = tuple(x[:, None, :] for x in staged)  # M = 1
    return MT.stage_affine_tables(
        staged, is_g2=False, n=len(points), chunk=chunk
    )


def _scalars_arr(scalars, m_axis=True):
    arr = F.ints_to_limbs([s % R for s in scalars])
    a = jnp.asarray(arr)
    return a[:, None, :] if m_axis else a


@pytest.mark.parametrize("n,chunk", [(32, 32), (64, 16), (96, 32)])
def test_tree_msm_g1_matches_host(n, chunk):
    rng = random.Random(7)
    points = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(0, R) for _ in range(n)]
    scalars[3] = 0  # zero scalar lane
    tabs = _stage_g1(points, chunk)
    ops = EC.make_g1_ops_rns()
    X, Y, Z = MT.msm_affine_tree(tabs, _scalars_arr(scalars), ops)
    got = EC.g1_point_from_rns(
        np.asarray(X)[:, 0], np.asarray(Y)[:, 0], np.asarray(Z)[:, 0]
    )
    assert got == _host_msm_g1(points, scalars)


def test_tree_msm_g1_tail_padding():
    """None tail padding with zero scalars (the pk staging layout)."""
    rng = random.Random(11)
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(20)]
    points = pts + [None] * 12
    scalars = [rng.randrange(0, R) for _ in range(20)] + [0] * 12
    tabs = _stage_g1(points, chunk=16)
    ops = EC.make_g1_ops_rns()
    X, Y, Z = MT.msm_affine_tree(tabs, _scalars_arr(scalars), ops)
    got = EC.g1_point_from_rns(
        np.asarray(X)[:, 0], np.asarray(Y)[:, 0], np.asarray(Z)[:, 0]
    )
    assert got == _host_msm_g1(points, scalars)


def test_tree_msm_g1_identity_with_live_scalars():
    """Interior None (identity) points carrying NONZERO scalars -- the
    pk-query shape after density filtering (setup stores None at
    non-dense slots while the witness scalar stays live).  Regression:
    the tree used to flag infinity only on digit==0, letting garbage
    staged table entries of identity columns enter the sum."""
    rng = random.Random(23)
    n = 32
    points = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    for i in (0, 5, 17, 30):  # interior identities
        points[i] = None
    scalars = [rng.randrange(1, R) for _ in range(n)]  # ALL nonzero
    tabs = _stage_g1(points, chunk=16)
    ops = EC.make_g1_ops_rns()
    X, Y, Z = MT.msm_affine_tree(tabs, _scalars_arr(scalars), ops)
    got = EC.g1_point_from_rns(
        np.asarray(X)[:, 0], np.asarray(Y)[:, 0], np.asarray(Z)[:, 0]
    )
    assert got == _host_msm_g1(points, scalars)


def test_tree_msm_g2_identity_with_live_scalars():
    """Same regression for the flat-Fq2 tree (b_g2 queries are
    density-filtered too)."""
    rng = random.Random(29)
    n = 16
    points = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(n)]
    for i in (1, 7, 12):
        points[i] = None
    scalars = [rng.randrange(1, R) for _ in range(n)]
    staged = EC.g2_points_to_rns(points)
    staged = tuple(x[:, :, None, :] for x in staged)
    tabs = MT.stage_affine_tables(staged, is_g2=True, n=n, chunk=8)
    ops = EC.make_g2_ops_rns()
    X, Y, Z = MT.msm_affine_tree(tabs, _scalars_arr(scalars), ops)
    got = EC.g2_point_from_rns(
        np.asarray(X)[:, :, 0], np.asarray(Y)[:, :, 0],
        np.asarray(Z)[:, :, 0],
    )
    assert got == _host_msm_g2(points, scalars)


def test_tree_msm_g1_grouped():
    """M = 2 same-table-size queries in one call."""
    rng = random.Random(13)
    n = 32
    p1 = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    p2 = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    s1 = [rng.randrange(0, R) for _ in range(n)]
    s2 = [rng.randrange(0, R) for _ in range(n)]
    st1 = EC.g1_points_to_rns(p1)
    st2 = EC.g1_points_to_rns(p2)
    staged = tuple(
        jnp.stack([a, b], axis=1) for a, b in zip(st1, st2)
    )
    tabs = MT.stage_affine_tables(staged, is_g2=False, n=n, chunk=16)
    sc = jnp.stack(
        [jnp.asarray(F.ints_to_limbs(s1)), jnp.asarray(F.ints_to_limbs(s2))],
        axis=1,
    )
    ops = EC.make_g1_ops_rns()
    X, Y, Z = MT.msm_affine_tree(tabs, sc, ops)
    for i, (pp, ss) in enumerate(((p1, s1), (p2, s2))):
        got = EC.g1_point_from_rns(
            np.asarray(X)[:, i], np.asarray(Y)[:, i], np.asarray(Z)[:, i]
        )
        assert got == _host_msm_g1(pp, ss)


@pytest.mark.parametrize("n,chunk", [(32, 16)])
def test_tree_msm_g2_matches_host(n, chunk):
    rng = random.Random(17)
    points = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(0, R) for _ in range(n)]
    staged = EC.g2_points_to_rns(points)
    staged = tuple(x[:, :, None, :] for x in staged)  # (35, 2, 1, n)
    tabs = MT.stage_affine_tables(staged, is_g2=True, n=n, chunk=chunk)
    ops = EC.make_g2_ops_rns()
    X, Y, Z = MT.msm_affine_tree(tabs, _scalars_arr(scalars), ops)
    got = EC.g2_point_from_rns(
        np.asarray(X)[:, :, 0], np.asarray(Y)[:, :, 0],
        np.asarray(Z)[:, :, 0],
    )
    assert got == _host_msm_g2(points, scalars)


def test_tree_matches_signed_dense():
    """Cross-check against the production signed-dense MSM on the
    same inputs (both must equal the host oracle and each other)."""
    import za_tpu.engine.msm as MSM

    rng = random.Random(19)
    n = 64
    points = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(0, R) for _ in range(n)]
    staged = EC.g1_points_to_rns(points)
    staged_m = tuple(x[:, None, :] for x in staged)
    ops = EC.make_g1_ops_rns()

    Xd, Yd, Zd = MSM.msm_signed_dense(
        staged_m, _scalars_arr(scalars), ops, c=4, lanes=8
    )
    dense = EC.g1_point_from_rns(
        np.asarray(Xd)[:, 0], np.asarray(Yd)[:, 0], np.asarray(Zd)[:, 0]
    )

    tabs = _stage_g1(points, chunk=32)
    Xt, Yt, Zt = MT.msm_affine_tree(tabs, _scalars_arr(scalars), ops)
    tree = EC.g1_point_from_rns(
        np.asarray(Xt)[:, 0], np.asarray(Yt)[:, 0], np.asarray(Zt)[:, 0]
    )
    host = _host_msm_g1(points, scalars)
    assert dense == host and tree == host


@pytest.mark.compiled
@pytest.mark.slow
def test_devcache_roundtrip(tmp_path):
    """Device-layout pk cache: first staging writes <pk>.devcache;
    a FRESH engine loads byte-identical tables from it instead of
    rebuilding (SURVEY section 5 checkpoint row)."""
    from za_tpu.engine.engine import TpuEngine
    from za_tpu.groth16.r1cs import R1CS
    from za_tpu.groth16.setup import generate_parameters

    rng = random.Random(31)
    n = 600
    a_rows = [[(i + 1, 1)] for i in range(n)]
    b_rows = [[(i + 1, 1)] for i in range(n)]
    c_rows = [[(i + 2, 1)] for i in range(n)]
    r1cs = R1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                a_rows=a_rows, b_rows=b_rows, c_rows=c_rows,
                var_of_signal=[])
    params = generate_parameters(r1cs, tau=11, alpha=3, beta=5,
                                 gamma=7, delta=9)
    cache = str(tmp_path / "pk.devcache")

    eng = TpuEngine(msm_style="rns", lanes=8)
    eng.msm_tree = True
    eng._tree_min = 256
    params._devcache_path = cache
    params._devcache_digest = "d" * 16
    staged1 = eng.stage_params(params, r1cs)
    assert "g1abl" in staged1
    import os

    assert os.path.exists(cache), "devcache not written"

    params._staged_cache = None  # force restage on the fresh engine
    eng2 = TpuEngine(msm_style="rns", lanes=8)
    eng2.msm_tree = True
    eng2._tree_min = 256
    staged2 = eng2.stage_params(params, r1cs)
    for name in ("g1abl", "g1h", "b_g2x"):
        t1, t2 = staged1[name], staged2[name]
        assert np.array_equal(np.asarray(t1.tx), np.asarray(t2.tx))
        assert np.array_equal(np.asarray(t1.ty), np.asarray(t2.ty))
        assert np.array_equal(
            np.asarray(t1.ident), np.asarray(t2.ident)
        )

    # digest mismatch invalidates
    params._staged_cache = None
    params._devcache_digest = "e" * 16
    eng3 = TpuEngine(msm_style="rns", lanes=8)
    eng3.msm_tree = True
    eng3._tree_min = 256
    staged3 = eng3.stage_params(params, r1cs)  # restages, no crash
    assert np.array_equal(
        np.asarray(staged3["g1h"].tx), np.asarray(staged1["g1h"].tx)
    )


@pytest.mark.compiled
@pytest.mark.slow
def test_tree_engine_prove_matches_host():
    """helper-path prove with the batch-affine tree staging (>=512
    constraints engages stage_params; msm_tree defaults on for the
    single-device rns engine) -- proof byte-equal to the host engine."""
    from za_tpu.algebra import FS, Value
    from za_tpu.compiler import Evaluator, Mode
    from za_tpu.compiler.evaluator import Scope
    from za_tpu.engine.engine import TpuEngine
    from za_tpu.groth16 import (
        R1CS, generate_parameters, prove, verify_proof,
    )
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
    component main = chain(600);
    """
    ev = Evaluator(Mode.GEN_CONSTRAINTS)
    ev.eval_inline(Scope(True, None, "root"), circuit)
    r1cs = R1CS.from_constraints(ev.signals, ev.constraints, [])
    evw = Evaluator(Mode.GEN_WITNESS)
    evw.set_deferred_value("main.x", Value(FS(3)))
    evw.eval_inline(Scope(True, None, "root"), circuit)
    z = r1cs.assignment_from_signals(evw.signals)
    params = generate_parameters(r1cs, tau=11, alpha=3, beta=5,
                                 gamma=7, delta=9)
    eng = TpuEngine(msm_style="rns", lanes=8)
    eng.msm_tree = True   # the cpu profile keeps the tree off
    eng._tree_min = 512   # small test circuit
    p1 = prove(params, r1cs, z, r=13, s=17, engine=eng)
    assert "g1abl" in params._staged_cache[1], "tree staging not used"
    p2 = prove(params, r1cs, z, r=13, s=17, engine=HostEngine())
    assert (p1.a, p1.b, p1.c) == (p2.a, p2.b, p2.c)
    assert verify_proof(params.vk, p1, z[1 : r1cs.num_inputs])
