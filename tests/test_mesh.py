"""Multi-chip collective correctness on the 8-device virtual CPU mesh."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import za_tpu.engine.ec as EC
import za_tpu.engine.field as F
import za_tpu.engine.mesh as MESH
from za_tpu.curve import G1_GEN, R, g1_mul
from za_tpu.engine.ec import G1_OPS
from za_tpu.groth16.domain import Domain
from za_tpu.groth16.prove import HostEngine

rng = random.Random(5)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return MESH.make_mesh(8)


@pytest.mark.slow
def test_sharded_ntt_roundtrip(mesh):
    n = 256
    dd = MESH.ShardedDomain(n, 8)
    dom = Domain(n)
    coeffs = [rng.randrange(R) for _ in range(n)]
    cm = F.ints_to_limbs([F.FR.to_mont_int(c) for c in coeffs])
    fwd = MESH.sharded_ntt_fn(mesh, dd, inverse=False)(cm)
    got = [F.FR.from_mont_int(v) for v in F.limbs_to_ints(np.asarray(fwd))]
    assert got == dom.ntt(coeffs)
    back = MESH.sharded_ntt_fn(mesh, dd, inverse=True)(fwd)
    got = [F.FR.from_mont_int(v) for v in F.limbs_to_ints(np.asarray(back))]
    assert got == coeffs


@pytest.mark.slow
def test_sharded_msm_matches_host(mesh):
    host = HostEngine()
    n = 32
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[2] = None
    scs = [rng.randrange(R) for _ in range(n)]
    fn = MESH.sharded_msm_fn(mesh, G1_OPS, c=4, lanes=2, is_g2=False)
    X, Y, Z = fn(EC.g1_points_to_device(pts), F.ints_to_limbs(scs))
    got = EC.g1_point_from_device(np.asarray(X), np.asarray(Y), np.asarray(Z))
    assert got == host.msm_g1(pts, scs)


@pytest.mark.slow
def test_sharded_signed_msm_g1(mesh):
    """Production multi-chip MSM: signed-dense over RNS ops, point
    stream sharded, window sums combined over the mesh axis."""
    import za_tpu.engine.field as F2

    host = HostEngine()
    n = 32
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[3] = None
    scs = [rng.randrange(R) for _ in range(n)]
    scs[1] = 0
    ops = EC.make_g1_ops_rns()
    fn = MESH.sharded_signed_msm_fn(mesh, ops, c=4, lanes=2, is_g2=False)
    staged = EC.g1_points_to_rns(pts)
    staged = jax.tree_util.tree_map(lambda x: np.asarray(x)[:, None, :], staged)
    X, Y, Z = fn(staged, F.ints_to_limbs(scs)[:, None, :])
    got = EC.g1_point_from_rns(
        np.asarray(X)[:, 0], np.asarray(Y)[:, 0], np.asarray(Z)[:, 0]
    )
    assert got == host.msm_g1(pts, scs)


@pytest.mark.slow
def test_sharded_signed_msm_g2(mesh):
    from za_tpu.curve import G2_GEN, g2_mul

    host = HostEngine()
    n = 16
    pts = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(n)]
    scs = [rng.randrange(R) for _ in range(n)]
    ops = EC.make_g2_ops_rns()
    fn = MESH.sharded_signed_msm_fn(mesh, ops, c=4, lanes=2, is_g2=True)
    staged = EC.g2_points_to_rns(pts)  # flat-Fq2 leaves (35, 2, n)
    staged = jax.tree_util.tree_map(
        lambda x: jnp.expand_dims(jnp.asarray(x), -2), staged
    )
    X, Y, Z = fn(staged, F.ints_to_limbs(scs)[:, None, :])
    got = EC.g2_point_from_rns(
        np.asarray(X)[:, :, 0], np.asarray(Y)[:, :, 0],
        np.asarray(Z)[:, :, 0],
    )
    assert got == host.msm_g2(pts, scs)


@pytest.mark.slow
def test_sharded_tree_msm_matches_host(mesh):
    """Multi-chip batch-affine tree MSM: staged tables' chunk axis
    sharded over the mesh, per-chip tree window sums combined with
    all_gather + point-reduce.  Includes interior identity points with
    live scalars (the density-filtered pk-query shape)."""
    import za_tpu.engine.msm_tree as MT
    from za_tpu.engine.engine import TpuEngine

    host = HostEngine()
    n = 128
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[3] = None
    pts[77] = None
    scs = [rng.randrange(1, R) for _ in range(n)]
    eng = TpuEngine(msm_style="rns", mesh_devices=8)
    tabs = eng.stage_g1_affine([pts], chunk=8)
    assert tabs.chunks % 8 == 0
    ops = EC.make_g1_ops_rns()
    fn = MESH.sharded_tree_msm_fn(mesh, ops, is_g2=False)
    sc = jnp.asarray(F.ints_to_limbs(scs))[:, None, :]
    sc = jnp.pad(sc, ((0, 0), (0, 0), (0, tabs.chunks * tabs.chunk_cols - n)))
    X, Y, Z = fn(tabs.tx, tabs.ty, tabs.ident, sc)
    got = EC.g1_point_from_rns(
        np.asarray(X)[:, 0], np.asarray(Y)[:, 0], np.asarray(Z)[:, 0]
    )
    assert got == host.msm_g1(pts, scs)


@pytest.mark.slow
def test_sharded_tree_msm_g2_matches_host(mesh):
    from za_tpu.curve import G2_GEN, g2_mul
    from za_tpu.engine.engine import TpuEngine

    host = HostEngine()
    n = 64
    pts = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[9] = None
    scs = [rng.randrange(1, R) for _ in range(n)]
    eng = TpuEngine(msm_style="rns", mesh_devices=8)
    tabs = eng.stage_g2_affine([pts], chunk=8)
    ops = EC.make_g2_ops_rns()
    fn = MESH.sharded_tree_msm_fn(mesh, ops, is_g2=True)
    sc = jnp.asarray(F.ints_to_limbs(scs))[:, None, :]
    sc = jnp.pad(sc, ((0, 0), (0, 0), (0, tabs.chunks * tabs.chunk_cols - n)))
    X, Y, Z = fn(tabs.tx, tabs.ty, tabs.ident, sc)
    got = EC.g2_point_from_rns(
        np.asarray(X)[:, :, 0], np.asarray(Y)[:, :, 0],
        np.asarray(Z)[:, :, 0],
    )
    assert got == host.msm_g2(pts, scs)


@pytest.mark.slow
def test_sharded_tree_prove_end_to_end(mesh):
    """Mesh prove with the TREE staging path (the production
    multi-chip configuration): every heavy stage sharded AND on the
    tree kernels; proof byte-equal to the host engine."""
    from za_tpu.algebra import FS, Value
    from za_tpu.compiler import Evaluator, Mode
    from za_tpu.compiler.evaluator import Scope
    from za_tpu.engine.engine import TpuEngine
    from za_tpu.groth16 import (
        R1CS, generate_parameters, prove, verify_proof,
    )

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

    params = generate_parameters(r1cs, tau=11, alpha=3, beta=5, gamma=7,
                                 delta=9)
    eng = TpuEngine(mesh_devices=8, lanes=8)
    eng.msm_tree = True   # the cpu profile keeps the tree off
    eng._tree_min = 512
    p_mesh = prove(params, r1cs, z, r=13, s=17, engine=eng)
    assert "g1abl" in params._staged_cache[1], "tree staging not used"
    p_host = prove(params, r1cs, z, r=13, s=17, engine=HostEngine())
    assert (p_mesh.a, p_mesh.b, p_mesh.c) == (p_host.a, p_host.b, p_host.c)
    assert verify_proof(params.vk, p_mesh, z[1 : r1cs.num_inputs])


@pytest.mark.slow
def test_sharded_prove_end_to_end(mesh):
    """helper-level prove with every heavy stage sharded over the mesh
    (MSMs, R1CS matvec, coset NTTs); proof equals the host engine's
    deterministic-rs proof and verifies."""
    from za_tpu.algebra import FS, Value
    from za_tpu.compiler import Evaluator, Mode
    from za_tpu.compiler.evaluator import Scope
    from za_tpu.engine.engine import TpuEngine
    from za_tpu.groth16 import (
        R1CS, generate_parameters, prove, verify_proof,
    )

    circuit = """
    template chain(N) {
        signal input x;
        signal output out;
        signal t[N];
        t[0] <== x * x;
        for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * x + i; }
        out <== t[N-1];
    }
    component main = chain(60);
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
    eng = TpuEngine(mesh_devices=8, lanes=8)
    eng.use_grouped = True
    p_mesh = prove(params, r1cs, z, r=13, s=17, engine=eng)
    p_host = prove(params, r1cs, z, r=13, s=17, engine=HostEngine())
    assert (p_mesh.a, p_mesh.b, p_mesh.c) == (p_host.a, p_host.b, p_host.c)
    assert verify_proof(params.vk, p_mesh, z[1 : r1cs.num_inputs])
