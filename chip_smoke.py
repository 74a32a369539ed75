"""Smoke test of the Groth16 prove path on one NVIDIA GPU.

  phase 0  the device: refuses anything but a GPU, names the card
  phase 1  kernels at real widths against exact references: the RNS
           Montgomery multiply, its int8 base-extension dot and float32
           alpha, the RNS NTT, the G1/G2 MSMs of the profile's route
  phase 2  the main path: setup -> prove (cold, warm) -> verify through
           groth16.helper with the CLI's engine at 2^17 constraints; a
           2^10 circuit proves byte-equal to the host engine

Every comparison is bit-exact on canonical residues, integers or proof
bytes: the tolerance is zero.  Data and toxic-waste-free inputs come
from fixed seeds.  The last stdout line is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed.

  python chip_smoke.py             one GPU (the default)
  python chip_smoke.py --mesh 4    only the 2^17 prove sharded over four
                                   GPUs, against the one-GPU proof
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
SEED = 2024
RS = (0x1234567 * 3 + 11, 0x7654321 * 5 + 7)  # pinned Groth16 r, s
FAILED: list[str] = []


def check(name, fn, *args):
    """Run one check; a failure is recorded and the run goes on."""
    t0 = time.monotonic()
    try:
        fn(*args)
    except Exception:  # noqa: BLE001 -- every failure is reported
        FAILED.append(name)
        print(f"FAIL {name} ({time.monotonic() - t0:.1f}s)", flush=True)
        traceback.print_exc()
        return
    print(f"PASS {name} ({time.monotonic() - t0:.1f}s)", flush=True)


# -- phase 0 -------------------------------------------------------------------


def phase0():
    import jax

    if jax.default_backend() != "gpu":
        print(f"error: needs an NVIDIA GPU, JAX found platform "
              f"{jax.default_backend()!r}", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from za_tpu.engine.device import card_line, device_json
    from za_tpu.engine.engine import _enable_compilation_cache

    _enable_compilation_cache()
    dev = device_json()
    print(f"device: {dev['kind']} x{dev['count']}  jax {jax.__version__}  "
          f"compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"card: {card_line()}", flush=True)
    return dev


# -- phase 1: kernels at real widths -------------------------------------------


def _rand_ints(rng, n, bound):
    return [rng.randrange(bound) for _ in range(n)]


def check_mont_mul(log2n=20, n_check=1 << 14):
    """mont_mul_rns on (35, 2^20) for Fq and Fr: the first n_check
    columns against Python integers, every column against XLA:CPU;
    then small batches, jitted and op by op, against XLA:CPU."""
    import jax
    import numpy as np

    import za_tpu.engine.rns as RNS

    rng = random.Random(SEED)
    n = 1 << log2n
    cpu = jax.devices("cpu")[0]
    for ctx in (RNS.RQ, RNS.RR):
        N = ctx.modulus
        av = _rand_ints(rng, n, 512 * N)  # the mont_mul input contract
        bv = _rand_ints(rng, n, 512 * N)
        A = ctx.ints_to_rns(av)
        B = ctx.ints_to_rns(bv)
        fn = jax.jit(lambda a, b, ctx=ctx: RNS.mont_mul_rns(a, b, ctx))
        got = np.asarray(fn(A, B))
        ref = np.asarray(fn(jax.device_put(A, cpu), jax.device_put(B, cpu)))
        assert np.array_equal(got, ref), "GPU != XLA:CPU residues"
        m1inv = pow(ctx.m1, -1, N)
        vals = ctx.rns_to_ints(got[:, :n_check])
        for j, v in enumerate(vals):
            assert v < 4 * N, f"output bound broken at column {j}"
            assert v % N == av[j] * bv[j] * m1inv % N, f"column {j}"
        for k in (1, 2, 3, 8, 64):
            a, b = A[:, :k], B[:, :k]
            ref = np.asarray(fn(jax.device_put(a, cpu),
                                jax.device_put(b, cpu)))
            assert np.array_equal(np.asarray(fn(a, b)), ref), f"jit {k}"
            eager = RNS.mont_mul_rns(jax.numpy.asarray(a),
                                     jax.numpy.asarray(b), ctx)
            assert np.array_equal(np.asarray(eager), ref), f"eager {k}"


def check_dot_i8(log2n=20):
    """The base-extension dot of int8 digits equals an int64 numpy
    product on the full batch and on small batches.  It runs as a
    float32 dot at HIGHEST precision (rns._dot_i8), exact because every
    product is below 2^14 and every sum below 2^20; XLA:GPU's int8
    dot gave wrong sums at small batches."""
    import jax
    import numpy as np

    import za_tpu.engine.rns as RNS

    rng = np.random.default_rng(SEED)
    w = RNS.RQ.ext1_w0
    d = rng.integers(-128, 128, size=(w.shape[1], 1 << log2n), dtype=np.int8)
    d[:, 0] = -128  # extreme columns
    d[:, 1] = 127
    fn = jax.jit(RNS._dot_i8)
    for k in (1 << log2n, 1, 2, 3, 8, 64):
        got = np.asarray(fn(w, d[:, :k])).astype(np.int64)
        assert np.array_equal(got, w.astype(np.int64) @ d[:, :k]), k


def check_alpha(log2n=20):
    """The float32 Kawamura alpha never exceeds the exact floor of
    sum(lam_i / p_i), and is at most one below it, under the GPU's
    reduction order."""
    from fractions import Fraction

    import jax
    import jax.numpy as jnp
    import numpy as np

    import za_tpu.engine.rns as RNS

    ctx = RNS.RQ
    rng = np.random.default_rng(SEED + 1)
    n = 1 << log2n
    t = rng.integers(0, ctx.p[:, None], size=(RNS.N_CH, n)).astype(np.uint32)

    @jax.jit
    def alpha_of(t):
        lam = RNS.ch_mul_const(t[RNS.B1], ctx.lamw1, ctx, RNS.B1)
        rcp = RNS._b(ctx.alpha_rcp, lam).astype(jnp.float32)
        alpha = jnp.floor(
            jnp.sum(lam.astype(jnp.float32) * rcp, axis=0)
        ).astype(jnp.int32)
        return lam, alpha

    lam, alpha = (np.asarray(x) for x in alpha_of(t))
    p = np.asarray(ctx.b1, dtype=np.float64)[:, None]
    s = (lam.astype(np.float64) / p).sum(axis=0)
    exact = np.floor(s).astype(np.int64)
    near = np.nonzero(np.abs(s - np.round(s)) < 1e-9)[0]
    for j in near:  # resolve float64-ambiguous columns exactly
        exact[j] = int(sum(Fraction(int(lam[i, j]), int(pi))
                           for i, pi in enumerate(ctx.b1)))
    assert (alpha <= exact).all(), "alpha overestimates"
    assert (alpha >= exact - 1).all(), "alpha more than one below"


def check_ntt(eng, log2n=17):
    """RNS NTT and inverse NTT on the profile's layout against the host
    Domain, at the main path's domain size (one compile for both)."""
    import jax.numpy as jnp

    import za_tpu.engine.ntt_rns as NR
    from za_tpu.curve import R
    from za_tpu.engine.rns import RR
    from za_tpu.groth16.domain import Domain

    m = 1 << log2n
    rng = random.Random(SEED + 2)
    coeffs = _rand_ints(rng, m, R)
    dom = eng._rns_domain(m)
    x = jnp.asarray(RR.ints_to_rns([c * RR.m1 % R for c in coeffs]))

    def demont(a):
        return [RR.from_mont_int(v) % R for v in RR.rns_to_ints(a)]

    import numpy as np

    fwd = NR.ntt_steps(dom, x)
    assert demont(np.asarray(fwd)) == Domain(m).ntt(coeffs), "ntt"
    assert demont(np.asarray(NR.intt_steps(dom, fwd))) == coeffs, "intt"


def _pool_bases(rng, n, period, mul, gen):
    """n bases cycling through `period` (prime) random multiples k*G:
    exact and cheap expected MSMs, and no small linear relations
    between the operands of any tree node (msm_tree's contract)."""
    from za_tpu.curve import R

    ks = [rng.randrange(1, R) for _ in range(period)]
    pool = [mul(gen, k) for k in ks]
    return [pool[i % period] for i in range(n)], [
        ks[i % period] for i in range(n)
    ]


def _stage(eng, queries, is_g2):
    if eng.msm_tree and len(queries[0]) >= eng._tree_min:
        return (eng.stage_g2_affine if is_g2 else eng.stage_g1_affine)(queries)
    return (eng.stage_g2_stacked if is_g2 else eng.stage_g1_stacked)(queries)


def check_msm(eng, is_g2, log2n=17, queries=1):
    """G1 or G2 MSMs of 2^17 points through the profile's route, one per
    scalar vector over the same bases: sum s_i * (k_i G) must equal
    (sum s_i k_i mod r) G."""
    from za_tpu.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul

    rng = random.Random(SEED + (4 if is_g2 else 3))
    n = 1 << log2n
    mul, gen = (g2_mul, G2_GEN) if is_g2 else (g1_mul, G1_GEN)
    pts, ks = _pool_bases(rng, n, 257 if is_g2 else 1021, mul, gen)
    svecs = [_rand_ints(rng, n, R) for _ in range(queries)]
    svecs[0][:3] = [0, 1, R - 1]
    want = [mul(gen, sum(s * k for s, k in zip(sv, ks)) % R) for sv in svecs]
    staged = _stage(eng, [pts] * queries, is_g2)
    many = eng.msm_g2_many if is_g2 else eng.msm_g1_many
    assert many(staged, svecs) == want


def phase1(eng):
    print(f"== phase 1: kernels (profile {eng.profile.name}: "
          f"msm_tree={eng.msm_tree} ntt_fourstep="
          f"{eng.profile.ntt_fourstep}; tolerance: bit-exact)", flush=True)
    check("mont_mul_rns (35, 2^20) Fq+Fr", check_mont_mul)
    check("int8 extension dot (18x34 @ 34x2^20)", check_dot_i8)
    check("float32 alpha <= exact floor (2^20 columns)", check_alpha)
    check("RNS NTT/iNTT 2^17", check_ntt, eng)
    # four G1 queries and one G2 query: the prove's own MSM shapes
    check("G1 MSM 2^17 x4", check_msm, eng, False, 17, 4)
    check("G2 MSM 2^17", check_msm, eng, True)


# -- phase 2: the main path ----------------------------------------------------


CHAIN = """
template chain(N) {
    signal input x;
    signal output out;
    signal t[N];
    t[0] <== x * x;
    for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * t[i-1] + i; }
    out <== t[N-1];
}
component main = chain(%d);
"""


class _Clock:
    """Compile seconds (JAX's own event) and pk staging seconds."""

    def __init__(self, eng):
        import jax

        self.compile_s = 0.0
        self.stage_s = 0.0

        def on_event(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.compile_s += duration

        jax.monitoring.register_event_duration_secs_listener(on_event)
        inner = eng.stage_params

        def timed(*a, **k):
            t0 = time.monotonic()
            out = inner(*a, **k)
            import jax as _jax

            _jax.block_until_ready(out)
            self.stage_s += time.monotonic() - t0
            return out

        eng.stage_params = timed


def _circuit_dir(name, n_chain):
    d = os.path.join(WORK, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "circuit.za"), "w") as f:
        f.write(CHAIN % n_chain)
    return d


def _setup(d, engine):
    from za_tpu.groth16 import helper

    cwd = os.getcwd()
    os.chdir(d)
    try:
        return helper.setup("circuit.za", "proving.key", "json",
                            engine=engine)
    finally:
        os.chdir(cwd)


def _prove(d, engine):
    from za_tpu.groth16 import format as fmt, helper

    inputs = fmt.flatten_json("main", '{"x": "3"}')
    return helper.prove(os.path.join(d, "proving.key"), inputs,
                        engine=engine, deterministic_rs=RS)


def _tampered(proof_json):
    d = json.loads(proof_json)
    d["public_inputs"][0] = str(int(d["public_inputs"][0]) + 1)
    return json.dumps(d, separators=(",", ":"))


def main_path(eng, log2n=17, n_small=1 << 10):
    """setup -> prove cold -> prove warm -> verify at 2^log2n."""
    import jax

    from za_tpu.groth16 import helper

    clock = _Clock(eng)
    d = _circuit_dir(f"chain{log2n}", (1 << log2n) - 8)
    t0 = time.monotonic()
    vk = _setup(d, eng)
    setup_s = time.monotonic() - t0
    c0 = clock.compile_s
    t0 = time.monotonic()
    p_cold = _prove(d, eng)
    cold_s = time.monotonic() - t0
    c1, s1 = clock.compile_s, clock.stage_s
    t0 = time.monotonic()
    p_warm = _prove(d, eng)
    warm_s = time.monotonic() - t0
    assert p_cold == p_warm, "cold and warm proofs differ"
    assert helper.verify(vk, p_warm), "proof does not verify"
    print("verify: OK")
    assert not helper.verify(vk, _tampered(p_warm)), "tampered verified"
    print("verify tampered public input: INVALID")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not reported")
    timing = {
        "setup_s": setup_s, "setup_compile_s": c0,
        "prove_cold_s": cold_s, "prove_cold_compile_s": c1 - c0,
        "prove_cold_staging_s": s1,
        "prove_warm_s": warm_s, "prove_warm_staging_s": clock.stage_s - s1,
        "prove_warm_compile_s": clock.compile_s - c1,
        "peak_device_bytes": peak,
    }
    print("timing: " + json.dumps(timing), flush=True)

    ds = _circuit_dir("chain_small", n_small - 8)
    vk_s = _setup(ds, eng)
    p_dev = _prove(ds, eng)
    p_host = _prove(ds, None)
    assert p_dev == p_host, "device proof != host-engine proof"
    assert helper.verify(vk_s, p_dev)
    print(f"2^{n_small.bit_length() - 1} circuit: device proof == host "
          "proof, verifies")


def mesh_path(n_devices, log2n=17):
    """The 2^17 prove sharded over n_devices against one device."""
    from za_tpu.cli import _engine
    from za_tpu.groth16 import helper

    one = _engine("tpu")
    d = _circuit_dir(f"chain{log2n}_mesh", (1 << log2n) - 8)
    t0 = time.monotonic()
    vk = _setup(d, one)
    print(f"setup {time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    p_one = _prove(d, one)
    print(f"one-device prove (cold) {time.monotonic() - t0:.1f}s", flush=True)
    mesh = _engine("tpu", n_devices)
    t0 = time.monotonic()
    p_mesh = _prove(d, mesh)
    print(f"{n_devices}-device prove (cold) {time.monotonic() - t0:.1f}s",
          flush=True)
    assert p_mesh == p_one, "sharded proof != one-device proof"
    assert helper.verify(vk, p_mesh)
    print(f"{n_devices}-device proof == one-device proof, verifies",
          flush=True)
    t0 = time.monotonic()
    assert _prove(d, mesh) == p_mesh
    print(f"{n_devices}-device prove (warm) {time.monotonic() - t0:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run only the sharded 2^17 prove over N GPUs")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    dev = phase0()
    sys.setrecursionlimit(100_000)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        if args.mesh:
            print(f"== mesh: {args.mesh} devices", flush=True)
            check(f"2^17 prove on {args.mesh} devices", mesh_path, args.mesh)
        else:
            from za_tpu.cli import _engine

            eng = _engine("tpu")
            phase1(eng)
            print("== phase 2: setup / prove / verify", flush=True)
            check("main path 2^17", main_path, eng)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"total {time.monotonic() - t_start:.1f}s", flush=True)
    if FAILED:
        print(f"FAILED: {FAILED}", file=sys.stderr)
        sys.exit(1)
    from za_tpu.engine.device import card_line

    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main()
