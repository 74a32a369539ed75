"""Benchmark harness: Groth16 prover device compute on one GPU.

Measures the device compute of one proof for a synthetic multiplier
chain (BASELINE.md config 5 scaled by ZA_BENCH_LOG2N, default 2^17):
QAP h(x) via coset NTT + the four G1 MSMs + the G2 MSM, through the
same TpuEngine the prover uses (its backend profile picks the MSM and
NTT), plus a host witness-generation datapoint (interpreter vs compiled
wtrace replay) so every stage of the north-star prove path (SURVEY.md
section 3.2) has a number.  Refuses to run without a GPU; the card's
name and power limit go to stderr on a '#' line.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

vs_baseline compares against single-core CPU bellman extrapolated at
~5000 constraints/s (the reference publishes no numbers -- BASELINE.md;
this constant approximates bellman_ce's single-thread proving rate on a
modern core and is recorded here for transparency).

Env knobs: ZA_BENCH_LOG2N (ladder: 13 / 17 / 20), ZA_BENCH_LANES,
ZA_BENCH_WITNESS=0 to skip the witness stage.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.setrecursionlimit(1_000_000)

BELLMAN_SINGLE_CORE_CONSTRAINTS_PER_S = 5000.0


def build_r1cs(log2n: int):
    """Synthetic multiplier chain: n constraints t[i] = t[i-1]*t[i-1]+i,
    built directly as R1CS (the witness benchmark below exercises the
    circuit interpreter separately)."""
    import random

    from za_tpu.curve import R
    from za_tpu.groth16.r1cs import R1CS

    n = 1 << log2n
    rng = random.Random(99)
    a_rows, b_rows, c_rows = [], [], []
    z = [1, rng.randrange(1, R)]
    for i in range(n):
        prev = i + 1
        cur = i + 2
        a_rows.append([(prev, 1)])
        b_rows.append([(prev, 1)])
        c_rows.append([(cur, 1), (0, (-i) % R)])
        z.append((z[prev] * z[prev] + i) % R)
    r1cs = R1CS(
        num_inputs=2,
        num_aux=n,
        input_names=["main.x"],
        a_rows=a_rows,
        b_rows=b_rows,
        c_rows=c_rows,
        var_of_signal=[],
    )
    assert r1cs.is_satisfied(z)
    return r1cs, z


def witness_bench(log2n: int) -> dict:
    """Interpreter vs compiled-trace witness generation on a real
    multiplier-chain circuit AT THE REPORTED SIZE (no cap: the ladder
    measures witness cost at the config it reports).  Replay goes
    through the native C tape interpreter when buildable
    (native/wtrace_replay.c), falling back to the Python tape."""
    from za_tpu.algebra import FS, Value
    from za_tpu.compiler import Evaluator, Mode
    from za_tpu.compiler.evaluator import Scope
    from za_tpu.compiler.wtrace import TraceRecorder

    n = 1 << log2n
    if os.environ.get("ZA_BENCH_WITNESS_CAP"):
        n = min(n, 1 << int(os.environ["ZA_BENCH_WITNESS_CAP"]))
    circuit = (
        "template chain(N) {\n"
        " signal input x;\n signal output out;\n signal t[N];\n"
        " t[0] <== x * x;\n"
        " for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * t[i-1] + i; }\n"
        " out <== t[N-1];\n}\ncomponent main = chain(%d);\n" % n
    )

    ev = Evaluator(Mode.GEN_WITNESS)
    ev.wtrace = TraceRecorder()
    ev.set_deferred_value("main.x", Value(FS(3)))
    t0 = time.time()
    ev.eval_inline(Scope(True, None, "root"), circuit)
    interp_s = time.time() - t0
    prog = ev.wtrace.finish(ev.signals)

    t0 = time.time()
    prog._packed()  # one-time tape packing (cold-path cost)
    pack_s = time.time() - t0

    from za_tpu.native import wtrace_lib

    native = wtrace_lib() is not None

    def one_replay():
        t0 = time.time()
        limbs = prog.replay_limbs({"main.x": 3})
        if limbs is None:
            prog.replay_values({"main.x": 3})
        return time.time() - t0

    replay_cold_s = one_replay()  # first call pays the page faults
    replay_s = one_replay()       # steady state (repeat proves)
    return {
        "witness_constraints": n,
        "witness_interpret_c_per_s": int(n / interp_s),
        "witness_replay_c_per_s": int(n / max(replay_s, 1e-9)),
        "witness_replay_s": round(replay_s, 4),
        "witness_replay_cold_s": round(replay_cold_s, 4),
        "witness_interpret_s": round(interp_s, 2),
        "witness_pack_s": round(pack_s, 2),
        "witness_replay_native": native,
    }


def main():
    if os.environ.get("ZA_METRICS", "0") != "0":
        import logging

        logging.basicConfig(level=logging.INFO, format="# %(message)s",
                            stream=sys.stderr)
    # default 2^17: the mid-rung of the BASELINE ladder (13/17/20)
    log2n = int(os.environ.get("ZA_BENCH_LOG2N", "17"))
    lanes = os.environ.get("ZA_BENCH_LANES")
    lanes = int(lanes) if lanes else None

    import jax

    from za_tpu.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul
    from za_tpu.engine.device import card_line, device_json, require_gpu
    from za_tpu.engine.engine import TpuEngine
    from za_tpu.groth16.domain import Domain

    require_gpu()
    print(f"# device: {json.dumps(device_json())} jax {jax.__version__}",
          file=sys.stderr)
    print(f"# card: {card_line()}", file=sys.stderr, flush=True)

    t0 = time.time()
    r1cs, z = build_r1cs(log2n)
    n = r1cs.num_constraints
    domain = Domain.for_constraints(n + r1cs.num_inputs)
    print(f"# built r1cs n={n} domain={domain.size} in {time.time()-t0:.1f}s",
          file=sys.stderr)

    wit = {}
    if os.environ.get("ZA_BENCH_WITNESS", "1") != "0":
        t0 = time.time()
        wit = witness_bench(log2n)
        print(f"# witness bench done in {time.time()-t0:.1f}s: {wit}",
              file=sys.stderr, flush=True)

    # synthetic pk queries (random points; the kernels do identical work
    # regardless of the point values)
    import random

    t0 = time.time()
    rng = random.Random(5)

    # pool sizes are PRIME (not a power-of-two divisor): the tree MSM's
    # fold-half pairing would otherwise pair equal base points, which
    # its incomplete affine adds exclude by contract (real pk points
    # are all distinct; see engine/msm_tree.py)
    def g1s(k):
        base = [g1_mul(G1_GEN, rng.randrange(1, 1 << 62)) for _ in range(67)]
        return [base[i % 67] for i in range(k)]

    def g2s(k):
        base = [g2_mul(G2_GEN, rng.randrange(1, 1 << 62)) for _ in range(19)]
        return [base[i % 19] for i in range(k)]

    nv = r1cs.num_vars
    m = domain.size
    a_q, b1_q, l_q, h_q = g1s(nv), g1s(nv), g1s(r1cs.num_aux), g1s(m - 1)
    b2_q = g2s(nv)
    print(f"# host pk queries built in {time.time()-t0:.1f}s",
          file=sys.stderr, flush=True)

    eng = TpuEngine(lanes=lanes)
    print(f"# engine init ok (msm_style={eng.msm_style})",
          file=sys.stderr, flush=True)

    stage_total = [0.0]

    def stage(name, f):
        t = time.time()
        r = jax.block_until_ready(f())
        dt_ = time.time() - t
        stage_total[0] += dt_
        print(f"#   {name}: {dt_:.2f}s", file=sys.stderr, flush=True)
        return r

    # stage pk material and witness limbs once (device-resident, as a
    # deployed prover holds the pk; z limb conversion is host prep)
    import za_tpu.engine.field as F
    from za_tpu.engine.engine import _pad_pow2ish

    n2 = _pad_pow2ish(len(b2_q))
    n_abl = _pad_pow2ish(max(len(a_q), len(b1_q), len(l_q)))
    use_tree = (
        getattr(eng, "msm_tree", False) and n_abl >= eng._tree_min
    )
    if use_tree:
        # batch-affine tree staging (the production prove layout):
        # a/b1/l share one table group, h gets its own; chunk-aligned
        # padding (no pow2 doubling)
        s_abl = stage("stage_tree_g1abl", lambda: eng.stage_g1_affine(
            [a_q, b1_q, l_q]))
        s_h = stage("stage_tree_g1h", lambda: eng.stage_g1_affine(
            [h_q]))
        if os.environ.get("ZA_TREE_G2", "1") != "0":
            sb2 = stage("stage_tree_b2", lambda: eng.stage_g2_affine(
                [b2_q]))
        else:
            sb2 = stage("stage_b2", lambda: eng.stage_g2_stacked(
                [b2_q + [None] * (n2 - len(b2_q))]))
    else:
        n_common = _pad_pow2ish(
            max(len(a_q), len(b1_q), len(l_q), len(h_q))
        )

        def padded(q):  # pre-pad so msm_g1_many shares one staged shape
            return q + [None] * (n_common - len(q))

        s4 = stage("stage_g1x4", lambda: eng.stage_g1_stacked(
            [padded(a_q), padded(b1_q), padded(l_q), padded(h_q)]))
        sb2 = stage("stage_b2", lambda: eng.stage_g2_stacked(
            [b2_q + [None] * (n2 - len(b2_q))]))
    # one witness upload shared by h/sat/MSM (same path helper.prove
    # uses); the aux slice stays on device
    z_l = eng.witness_limbs_dev(z)
    zaux_l = z_l[:, r1cs.num_inputs:]

    def prove_compute():
        h = stage("h_coeffs", lambda: eng.h_coeffs_limbs(r1cs, z_l, domain))
        if use_tree:
            pa, pb1, pl = stage("msm_g1abl", lambda: eng.msm_g1_many(
                s_abl, [z_l, z_l, zaux_l]))
            ph = stage("msm_g1h", lambda: eng.msm_g1_many(s_h, [h])[0])
        else:
            pa, pb1, pl, ph = stage("msm_g1x4", lambda: eng.msm_g1_many(
                s4, [z_l, z_l, zaux_l, h]))
        pb2 = stage("msm_b2", lambda: eng.msm_g2_many(sb2, [z_l])[0])
        return pa, pb1, pl, ph, pb2

    staging_s = stage_total[0]  # pk staging only (pre-warmup)
    t0 = time.time()
    prove_compute()  # compile + warm
    warm = time.time() - t0
    print(f"# warmup (incl compile) {warm:.1f}s", file=sys.stderr)

    # warm sat-check (part of every real prove; compiled in warmup)
    eng.r1cs_satisfied(r1cs, z_l)
    t0 = time.time()
    sat_ok = eng.r1cs_satisfied(r1cs, z_l)
    sat_s = time.time() - t0
    assert sat_ok
    print(f"# sat check {sat_s:.2f}s", file=sys.stderr, flush=True)

    eng._sat_legs = None  # headline dt: h WITHOUT the sat-leg reuse
    t0 = time.time()
    prove_compute()
    dt = time.time() - t0

    # the real prove pipeline: sat check stashes its Az/Bz/Cz matvec
    # legs and h(x) reuses them (helper path order)
    t0 = time.time()
    assert eng.r1cs_satisfied(r1cs, z_l)
    prove_compute()
    pipeline_s = time.time() - t0
    print(f"# sat+prove pipeline {pipeline_s:.2f}s", file=sys.stderr,
          flush=True)

    # end-to-end wall accounting: warm wall = one
    # full repeat prove (witness replay + sat-fused device pipeline +
    # result d2h, all inside the measured calls); cold wall = first
    # prove of a fresh process (staging + compile-included first
    # iteration + witness interpret + tape pack)
    wit_replay_s = wit.get("witness_replay_s", 0.0)
    prove_wall_warm = round(wit_replay_s + pipeline_s, 3)
    prove_wall_cold = round(
        staging_s + warm
        + wit.get("witness_interpret_s", 0.0)
        + wit.get("witness_pack_s", 0.0), 1,
    )

    # point-add work model of the signed radix-16 dense MSM:
    # (ceil(254/4) windows + 7 table adds) per point
    g1_points = 3 * nv + (m - 1) + r1cs.num_aux
    point_adds = (64 + 7) * g1_points
    baseline_s = n / BELLMAN_SINGLE_CORE_CONSTRAINTS_PER_S

    result = {
        "metric": f"groth16_prove_device_compute_{1 << log2n}c",
        "value": round(dt, 4),
        "unit": "s",
        "vs_baseline": round(baseline_s / dt, 2),
        "detail": {
            "constraints": n,
            "domain": m,
            "constraints_per_s": int(n / dt),
            "g1_point_adds_per_s": int(point_adds / dt),
            "warmup_s": round(warm, 1),
            "stage_s": round(staging_s, 1),
            "sat_check_s": round(sat_s, 3),
            "sat_prove_pipeline_s": round(pipeline_s, 3),
            "prove_wall_s_warm": prove_wall_warm,
            "prove_wall_s_cold": prove_wall_cold,
            "msm_style": eng.msm_style,
            "msm_tree": getattr(eng, "msm_tree", False),
            "baseline": "single-core bellman @5k constraints/s (est)",
            **wit,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
