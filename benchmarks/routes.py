"""Per-layer timing of each XLA route on one GPU, to choose the backend
profile (engine/profile.py) by measurement.

At the size of the chip smoke test's main path (2^17 points, domain
2^17):

  ntt  one h(x) leg, iNTT then coset NTT in RNS: four-step
       (ntt_fourstep=True) against stage-unrolled
  msm  the G1 and the G2 MSM of 2^17 points: RNS signed-dense (the
       profile's msm_style="rns", msm_tree=False), limb bucket
       Pippenger (msm_style="grouped", the cpu profile's route), and
       last the batch-affine tree (msm_tree=True), whose staging and
       compile are the slowest, so a time limit cuts it and no other

Each route compiles with its first call, then runs ZA_ROUTES_ITERS warm
calls that end in block_until_ready; every row is printed as soon as it
is measured.  The routes of a layer must give the same result.  Refuses
to run without a GPU.

Run: python benchmarks/routes.py         # prints lines + one JSON line
"""

import dataclasses
import json
import os
import random
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LOG2N = 17


def _timed(fn, iters):
    t0 = time.monotonic()
    ref = jax.block_until_ready(fn())
    first = time.monotonic() - t0
    warm = []
    for _ in range(iters):
        t0 = time.monotonic()
        jax.block_until_ready(fn())
        warm.append(time.monotonic() - t0)
    return ref, {"first_s": first, "warm_s": warm}


def main():
    from za_tpu.engine.device import card_line, device_json, require_gpu

    require_gpu()
    iters = int(os.environ.get("ZA_ROUTES_ITERS", "3"))
    print(f"# device: {json.dumps(device_json())} jax {jax.__version__}")
    print(f"# card: {card_line()}", flush=True)

    import za_tpu.engine.ntt_rns as NR
    from za_tpu.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul
    from za_tpu.engine.engine import TpuEngine
    from za_tpu.engine.profile import PROFILES
    from za_tpu.engine.rns import RR

    def engine(**kw):
        return TpuEngine(profile=dataclasses.replace(PROFILES["gpu"], **kw))

    n = 1 << LOG2N
    rng = random.Random(7)
    rows = []

    def report(layer, route, res):
        row = {"layer": layer, "route": route, **res}
        rows.append(row)
        print(json.dumps(row), flush=True)

    dom_ints = [rng.randrange(R) for _ in range(n)]
    x = jnp.asarray(RR.ints_to_rns([v * RR.m1 % R for v in dom_ints]))
    outs = {}
    for route, four in (("fourstep", True), ("unrolled", False)):
        dom = engine(ntt_fourstep=four)._rns_domain(n)
        out, res = _timed(
            lambda: NR.coset_ntt_steps(dom, NR.intt_steps(dom, x)), iters
        )
        outs[route] = [v % R for v in RR.rns_to_ints(np.asarray(out[:, :256]))]
        report("ntt_leg", route, res)
    assert outs["fourstep"] == outs["unrolled"], "NTT routes differ"

    import za_tpu.engine.ec as EC

    def stage_dense(eng, pts, is_g2):
        stage = eng.stage_g2_stacked if is_g2 else eng.stage_g1_stacked
        staged = stage([pts])
        many = eng.msm_g2_many if is_g2 else eng.msm_g1_many
        return staged, lambda s: many(staged, [s])[0]

    def stage_limb(eng, pts, is_g2):
        staged = (EC.g2_points_to_device if is_g2
                  else EC.g1_points_to_device)(pts)
        kind = "g2" if is_g2 else "g1"
        fn = eng._msm_jit(kind, n, *eng._msm_params(n, is_g2))
        back = EC.g2_point_from_device if is_g2 else EC.g1_point_from_device
        return staged, lambda s: back(*fn(staged, eng._scalars_limbs(s, n)))

    def stage_tree(eng, pts, is_g2):
        stage = eng.stage_g2_affine if is_g2 else eng.stage_g1_affine
        staged = stage([pts])
        many = eng.msm_g2_many if is_g2 else eng.msm_g1_many
        return staged, lambda s: many(staged, [s])[0]

    routes = (
        ("dense", {}, stage_dense),
        ("limb", {"msm_style": "grouped"}, stage_limb),
        ("tree", {"msm_tree": True}, stage_tree),
    )
    inputs = {}
    for is_g2 in (False, True):
        mul, gen = (g2_mul, G2_GEN) if is_g2 else (g1_mul, G1_GEN)
        pool = [mul(gen, rng.randrange(1, R)) for _ in range(257)]
        inputs[is_g2] = ([pool[i % 257] for i in range(n)],
                         [rng.randrange(R) for _ in range(n)])
    results = {}
    for route, kw, stage in routes:
        for is_g2 in (False, True):
            pts, scalars = inputs[is_g2]
            layer = "msm_g2" if is_g2 else "msm_g1"
            eng = engine(**kw)
            t0 = time.monotonic()
            staged, run = stage(eng, pts, is_g2)
            jax.block_until_ready(staged)
            stage_s = time.monotonic() - t0
            out, res = _timed(lambda: run(scalars), iters)
            report(layer, route, {"staging_s": stage_s, **res})
            want = results.setdefault(layer, out)
            assert out == want, f"{layer}: {route} differs from dense"
            del staged, run

    print(json.dumps({"device": device_json(), "card": card_line(),
                      "rows": rows}))


if __name__ == "__main__":
    main()
