"""Per-kernel microbenchmarks of the prover's building blocks on the GPU.

Times the field and group primitives at MSM-sized batches so kernel
regressions show up as numbers.  Every timing ends in
jax.block_until_ready.  Refuses to run without a GPU.

Run: python benchmarks/micro.py            # prints a table + JSON
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from za_tpu.engine.device import (  # noqa: E402
    card_line, device_json, require_gpu,
)
from za_tpu.engine.engine import _enable_compilation_cache  # noqa: E402


def timeit(fn, *args, iters=5):
    jax.block_until_ready(fn(*args))  # compile + first run
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    require_gpu()
    _enable_compilation_cache()
    print(f"# device: {json.dumps(device_json())} jax {jax.__version__}")
    print(f"# card: {card_line()}", flush=True)

    import za_tpu.engine.ec as EC
    import za_tpu.engine.field as F
    import za_tpu.engine.rns as RNS
    from za_tpu.engine.field import FQ
    from za_tpu.engine.rns import RQ

    rng = np.random.RandomState(7)
    rows = []

    def report(name, dt, rate, unit, **extra):
        rows.append({"kernel": name, "ms": dt * 1e3, "rate": rate,
                     "unit": unit, **extra})
        print(f"{name:34s} {dt*1e3:10.4f} ms  {rate:12.3f} {unit}",
              flush=True)

    # raw u32 elementwise and int8 dot rates
    n = 1 << 20
    a32 = jnp.asarray(rng.randint(0, 1 << 16, size=(16, n), dtype=np.uint32))
    b32 = jnp.asarray(rng.randint(0, 1 << 16, size=(16, n), dtype=np.uint32))

    @jax.jit
    def chain_mul(a, b):
        x = a
        for _ in range(32):
            x = x * b + a
        return x

    dt = timeit(chain_mul, a32, b32)
    report("u32 elementwise mul+add (x32)", dt,
           32 * 2 * 16 * n / dt / 1e12, "Tops/s")

    A8 = jnp.asarray(rng.randint(-127, 127, size=(4096, 512), dtype=np.int8))
    B8 = jnp.asarray(rng.randint(-127, 127, size=(512, 4096), dtype=np.int8))

    @jax.jit
    def mm_i8(a, b):
        return jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)

    dt = timeit(mm_i8, A8, B8, iters=20)
    report("int8 dot 4096x512x4096", dt, 2 * 4096 * 512 * 4096 / dt / 1e12,
           "Tops/s")

    # the base-extension dot at its own shape: (18, 34) @ (34, 2^20)
    # int8 digits, as the exact float32 dot the engine runs
    # (rns._dot_i8) and as the int8 x int8 -> int32 dot it replaced
    W8 = jnp.asarray(RQ.ext1_w0)
    D8 = jnp.asarray(rng.randint(-128, 127, size=(34, n), dtype=np.int8))
    for name, fn in (("float32", RNS._dot_i8), ("int8", mm_i8)):
        dt = timeit(jax.jit(fn), W8, D8, iters=20)
        report(f"extension dot {name} 18x34 @ 34x2^20", dt,
               2 * 18 * 34 * n / dt / 1e12, "Tops/s")

    # limb field core
    nn = 1 << 18
    fa = jnp.asarray(rng.randint(0, 1 << 16, size=(16, nn), dtype=np.uint32))
    fb = jnp.asarray(rng.randint(0, 1 << 16, size=(16, nn), dtype=np.uint32))

    @jax.jit
    def chain_mont_limb(a, b):
        x = a
        for _ in range(8):
            x = F.mont_mul(x, b, FQ)
        return x

    dt = timeit(chain_mont_limb, fa, fb)
    report("limb mont_mul (x8, 2^18)", dt, 8 * nn / dt / 1e6, "Mmul/s")

    # RNS multiply at MSM-sized batches (35 x 2^20)
    ra = jnp.asarray(rng.randint(0, 65000, size=(35, n), dtype=np.uint32))
    rb = jnp.asarray(rng.randint(0, 65000, size=(35, n), dtype=np.uint32))
    io_bytes = 3 * 35 * 4  # two operands in, one product out (u32)
    one = jax.jit(lambda a, b: RNS.mont_mul_rns(a, b, RQ))
    dt = timeit(one, ra, rb, iters=10)
    report("rns mont_mul (35x2^20)", dt, n / dt / 1e6, "Mmul/s",
           io_GBps=io_bytes * n / dt / 1e9)

    @jax.jit
    def chain_mont_rns(a, b):
        x = a
        for _ in range(8):
            x = RNS.mont_mul_rns(x, b, RQ)
        return x

    dt = timeit(chain_mont_rns, ra, rb)
    report("rns mont_mul (x8 chain)", dt, 8 * n / dt / 1e6, "Mmul/s")

    # point adds over the RNS field
    def rpt_rns(k, g2=False):
        shape = (35, 2, k) if g2 else (35, k)
        return tuple(
            jnp.asarray(rng.randint(0, 65000, size=shape, dtype=np.uint32))
            for _ in range(3))

    nn = 1 << 17
    p1, p2 = rpt_rns(nn), rpt_rns(nn)

    @jax.jit
    def chain_g1_rns(p, q):
        x = p
        for _ in range(4):
            x = EC.point_add(x, q, EC.make_g1_ops_rns())
        return x

    dt = timeit(chain_g1_rns, p1, p2)
    report("rns g1 point_add (x4, 2^17)", dt, 4 * nn / dt / 1e6, "Madd/s")

    q1, q2 = rpt_rns(nn // 2, True), rpt_rns(nn // 2, True)

    @jax.jit
    def chain_g2_rns(p, q):
        x = p
        for _ in range(4):
            x = EC.point_add(x, q, EC.make_g2_ops_rns())
        return x

    dt = timeit(chain_g2_rns, q1, q2)
    report("rns g2 point_add (x4, 2^16)", dt, 4 * (nn // 2) / dt / 1e6,
           "Madd/s")

    print(json.dumps({"device": device_json(), "card": card_line(),
                      "rows": rows}))


if __name__ == "__main__":
    main()
