"""Multi-host (2-process) wiring test over the CPU backend.

Spawns 2 worker processes, each owning 4 virtual CPU devices; the
workers connect via jax.distributed (the DCN analogue), build an
8-device global mesh, and run the sharded RNS four-step NTT with
inputs constructed as global arrays -- collectives cross the process
boundary. Worker 0 checks the transform against the host golden
Domain and prints MULTIHOST_OK.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["ZA_REPO"])
import numpy as np

import jax
# force the CPU backend via config BEFORE the first backend touch
jax.config.update("jax_platforms", "cpu")

from za_tpu.engine.dist import init_distributed, host_to_global
assert init_distributed(), "distributed init did not engage"

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()

import za_tpu.engine.mesh as MESH
import za_tpu.engine.rns as RNS
from za_tpu.engine.rns import RR
from za_tpu.curve import R
from za_tpu.groth16.domain import Domain

mesh = MESH.make_mesh(8)
n = 64
dd = MESH.ShardedRnsDomain(n, 8)
fwd = MESH.sharded_ntt_rns_fn(mesh, dd, inverse=False)

rng = np.random.default_rng(7)
coeffs = [int(v) for v in rng.integers(0, 1 << 62, size=n)]
cm = RR.ints_to_rns([c * RR.m1 % R for c in coeffs])
x = host_to_global(mesh, cm.astype(np.uint32), P(None, "d"))

out = fwd(x)
from jax.experimental import multihost_utils
out_np = np.asarray(multihost_utils.process_allgather(out, tiled=True))
if jax.process_index() == 0:
    got = [RR.from_mont_int(v) % R for v in RR.rns_to_ints(out_np)]
    want = Domain(n).ntt(coeffs)
    assert got == want, "sharded multi-process NTT mismatch"
    print("MULTIHOST_OK", flush=True)
"""


PROVE_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["ZA_REPO"])
import numpy as np

import jax
jax.config.update("jax_platforms", "cpu")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.environ["ZA_REPO"], ".jax_cache"),
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from za_tpu.engine.dist import init_distributed
assert init_distributed(), "distributed init did not engage"
assert jax.process_count() == 2 and len(jax.devices()) == 8

from za_tpu.algebra import FS, Value
from za_tpu.compiler import Evaluator, Mode
from za_tpu.compiler.evaluator import Scope
from za_tpu.engine.engine import TpuEngine
from za_tpu.groth16 import R1CS, generate_parameters, prove, verify_proof
from za_tpu.groth16.prove import HostEngine

circuit = '''
template chain(N) {
    signal input x;
    signal output out;
    signal t[N];
    t[0] <== x * x;
    for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * x + i; }
    out <== t[N-1];
}
component main = chain(600);
'''
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
assert eng._multiproc(), "engine must see the 2-process runtime"
assert eng.r1cs_satisfied(r1cs, z), "sharded multihost sat check"
p = prove(params, r1cs, z, r=13, s=17, engine=eng)
p_host = prove(params, r1cs, z, r=13, s=17, engine=HostEngine())
assert (p.a, p.b, p.c) == (p_host.a, p_host.b, p_host.c), \
    "multihost proof != host proof"
assert verify_proof(params.vk, p, z[1 : r1cs.num_inputs])
if jax.process_index() == 0:
    print("MULTIHOST_PROVE_OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_prove(tmp_path):
    """2-process CPU-mesh PROVE over jax.distributed (the DCN path):
    every heavy stage (staging uploads as global arrays, sharded
    matvec/NTT/MSM) crosses the process boundary; the proof byte-equals
    the host engine's with pinned r, s and verifies.  BASELINE's
    N>=2-host config exercised end to end without accelerators."""
    port = _free_port()
    workers = []
    script = tmp_path / "worker_prove.py"
    script.write_text(PROVE_WORKER)
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            ZA_REPO=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ZA_DIST=f"localhost:{port},2,{pid}",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
        )
        env.pop("JAX_COORDINATOR_ADDRESS", None)
        workers.append(
            subprocess.Popen(
                [sys.executable, str(script)],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
        )
    outs = []
    for w in workers:
        try:
            out, _ = w.communicate(timeout=1500)
        except subprocess.TimeoutExpired:
            for ww in workers:
                ww.kill()
            raise
        outs.append(out)
    for i, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
    assert "MULTIHOST_PROVE_OK" in outs[0], outs[0][-4000:]


@pytest.mark.slow
def test_two_process_sharded_ntt(tmp_path):
    port = _free_port()
    workers = []
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            ZA_REPO=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ZA_DIST=f"localhost:{port},2,{pid}",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
        )
        env.pop("JAX_COORDINATOR_ADDRESS", None)
        workers.append(
            subprocess.Popen(
                [sys.executable, str(script)],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
        )
    outs = []
    for w in workers:
        try:
            out, _ = w.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for ww in workers:
                ww.kill()
            raise
        outs.append(out)
    for i, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"worker {i} failed:\n{out}"
    assert "MULTIHOST_OK" in outs[0], outs[0]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
