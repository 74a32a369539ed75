"""Device compute engine: JAX/XLA kernels for the Groth16 hot loops.

Replaces the reference's CPU bellman engine with device compute on
NVIDIA GPUs (tests on the CPU backend):

  * profile.py -- the per-backend choices, resolved once
  * field.py -- BN254 Fr/Fq as 16x16-bit limb vectors, batched
    Montgomery arithmetic
  * rns.py   -- the residue-number-system field core (int8-dot base
    extensions); msm_tree.py / ntt_rns.py build on it
  * ntt.py   -- radix-2 (coset) NTT over Fr for the QAP h(x)
  * ec.py    -- G1/G2 projective group law (complete RCB formulas,
    branchless)
  * msm.py   -- Pippenger multi-scalar multiplication with per-lane
    bucket accumulation (no scatter conflicts)
  * engine.py-- TpuEngine: the prover-facing facade
  * mesh.py  -- multi-device sharding (shard_map over a Mesh)
"""

def __getattr__(name):
    if name == "TpuEngine":
        from .engine import TpuEngine

        return TpuEngine
    raise AttributeError(name)
