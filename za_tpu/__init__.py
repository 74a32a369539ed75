"""A zk-SNARK toolchain with a JAX Groth16 prover.

A circom-compatible circuit compiler (parser -> evaluator -> R1CS optimizer ->
embedded tester) fronting a from-scratch Groth16 proving engine built on
JAX/XLA for NVIDIA GPUs. Capability parity target: adria0/za (see SURVEY.md).
"""

__version__ = "0.1.0"
