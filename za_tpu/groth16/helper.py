"""End-to-end orchestration: setup() / prove() / verify().

The capability surface re-exported by every binding
(reference: prover/src/groth16/helper.rs:17-159).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..algebra import FS, Value
from ..compiler import Constraints, Evaluator, Mode, Signals, optimize
from ..compiler.evaluator import Scope
from ..compiler.tester import dump_error
from . import format as fmt
from .ethereum import generate_solidity
from .prove import Proof, prove as groth16_prove
from .r1cs import R1CS
from .setup import generate_parameters
from .verify import verify_proof

log = logging.getLogger("za_tpu")

VERIFIER_SOLIDITY = "solidity"
VERIFIER_JSON = "json"


def setup(
    circuit_path: str,
    proving_key_path: str,
    verifier_type: str = VERIFIER_SOLIDITY,
    engine=None,
) -> str:
    """Compile(GenConstraints) -> optimize -> trusted setup -> write pk;
    returns the verifier artifact text (helper.rs:22-89)."""
    ev = Evaluator(Mode.GEN_CONSTRAINTS)

    log.info("Compiling circuit...")
    start = time.monotonic()
    try:
        ev.eval_file(".", circuit_path)
    except Exception as err:
        dump_error(ev, repr(err))
        raise
    log.info("Compilation time: %.3fs", time.monotonic() - start)

    signals, constraints = ev.signals, ev.constraints
    log.info("[compile] %d signals, %d constraints", len(signals), len(constraints))

    start = time.monotonic()
    irreducible = signals.main_input_ids()
    constraints, removed_signals = optimize(constraints, irreducible)
    log.info("Optimization time: %.3fs", time.monotonic() - start)
    log.info(
        "[optimized] %d signals, %d constraints",
        len(signals) - len(removed_signals),
        len(constraints),
    )

    log.info("Running setup")
    start = time.monotonic()
    r1cs = R1CS.from_constraints(signals, constraints, removed_signals)
    params = generate_parameters(r1cs, engine=engine)
    log.info("Setup time: %.3fs", time.monotonic() - start)

    start = time.monotonic()
    with open(proving_key_path, "wb") as f:
        fmt.write_pk(
            f, ev.collected_asts, constraints, removed_signals, params,
            densities=r1cs.densities(),
        )
    log.info("Proving key write time: %.3fs", time.monotonic() - start)

    inputs = signals.main_public_input_names()
    if verifier_type == VERIFIER_SOLIDITY:
        return generate_solidity(params.vk, inputs)
    if verifier_type == VERIFIER_JSON:
        return fmt.vk_to_json(params.vk, inputs)
    raise ValueError(f"unknown verifier type {verifier_type}")


def prove(
    proving_key_path: str,
    inputs: list[tuple[str, FS]],
    engine=None,
    deterministic_rs: Optional[tuple[int, int]] = None,
    use_wtrace: bool = True,
) -> str:
    """read pk -> witness (compiled trace replay, or GenWitness over the
    pk-stored ASTs on first run / trace divergence) -> prove -> proof.json
    (helper.rs:91-147).

    Unlike the reference, witness generation is compiled on first use:
    the interpreted run records a straight-line witness program which is
    cached next to the pk (``<pk>.wtrace``) and replayed for subsequent
    proofs (compiler/wtrace.py). Guard mismatches (input-dependent
    control flow) fall back to the interpreter transparently.
    """
    import os

    from ..compiler.wtrace import (
        TraceMismatch, TraceRecorder, WitnessProgram, pk_digest,
    )

    # engines with device staging read the query vectors as raw limb
    # arrays (vectorized parse; batched on-device curve check at
    # staging) -- minutes faster than per-point Python at 1M points
    raw = (
        engine is not None
        and hasattr(engine, "stage_params")
        and getattr(engine, "use_grouped", False)
    )
    t_all = time.monotonic()
    start = time.monotonic()
    with open(proving_key_path, "rb") as f:
        pk = fmt.read_pk(f, raw_queries=raw)
    log.info("Proving key read time: %.3fs", time.monotonic() - start)

    def _done(proof_json: str) -> str:
        log.info(
            "prove wall time: %.3fs end to end (pk read -> witness -> "
            "prove -> self-verify)", time.monotonic() - t_all,
        )
        return proof_json

    use_wtrace = use_wtrace and os.environ.get("ZA_WTRACE", "1") != "0"
    wtrace_path = proving_key_path + ".wtrace"
    use_devcache = (
        raw and os.environ.get("ZA_DEVCACHE", "1") != "0"
    )
    digest = (
        pk_digest(proving_key_path) if (use_wtrace or use_devcache)
        else b""
    )
    if use_devcache:
        # device-layout staging cache: stage_params loads the staged
        # affine tables from <pk>.devcache (or saves them after the
        # first staging) instead of rebuilding per process
        pk.params._devcache_path = proving_key_path + ".devcache"
        pk.params._devcache_digest = digest.hex()

    replayed = False
    signals = None
    had_valid_cache = False
    z_pack = None
    if use_wtrace:
        prog = WitnessProgram.load(wtrace_path, digest)
        had_valid_cache = prog is not None
        if prog is not None:
            start = time.monotonic()
            try:
                # replay straight into the R1CS assignment (native C
                # tape interpreter when available): no Signals-store
                # rebuild, no per-prove R1CS reconstruction
                r1cs = _replay_r1cs(digest, prog, pk)
                z_limbs, z_head = prog.run_z(
                    {name: fs.v for name, fs in inputs}, r1cs
                )
                z_pack = (r1cs, z_limbs, z_head)
                replayed = True
                log.info(
                    "Witness replay time: %.3fs (compiled trace)",
                    time.monotonic() - start,
                )
            except TraceMismatch as exc:
                log.info("Witness trace diverged (%s); re-interpreting", exc)

    if replayed:
        # belt-and-braces: a replayed witness that fails the R1CS check
        # (which the guards should make impossible) falls back to the
        # interpreter instead of failing the proof
        try:
            r1cs, z_limbs, z_head = z_pack
            return _done(generate_verified_proof_z(
                r1cs, z_limbs, z_head, pk.params,
                engine=engine, deterministic_rs=deterministic_rs,
            ))
        except RuntimeError as exc:
            log.warning("replayed witness rejected (%s); re-interpreting", exc)
            signals = None

    if signals is None:
        log.info("Generating witness...")
        ev = Evaluator(Mode.GEN_WITNESS)
        if use_wtrace:
            ev.wtrace = TraceRecorder()
        start = time.monotonic()
        for signal, value in inputs:
            ev.set_deferred_value(signal, Value(value))
        ev.eval_asts(pk.asts)
        log.info("Witness generation time: %.3fs", time.monotonic() - start)

        if not ev.constraints.is_empty():
            raise RuntimeError("Constrains generated in witnes")

        log.info("Checking signals...")
        for n in range(1, len(ev.signals)):
            signal = ev.signals.get_by_id(n)
            if signal.value is None:
                raise RuntimeError(
                    f"signal '{signal.full_name}' value is not defined"
                )
        signals = ev.signals

        if use_wtrace and not had_valid_cache:
            # keep an existing valid cache on guard divergence: a workload
            # alternating between input-dependent paths would otherwise
            # re-record and rewrite the cache on every prove
            try:
                ev.wtrace.finish(ev.signals).dump(wtrace_path, digest)
            except OSError as exc:  # read-only pk dir: skip the cache
                log.info("could not cache witness trace: %s", exc)

    log.info("Creating and self-verifying proof...")
    return _done(generate_verified_proof(
        signals, pk.ignore_signals, pk.constraints, pk.params,
        engine=engine, deterministic_rs=deterministic_rs,
    ))


#: per-process replay R1CS cache: the variable layout and constraint
#: rows are pk-static, so repeat proves share one compiled R1CS
_replay_r1cs_cache: dict = {}


def _replay_r1cs(digest: bytes, prog, pk):
    key = digest.hex()
    r1cs = _replay_r1cs_cache.get(key)
    if r1cs is None:
        r1cs = R1CS.from_constraints(
            prog.meta_signals(), pk.constraints, pk.ignore_signals
        )
        _replay_r1cs_cache.clear()  # hold at most one pk's tables
        _replay_r1cs_cache[key] = r1cs
    return r1cs


def _z_ints(z_limbs) -> list[int]:
    """(16, nv) u32 16-bit-limb array -> plain int list (host paths)."""
    import numpy as np

    a = np.asarray(z_limbs, dtype=np.uint64)
    out = []
    for col in a.T:
        v = 0
        for k in range(15, -1, -1):
            v = (v << 16) | int(col[k])
        out.append(v)
    return out


def generate_verified_proof_z(
    r1cs: R1CS,
    z_limbs,
    z_head: list[int],
    params,
    engine=None,
    deterministic_rs: Optional[tuple[int, int]] = None,
) -> str:
    """generate_verified_proof from a replayed R1CS assignment: z as
    the engine's (16, nv) limb array (device engines consume it with
    zero conversion; host engines get a plain int list)."""
    start = time.monotonic()
    device = (
        engine is not None
        and hasattr(engine, "r1cs_satisfied")
        and hasattr(engine, "witness_limbs_dev")
        # tiny circuits take prove()'s unstaged path, which consumes
        # int lists (mirrors the staged-branch gate in prove.py)
        and max(r1cs.num_vars, params.domain_size - 1) >= 512
    )
    z = z_limbs if device else _z_ints(z_limbs)
    if device:
        if not engine.r1cs_satisfied(r1cs, z):
            raise RuntimeError("constraints not satisfied by witness")
    else:
        if not r1cs.is_satisfied(z):
            raise RuntimeError("constraints not satisfied by witness")
    log.info(
        "Constraint check time: %.3fs for %d constraint",
        time.monotonic() - start, r1cs.num_constraints,
    )

    start = time.monotonic()
    r, s = deterministic_rs if deterministic_rs is not None else (None, None)
    proof = groth16_prove(params, r1cs, z, r=r, s=s, engine=engine)
    _dt = time.monotonic() - start
    log.info(
        "Proof generation time: %.3fs (%d constraints, %.0f "
        "constraints/s)", _dt, r1cs.num_constraints,
        r1cs.num_constraints / _dt if _dt > 0 else 0.0,
    )

    start = time.monotonic()
    public_inputs = list(zip(r1cs.input_names, z_head[1:]))
    if not verify_proof(params.vk, proof, [v for _, v in public_inputs]):
        raise RuntimeError("proof self-verification failed")
    log.info("Proof verification time: %.3fs", time.monotonic() - start)

    from ..algebra import FS as _FS

    return fmt.proof_to_json(
        proof, [(n, _FS(v)) for n, v in public_inputs]
    )


def generate_verified_proof(
    signals: Signals,
    ignore_signals: list[int],
    constraints: Constraints,
    params,
    engine=None,
    deterministic_rs: Optional[tuple[int, int]] = None,
) -> str:
    """Constraint check -> proof -> self-verify -> proof.json
    (prover.rs:139-208)."""
    start = time.monotonic()
    r1cs = R1CS.from_constraints(signals, constraints, ignore_signals)
    z = r1cs.assignment_from_signals(signals)
    if engine is not None and hasattr(engine, "r1cs_satisfied"):
        if not engine.r1cs_satisfied(r1cs, z):  # device sparse matvec
            raise RuntimeError("constraints not satisfied by witness")
    else:
        constraints.satisfies_with_signals(signals)
    log.info(
        "Constraint check time: %.3fs for %d constraint",
        time.monotonic() - start, len(constraints),
    )

    start = time.monotonic()
    r, s = deterministic_rs if deterministic_rs is not None else (None, None)
    proof = groth16_prove(params, r1cs, z, r=r, s=s, engine=engine)
    _dt = time.monotonic() - start
    log.info(
        "Proof generation time: %.3fs (%d constraints, %.0f "
        "constraints/s)", _dt, r1cs.num_constraints,
        r1cs.num_constraints / _dt if _dt > 0 else 0.0,
    )

    # self-verify and emit public inputs
    start = time.monotonic()
    public_inputs = []
    for n in range(len(signals)):
        signal = signals.get_by_id(n)
        if signal.is_main_public_input():
            public_inputs.append((signal.full_name, signal.value.v))
    if not verify_proof(params.vk, proof, [fs.v for _, fs in public_inputs]):
        raise RuntimeError("proof self-verification failed")
    log.info("Proof verification time: %.3fs", time.monotonic() - start)

    return fmt.proof_to_json(proof, public_inputs)


def verify(json_verifying_key: str, proof_and_public_input: str) -> bool:
    """Bindings-only entry (helper.rs:149-159)."""
    vk, _ = fmt.vk_from_json(json_verifying_key)
    proof, public_inputs = fmt.proof_from_json(proof_and_public_input)
    return verify_proof(vk, proof, public_inputs)
