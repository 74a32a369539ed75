"""Radix-2 NTT over Fr on device (coefficients <-> evaluations).

Iterative Cooley-Tukey with a precomputed bit-reversal permutation and
a master twiddle table (strided per stage). All values in Montgomery
form; matches the host golden model za_tpu.groth16.domain.Domain.

Stages whose butterfly span stays inside a shard are local; the
sharded variant (za_tpu.engine.mesh) runs the four-step decomposition
with an all-to-all between the two local halves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..curve import R
from ..groth16.domain import Domain
from . import field as F
from .field import FR


def _bitrev_indices(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _pow_table(base: int, count: int) -> np.ndarray:
    """(16, count) Montgomery limb table of base^0..base^{count-1}."""
    vals = []
    acc = 1
    for _ in range(count):
        vals.append(FR.to_mont_int(acc))
        acc = acc * base % R
    return F.ints_to_limbs(vals)


#: domains at least this large use the four-step layout (batched
#: sub-NTTs along a non-lane axis -- see FourStepTables below)
FOURSTEP_MIN = 1 << 12


class DeviceDomain:
    """Twiddle/scaling tables for a 2^k domain, uploaded once."""

    def __init__(self, size: int, fourstep: bool = False):
        """fourstep: the backend profile's NTT layout choice (XLA:CPU
        compiles the four-step stage ops slowly, so tests and host-mesh
        runs keep the 2D unrolled form)."""
        self.size = size
        self.host = Domain(size)
        h = self.host
        half = max(size // 2, 1)
        self.rev = jnp.asarray(_bitrev_indices(size))
        self.w_fwd = jnp.asarray(_pow_table(h.omega, half))
        self.w_inv = jnp.asarray(_pow_table(h.omega_inv, half))
        use_fourstep = fourstep and size >= FOURSTEP_MIN
        self.fourstep = (
            FourStepTables(size, h.omega, h.size_inv) if use_fourstep else None
        )
        self.size_inv = jnp.asarray(F.int_to_limbs(FR.to_mont_int(h.size_inv)))
        # coset scaling vectors (folded with 1/n for the inverse)
        self.coset_pow = jnp.asarray(_pow_table(h.coset_gen, size))
        ginv_scaled = []
        acc = h.size_inv
        for _ in range(size):
            ginv_scaled.append(FR.to_mont_int(acc))
            acc = acc * h.coset_gen_inv % R
        self.coset_inv_pow = jnp.asarray(F.ints_to_limbs(ginv_scaled))
        self.z_coset_inv = jnp.asarray(
            F.int_to_limbs(FR.to_mont_int(h.z_coset_inv))
        )
        # plain g^-j (the four-step and sharded inverses fold 1/n
        # themselves)
        self.coset_inv_nofold = jnp.asarray(
            _pow_table(h.coset_gen_inv, size)
        )


def _ntt_core_unrolled(x, table, n: int):
    """Stage-unrolled radix-2 NTT (small n: static twiddle slices)."""
    x = x[:, np.asarray(_bitrev_indices(n))]
    length = 2
    while length <= n:
        half = length // 2
        stride = n // length
        tw = table[:, :: stride][:, :half]  # (16, half)
        xr = x.reshape(F.NLIMBS, n // length, length)
        u = xr[:, :, :half]
        v = xr[:, :, half:]
        twb = jnp.broadcast_to(tw[:, None, :], v.shape)
        vt = F.mont_mul(v, twb, FR)
        x = jnp.concatenate(
            [F.add_mod(u, vt, FR), F.sub_mod(u, vt, FR)], axis=2
        ).reshape(F.NLIMBS, n)
        length *= 2
    return x


def _ntt_core_fori(x, table, n: int):
    """Radix-2 NTT with ONE compiled stage body (fori over stages,
    stage-dependent butterfly indices computed from iota with dynamic
    shifts) -- keeps XLA compile time independent of log2(n)."""
    k = n.bit_length() - 1
    x = x[:, np.asarray(_bitrev_indices(n))]
    kk = jnp.arange(n // 2, dtype=jnp.int32)
    j = jnp.arange(n, dtype=jnp.int32)

    def stage(s, x):
        half = jnp.left_shift(jnp.int32(1), s)
        mask = half - 1
        block = jnp.right_shift(kk, s)
        t = kk & mask
        iu = jnp.left_shift(block, s + 1) | t
        iv = iu + half
        u = x[:, iu]
        v = x[:, iv]
        twidx = jnp.left_shift(t, k - 1 - s)
        vt = F.mont_mul(v, table[:, twidx], FR)
        addv = F.add_mod(u, vt, FR)
        subv = F.sub_mod(u, vt, FR)
        pairk = jnp.left_shift(jnp.right_shift(j, s + 1), s) | (j & mask)
        is_hi = jnp.right_shift(j, s) & 1
        return jnp.where(is_hi == 0, addv[:, pairk], subv[:, pairk])

    return jax.lax.fori_loop(0, k, stage, x)


def _ntt_core(x, table, n: int):
    """x: (16, n) Montgomery values; table: (16, n/2) master twiddles.

    The unrolled form is all reshape/slice/concat (no mid-stage
    gathers); the fori variant trades runtime for a
    log(n)-independent compile and remains available for experiments."""
    return _ntt_core_unrolled(x, table, n)


def ntt(dom: DeviceDomain, coeffs):
    if dom.fourstep is not None:
        return _fourstep_local_ntt(coeffs, dom.fourstep, inverse=False)
    return _ntt_core(coeffs, dom.w_fwd, dom.size)


def intt(dom: DeviceDomain, evals):
    if dom.fourstep is not None:
        return _fourstep_local_ntt(evals, dom.fourstep, inverse=True)
    x = _ntt_core(evals, dom.w_inv, dom.size)
    s = jnp.broadcast_to(dom.size_inv[:, None], x.shape)
    return F.mont_mul(x, s, FR)


def coset_ntt(dom: DeviceDomain, coeffs):
    scaled = F.mont_mul(coeffs, dom.coset_pow, FR)
    if dom.fourstep is not None:
        return _fourstep_local_ntt(scaled, dom.fourstep, inverse=False)
    return _ntt_core(scaled, dom.w_fwd, dom.size)


def coset_intt(dom: DeviceDomain, evals):
    if dom.fourstep is not None:
        x = _fourstep_local_ntt(evals, dom.fourstep, inverse=True)
        return F.mont_mul(x, dom.coset_inv_nofold, FR)
    x = _ntt_core(evals, dom.w_inv, dom.size)
    return F.mont_mul(x, dom.coset_inv_pow, FR)


# -- piecewise (compile-shared) NTT drivers -----------------------------------
# One giant jitted prover graph inlines every NTT stage of every call:
# XLA compile time scales superlinearly with HLO op count (~7 NTTs
# x log2(n) stages x ~300-op Montgomery muls blew past 3 minutes at
# n=2^14). These drivers jit the NTT CORE once per size with the
# twiddle tables as *arguments*, so forward/inverse/coset calls -- and
# every h_coeffs invocation -- share a single compiled graph, plus one
# tiny elementwise-scale graph.

_piece_jits: dict = {}


def _core_jit(size: int, fourstep: bool):
    key = ("core", size, fourstep)
    fn = _piece_jits.get(key)
    if fn is None:
        if fourstep:
            def run(x, t2, t1, inter, n1, n2):
                xr = x.reshape(F.NLIMBS, n2, n1)
                a = _sub_ntt_axis1(xr, t2, n2)
                a = F.mont_mul(a, inter, FR)
                a = jnp.swapaxes(a, 1, 2)
                b = _sub_ntt_axis1(a, t1, n1)
                return b.reshape(F.NLIMBS, n1 * n2)

            fn = jax.jit(run, static_argnums=(4, 5))
        else:
            def run(x, table):
                return _ntt_core(x, table, size)

            fn = jax.jit(run)
        _piece_jits[key] = fn
    return fn


def _scale():
    """Elementwise Montgomery multiply by a (16, n) or (16, 1) vector."""
    fn = _piece_jits.get("scale")
    if fn is None:
        fn = jax.jit(
            lambda x, v: F.mont_mul(x, jnp.broadcast_to(v, x.shape), FR)
        )
        _piece_jits["scale"] = fn
    return fn


def _run_core(dom: DeviceDomain, x, inverse: bool):
    fs = dom.fourstep
    if fs is not None:
        t2 = fs.t2_inv if inverse else fs.t2_fwd
        t1 = fs.t1_inv if inverse else fs.t1_fwd
        inter = fs.inter_inv if inverse else fs.inter_fwd
        return _core_jit(dom.size, True)(x, t2, t1, inter, fs.n1, fs.n2)
    table = dom.w_inv if inverse else dom.w_fwd
    return _core_jit(dom.size, False)(x, table)


def ntt_steps(dom: DeviceDomain, coeffs):
    """ntt() as separately-jitted device calls (compile-shared)."""
    return _run_core(dom, coeffs, inverse=False)


def intt_steps(dom: DeviceDomain, evals):
    x = _run_core(dom, evals, inverse=True)
    if dom.fourstep is not None:  # four-step inverse folds 1/n already
        return x
    return _scale()(x, dom.size_inv[:, None])


def coset_ntt_steps(dom: DeviceDomain, coeffs):
    return _run_core(dom, _scale()(coeffs, dom.coset_pow), inverse=False)


def coset_intt_steps(dom: DeviceDomain, evals):
    x = _run_core(dom, evals, inverse=True)
    if dom.fourstep is not None:
        return _scale()(x, dom.coset_inv_nofold)
    return _scale()(x, dom.coset_inv_pow)


# -- local four-step NTT ------------------------------------------------------
# Butterflies along the lane axis relayout data every stage; splitting
# n = n1*n2 runs batched sub-NTTs along a NON-lane axis (lanes stay
# full and stages are static slices), with one transpose and an
# elementwise inter-factor twiddle in between.


def _sub_ntt_axis1(x, table, S: int):
    """Radix-2 NTT along axis 1 of (16, S, lanes); table (16, S/2)."""
    lanes = x.shape[2]
    x = x[:, np.asarray(_bitrev_indices(S)), :]
    length = 2
    while length <= S:
        half = length // 2
        stride = S // length
        tw = table[:, ::stride][:, :half]  # (16, half)
        xr = x.reshape(F.NLIMBS, S // length, length, lanes)
        u = xr[:, :, :half, :]
        v = xr[:, :, half:, :]
        twb = jnp.broadcast_to(tw[:, None, :, None], v.shape)
        vt = F.mont_mul(v, twb, FR)
        x = jnp.concatenate(
            [F.add_mod(u, vt, FR), F.sub_mod(u, vt, FR)], axis=2
        ).reshape(F.NLIMBS, S, lanes)
        length *= 2
    return x


class FourStepTables:
    """Precomputed tables for the single-chip four-step NTT."""

    def __init__(self, size: int, omega: int, size_inv: int):
        k = size.bit_length() - 1
        self.n1 = 1 << ((k + 1) // 2)
        self.n2 = size // self.n1
        self.size = size
        # sub-domain master twiddles (canonical roots coincide with
        # omega^{n1} / omega^{n2})
        sub1 = Domain(self.n1)
        sub2 = Domain(self.n2)
        self.t1_fwd = jnp.asarray(_pow_table(sub1.omega, max(self.n1 // 2, 1)))
        self.t1_inv = jnp.asarray(
            _pow_table(sub1.omega_inv, max(self.n1 // 2, 1))
        )
        self.t2_fwd = jnp.asarray(_pow_table(sub2.omega, max(self.n2 // 2, 1)))
        self.t2_inv = jnp.asarray(
            _pow_table(sub2.omega_inv, max(self.n2 // 2, 1))
        )
        # inter-factor twiddles W[k2, j1] = omega^(j1*k2); inverse folds 1/n
        self.inter_fwd = jnp.asarray(self._inter(omega, 1))
        self.inter_inv = jnp.asarray(
            self._inter(pow(omega, R - 2, R), size_inv)
        )

    def _inter(self, w: int, scale: int) -> np.ndarray:
        out = np.empty((F.NLIMBS, self.n2, self.n1), dtype=np.uint32)
        for k2 in range(self.n2):
            wk = pow(w, k2, R)
            row = []
            acc = scale % R
            for _ in range(self.n1):
                row.append(FR.to_mont_int(acc))
                acc = acc * wk % R
            out[:, k2, :] = F.ints_to_limbs(row)
        return out


def _fourstep_local_ntt(x, tabs: FourStepTables, inverse: bool):
    """(16, n) natural order -> (16, n) natural order (single chip)."""
    n1, n2 = tabs.n1, tabs.n2
    xr = x.reshape(F.NLIMBS, n2, n1)  # element (j2, j1) = x[j1 + n1*j2]
    t2 = tabs.t2_inv if inverse else tabs.t2_fwd
    t1 = tabs.t1_inv if inverse else tabs.t1_fwd
    inter = tabs.inter_inv if inverse else tabs.inter_fwd
    a = _sub_ntt_axis1(xr, t2, n2)          # inner NTT over j2
    a = F.mont_mul(a, inter, FR)            # omega^(j1*k2) (+ 1/n inverse)
    a = jnp.swapaxes(a, 1, 2)               # (16, n1, n2): axis1 = j1
    b = _sub_ntt_axis1(a, t1, n1)           # outer NTT over j1
    return b.reshape(F.NLIMBS, n1 * n2)     # [k1, k2] -> k2 + n2*k1 natural
