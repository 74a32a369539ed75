"""Radix-2 NTT over Fr in the RNS representation.

The limb NTT's butterflies pay ~8k elementwise u32 ops per Montgomery
twiddle multiply; in RNS (za_tpu.engine.rns) the same multiply is ~1.9k
ops with the CRT extensions as int8 dots, so the h(x) pipeline --
dominated by 7 NTTs at domain size -- drops proportionally.

Integer-bound bookkeeping (rns.py discipline): butterfly outputs
  u' = u + w*v        (bound B + 4N)
  v' = u + 8N - w*v   (bound B + 8N, via the 8N sub offset: the
                       subtrahend is always a fresh mul output < 4N)
grow by <= 8N per stage from a start of 4N, so 2^20 domains peak at
164N -- comfortably inside the 512N mont_mul contract; every twiddle
multiply resets its output to < 4N.

All values are M1-Montgomery residues (x~ = X*M1 mod r); tables are
Montgomery-form constants. Mirrors the host golden model
za_tpu.groth16.domain.Domain and the limb engine za_tpu.engine.ntt.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..curve import R
from ..groth16.domain import Domain
from . import rns as RNS
from .ntt import _bitrev_indices
from .rns import RR


def _mont_table(vals) -> np.ndarray:
    """list of Fr ints -> (35, n) Montgomery RNS residues, u16
    (residues < 2^16; mont_mul_rns widens on use -- constant tables
    resident at half the HBM)."""
    return RR.ints_to_rns(
        [v * RR.m1 % R for v in vals]
    ).astype(np.uint16)


def _pow_list(base: int, count: int) -> list[int]:
    out = []
    acc = 1
    for _ in range(count):
        out.append(acc)
        acc = acc * base % R
    return out


def _doubling(x, p, width: int, count: int):
    """Extend x (35, ..., width) by geometric doubling along the last
    axis: x[..., j + w] = x[..., j] * p^w (p broadcast on that axis),
    until count entries; u16 out."""
    x = x.astype(jnp.uint32)
    p = p.astype(jnp.uint32)
    while width < count:
        step = RNS.mont_mul_rns(x, jnp.broadcast_to(p, x.shape), RR)
        x = jnp.concatenate([x, step], axis=-1)
        p = RNS.mont_mul_rns(p, p, RR)
        width *= 2
    return x[..., :count].astype(jnp.uint16)


#: the doubling runs as one program per table size instead of a stream
#: of op-by-op dispatches, each compiled for its own width
_doubling_jit = jax.jit(_doubling, static_argnums=(2, 3))


def geom_table(base: int, count: int, scale: int = 1):
    """(35, count) u16 Montgomery RNS table of [scale * base^i]:
    built on DEVICE by axis doubling (log2(count) full-width mont
    muls).  The host _pow_list at 2^21 costs ~2M big-int multiplies
    (tens of seconds of domain construction); this is milliseconds."""
    return _doubling_jit(
        _mont_table([scale % R]), _mont_table([base % R]), 1, count
    )


#: domains at least this large use the four-step layout where the
#: backend profile asks for it (see ntt.py FourStepTables)
FOURSTEP_MIN = 1 << 12


class RnsDomain:
    """Twiddle/scaling tables for a 2^k domain in Montgomery RNS.

    fourstep: the backend profile's NTT layout choice."""

    def __init__(self, size: int, fourstep: bool = False):
        self.size = size
        self.host = Domain(size)
        h = self.host
        self.fourstep = (
            RnsFourStep(size, h.omega, h.size_inv)
            if fourstep and size >= FOURSTEP_MIN
            else None
        )
        if self.fourstep is None:
            half = max(size // 2, 1)
            self.w_fwd = jnp.asarray(_mont_table(_pow_list(h.omega, half)))
            self.w_inv = jnp.asarray(
                _mont_table(_pow_list(h.omega_inv, half))
            )
        self.size_inv = jnp.asarray(_mont_table([h.size_inv]))
        self.coset_pow = geom_table(h.coset_gen, size)
        if self.fourstep is None:
            # inverse coset scaling with 1/n folded in
            self.coset_inv_pow = geom_table(
                h.coset_gen_inv, size, scale=h.size_inv
            )
        else:
            # the four-step inverse folds 1/n into its inter twiddles
            self.coset_inv_nofold = geom_table(h.coset_gen_inv, size)
        self.z_coset_inv = jnp.asarray(_mont_table([h.z_coset_inv]))


class RnsFourStep:
    """Four-step tables: n = n1*n2, batched sub-NTTs along a non-lane
    axis with an elementwise inter-factor twiddle (+1/n on the inverse)
    in between (RNS port of ntt.FourStepTables)."""

    def __init__(self, size: int, omega: int, size_inv: int):
        k = size.bit_length() - 1
        self.n1 = 1 << ((k + 1) // 2)
        self.n2 = size // self.n1
        self.size = size
        sub1 = Domain(self.n1)
        sub2 = Domain(self.n2)
        self.t1_fwd = jnp.asarray(
            _mont_table(_pow_list(sub1.omega, max(self.n1 // 2, 1)))
        )
        self.t1_inv = jnp.asarray(
            _mont_table(_pow_list(sub1.omega_inv, max(self.n1 // 2, 1)))
        )
        self.t2_fwd = jnp.asarray(
            _mont_table(_pow_list(sub2.omega, max(self.n2 // 2, 1)))
        )
        self.t2_inv = jnp.asarray(
            _mont_table(_pow_list(sub2.omega_inv, max(self.n2 // 2, 1)))
        )
        self.inter_fwd = self._inter(omega, 1)
        self.inter_inv = self._inter(pow(omega, R - 2, R), size_inv)

    def _inter(self, w: int, scale: int):
        """(35, n2, n1) u16: inter[k2, j1] = scale * w^(k2*j1), built
        on DEVICE by doubling the j1 axis (log2(n1) mont muls over the
        full (35, n2, width) block); only the n2 row bases w^k2 are
        host big-int work."""
        n1, n2 = self.n1, self.n2
        wk = _pow_list(w, n2)  # w^k2, host (n2 muls)
        p = _mont_table(wk)[:, :, None]                      # (35, n2, 1)
        x = _mont_table([scale % R] * n2)[:, :, None]        # (35, n2, 1)
        return _doubling_jit(x, p, 1, n1)


def _ntt_core(x, table, n: int):
    """Stage-unrolled radix-2 NTT on (35, n) Montgomery residues."""
    x = x[:, np.asarray(_bitrev_indices(n))]
    length = 2
    while length <= n:
        half = length // 2
        stride = n // length
        tw = table[:, ::stride][:, :half]  # (35, half)
        xr = x.reshape(RNS.N_CH, n // length, length)
        u = xr[:, :, :half]
        v = xr[:, :, half:]
        twb = jnp.broadcast_to(tw[:, None, :], v.shape)
        vt = RNS.mont_mul_rns(v, twb, RR)
        x = jnp.concatenate(
            [
                RNS.ch_add(u, vt, RR),
                RNS.ch_sub_off(u, vt, RR, off_vec=RR.sub_off8),
            ],
            axis=2,
        ).reshape(RNS.N_CH, n)
        length *= 2
    return x


def _scale(x, v):
    """Elementwise Montgomery multiply by a (35, n) or (35, 1) vector
    (resets the integer bound to < 4N)."""
    return RNS.mont_mul_rns(x, jnp.broadcast_to(v, x.shape), RR)


def _core_eager(dom: "RnsDomain", x, inverse: bool):
    fs = dom.fourstep
    if fs is not None:
        return _fourstep_core(
            x,
            fs.t2_inv if inverse else fs.t2_fwd,
            fs.t1_inv if inverse else fs.t1_fwd,
            fs.inter_inv if inverse else fs.inter_fwd,
            fs.n1, fs.n2,
        )
    return _ntt_core(x, dom.w_inv if inverse else dom.w_fwd, dom.size)


def ntt(dom: RnsDomain, coeffs):
    return _core_eager(dom, coeffs, inverse=False)


def intt(dom: RnsDomain, evals):
    x = _core_eager(dom, evals, inverse=True)
    if dom.fourstep is not None:  # inverse folds 1/n already
        return x
    return _scale(x, dom.size_inv)


def coset_ntt(dom: RnsDomain, coeffs):
    return _core_eager(dom, _scale(coeffs, dom.coset_pow), inverse=False)


def coset_intt(dom: RnsDomain, evals):
    x = _core_eager(dom, evals, inverse=True)
    if dom.fourstep is not None:
        return _scale(x, dom.coset_inv_nofold)
    return _scale(x, dom.coset_inv_pow)


# -- four-step core (lane-friendly stage layout) ------------------------------


def _sub_ntt_axis1(x, table, S: int):
    """Radix-2 NTT along axis 1 of (35, S, lanes); table (35, S/2).
    Bounds: butterfly outputs grow <= 8N per stage from a < 4N start
    (each twiddle multiply resets its own output to < 4N)."""
    lanes = x.shape[2]
    x = x[:, np.asarray(_bitrev_indices(S)), :]
    length = 2
    while length <= S:
        half = length // 2
        stride = S // length
        tw = table[:, ::stride][:, :half]  # (35, half)
        xr = x.reshape(RNS.N_CH, S // length, length, lanes)
        u = xr[:, :, :half, :]
        v = xr[:, :, half:, :]
        twb = jnp.broadcast_to(tw[:, None, :, None], v.shape)
        vt = RNS.mont_mul_rns(v, twb, RR)
        x = jnp.concatenate(
            [
                RNS.ch_add(u, vt, RR),
                RNS.ch_sub_off(u, vt, RR, off_vec=RR.sub_off8),
            ],
            axis=2,
        ).reshape(RNS.N_CH, S, lanes)
        length *= 2
    return x


def _fourstep_core(x, t2, t1, inter, n1: int, n2: int):
    """(35, n) natural order -> (35, n) natural order."""
    xr = x.reshape(RNS.N_CH, n2, n1)      # element (j2, j1) = x[j1 + n1*j2]
    a = _sub_ntt_axis1(xr, t2, n2)        # inner NTT over j2
    a = RNS.mont_mul_rns(a, inter, RR)    # omega^(j1*k2) (+ 1/n inverse)
    a = jnp.swapaxes(a, 1, 2)             # (35, n1, n2): axis1 = j1
    b = _sub_ntt_axis1(a, t1, n1)         # outer NTT over j1
    return b.reshape(RNS.N_CH, n1 * n2)   # [k1, k2] -> natural order


# -- compile-shared drivers (one jitted core per size, tables as args) --------

_piece_jits: dict = {}


def _core_jit(size: int, fourstep: bool):
    key = ("rns_core", size, fourstep)
    fn = _piece_jits.get(key)
    if fn is None:
        if fourstep:
            fn = jax.jit(_fourstep_core, static_argnums=(4, 5))
        else:
            fn = jax.jit(lambda x, table: _ntt_core(x, table, size))
        _piece_jits[key] = fn
    return fn


def _scale_jit():
    fn = _piece_jits.get("rns_scale")
    if fn is None:
        fn = jax.jit(_scale)
        _piece_jits["rns_scale"] = fn
    return fn


def _run_core(dom: RnsDomain, x, inverse: bool):
    fs = dom.fourstep
    if fs is not None:
        t2 = fs.t2_inv if inverse else fs.t2_fwd
        t1 = fs.t1_inv if inverse else fs.t1_fwd
        inter = fs.inter_inv if inverse else fs.inter_fwd
        return _core_jit(dom.size, True)(x, t2, t1, inter, fs.n1, fs.n2)
    table = dom.w_inv if inverse else dom.w_fwd
    return _core_jit(dom.size, False)(x, table)


def ntt_steps(dom: RnsDomain, coeffs):
    return _run_core(dom, coeffs, inverse=False)


def intt_steps(dom: RnsDomain, evals):
    x = _run_core(dom, evals, inverse=True)
    if dom.fourstep is not None:  # four-step inverse folds 1/n already
        return x
    return _scale_jit()(x, dom.size_inv)


def coset_ntt_steps(dom: RnsDomain, coeffs):
    scaled = _scale_jit()(coeffs, dom.coset_pow)
    return _run_core(dom, scaled, inverse=False)


def coset_intt_steps(dom: RnsDomain, evals):
    x = _run_core(dom, evals, inverse=True)
    if dom.fourstep is not None:
        return _scale_jit()(x, dom.coset_inv_nofold)
    return _scale_jit()(x, dom.coset_inv_pow)
