"""Batched modular big-integer arithmetic on 16-bit limb vectors.

Representation: a field element is 16 little-endian limbs of 16 bits
stored as uint32, shape ``(16, ...)`` (limb axis leading, the batch on
the trailing axes). Products of two 16-bit limbs are exact in uint32;
partial-product columns accumulate at most 32 terms of 16 bits so
column sums stay < 2^21 -- no overflow anywhere, no 64-bit arithmetic.

Montgomery arithmetic with R = 2^256: ``mont_mul(a, b) = a*b*R^-1``.
The same code runs as plain jitted XLA on the CPU and the GPU; the
host golden model is za_tpu.curve / Python ints.

Reference behavior being replaced: bn128 Fq/Fr arithmetic inside the
pairing_ce/bellman_ce forks (SURVEY.md section 2.3).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NLIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
MONT_BITS = NLIMBS * LIMB_BITS  # R = 2^256


def int_to_limbs(v: int) -> np.ndarray:
    """Python int -> (16,) uint32 limb array."""
    return np.array(
        [(v >> (LIMB_BITS * i)) & MASK for i in range(NLIMBS)], dtype=np.uint32
    )


def ints_to_limbs(vs) -> np.ndarray:
    """list of ints (< 2^256) -> (16, n) uint32 (vectorized byte pack)."""
    buf = b"".join(v.to_bytes(32, "little") for v in vs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vs), NLIMBS)
    return np.ascontiguousarray(arr.T).astype(np.uint32)


def limbs_to_int(a) -> int:
    a = np.asarray(a)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(a.shape[0]))


def limbs_to_ints(a) -> list:
    """(16, n) canonical 16-bit digits -> list of n ints (byte pack)."""
    a = np.asarray(a)
    packed = a.astype("<u2").T.copy().tobytes()
    return [
        int.from_bytes(packed[j * 32 : (j + 1) * 32], "little")
        for j in range(a.shape[1])
    ]


class FpParams:
    """Montgomery constants for a modulus (used for both Fr and Fq)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.r_mod = (1 << MONT_BITS) % modulus
        self.r2 = (1 << (2 * MONT_BITS)) % modulus
        self.n_prime = (-pow(modulus, -1, 1 << MONT_BITS)) % (1 << MONT_BITS)
        self.mod_limbs = int_to_limbs(modulus)
        self.np_limbs = int_to_limbs(self.n_prime)
        self.r2_limbs = int_to_limbs(self.r2)
        self.one_mont = int_to_limbs(self.r_mod)
        self.one_plain = int_to_limbs(1)
        self.zero = int_to_limbs(0)

    def to_mont_int(self, v: int) -> int:
        return v * self.r_mod % self.modulus

    def from_mont_int(self, v: int) -> int:
        return v * pow(self.r_mod, -1, self.modulus) % self.modulus


from ..curve import Q as _Q, R as _R  # noqa: E402

FR = FpParams(_R)
FQ = FpParams(_Q)


# -- carry / compare primitives ----------------------------------------------


def _shift_up(x):
    """Shift limb vectors up by one position (toward higher limbs)."""
    pad = [(1, 0)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)[:-1]


def _ks_resolve(e):
    """Resolve single-bit ripple carries on digits e <= 2^16 + eps via a
    Kogge-Stone parallel prefix over the limb axis (log2(L) fixed steps,
    no sequential loop).

    e: (L, ...) uint32 with e[k] + 1 < 2^17; returns canonical digits,
    dropping carry out of the top limb (callers guarantee it is zero)."""
    L = e.shape[0]
    g = (e >> LIMB_BITS).astype(jnp.uint32)  # generates carry (0/1)
    p = ((e & MASK) == MASK).astype(jnp.uint32)  # propagates carry
    # carry INTO limb k = prefix combine of (g, p) over limbs < k
    shift = 1
    while shift < L:
        g_prev = jnp.pad(g, [(shift, 0)] + [(0, 0)] * (g.ndim - 1))[:-shift]
        p_prev = jnp.pad(p, [(shift, 0)] + [(0, 0)] * (p.ndim - 1))[:-shift]
        g = g | (p & g_prev)
        p = p & p_prev
        shift *= 2
    carry_in = _shift_up(g)
    return (e + carry_in) & MASK


def carry_prop(cols):
    """Exact carry propagation: (L, ...) uint32 columns (any values
    < 2^32) -> (L, ...) canonical 16-bit digits. Two local split passes
    bring digits to <= 2^16 + 2, then a Kogge-Stone pass resolves the
    remaining binary ripple. Constant depth, no loops. The carry out of
    the top limb must be zero (callers guarantee bounds)."""
    e = (cols & MASK) + _shift_up(cols >> LIMB_BITS)
    e = (e & MASK) + _shift_up(e >> LIMB_BITS)
    return _ks_resolve(e)


def sub_borrow(a, b):
    """a - b with borrow chain; returns (digits, borrow_out in {0,1}).

    Implemented as a + ~b + 1 on 16-bit limb complements so the same
    Kogge-Stone carry machinery applies; borrow = !carry_out."""
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    a = jnp.broadcast_to(a, shape)
    b = jnp.broadcast_to(b, shape)
    L = a.shape[0]
    e = a + (b ^ MASK)
    # +1 at limb 0 via an iota mask (no scatter-add)
    limb0 = jax.lax.broadcasted_iota(jnp.uint32, e.shape, 0) == 0
    e = e + jnp.where(limb0, jnp.uint32(1), jnp.uint32(0))
    # limb sums <= 2^17 - 1: one local split pass, keeping the top carry
    local_top = e[L - 1] >> LIMB_BITS
    e = (e & MASK) + _shift_up(e >> LIMB_BITS)
    # digits <= 2^16: Kogge-Stone for the remaining binary ripple
    g = (e >> LIMB_BITS).astype(jnp.uint32)
    p = ((e & MASK) == MASK).astype(jnp.uint32)
    shift = 1
    while shift < L:
        g_prev = jnp.pad(g, [(shift, 0)] + [(0, 0)] * (g.ndim - 1))[:-shift]
        p_prev = jnp.pad(p, [(shift, 0)] + [(0, 0)] * (p.ndim - 1))[:-shift]
        g = g | (p & g_prev)
        p = p & p_prev
        shift *= 2
    carry_in = _shift_up(g)
    digits = (e + carry_in) & MASK
    ks_top = (e[L - 1] + carry_in[L - 1]) >> LIMB_BITS
    carry_out = (local_top + ks_top).astype(jnp.int32)  # in {0, 1}
    borrow = 1 - carry_out
    return digits, borrow


def add_nocarry(a, b):
    """a + b, both canonical 16-bit digits; exact carry propagation
    (result must fit in L limbs)."""
    return carry_prop(a + b)


def geq(a, b):
    """a >= b for canonical digit vectors."""
    _, br = sub_borrow(a, b)
    return br == 0


# -- modular add/sub/neg ------------------------------------------------------


def _bshape(modl, x):
    """Broadcast a constant vector against x along the LEADING axes:
    (16,) limbs, (35,) RNS channels, or (35, 2) flat-Fq2 constants."""
    m = np.asarray(modl)
    extra = x.ndim - m.ndim
    shape = m.shape + (1,) * extra
    if isinstance(modl, np.ndarray):
        return jnp.asarray(modl.reshape(shape))
    return jnp.asarray(modl).reshape(shape)


def add_mod(a, b, p: FpParams):
    s = carry_prop(a + b)  # < 2N < 2^257? N < 2^254 so sum < 2^255: fits
    n = _bshape(p.mod_limbs, a)
    d, br = sub_borrow(s, n)
    return jnp.where(br == 0, d, s)


def sub_mod(a, b, p: FpParams):
    d, br = sub_borrow(a, b)
    n = _bshape(p.mod_limbs, a)
    dn = carry_prop(d + n)
    return jnp.where(br == 1, dn, d)


def neg_mod(a, p: FpParams):
    """(N - a) mod N; maps 0 -> 0."""
    n = _bshape(p.mod_limbs, a)
    d, _ = sub_borrow(n, a)
    is_zero = jnp.all(a == 0, axis=0)
    return jnp.where(is_zero, a, d)


# -- wide multiply + Montgomery reduction ------------------------------------


def mul_wide(a, b):
    """Full 512-bit product as 32 columns of < 2^21 digits.

    a, b: (16, ...) canonical 16-bit digits. Vectorized over the limb
    axis: ONE broadcast outer product (16, 16, ...) followed by 16
    pad-shifted row folds -- ~60 HLO ops per product instead of the
    ~770 a per-column Python loop emits (XLA compile time and
    per-op dispatch both scale with op count, and a full prover graph
    inlines dozens of these). Column sums gather at most 32 16-bit
    terms -> < 2^21, no overflow in uint32."""
    p = a[:, None] * b[None, :]  # (16, 16, ...) exact u32 products
    pl_ = p & MASK
    ph = p >> LIMB_BITS
    tail = [(0, 0)] * (a.ndim - 1)
    cols = None
    for i in range(NLIMBS):
        # row i contributes lo at columns i..i+15, hi at i+1..i+16
        row = jnp.pad(pl_[i], [(i, NLIMBS - i)] + tail) + jnp.pad(
            ph[i], [(i + 1, NLIMBS - 1 - i)] + tail
        )
        cols = row if cols is None else cols + row
    return cols


def mul_lo(a, b):
    """Low 256 bits of a*b as canonical digits (mod 2^256): the low 16
    columns of the wide product, carried with overflow dropped."""
    cols = mul_wide(a, b)[:NLIMBS]
    return carry_prop(cols)  # final carry dropped by construction


def redc_wide(t_cols, p: FpParams):
    """Montgomery reduction of a 32-column value t < N*R (digits may be
    non-canonical, up to ~2^26): returns t*R^-1 mod N as canonical digits."""
    t = carry_prop(t_cols)  # canonical 32 digits
    npr = _bshape(p.np_limbs, t[:NLIMBS])
    m = mul_lo(t[:NLIMBS], npr)  # m = (t mod R) * N' mod R
    n = _bshape(p.mod_limbs, m)
    u = t + mul_wide(m, n)  # columns < 2^21 + 2^16: safe
    u = carry_prop(u)
    res = u[NLIMBS:]
    d, br = sub_borrow(res, n)
    return jnp.where(br == 0, d, res)


def mont_mul(a, b, p: FpParams):
    """a * b * R^-1 mod N (Montgomery product)."""
    return redc_wide(mul_wide(a, b), p)


def to_mont(a, p: FpParams):
    return mont_mul(a, _bshape(p.r2_limbs, a), p)


def from_mont(a, p: FpParams):
    return mont_mul(a, _bshape(p.one_plain, a), p)


def mont_sqr(a, p: FpParams):
    return mont_mul(a, a, p)


def mont_pow(a, e: int, p: FpParams):
    """Static-exponent power, unrolled: use only for SMALL exponents
    (every set bit becomes a mont_mul in the graph)."""
    result = jnp.broadcast_to(_bshape(p.one_mont, a), a.shape)
    base = a
    while e:
        if e & 1:
            result = mont_mul(result, base, p)
        base = mont_sqr(base, p)
        e >>= 1
    return result


def mont_pow_bits(a, e: int, p: FpParams):
    """Static 256-bit exponent power via fori_loop (square-and-multiply
    LSB-first) -- small compiled graph."""
    nbits = max(e.bit_length(), 1)
    bits = jnp.asarray(
        np.array([(e >> i) & 1 for i in range(nbits)], dtype=np.uint32)
    )
    one = jnp.broadcast_to(_bshape(p.one_mont, a), a.shape)

    def body(i, state):
        result, base = state
        mul = mont_mul(result, base, p)
        result = jnp.where(bits[i] == 1, mul, result)
        base = mont_sqr(base, p)
        return result, base

    result, _ = jax.lax.fori_loop(0, nbits, body, (one, a))
    return result


def mont_inv(a, p: FpParams):
    """Batched inversion via Fermat (a^(N-2)); maps 0 -> 0."""
    return mont_pow_bits(a, p.modulus - 2, p)


def batch_inverse_mont(a, p: FpParams):
    """Montgomery batch inversion along the last axis: one Fermat
    inversion + 3(n-1) muls. Requires all entries nonzero."""
    n = a.shape[-1]
    if n == 1:
        return mont_inv(a, p)

    def scan_fwd(carry, x):
        nxt = mont_mul(carry, x, p)
        return nxt, carry

    one = jnp.broadcast_to(_bshape(p.one_mont, a[..., 0]), a[..., 0].shape)
    # prefix[i] = a_0 * ... * a_{i-1}
    a_t = jnp.moveaxis(a, -1, 0)
    total, prefixes = jax.lax.scan(scan_fwd, one, a_t)
    inv_total = mont_inv(total, p)

    def scan_bwd(carry, xs):
        x, prefix = xs
        out = mont_mul(carry, prefix, p)
        carry = mont_mul(carry, x, p)
        return carry, out

    _, invs = jax.lax.scan(scan_bwd, inv_total, (a_t, prefixes), reverse=True)
    return jnp.moveaxis(invs, 0, -1)


# -- Fq2 on limb pairs (for G2) ----------------------------------------------
# An Fq2 element is a pair (c0, c1) of (16, ...) limb arrays; i^2 = -1.


def fq2_add(a, b, p=FQ):
    return (add_mod(a[0], b[0], p), add_mod(a[1], b[1], p))


def fq2_sub(a, b, p=FQ):
    return (sub_mod(a[0], b[0], p), sub_mod(a[1], b[1], p))


def fq2_neg(a, p=FQ):
    return (neg_mod(a[0], p), neg_mod(a[1], p))


def fq2_mul(a, b, p=FQ):
    a0, a1 = a
    b0, b1 = b
    t0 = mont_mul(a0, b0, p)
    t1 = mont_mul(a1, b1, p)
    # (a0+a1)(b0+b1) - t0 - t1
    cross = mont_mul(add_mod(a0, a1, p), add_mod(b0, b1, p), p)
    c1 = sub_mod(sub_mod(cross, t0, p), t1, p)
    c0 = sub_mod(t0, t1, p)
    return (c0, c1)


def fq2_sqr(a, p=FQ):
    return fq2_mul(a, a, p)


def fq2_scale(a, s, p=FQ):
    """Multiply Fq2 by an Fq scalar (limb array)."""
    return (mont_mul(a[0], s, p), mont_mul(a[1], s, p))
