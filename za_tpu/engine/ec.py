"""Batched elliptic-curve group law on limb vectors (G1 over Fq, G2 over Fq2).

Uses the Renes-Costello-Batina complete addition formulas for a=0
short-Weierstrass curves (homogeneous projective coordinates, identity
(0:1:0)): 12M + 2 mul-by-3b, fully branchless -- no doubling/infinity
special cases, which is exactly what SIMD bucket accumulation needs.
Inputs restricted to the odd-prime-order r subgroups (always true for
Groth16 key/proof material), where the formulas are complete.

Coordinates are Montgomery-form limb arrays (za_tpu.engine.field);
a G1 point is (X, Y, Z) of (16, ...) arrays, a G2 point is the same
with Fq2 pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..curve import B2, Q
from . import field as F
from .field import FQ


class FieldOps:
    """Field interface consumed by the generic group law.

    mul_many batches a list of independent products into ONE limb
    multiply (stacked along a new axis): the group law needs only 3
    multiply layers, keeping both the compiled graph tiny and the
    elementwise batch wide.
    """

    def __init__(self, add, sub, mul, b3_mul, zero, one, mul_many, b3_const,
                 add_many, sub_many):
        self.add = add
        self.sub = sub
        self.mul = mul
        self.b3_mul = b3_mul    # multiply by 3*b (curve constant)
        self.zero = zero        # limb constant, broadcastable
        self.one = one
        self.mul_many = mul_many  # [(a,b), ...] -> [a*b, ...]
        self.b3_const = b3_const  # like -> 3*b broadcast to like's shape
        self.add_many = add_many  # [(a,b), ...] -> [a+b, ...]
        self.sub_many = sub_many


# -- G1: y^2 = x^3 + 3, b3 = 9 ------------------------------------------------

_B3_G1 = FQ.to_mont_int(9)
_B3_G1_LIMBS = F.int_to_limbs(_B3_G1)


def _bcast(const_limbs, like):
    return F._bshape(const_limbs, like)


def make_g1_ops(fq=FQ, b3_limbs=_B3_G1_LIMBS, one_limbs=None,
                zero_limbs=None) -> "FieldOps":
    """Build the G1 FieldOps over explicit constants.

    The defaults are the module-level host numpy constants."""
    if one_limbs is None:
        one_limbs = F.int_to_limbs(fq.r_mod) if hasattr(fq, "r_mod") \
            else F.int_to_limbs(FQ.r_mod)
    if zero_limbs is None:
        zero_limbs = F.int_to_limbs(0)

    def add(a, b):
        return F.add_mod(a, b, fq)

    def sub(a, b):
        return F.sub_mod(a, b, fq)

    def mul(a, b):
        return F.mont_mul(a, b, fq)

    def b3_mul(a):
        return F.mont_mul(a, _bcast(b3_limbs, a), fq)

    def mul_many(pairs):
        k = len(pairs)
        A = jnp.stack([a for a, _ in pairs], axis=1)  # (16, k, ...)
        B = jnp.stack([b for _, b in pairs], axis=1)
        P = F.mont_mul(A, B, fq)
        return [P[:, i] for i in range(k)]

    def add_many(pairs):
        A = jnp.stack([a for a, _ in pairs], axis=1)
        B = jnp.stack([b for _, b in pairs], axis=1)
        S = F.add_mod(A, B, fq)
        return [S[:, i] for i in range(len(pairs))]

    def sub_many(pairs):
        A = jnp.stack([a for a, _ in pairs], axis=1)
        B = jnp.stack([b for _, b in pairs], axis=1)
        S = F.sub_mod(A, B, fq)
        return [S[:, i] for i in range(len(pairs))]

    def b3_const(like):
        return jnp.broadcast_to(_bcast(b3_limbs, like), like.shape)

    return FieldOps(
        add, sub, mul, b3_mul,
        zero=zero_limbs,
        one=one_limbs,
        mul_many=mul_many,
        b3_const=b3_const,
        add_many=add_many,
        sub_many=sub_many,
    )


G1_OPS = make_g1_ops()

# -- G2: y^2 = x^3 + 3/(9+i), b3 = 3*B2 over Fq2 ------------------------------

_B3_G2_C0 = FQ.to_mont_int((3 * B2.c0) % Q)
_B3_G2_C1 = FQ.to_mont_int((3 * B2.c1) % Q)
_B3_G2_LIMBS = (F.int_to_limbs(_B3_G2_C0), F.int_to_limbs(_B3_G2_C1))


def make_g2_ops(fq=FQ, b3_limbs=_B3_G2_LIMBS, one_limbs=None,
                zero_limbs=None) -> "FieldOps":
    """G2 FieldOps over explicit constants (see make_g1_ops)."""
    if one_limbs is None:
        one_limbs = F.int_to_limbs(fq.r_mod) if hasattr(fq, "r_mod") \
            else F.int_to_limbs(FQ.r_mod)
    if zero_limbs is None:
        zero_limbs = F.int_to_limbs(0)

    def fq2_add(a, b):
        return F.fq2_add(a, b, fq)

    def fq2_sub(a, b):
        return F.fq2_sub(a, b, fq)

    def fq2_mul(a, b):
        return F.fq2_mul(a, b, fq)

    def b3_mul(a):
        c = (_bcast(b3_limbs[0], a[0]), _bcast(b3_limbs[1], a[1]))
        return F.fq2_mul(a, c, fq)

    def mul_many(pairs):
        """Karatsuba Fq2 products, all limb-multiplies fused into one:
        for each pair we need a0*b0, a1*b1, (a0+a1)*(b0+b1) -- 3k
        products in a single stacked mont_mul, with vectorized
        recombination."""
        k = len(pairs)
        A0 = jnp.stack([a[0] for a, _ in pairs], axis=1)  # (16, k, ...)
        A1 = jnp.stack([a[1] for a, _ in pairs], axis=1)
        B0 = jnp.stack([b[0] for _, b in pairs], axis=1)
        B1 = jnp.stack([b[1] for _, b in pairs], axis=1)
        Asum = F.add_mod(A0, A1, fq)
        Bsum = F.add_mod(B0, B1, fq)
        A = jnp.concatenate([A0, A1, Asum], axis=1)
        B = jnp.concatenate([B0, B1, Bsum], axis=1)
        P = F.mont_mul(A, B, fq)
        t0 = P[:, :k]
        t1 = P[:, k : 2 * k]
        cross = P[:, 2 * k :]
        C0 = F.sub_mod(t0, t1, fq)
        C1 = F.sub_mod(F.sub_mod(cross, t0, fq), t1, fq)
        return [(C0[:, i], C1[:, i]) for i in range(k)]

    def _stack(pairs):
        A = jnp.stack(
            [a[0] for a, _ in pairs] + [a[1] for a, _ in pairs], axis=1
        )
        B = jnp.stack(
            [b[0] for _, b in pairs] + [b[1] for _, b in pairs], axis=1
        )
        return A, B

    def _unstack(S, k):
        return [(S[:, i], S[:, k + i]) for i in range(k)]

    def add_many(pairs):
        A, B = _stack(pairs)
        return _unstack(F.add_mod(A, B, fq), len(pairs))

    def sub_many(pairs):
        A, B = _stack(pairs)
        return _unstack(F.sub_mod(A, B, fq), len(pairs))

    def b3_const(like):
        return (
            jnp.broadcast_to(_bcast(b3_limbs[0], like[0]), like[0].shape),
            jnp.broadcast_to(_bcast(b3_limbs[1], like[1]), like[1].shape),
        )

    return FieldOps(
        fq2_add, fq2_sub, fq2_mul, b3_mul,
        zero=(zero_limbs, zero_limbs),
        one=(one_limbs, zero_limbs),
        mul_many=mul_many,
        b3_const=b3_const,
        add_many=add_many,
        sub_many=sub_many,
    )


G2_OPS = make_g2_ops()


# -- RNS-backed FieldOps (int8-dot base extensions; za_tpu.engine.rns) --------
# Same complete RCB group law, field elements as 35-channel residue
# vectors in M1-Montgomery form. The integer bound discipline of
# rns.mont_mul_rns (inputs < 64N) is satisfied by the RCB dataflow:
# coordinates stay < 36N, pre-mul sums < 44N (see rns.py docstring).


def make_g1_ops_rns(ctx=None) -> "FieldOps":
    from . import rns as RNS

    if ctx is None:
        ctx = RNS.RQ

    def mul(a, b):
        return RNS.mont_mul_rns(a, b, ctx)

    b3_rns = ctx.ints_to_rns([ctx.to_mont_int(9)])[:, 0]

    def b3_mul(a):
        return RNS.mont_mul_rns(a, _bcast(b3_rns, a), ctx)

    def mul_many(pairs):
        k = len(pairs)
        A = jnp.stack([a for a, _ in pairs], axis=1)
        B = jnp.stack([b for _, b in pairs], axis=1)
        P = RNS.mont_mul_rns(A, B, ctx)
        return [P[:, i] for i in range(k)]

    def add_many(pairs):
        A = jnp.stack([a for a, _ in pairs], axis=1)
        B = jnp.stack([b for _, b in pairs], axis=1)
        S = RNS.ch_add(A, B, ctx)
        return [S[:, i] for i in range(len(pairs))]

    def sub_many(pairs):
        A = jnp.stack([a for a, _ in pairs], axis=1)
        B = jnp.stack([b for _, b in pairs], axis=1)
        S = RNS.ch_sub_off(A, B, ctx)
        return [S[:, i] for i in range(len(pairs))]

    def b3_const(like):
        return jnp.broadcast_to(_bcast(b3_rns, like), like.shape)

    return FieldOps(
        lambda a, b: RNS.ch_add(a, b, ctx),
        lambda a, b: RNS.ch_sub_off(a, b, ctx),
        mul, b3_mul,
        zero=np.zeros(RNS.N_CH, dtype=np.uint32),
        one=ctx.one_rns,
        mul_many=mul_many,
        b3_const=b3_const,
        add_many=add_many,
        sub_many=sub_many,
    )


def make_g2_ops_rns(ctx=None) -> "FieldOps":
    """G2 over flat-Fq2 RNS arrays: a coordinate is ONE (35, 2, ...)
    array with c0/c1 on axis 1, so a G2 point has the same 3-leaf
    structure as G1 (the flat layout keeps batches wider than a nested
    (c0, c1) pytree).

    Fq2 product: schoolbook a0b0/a0b1/a1b0/a1b1 in one stacked
    mont_mul; the C0 subtraction uses the 8N offset (t11 < 4N always)
    so the component bounds stay stationary: mul out (c0, c1) <
    (12N, 8N), coordinates < (44N, 40N), pre-mul sums < (68N, 56N) --
    inside the 512N mont_mul contract. (Karatsuba would double the
    input bounds for a 25% mul saving -- revisit if needed.)"""
    from . import rns as RNS

    if ctx is None:
        ctx = RNS.RQ

    b3_rns = np.stack(
        [
            ctx.ints_to_rns([ctx.to_mont_int((3 * B2.c0) % Q)])[:, 0],
            ctx.ints_to_rns([ctx.to_mont_int((3 * B2.c1) % Q)])[:, 0],
        ],
        axis=1,
    )  # (35, 2)

    def mul_many(pairs):
        k = len(pairs)
        A = jnp.stack(
            [x for a, _ in pairs for x in (a[:, 0], a[:, 0], a[:, 1],
                                           a[:, 1])],
            axis=1,
        )  # (35, 4k, ...)
        B = jnp.stack(
            [x for _, b in pairs for x in (b[:, 0], b[:, 1], b[:, 0],
                                           b[:, 1])],
            axis=1,
        )
        P = RNS.mont_mul_rns(A, B, ctx)
        Pk = P.reshape((P.shape[0], k, 4) + P.shape[2:])
        C0 = RNS.ch_sub_off(
            Pk[:, :, 0], Pk[:, :, 3], ctx, off_vec=ctx.sub_off8
        )
        C1 = RNS.ch_add(Pk[:, :, 1], Pk[:, :, 2], ctx)
        out = jnp.stack([C0, C1], axis=2)  # (35, k, 2, ...)
        return [out[:, i] for i in range(k)]

    def fq2_mul(a, b):
        return mul_many([(a, b)])[0]

    def b3_mul(a):
        return fq2_mul(a, _bcast(b3_rns, a))

    def b3_const(like):
        return jnp.broadcast_to(_bcast(b3_rns, like), like.shape)

    def add_many(pairs):
        A = jnp.stack([a for a, _ in pairs], axis=1)
        B = jnp.stack([b for _, b in pairs], axis=1)
        S = RNS.ch_add(A, B, ctx)
        return [S[:, i] for i in range(len(pairs))]

    def sub_many(pairs):
        A = jnp.stack([a for a, _ in pairs], axis=1)
        B = jnp.stack([b for _, b in pairs], axis=1)
        S = RNS.ch_sub_off(A, B, ctx)
        return [S[:, i] for i in range(len(pairs))]

    zero2 = np.zeros((RNS.N_CH, 2), dtype=np.uint32)
    one2 = np.stack(
        [ctx.one_rns, np.zeros(RNS.N_CH, dtype=np.uint32)], axis=1
    )
    return FieldOps(
        lambda a, b: RNS.ch_add(a, b, ctx),
        lambda a, b: RNS.ch_sub_off(a, b, ctx),
        fq2_mul, b3_mul,
        zero=zero2,
        one=one2,
        mul_many=mul_many,
        b3_const=b3_const,
        add_many=add_many,
        sub_many=sub_many,
    )


# -- RNS staging / unstaging helpers ------------------------------------------


_l2r_jit = None


def _limbs_to_rns_mont(limbs, ctx):
    """(16, n) plain limb values -> (35, n) Montgomery RNS residues,
    on device (matmul conversion + one RNS mul by M1^2). Host arrays
    upload as u16 (limbs are 16-bit digits; halves the h2d volume) and
    widen on device."""
    global _l2r_jit
    from . import rns as RNS

    if _l2r_jit is None:
        _l2r_jit = jax.jit(
            lambda a: RNS.to_mont_rns(
                RNS.limbs_to_rns(a.astype(jnp.uint32), RNS.RQ), RNS.RQ
            )
        )
    if isinstance(limbs, np.ndarray) and limbs.dtype != np.uint16:
        limbs = limbs.astype(np.uint16)
    return _l2r_jit(jnp.asarray(limbs))


def g1_points_to_rns(points, ctx=None) -> tuple:
    """list of affine G1 (or None) -> projective Montgomery RNS arrays
    (X, Y, Z) each (35, n). None -> (0:1:0)."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    from . import rns as RNS

    ctx = ctx or RNS.RQ
    return tuple(
        _limbs_to_rns_mont(F.ints_to_limbs(v), ctx) for v in (xs, ys, zs)
    )


def g2_points_to_rns(points, ctx=None) -> tuple:
    """list of affine G2 (or None) -> flat-Fq2 projective Montgomery
    RNS arrays (X, Y, Z), each (35, 2, n)."""
    from . import rns as RNS

    ctx = ctx or RNS.RQ
    x0 = [0 if p is None else p[0].c0 for p in points]
    x1 = [0 if p is None else p[0].c1 for p in points]
    y0 = [1 if p is None else p[1].c0 for p in points]
    y1 = [0 if p is None else p[1].c1 for p in points]
    z0 = [0 if p is None else 1 for p in points]
    z1 = [0] * len(points)

    def cv(c0, c1):
        both = _limbs_to_rns_mont(F.ints_to_limbs(c0 + c1), ctx)
        n = len(c0)
        return jnp.stack([both[:, :n], both[:, n:]], axis=1)

    return (cv(x0, x1), cv(y0, y1), cv(z0, z1))


def g1_point_from_rns(X, Y, Z, ctx=None):
    """Single projective RNS point (batch size 1) -> host affine tuple
    or None (host-side CRT + inversion: final MSM outputs only)."""
    from . import rns as RNS

    ctx = ctx or RNS.RQ
    arr = np.stack(
        [np.asarray(c).reshape(RNS.N_CH, -1)[:, 0] for c in (X, Y, Z)],
        axis=1,
    )
    x, y, z = [ctx.from_mont_int(v) % Q for v in ctx.rns_to_ints(arr)]
    if z == 0:
        return None
    zinv = pow(z, -1, Q)
    return (x * zinv % Q, y * zinv % Q)


def g2_point_from_rns(X, Y, Z, ctx=None):
    """Single flat-Fq2 projective RNS point (leaves (35, 2) or
    (35, 2, 1)) -> host affine pair or None."""
    from ..curve import Fq2
    from . import rns as RNS

    ctx = ctx or RNS.RQ

    def cv(c):
        arr = np.asarray(c).reshape(RNS.N_CH, 2, -1)[:, :, 0]
        v0, v1 = ctx.rns_to_ints(arr)
        return Fq2(
            ctx.from_mont_int(v0) % Q, ctx.from_mont_int(v1) % Q
        )

    x, y, z = cv(X), cv(Y), cv(Z)
    if z.is_zero():
        return None
    zinv = z.inv()
    return (x * zinv, y * zinv)


# -- complete projective addition (RCB 2015, a=0) -----------------------------


def point_add(p, q, ops: FieldOps):
    """(X1:Y1:Z1) + (X2:Y2:Z2), complete (handles identity/doubling).

    RCB operations regrouped into three batched multiply layers (the
    formulas' data dependencies allow exactly this): layer 1 computes
    the six pairwise coordinate products, layer 2 the two b3 scalings,
    layer 3 the six cross products."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    add, sub = ops.add, ops.sub

    sxy1, sxy2, syz1, syz2, sxz1, sxz2 = ops.add_many(
        [(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2)]
    )
    t0, t1, t2, m3, m4, m5 = ops.mul_many(
        [(X1, X2), (Y1, Y2), (Z1, Z2), (sxy1, sxy2), (syz1, syz2),
         (sxz1, sxz2)]
    )
    a01, a12, a02, x3d = ops.add_many(
        [(t0, t1), (t1, t2), (t0, t2), (t0, t0)]
    )
    t3, t4, y3 = ops.sub_many([(m3, a01), (m4, a12), (m5, a02)])
    t0 = add(x3d, t0)                        # 3*X1X2

    b3c = ops.b3_const(t2)
    t2b, y3b = ops.mul_many([(t2, b3c), (y3, b3c)])
    Z3 = add(t1, t2b)
    t1 = sub(t1, t2b)

    p0, p1, p2, p3, p4, p5 = ops.mul_many(
        [(t4, y3b), (t3, t1), (y3b, t0), (t1, Z3), (t0, t3), (Z3, t4)]
    )
    X3 = sub(p1, p0)
    Y3, Z3 = ops.add_many([(p3, p2), (p5, p4)])
    return (X3, Y3, Z3)


def point_double(p, ops: FieldOps):
    return point_add(p, p, ops)


def point_identity_like(coord_like, ops: FieldOps, is_g2: bool):
    """(0:1:0) broadcast to the batch shape of coord_like.

    The branch is representation-driven: limb-G2 coordinates are
    (c0, c1) tuples; the RNS flat-Fq2 representation keeps c0/c1 on
    array axis 1 and takes the plain path with (35, 2) constants."""
    if is_g2 and isinstance(ops.zero, tuple):
        shape = coord_like[0].shape

        def c(l):
            return jnp.broadcast_to(_bcast(l, coord_like[0]), shape)

        zero = (c(ops.zero[0]), c(ops.zero[1]))
        one = (c(ops.one[0]), c(ops.one[1]))
        return (zero, one, zero)
    shape = coord_like.shape
    zero = jnp.broadcast_to(_bcast(ops.zero, coord_like), shape)
    one = jnp.broadcast_to(_bcast(ops.one, coord_like), shape)
    return (zero, one, zero)


# -- host conversion helpers --------------------------------------------------


_to_mont_jit = None


def _to_mont_dev(arr: np.ndarray):
    """(16, n) plain-form limbs -> Montgomery form, converted on device
    (host bigint conversion is ~2 mults per value -- minutes at 1M)."""
    global _to_mont_jit
    if _to_mont_jit is None:
        _to_mont_jit = jax.jit(lambda a: F.to_mont(a, FQ))
    return _to_mont_jit(arr)


def g1_points_to_device(points) -> tuple:
    """list of affine G1 (or None) -> projective Montgomery limb arrays
    (X, Y, Z) each (16, n). None -> (0:1:0)."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return (
        _to_mont_dev(F.ints_to_limbs(xs)),
        _to_mont_dev(F.ints_to_limbs(ys)),
        _to_mont_dev(F.ints_to_limbs(zs)),
    )


def g2_points_to_device(points):
    """list of affine G2 (or None) -> projective Fq2 limb arrays."""
    x0 = [0 if p is None else p[0].c0 for p in points]
    x1 = [0 if p is None else p[0].c1 for p in points]
    y0 = [1 if p is None else p[1].c0 for p in points]
    y1 = [0 if p is None else p[1].c1 for p in points]
    z0 = [0 if p is None else 1 for p in points]
    z1 = [0] * len(points)

    def mk(vs):
        return _to_mont_dev(F.ints_to_limbs(vs))

    return (
        (mk(x0), mk(x1)),
        (mk(y0), mk(y1)),
        (mk(z0), mk(z1)),
    )


def g1_point_from_device(X, Y, Z):
    """Single projective point (limbs, batch size 1 or scalar) -> affine
    host tuple or None."""
    x = FQ.from_mont_int(F.limbs_to_int(np.asarray(X).reshape(F.NLIMBS, -1)[:, 0]))
    y = FQ.from_mont_int(F.limbs_to_int(np.asarray(Y).reshape(F.NLIMBS, -1)[:, 0]))
    z = FQ.from_mont_int(F.limbs_to_int(np.asarray(Z).reshape(F.NLIMBS, -1)[:, 0]))
    if z == 0:
        return None
    zinv = pow(z, -1, Q)
    return (x * zinv % Q, y * zinv % Q)


def g2_point_from_device(X, Y, Z):
    from ..curve import Fq2

    def cv(c):
        return FQ.from_mont_int(
            F.limbs_to_int(np.asarray(c).reshape(F.NLIMBS, -1)[:, 0])
        )

    x = Fq2(cv(X[0]), cv(X[1]))
    y = Fq2(cv(Y[0]), cv(Y[1]))
    z = Fq2(cv(Z[0]), cv(Z[1]))
    if z.is_zero():
        return None
    zinv = z.inv()
    return (x * zinv, y * zinv)


# -- batched projective -> affine normalization (device) ----------------------


def normalize_g1(X, Y, Z):
    """Projective Montgomery -> plain affine + infinity mask, batched:
    one Fermat inversion via a Montgomery batch-inverse chain."""
    is_zero = jnp.all(Z == 0, axis=0)
    one = _bcast(F.int_to_limbs(FQ.r_mod), Z)
    z_safe = jnp.where(is_zero, jnp.broadcast_to(one, Z.shape), Z)
    zinv = F.batch_inverse_mont(z_safe, FQ)
    x = F.from_mont(F.mont_mul(X, zinv, FQ), FQ)
    y = F.from_mont(F.mont_mul(Y, zinv, FQ), FQ)
    return x, y, is_zero


def normalize_g2(X, Y, Z):
    """Fq2 projective -> plain affine + infinity mask (batched).
    1/(z0 + z1 i) = (z0 - z1 i) / (z0^2 + z1^2)."""
    z0, z1 = Z
    is_zero = jnp.all(z0 == 0, axis=0) & jnp.all(z1 == 0, axis=0)
    norm = F.add_mod(
        F.mont_mul(z0, z0, FQ), F.mont_mul(z1, z1, FQ), FQ
    )
    one = _bcast(F.int_to_limbs(FQ.r_mod), norm)
    norm_safe = jnp.where(is_zero, jnp.broadcast_to(one, norm.shape), norm)
    ninv = F.batch_inverse_mont(norm_safe, FQ)
    zinv = (F.mont_mul(z0, ninv, FQ), F.neg_mod(F.mont_mul(z1, ninv, FQ), FQ))
    x = F.fq2_mul(X, zinv)
    y = F.fq2_mul(Y, zinv)
    return (
        (F.from_mont(x[0], FQ), F.from_mont(x[1], FQ)),
        (F.from_mont(y[0], FQ), F.from_mont(y[1], FQ)),
        is_zero,
    )


def limbs_to_ints_fast(a: np.ndarray) -> list:
    """(16, n) uint32 16-bit digits -> list of n ints (vectorized pack)."""
    a = np.asarray(a)
    packed = a.astype("<u2").T.copy().tobytes()  # n rows of 32 bytes LE
    return [
        int.from_bytes(packed[i * 32 : (i + 1) * 32], "little")
        for i in range(a.shape[1])
    ]


def g1_batch_from_device(x_plain, y_plain, is_zero) -> list:
    xs = limbs_to_ints_fast(np.asarray(x_plain))
    ys = limbs_to_ints_fast(np.asarray(y_plain))
    zeros = np.asarray(is_zero)
    return [
        None if zeros[j] else (xs[j], ys[j]) for j in range(len(xs))
    ]


def g2_batch_from_device(x_pair, y_pair, is_zero) -> list:
    from ..curve import Fq2

    x0 = limbs_to_ints_fast(np.asarray(x_pair[0]))
    x1 = limbs_to_ints_fast(np.asarray(x_pair[1]))
    y0 = limbs_to_ints_fast(np.asarray(y_pair[0]))
    y1 = limbs_to_ints_fast(np.asarray(y_pair[1]))
    zeros = np.asarray(is_zero)
    return [
        None
        if zeros[j]
        else (Fq2(x0[j], x1[j]), Fq2(y0[j], y1[j]))
        for j in range(len(x0))
    ]
