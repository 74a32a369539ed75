"""Batch-affine tree MSM over the RNS field core.

The signed-dense MSM (msm.msm_signed_dense) runs complete projective
RCB adds: 14 Montgomery muls per accumulate plus 7/71 of the work
building {P..8P} tables per call.  This module removes both costs with
the classic batch-affine trick, reformulated as a tree so it stays
dense XLA (no scatters, no per-bucket serial chains):

  * the {1P..8P} multiple tables are built ONCE at pk-staging time,
    batch-normalized to AFFINE, and stored as u16 residue planes
    (RNS residues are < 2^16 by construction) -- 1120 B/point for G1.
  * per window w and point i the signed radix-16 digit selects
    d_{w,i} * P_i from the staged table (negative digits flip y);
    digit 0 marks the lane at infinity.
  * each window's n selected points are summed by a BINARY TREE:
    every level pairs adjacent lanes and performs an AFFINE addition

        lam = (y2 - y1) / (x2 - x1)
        x3  = lam^2 - x1 - x2,   y3 = lam*(x1 - x3) - y1

    where ALL divisions of a level share one field inversion through
    Montgomery's batch-inversion trick: 3 muls/lane + one narrow
    Fermat inversion.  Cost: ~6 Montgomery muls per add (G1) vs 14
    for the complete projective formulas -- and no table build.
  * after A affine levels (>= 94% of the adds) the partial sums switch
    to complete projective adds for the narrow tail, chunk partials
    accumulate into a projective carry, and the standard lane-fold +
    Horner tail (engine/msm.py) combines windows.

Completeness / exceptional cases: affine addition is INCOMPLETE
(x1 == x2 divides by zero).  Infinity lanes are tracked exactly with
boolean flags (digit 0, padding, and inverse-pair results all set the
flag; flagged lanes force den = 1 so the shared inversion stays
valid).  The remaining exceptional case -- two non-infinity operands
with EQUAL x field values (doubling or inverse pair) -- cannot be
detected cheaply in RNS (residues compare represented integers, not
values mod N) and is not handled: for Groth16 MSM inputs the operands
of every tree node are sums of disjoint subsets of pk points with
attacker-independent coefficients, so a collision implies a nontrivial
discrete-log relation between pk points (probability ~ 2^-230; finding
one breaks DLOG).  The helper/CLI path (groth16/helper.py) additionally
self-verifies every proof it emits, so an astronomically unlikely hit
there cannot produce a wrong proof, only a retry via ZA_MSM_TREE=0;
direct prove() callers who skip the helper should verify the returned
proof themselves if they need that fail-stop.

CONTRACT: input points must be pairwise distinct (pk query points
are).  Synthetic inputs that repeat a point pool whose period divides
the pairing stride (adjacent lanes) WILL hit
the equal-x case -- benchmarks use prime pool sizes for this reason.

Bound discipline (represented-integer bounds, units of N; mont_mul
contract: inputs < 512N, outputs < 4N; ch_sub_off(a, b, kN) requires
bound(b) <= kN and yields bound(a) + kN):

  G1 per level k (inputs x < bx_k, y < by_k; tables bx_0 = 4,
  by_0 = 12 after the y-flip select):
    den = sub(x2, x1, bx)        -> 2*bx      (< 512 for bx <= 124)
    num = sub(y2, y1, by)        -> 2*by
    x3  = sub(lam^2, x1+x2, 2bx) -> bx' = 4 + 2*bx   (4,12,28,60,124)
    y3  = sub(lam*w, y1, by)     -> by' = 4 + by     (12,16,20,24,28)
    w   = sub(x1, x3, bx')       -> bx + bx' < 188
  Five affine levels (A=5) stay inside every contract with no
  bound-reset muls.  G2 (schoolbook flat-Fq2, mul out < (12, 8)):
  bx' = 12 + 2*bx gives 12,36,84,180 -- A=4 levels, projective
  conversion sums < 272 < 512.

Replaces bellman_ce's multiexp worker (SURVEY.md section 2.3,
/root/reference/prover/Cargo.toml:19) as the production MSM when the
staged affine tables fit device memory.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import ec, msm as MSM, rns as RNS

NCH = RNS.N_CH
WIN = 64          # ceil(254/4) signed radix-16 windows
HALF = 8          # table entries {1P..8P}


# -- offsets ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _off_vec(k: int, modulus: int) -> np.ndarray:
    """(35,) u32: (k*N mod p) per channel -- the k*N subtraction offset."""
    ctx = RNS.RQ if modulus == RNS.RQ.modulus else RNS.RR
    return np.array(
        [(k * modulus) % int(p) for p in ctx.primes_list], dtype=np.uint32
    )


def _sub(a, b, k: int, ctx: RNS.RnsContext):
    """a + kN - b (bound(b) <= kN required by the caller's audit)."""
    return RNS.ch_sub_off(a, b, ctx, off_vec=_off_vec(k, ctx.modulus))


# -- field adapters -----------------------------------------------------------
# The tree needs only mul / sub-with-offset / select / constants, over
# either Fq ((35, ...) planes) or flat-Fq2 ((35, 2, ...) planes).


class FqAdapter:
    """G1 coordinate field: plain (35, ...) RNS planes."""

    is_fq2 = False

    def __init__(self, ctx: RNS.RnsContext | None = None):
        self.ctx = ctx or RNS.RQ

    def mul(self, a, b):
        return RNS.mont_mul_rns(a, b, self.ctx)

    def sub(self, a, b, k: int):
        return _sub(a, b, k, self.ctx)

    def add(self, a, b):
        return RNS.ch_add(a, b, self.ctx)

    def one_like(self, x):
        one = RNS._b(self.ctx.one_rns, x)
        return jnp.broadcast_to(one, x.shape).astype(jnp.uint32)

    def zero_like(self, x):
        return jnp.zeros_like(x)

    def select(self, cond, a, b):
        return jnp.where(cond, a, b)

    def fermat_inv(self, x):
        """Montgomery-form inverse by x^(q-2) square-and-multiply."""
        return _pow_fermat(x, self.ctx.modulus - 2, self.mul)


class Fq2Adapter:
    """G2 coordinate field: flat-Fq2 (35, 2, ...) planes, schoolbook
    product (4 mont muls; output bounds (12, 8)N -- make_g2_ops_rns)."""

    is_fq2 = True

    def __init__(self, ctx: RNS.RnsContext | None = None):
        self.ctx = ctx or RNS.RQ

    def mul(self, a, b):
        ctx = self.ctx
        # stack the 4 schoolbook products on one axis
        A = jnp.stack(
            [a[:, 0], a[:, 0], a[:, 1], a[:, 1]], axis=1
        )
        B = jnp.stack(
            [b[:, 0], b[:, 1], b[:, 0], b[:, 1]], axis=1
        )
        P = RNS.mont_mul_rns(A, B, ctx)
        c0 = RNS.ch_sub_off(
            P[:, 0], P[:, 3], ctx, off_vec=ctx.sub_off8
        )
        c1 = RNS.ch_add(P[:, 1], P[:, 2], ctx)
        return jnp.stack([c0, c1], axis=1)

    def sub(self, a, b, k: int):
        return _sub(a, b, k, self.ctx)  # broadcasts over axis 1

    def add(self, a, b):
        return RNS.ch_add(a, b, self.ctx)

    def one_like(self, x):
        one = RNS._b(self.ctx.one_rns, x[:, 0])
        c0 = jnp.broadcast_to(one, x[:, 0].shape).astype(jnp.uint32)
        return jnp.stack([c0, jnp.zeros_like(c0)], axis=1)

    def zero_like(self, x):
        return jnp.zeros_like(x)

    def select(self, cond, a, b):
        return jnp.where(cond, a, b)  # right-aligned broadcast

    def fermat_inv(self, x):
        """Fq2 inverse via the norm map: (a + bi)^-1 =
        (a - bi) / (a^2 + b^2); one Fq Fermat on the norm."""
        ctx = self.ctx
        a0, a1 = x[:, 0], x[:, 1]
        sq = RNS.mont_mul_rns(
            jnp.stack([a0, a1], axis=1), jnp.stack([a0, a1], axis=1), ctx
        )
        norm = RNS.ch_add(sq[:, 0], sq[:, 1], ctx)  # < 8N
        ninv = _pow_fermat(norm, ctx.modulus - 2,
                           lambda u, v: RNS.mont_mul_rns(u, v, ctx))
        both = RNS.mont_mul_rns(
            jnp.stack([a0, a1], axis=1),
            jnp.stack([ninv, ninv], axis=1), ctx,
        )
        c0 = both[:, 0]
        c1 = _sub(jnp.zeros_like(both[:, 1]), both[:, 1], 8, ctx)
        return jnp.stack([c0, c1], axis=1)


def _pow_fermat(x, exp: int, mul, block: int = 8):
    """Square-and-multiply x^exp with 4-bit windows (Montgomery form
    in, Montgomery form out): ~253 squarings + ~63 window muls.

    The digit loop is a lax.fori_loop over BLOCKS of `block` digits,
    each block unrolled in the body: fully unrolled chains made XLA
    compiles take minutes (~10k-op graphs), while a fully rolled loop
    pays ~60 sequential steps per inversion.  Blocked, the graph stays
    ~1k ops and the loop runs ~8 steps."""
    digits = []
    e = exp
    while e:
        digits.append(e & 15)
        e >>= 4
    digits.reverse()
    assert digits and digits[0], "leading window must be nonzero"

    tab = [x]
    for _ in range(15):
        tab.append(mul(tab[-1], x))
    stack = jnp.stack(tab, axis=0)  # (16, 35[,2], K): x^(d+1)

    rest = digits[1:]
    nblk = -(-len(rest) // block)
    npad = nblk * block - len(rest)
    valid = [True] * len(rest) + [False] * npad  # pad skips the step
    rest = rest + [0] * npad
    darr = jnp.asarray(
        np.array(rest, dtype=np.int32).reshape(nblk, block)
    )
    varr = jnp.asarray(
        np.array(valid, dtype=bool).reshape(nblk, block)
    )

    def body(i, acc):
        db = darr[i]
        vb = varr[i]
        for j in range(block):
            sq = mul(acc, acc)
            sq = mul(sq, sq)
            sq = mul(sq, sq)
            sq = mul(sq, sq)
            d = db[j]
            t = jax.lax.dynamic_index_in_dim(
                stack, jnp.maximum(d - 1, 0), 0, keepdims=False
            )
            step = jnp.where(d > 0, mul(sq, t), sq)
            acc = jnp.where(vb[j], step, acc)
        return acc

    acc0 = tab[digits[0] - 1]
    return jax.lax.fori_loop(0, nblk, body, acc0)


# -- batch inversion ----------------------------------------------------------


def _maybe_pvary(x, axis: str | None):
    """Mark a constant as device-varying inside shard_map (scan carry
    type-checking); no-op outside (axis None)."""
    if axis is None:
        return x
    return jax.lax.pcast(x, axis, to="varying")


def batch_inv(d, fld, group: int = 64, tail: int = 1024,
              pvary_axis: str | None = None):
    """Montgomery batch inversion of d (leaves (35[,2], K)) along the
    LAST axis: ~3 muls per element + one narrow Fermat inversion.

    The K lanes reshape to (G, K/G); a serial lax.scan of length G
    computes group prefix products in parallel across K/G groups, the
    K/G group totals are inverted (recursively, until <= `tail` wide,
    then Fermat), and a reverse scan emits each lane's inverse.
    All values Montgomery form; products mont-bounded < 4N."""
    K = d.shape[-1]
    if K <= tail or K < 2 * group:
        return fld.fermat_inv(d)
    G = group
    while K % G:
        G //= 2
    if G < 2:  # odd K: grouping degenerates; recursing would not shrink
        return fld.fermat_inv(d)
    KG = K // G

    # (.., K) -> (G, .., KG): lane l of group g at position g*KG + l?
    # Use interleaved grouping: element index i = s*KG + j maps to
    # scan step s, column j (a plain reshape of the leading split).
    dg = jnp.moveaxis(d.reshape(d.shape[:-1] + (G, KG)), -2, 0)

    def fwd(carry, x):
        nxt = fld.mul(carry, x)
        return nxt, carry  # prefix EXCLUSIVE of x

    one = _maybe_pvary(fld.one_like(dg[0]), pvary_axis)
    total, pre = jax.lax.scan(fwd, one, dg)
    # total: product over the group; pre[s]: product of elements < s
    tinv = batch_inv(total, fld, group, tail, pvary_axis)

    def bwd(carry, xs):
        x, p = xs
        inv_x = fld.mul(carry, p)    # (prod later)^-1 * (prod earlier)
        nxt = fld.mul(carry, x)      # extend the suffix inverse
        return nxt, inv_x

    _, invs = jax.lax.scan(bwd, tinv, (dg, pre), reverse=True)
    return jnp.moveaxis(invs, 0, -2).reshape(d.shape)


# -- affine tree level --------------------------------------------------------


def _affine_level(x, y, inf, fld, bx: int, by: int, reset: bool,
                  pvary_axis: str | None = None):
    """One tree level: pair adjacent lanes on the last axis and add.

    x, y: (35[,2], ..., K) coordinate planes (K even), inf: (..., K)
    bool, with represented-integer bounds (bx, by) from _level_plan.
    Returns halved (x3, y3, inf3); when `reset` the x3 bound is pulled
    back to the mont-output bound with one extra multiply by 1."""
    omul = 12 if fld.is_fq2 else 4  # mul-output component bound

    def split(a):
        a = a.reshape(a.shape[:-1] + (a.shape[-1] // 2, 2))
        return a[..., 0], a[..., 1]

    x1, x2 = split(x)
    y1, y2 = split(y)
    i1, i2 = split(inf)

    den = fld.sub(x2, x1, bx)            # < 2*bx
    num = fld.sub(y2, y1, by)            # < 2*by
    either = i1 | i2
    den = fld.select(either, fld.one_like(den), den)
    dinv = batch_inv(den, fld, pvary_axis=pvary_axis)
    lam = fld.mul(num, dinv)
    t = fld.mul(lam, lam)
    sx = fld.add(x1, x2)                 # < 2*bx
    x3 = fld.sub(t, sx, 2 * bx)          # < omul + 2*bx
    if reset:  # bound reset: same field value, bound back to omul
        x3 = fld.mul(x3, fld.one_like(x3))
        w = fld.sub(x1, x3, omul + 4)    # < bx + omul + 4
    else:
        w = fld.sub(x1, x3, omul + 2 * bx)
    u = fld.mul(lam, w)
    y3 = fld.sub(u, y1, by)              # < omul + by

    # infinity resolution: both -> inf; one -> the other (same-slot
    # select keeps bounds); the equal-x exceptional case is assumed
    # absent (module docstring)
    x3 = fld.select(i1, x2, fld.select(i2, x1, x3))
    y3 = fld.select(i1, y2, fld.select(i2, y1, y3))
    return x3, y3, i1 & i2


def _level_plan(A: int, is_g2: bool):
    """Static per-level (bx, by, reset) schedule.

    bx cycles omul -> 3*omul+... doubling-ish until the next level's
    den (2*bx) or w (bx + omul + 2*bx) would leave the 512N mont
    contract; a reset multiply (amortized 1/2^lvl per point) pulls it
    back.  G1: 4,12,28,60,124,(reset); G2: 12,36,84,180,(reset).
    by grows by omul per level (the y-negation at selection gives
    by0 = 8/24); num = 2*by stays < 512N for any practical depth."""
    omul = 12 if is_g2 else 4
    bx, by = omul, (24 if is_g2 else 8) + omul
    plan = []
    for _ in range(A):
        nx = omul + 2 * bx
        reset = nx > 250
        plan.append((bx, by, reset))
        bx = omul if reset else nx
        by = omul + by
        assert 2 * by < 512 and 2 * bx < 512
    return plan


# -- staged affine tables -----------------------------------------------------


@dataclass
class AffineTables:
    """Staged MSM operand: u16 affine multiple tables, chunked.

    tx, ty: (C, HALF, 35[, 2], M, S) uint16 device arrays
    ident:  (C, M, S) bool -- identity INPUT columns (pk queries carry
            None points at non-dense slots, setup.expand_queries).
            Their staged tables are bounded garbage (no affine form of
            infinity exists); the MSMs zero these columns' digits so
            selection flags them at infinity REGARDLESS of the live
            witness scalar.
    n:      true (unpadded) point count per query
    is_g2:  flat-Fq2 tables when True"""

    tx: jax.Array
    ty: jax.Array
    ident: jax.Array
    n: int
    is_g2: bool

    @property
    def chunks(self) -> int:
        return self.tx.shape[0]

    @property
    def m(self) -> int:
        return self.tx.shape[-2]

    @property
    def chunk_cols(self) -> int:
        return self.tx.shape[-1]


def _normalize_affine(X, Y, Z, ident_mask, fld):
    """Projective -> affine with a single batch inversion.

    X/Y/Z: (HALF, 35[,2], M, n) planes; ident_mask: (M, n) bool marking
    identity INPUT columns (their multiples are identities too).  A
    point at infinity has no affine form; masked columns come out as
    bounded garbage -- the contract (module docstring) is that their
    digits are always 0, so the tree flags them at selection time.
    Masked Z is replaced by 1 so the shared batch product stays
    invertible (an identity's Z represents 0 mod N and would zero it).
    """
    nch = 2 if fld.is_fq2 else 1

    def flat(a):  # (HALF, ch.., M, n) -> (ch.., HALF*M*n)
        a = jnp.moveaxis(a, 0, nch)  # channels first
        return a.reshape(a.shape[:nch] + (-1,))

    zf, xf, yf = flat(Z), flat(X), flat(Y)
    mask = jnp.broadcast_to(
        ident_mask.reshape(-1), (HALF,) + (ident_mask.size,)
    ).reshape(-1)
    zsafe = fld.select(mask, fld.one_like(zf), zf)
    zinv = batch_inv(zsafe, fld)

    def unflat(a):
        a = a.reshape(a.shape[:nch] + (HALF,) + X.shape[nch + 1:])
        return jnp.moveaxis(a, nch, 0)

    return unflat(fld.mul(xf, zinv)), unflat(fld.mul(yf, zinv))


@functools.lru_cache(maxsize=None)
def _build_block_jit(is_g2: bool):
    fld = Fq2Adapter() if is_g2 else FqAdapter()
    ops = ec.make_g2_ops_rns() if is_g2 else ec.make_g1_ops_rns()

    @jax.jit
    def build_block(pts):
        Z0 = pts[2]
        if is_g2:
            ident = jnp.all(Z0 == 0, axis=(0, 1))  # (M, blk)
        else:
            ident = jnp.all(Z0 == 0, axis=0)
        tabs = MSM.build_multiples(pts, ops, HALF)  # 7 complete adds
        tx = jnp.stack([t[0] for t in tabs], axis=0)
        ty = jnp.stack([t[1] for t in tabs], axis=0)
        tz = jnp.stack([t[2] for t in tabs], axis=0)
        ax, ay = _normalize_affine(tx, ty, tz, ident, fld)
        return ax.astype(jnp.uint16), ay.astype(jnp.uint16), ident

    return build_block


def build_tables_block(staged_block, is_g2: bool):
    """One column block of staged projective points (leaves
    (35[,2], M, blk), Montgomery RNS) -> u16 affine {1P..8P} tables
    (HALF, 35[,2], M, blk) plus the (M, blk) bool identity-column
    mask.  Identity columns are detected on the STAGED input (their Z
    is exactly zero in every channel before any arithmetic touches
    it); their table entries are garbage and the mask MUST suppress
    their digits at MSM time."""
    return _build_block_jit(is_g2)(tuple(staged_block))


def chunkify_tables(xs, ys, ids, C: int, S: int, n: int,
                    is_g2: bool) -> AffineTables:
    """Concatenate per-block table arrays and split the column axis
    into C scan chunks of S."""

    @jax.jit
    def to_chunks(*blocks):
        big = jnp.concatenate(blocks, axis=-1)
        # (HALF, 35[,2], M, C*S) -> (C, HALF, 35[,2], M, S)
        big = big.reshape(big.shape[:-1] + (C, S))
        return jnp.moveaxis(big, -2, 0)

    @jax.jit
    def id_chunks(*blocks):
        big = jnp.concatenate(blocks, axis=-1)  # (M, C*S)
        big = big.reshape(big.shape[:-1] + (C, S))
        return jnp.moveaxis(big, -2, 0)         # (C, M, S)

    return AffineTables(
        tx=to_chunks(*xs), ty=to_chunks(*ys), ident=id_chunks(*ids),
        n=n, is_g2=is_g2,
    )


def mask_ident_digits(d, ident):
    """Zero the signed digits of identity columns: d (C, W, M, S)
    int8, ident (C, M, S) bool.  A zero digit selects the infinity
    flag at selection time, which is the only correct treatment of an
    identity input column (its staged affine table is garbage)."""
    return jnp.where(ident[:, None], jnp.int8(0), d)


def stage_affine_tables(staged_proj, is_g2: bool, n: int,
                        chunk: int = 1 << 15,
                        block: int = 1 << 16) -> AffineTables:
    """Staged projective tree (leaves (35[,2], M, n_pad), Montgomery
    RNS) -> chunked u16 affine tables, in column blocks of `block`
    points to bound transient memory.  (Large-n callers should stage
    block-wise from limbs instead -- engine.stage_g1_affine -- so the
    full projective tree never materializes.)"""
    X = jnp.asarray(staged_proj[0])
    n_pad = X.shape[-1]
    S = min(chunk, n_pad)
    C = -(-n_pad // S)
    total = C * S
    if total != n_pad:
        pad = total - n_pad
        staged_proj = jax.tree_util.tree_map(
            lambda a: jnp.pad(
                jnp.asarray(a),
                [(0, 0)] * (a.ndim - 1) + [(0, pad)],
            ),
            tuple(staged_proj),
        )
        n_pad = total
    if block % S:
        block = S * max(block // S, 1)

    xs, ys, ids = [], [], []
    for lo in range(0, n_pad, block):
        hi = min(lo + block, n_pad)
        pts = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a)[..., lo:hi], tuple(staged_proj)
        )
        ax, ay, ident = build_tables_block(pts, is_g2)
        xs.append(ax)
        ys.append(ay)
        ids.append(ident)

    return chunkify_tables(xs, ys, ids, C, S, n, is_g2)


# -- the tree MSM -------------------------------------------------------------


def _select_tables(tabx, taby, d, fld):
    """tabx/taby (HALF, 35[,2], M, S) u16, d (W, M, S) int8 digits ->
    selected affine planes (35[,2], M, W, S) + inf (M, W, S)."""
    ad = jnp.abs(d.astype(jnp.int32))  # (W, M, S)
    admw = jnp.moveaxis(ad, 0, 1)      # (M, W, S)

    def pick(tab):
        # tab (HALF, 35[,2], M, S) -> broadcast over W
        t = tab.astype(jnp.uint32)
        exp = jnp.expand_dims(t, -2)    # (HALF, 35[,2], M, 1, S)
        sel = exp[0]
        for k in range(2, HALF + 1):
            sel = jnp.where(admw == k, exp[k - 1], sel)
        return sel                      # (35[,2], M, W, S)

    sx = pick(tabx)
    sy = pick(taby)
    neg = jnp.moveaxis(d, 0, 1) < 0     # (M, W, S)
    # table y bound: 4N (G1) / 12N (G2 c0 component) -> negate with a
    # covering offset; yneg bound 8N / 24N
    yneg = fld.sub(fld.zero_like(sy), sy, 24 if fld.is_fq2 else 8)
    sy = jnp.where(neg, yneg, sy)
    inf = admw == 0
    return sx, sy, inf


def _proj_of_affine(x, y, inf, fld, ops):
    """Flagged affine -> complete projective: inf -> (0 : 1 : 0)."""
    one = fld.one_like(x)
    zero = fld.zero_like(x)
    X = fld.select(inf, zero, x)
    Y = fld.select(inf, one, y)
    Z = fld.select(inf, zero, one)
    return (X, Y, Z)


def tree_window_sums(tables: AffineTables, scalars, ops,
                     affine_levels: int | None = None,
                     pvary_axis: str | None = None):
    """Per-window sums of M same-size MSMs over staged affine tables:
    the pre-Horner stage, exposed so the sharded path can all_gather
    and point-reduce window sums across chips before the (replicated)
    Horner combine.

    scalars: (16, M, n_pad) u32 plain-form limbs (n_pad = C*S)
    returns projective point pytree, leaves (35[,2], W, M)."""
    is_g2 = tables.is_g2
    fld = Fq2Adapter() if is_g2 else FqAdapter()
    C, S, M = tables.chunks, tables.chunk_cols, tables.m
    log2s = max(S.bit_length() - 1, 0)
    if affine_levels is not None:
        A = affine_levels
    else:
        # affine down to T=64 per-window partials: the remaining
        # projective lane_fold is ~6 rounds on a narrow array
        A = max(log2s - 6, 0)
    A = min(A, log2s)
    plan = _level_plan(A, is_g2)
    T = S >> A  # per-window partial count after the affine levels

    n_pad = C * S
    if scalars.shape[-1] < n_pad:
        scalars = jnp.pad(
            scalars, ((0, 0),) * (scalars.ndim - 1)
            + ((0, n_pad - scalars.shape[-1]),)
        )
    d = MSM.signed_digits(scalars, 4).astype(jnp.int8)  # (W, M, n)
    d = d.reshape(WIN, M, C, S)
    d = jnp.moveaxis(d, 2, 0)  # (C, W, M, S)
    d = mask_ident_digits(d, tables.ident)

    def chunk_partials(tabx, taby, dg):
        x, y, inf = _select_tables(tabx, taby, dg, fld)
        for bx, by, reset in plan:
            x, y, inf = _affine_level(x, y, inf, fld, bx, by, reset,
                                      pvary_axis=pvary_axis)
        return _proj_of_affine(x, y, inf, fld, ops)  # (.., M, W, T)

    def scan_body(carry, xs):
        tabx, taby, dg = xs
        p = chunk_partials(tabx, taby, dg)
        return ec.point_add(carry, p, ops), None

    first = chunk_partials(tables.tx[0], tables.ty[0], d[0])
    if C > 1:
        acc, _ = jax.lax.scan(
            scan_body, first,
            (tables.tx[1:], tables.ty[1:], d[1:]),
        )
    else:
        acc = first

    # projective tail: fold the T per-window partials, then Horner.
    # lane_fold expects leaves (.., L); acc leaves are (.., M, W, T).
    if T > 1:
        acc = MSM.lane_fold(acc, ops, T)  # -> (.., M, W)
    else:
        acc = jax.tree_util.tree_map(lambda a: a[..., 0], acc)
    return jax.tree_util.tree_map(
        lambda a: jnp.swapaxes(a, -1, -2), acc
    )  # (.., W, M)


def msm_affine_tree(tables: AffineTables, scalars, ops,
                    affine_levels: int | None = None):
    """M same-size MSMs over staged affine tables.

    scalars: (16, M, n_pad) u32 plain-form limbs (n_pad = C*S)
    returns point pytree leaves (35[,2], M) -- same contract as
    msm_signed_dense."""
    wsum = tree_window_sums(tables, scalars, ops, affine_levels)
    return MSM.horner_windows(wsum, ops, tables.is_g2, 4)
