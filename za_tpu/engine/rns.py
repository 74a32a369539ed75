"""Residue-number-system (RNS) field arithmetic: the prover's field core.

A 16x16-limb Montgomery product (za_tpu.engine.field) costs ~8k
elementwise u32 ops. RNS replaces the quadratic part of modular
multiplication with two small constant-matrix products over int8
digits:

  * a field element is its residues modulo 35 pseudo-Mersenne 16-bit
    primes (channels): base B1 (17), base B2 (17), one redundant
    channel p_r. Channel products are exact in uint32 and reduce with
    3 eps-folds (p = 2^16 - eps, eps < 512).
  * multiplication mod N is RNS Montgomery (Bajard/Kawamura/Gandino):
    t = a*b per channel; q = -t/N in B1; base-extend q to B2+r;
    r = (t + q*N)/M1 in B2+r; base-extend r back to B1. Values carry a
    global Montgomery factor M1 (x~ = X*M1 mod N).
  * each base extension is a CRT matrix product with CONSTANT 16-bit
    matrices -- executed as TWO dots of int8 digits (exact float32
    dots, see _dot_i8) via an exact signed base-256 splitting (data d = d_lo + 256*d_hi + 32896 with int8
    digits; constants pre-split, the 32896 shift folded into a
    per-target additive constant).
  * extension 1 (q) uses Kawamura's approximate alpha from a shaved
    float32 dot (guaranteed underestimate, so q_ext = q + delta*M1,
    delta in {0,1} -- harmless slack absorbed by the bound budget).
    Extension 2 (r) must be exact and uses Shenoy-Kumaresan: the
    redundant channel p_r pins alpha exactly.

Integer bound discipline (no magnitude comparisons exist in RNS):
mont_mul accepts represented integers < 512N and outputs < 4N; add
outputs sum bounds; sub(a, b) adds a constant offset (32N default, 8N
for the Fq2 inner subtraction) and requires bound(b) <= offset. The
stationary coordinate bounds under the RCB formulas: G1 <= 44N, G2
component c0 <= 68N -- comfortably inside the 512N contract.
The complete RCB point formulas (za_tpu.engine.ec) keep every
intermediate within these contracts -- see rns_bounds in tests.

Replaces bn128 Fq/Fr multiplication inside the pairing_ce/bellman_ce
forks (SURVEY.md section 2.3) on the device compute path.
"""

from __future__ import annotations

import numpy as np

MASK16 = (1 << 16) - 1
SHIFT = 32896  # 128 + 256*128: the signed-base-256 data offset
K_BASE = 17    # channels per base
N_CH = 2 * K_BASE + 1  # B1 + B2 + redundant


def _gen_primes(count: int) -> list[int]:
    """The `count` largest primes below 2^16 with 2^16 - p < 512."""
    out = []
    p = (1 << 16) - 1
    while len(out) < count and p > (1 << 16) - 512:
        n = p
        if n % 2:
            d = 3
            is_p = True
            while d * d <= n:
                if n % d == 0:
                    is_p = False
                    break
                d += 2
            if is_p:
                out.append(n)
        p -= 1
    assert len(out) == count, "not enough pseudo-Mersenne 16-bit primes"
    return out


def _rep_i16x2(v: int) -> int:
    """Representative of v (mod nothing -- caller pre-reduces) in the
    exactly-int8x2-splittable window [-32896, 32639]."""
    assert -32896 <= v <= 32639
    return v


def _split_i8(v: int) -> tuple[int, int]:
    """v in [-32896, 32639] -> (lo, hi) int8 with v = lo + 256*hi."""
    u = v + SHIFT  # [0, 65535]
    lo = (u & 255) - 128
    hi = (u >> 8) - 128
    assert lo + 256 * hi == v and -128 <= lo <= 127 and -128 <= hi <= 127
    return lo, hi


def _window_rep(residue: int, p: int) -> int:
    """Pick residue or residue - p, whichever lies in [-32896, 32639]."""
    if residue <= 32639:
        return residue
    return residue - p


class RnsContext:
    """All constants for RNS arithmetic modulo `modulus` (Fq or Fr)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        primes = _gen_primes(N_CH)
        self.primes_list = primes
        self.b1 = primes[:K_BASE]
        self.b2 = primes[K_BASE:2 * K_BASE]
        self.pr = primes[2 * K_BASE]
        self.m1 = 1
        for p in self.b1:
            self.m1 *= p
        self.m2 = 1
        for p in self.b2:
            self.m2 *= p
        # mont_mul bound contract: t = A*B <= (512N)^2 and t/M1 <= 2N
        assert self.m1 >= (1 << 17) * modulus, "M1 too small for bounds"
        assert self.m2 > 512 * modulus, "M2 too small"

        N = modulus
        M1, M2, pr = self.m1, self.m2, self.pr
        self.p = np.array(primes, dtype=np.uint32)
        self.eps = (np.uint32(1 << 16) - self.p).astype(np.uint32)

        # fused lambda constant: lambda_i = t_i * (-N^-1 * (M1/p_i)^-1)
        self.lamw1 = np.array(
            [
                (-pow(N, -1, p) * pow(M1 // p, -1, p)) % p
                for p in self.b1
            ],
            dtype=np.uint32,
        )

        # ext1: B1 -> B2 + r. T1[i][j] = (M1/p_i) mod p_j
        tgt1 = self.b2 + [pr]
        self._build_ext(
            "ext1",
            srcs=self.b1,
            tgts=tgt1,
            entry=lambda i, j_p: (M1 // self.b1[i]) % j_p,
        )
        self.m1_mod_t1 = np.array([M1 % p for p in tgt1], dtype=np.uint32)
        # shaved reciprocals for the Kawamura alpha estimate: strictly
        # below 1/p so the f32 dot can never overestimate
        self.alpha_rcp = np.array(
            [(1.0 - 2.0 ** -11) / p for p in self.b1], dtype=np.float32
        )

        # step-4 constants over B2 + r: r_j = t_j*M1inv + q_j*(N*M1inv)
        self.m1inv_t = np.array(
            [pow(M1, -1, p) for p in tgt1], dtype=np.uint32
        )
        self.nm1inv_t = np.array(
            [(N * pow(M1, -1, p)) % p for p in tgt1], dtype=np.uint32
        )

        # ext2: B2 -> B1 + r (exact, Shenoy-Kumaresan via channel p_r)
        self.w2 = np.array(
            [pow(M2 // p, -1, p) for p in self.b2], dtype=np.uint32
        )
        tgt2 = self.b1 + [pr]
        self._build_ext(
            "ext2",
            srcs=self.b2,
            tgts=tgt2,
            entry=lambda i, j_p: (M2 // self.b2[i]) % j_p,
        )
        self.m2_mod_t2 = np.array([M2 % p for p in tgt2], dtype=np.uint32)
        self.m2inv_r = int(pow(M2, -1, pr))

        # limb -> RNS conversion: L[i][j] = 2^(16 i) mod p_j, 16 sources
        self._build_ext(
            "l2r",
            srcs=[0] * 16,
            tgts=primes,
            entry=lambda i, j_p: pow(2, 16 * i, j_p),
        )

        # Montgomery form x~ = X*M1 mod N
        self.m1sq_rns = self.ints_to_rns([(M1 * M1) % N])[:, 0]
        self.one_rns = self.ints_to_rns([M1 % N])[:, 0]
        self.sub_off = np.array(
            [(32 * N) % p for p in primes], dtype=np.uint32
        )
        self.sub_off8 = np.array(
            [(8 * N) % p for p in primes], dtype=np.uint32
        )
        # 64N offset: the Karatsuba-Fq2 G2 group law subtracts values
        # whose c1 component reaches 40N (> the 32N default window)
        self.sub_off64 = np.array(
            [(64 * N) % p for p in primes], dtype=np.uint32
        )
        # matmul-output reduction offset: p_j * ceil(2^27.5 / p_j)
        big = int(2 ** 27.5) + 1
        self.red_off = {
            "ext1": np.array(
                [p * (-(-big // p)) for p in tgt1], dtype=np.uint32
            ),
            "ext2": np.array(
                [p * (-(-big // p)) for p in tgt2], dtype=np.uint32
            ),
            "l2r": np.array(
                [p * (-(-big // p)) for p in primes], dtype=np.uint32
            ),
        }

        # host CRT over B1 for conversions out
        self.crt_c1 = [
            (M1 // p) * pow(M1 // p, -1, p) % M1 for p in self.b1
        ]

    def _build_ext(self, name: str, srcs, tgts, entry):
        """Precompute the int8-split matmul constants for one CRT
        extension: W0/W1 (n_tgt, 2*n_src) int8 and K (n_tgt,) u32 with

          sum_i lam_i * T[i][j]  ===  (W0 @ d)_j + 256*(W1 @ d)_j + K_j
                                                             (mod p_j)
        where d = [d_lo | d_hi], lam_i = d_lo_i + 256*d_hi_i + 32896."""
        ns, nt = len(srcs), len(tgts)
        w0 = np.zeros((nt, 2 * ns), dtype=np.int8)
        w1 = np.zeros((nt, 2 * ns), dtype=np.int8)
        k = np.zeros(nt, dtype=np.uint32)
        for j, pj in enumerate(tgts):
            ksum = 0
            for i in range(ns):
                t_ij = entry(i, pj)  # in [0, p_j)
                v_ij = (256 * t_ij) % pj
                t_rep = _window_rep(t_ij, pj)
                v_rep = _window_rep(v_ij, pj)
                tl, th = _split_i8(t_rep)
                vl, vh = _split_i8(v_rep)
                w0[j, i] = tl
                w0[j, ns + i] = vl
                w1[j, i] = th
                w1[j, ns + i] = vh
                ksum += SHIFT * t_rep
            k[j] = ksum % pj
        setattr(self, name + "_w0", w0)
        setattr(self, name + "_w1", w1)
        setattr(self, name + "_k", k)

    # -- host-side conversions (tests, tiny outputs) ------------------------

    def ints_to_rns(self, values) -> np.ndarray:
        """list of ints (0 <= v < 2^288, covers the 64N bound window)
        -> (35, n) uint32 residues."""
        buf = b"".join(int(v).to_bytes(36, "little") for v in values)
        limbs = (
            np.frombuffer(buf, dtype="<u2")
            .reshape(len(values), 18)
            .astype(np.uint64)
        )
        pow16 = np.array(
            [[pow(2, 16 * i, p) for i in range(18)] for p in self.primes_list],
            dtype=np.uint64,
        )  # (35, 18)
        acc = pow16 @ limbs.T  # (35, n), sums < 16*2^32 < 2^36: exact u64
        return (acc % self.p[:, None].astype(np.uint64)).astype(np.uint32)

    def rns_to_ints(self, arr) -> list[int]:
        """(35, n) residues -> represented integers (must be < M1):
        exact CRT over B1 with a consistency check against B2 and p_r."""
        arr = np.asarray(arr)
        out = []
        for col in range(arr.shape[1]):
            x = 0
            for i in range(K_BASE):
                x += int(arr[i, col]) * self.crt_c1[i]
            x %= self.m1
            for j, p in enumerate(self.b2):
                assert x % p == int(arr[K_BASE + j, col]), (
                    "RNS inconsistency (B2): represented value >= M1?"
                )
            assert x % self.pr == int(arr[2 * K_BASE, col]), (
                "RNS inconsistency (p_r)"
            )
            out.append(x)
        return out

    def to_mont_int(self, v: int) -> int:
        return v * self.m1 % self.modulus

    def from_mont_int(self, v: int) -> int:
        return v * pow(self.m1, -1, self.modulus) % self.modulus


from ..curve import Q as _Q, R as _R  # noqa: E402

RQ = RnsContext(_Q)
RR = RnsContext(_R)


# -- jax channel primitives ----------------------------------------------------
# All functions take (35, ...) uint32 arrays (channel axis leading, the
# batch on the trailing axes) and per-channel constant vectors that
# broadcast along the trailing axes. Pure jnp: runs under jit or eager.

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _b(v, x):
    """Broadcast a (C,) channel constant against (C, ...) data."""
    v = jnp.asarray(v)
    return v.reshape((v.shape[0],) + (1,) * (x.ndim - 1))


def _fold3(v, eps, p):
    """v < 2^28.7 (uint32) -> canonical residue in [0, p).
    Three pseudo-Mersenne folds (2^16 === eps mod p) + one cond-sub."""
    v = (v >> 16) * eps + (v & MASK16)
    v = (v >> 16) * eps + (v & MASK16)
    v = (v >> 16) * eps + (v & MASK16)
    return jnp.where(v >= p, v - p, v)


def ch_mul(a, b, ctx: RnsContext, sl=slice(None)):
    """Per-channel product mod p (both operands canonical residues)."""
    eps = _b(ctx.eps[sl], a)
    p = _b(ctx.p[sl], a)
    return _fold3(a * b, eps, p)


def ch_mul_const(a, cvec, ctx: RnsContext, sl=slice(None)):
    return ch_mul(a, _b(cvec, a), ctx, sl)


def ch_add(a, b, ctx: RnsContext, sl=slice(None)):
    p = _b(ctx.p[sl], a)
    s = a + b
    return jnp.where(s >= p, s - p, s)


def ch_sub_off(a, b, ctx: RnsContext, sl=slice(None), off_vec=None):
    """(a + off - b) channel-wise: the RNS subtraction. Integer
    semantics: represents A + off - B; requires bound(B) <= off
    (off = 32N default; pass ctx.sub_off8 where 8N suffices)."""
    p = _b(ctx.p[sl], a)
    off = _b(ctx.sub_off[sl] if off_vec is None else off_vec[sl], a)
    s = a + off + p - b  # < 3p < 2^18
    s = jnp.where(s >= p, s - p, s)
    return jnp.where(s >= p, s - p, s)


def _dot_i8(w, d):
    """Constant int8 matrix (nt, 2*ns) @ int8 data (2*ns, batch) -> the
    exact int32 products.

    The dot runs in float32 at HIGHEST precision, where it is exact:
    every product is below 2^14 and every sum below 2^20.  XLA:GPU's
    int8 x int8 -> int32 dot returned wrong sums for small batches."""
    out = jax.lax.dot_general(
        jnp.asarray(w, jnp.float32), d.astype(jnp.float32),
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out.astype(jnp.int32)


def _pack_i8(lam):
    """(ns, batch) canonical u16 residues -> (2*ns, batch) int8 signed
    base-256 digits (lam = d_lo + 256*d_hi + 32896)."""
    d_lo = (lam & 255).astype(jnp.int32) - 128
    d_hi = (lam >> 8).astype(jnp.int32) - 128
    return jnp.concatenate([d_lo, d_hi], axis=0).astype(jnp.int8)


def _extend(lam, w0, w1, k, red_off, p_tgt, eps_tgt, alpha=None,
            m_mod_tgt=None):
    """CRT base extension: lam (ns, batch) -> (nt, batch) canonical
    residues of sum_i lam_i*(M/p_i) [- alpha*M] at the target channels.

    alpha: optional (batch,) int32 multiple-of-M correction."""
    shape = lam.shape
    batch = 1
    for s in shape[1:]:
        batch *= s
    d = _pack_i8(lam.reshape(shape[0], batch))
    p0 = _dot_i8(w0, d)
    p1 = _dot_i8(w1, d)
    pre = p0 + (p1 << 8) + _b(k, p0).astype(jnp.int32)  # |pre| < 2^27.3
    if alpha is not None:
        am = alpha.reshape(1, batch).astype(jnp.int32) * _b(
            m_mod_tgt, p0
        ).astype(jnp.int32)
        pre = pre - am
    v = (pre + _b(red_off, pre).astype(jnp.int32)).astype(jnp.uint32)
    eps = _b(eps_tgt, v)
    p = _b(p_tgt, v)
    out = _fold3(v, eps, p)
    return out.reshape((out.shape[0],) + shape[1:])


B1 = slice(0, K_BASE)
B2 = slice(K_BASE, 2 * K_BASE)
B2R = slice(K_BASE, N_CH)
PR = 2 * K_BASE


def mont_mul_rns(a, b, ctx: RnsContext):
    """a * b * M1^-1 represented-integer product (all 35 channels).

    Contract: represented A, B < 512N; output < 4N. Channels canonical.

    u16 operands widen here (constant tables -- NTT twiddles, coset
    vectors, matvec coefficients -- stay resident at HALF the HBM and
    the cast fuses into the product)."""
    if a.dtype == jnp.uint16:
        a = a.astype(jnp.uint32)
    if b.dtype == jnp.uint16:
        b = b.astype(jnp.uint32)
    t = ch_mul(a, b, ctx)  # all 35 channels

    # lambda_i = t_i * (-N^-1 * w1_i) mod p_i  (B1 channels)
    lam = ch_mul_const(t[B1], ctx.lamw1, ctx, B1)

    # Kawamura alpha-hat (underestimate): floor(sum lam_i / p_i)
    rcp = _b(ctx.alpha_rcp, lam).astype(jnp.float32)
    alpha = jnp.floor(
        jnp.sum(lam.astype(jnp.float32) * rcp, axis=0)
    ).astype(jnp.int32)

    tgt1 = slice(K_BASE, N_CH)
    q_ext = _extend(
        lam, jnp.asarray(ctx.ext1_w0), jnp.asarray(ctx.ext1_w1),
        ctx.ext1_k, ctx.red_off["ext1"], ctx.p[tgt1], ctx.eps[tgt1],
        alpha=alpha, m_mod_tgt=ctx.m1_mod_t1,
    )  # (18, ...) residues of q + delta*M1 at B2 + r

    # r = (t + q*N) / M1 at B2 + r:  t*M1inv + q*(N*M1inv)
    r_t = ch_mul_const(t[B2R], ctx.m1inv_t, ctx, B2R)
    r_q = ch_mul_const(q_ext, ctx.nm1inv_t, ctx, B2R)
    r_b2r = ch_add(r_t, r_q, ctx, B2R)

    # exact extension B2 -> B1 (Shenoy-Kumaresan via p_r)
    lam2 = ch_mul_const(r_b2r[:K_BASE], ctx.w2, ctx, B2)
    tgt2 = list(range(K_BASE)) + [PR]
    s_all = _extend(
        lam2, jnp.asarray(ctx.ext2_w0), jnp.asarray(ctx.ext2_w1),
        ctx.ext2_k, ctx.red_off["ext2"], ctx.p[tgt2], ctx.eps[tgt2],
    )  # S_j = sum lam2 * (M2/p_j) mod p_j at B1 + r (no alpha yet)

    # alpha' = (S_r - r_r) * M2^-1 mod p_r   (exact, < 17)
    pr_p = np.uint32(ctx.pr)
    d_r = s_all[K_BASE] + pr_p - r_b2r[K_BASE]
    d_r = jnp.where(d_r >= pr_p, d_r - pr_p, d_r)
    eps_r = np.uint32((1 << 16) - ctx.pr)
    alpha2 = _fold3(d_r * np.uint32(ctx.m2inv_r), eps_r, pr_p)

    # r at B1: S_i - alpha' * (M2 mod p_i)
    am = alpha2[None] * _b(ctx.m2_mod_t2[:K_BASE], s_all[:K_BASE])
    # am < 17 * 2^16 < 2^21; S + k*p - am with k*p > 2^21
    koff = _b(
        np.array(
            [p * ((1 << 21) // p + 1) for p in ctx.b1], dtype=np.uint32
        ),
        s_all[:K_BASE],
    )
    v = s_all[:K_BASE] + koff - am
    r_b1 = _fold3(
        v, _b(ctx.eps[B1], v), _b(ctx.p[B1], v)
    )

    return jnp.concatenate([r_b1, r_b2r], axis=0)


def to_mont_rns(x, ctx: RnsContext):
    """Plain residues (integer X < 64N) -> Montgomery form X*M1 mod-N
    (bound < 4N): one mont mul by M1^2."""
    return mont_mul_rns(x, _b(ctx.m1sq_rns, x), ctx)


def from_mont_rns(x, ctx: RnsContext):
    """Montgomery form -> plain residues of (X mod-N rep, < 4N):
    one mont mul by the integer 1."""
    one = jnp.ones((N_CH,) + (1,) * (x.ndim - 1), dtype=jnp.uint32)
    return mont_mul_rns(x, one, ctx)


def limbs_to_rns(limbs, ctx: RnsContext):
    """(16, ...) plain u16-limb values (integers < 2^256) -> (35, ...)
    plain residues, on device (the staging path for pk points)."""
    return _extend(
        limbs, jnp.asarray(ctx.l2r_w0), jnp.asarray(ctx.l2r_w1),
        ctx.l2r_k, ctx.red_off["l2r"], ctx.p, ctx.eps,
    )


def _r2l_consts(ctx: RnsContext):
    """(M1/p_i) and M1 as u8-limb rows for the exact CRT-out sum.
    Width covers S = sum lam_i*(M1/p_i) < 17*M1 (4 extra bytes)."""
    nbytes = (ctx.m1.bit_length() + 7) // 8 + 4
    nbytes = -(-nbytes // 2) * 2  # even, so u16 limb count is exact
    consts = np.array(
        [list((ctx.m1 // p).to_bytes(nbytes, "little")) for p in ctx.b1],
        dtype=np.uint32,
    )  # (17, nbytes)
    m1_bytes = np.array(
        list(ctx.m1.to_bytes(nbytes, "little")), dtype=np.uint32
    )
    w1 = np.array(
        [pow(ctx.m1 // p, -1, p) for p in ctx.b1], dtype=np.uint32
    )
    # S-K alpha over the redundant channel
    m1p_r = np.array(
        [(ctx.m1 // p) % ctx.pr for p in ctx.b1], dtype=np.uint32
    )
    m1inv_r = int(pow(ctx.m1, -1, ctx.pr))
    return consts, m1_bytes, w1, m1p_r, m1inv_r, nbytes


def _byte_fold(cols):
    """u32 byte columns (< 2^28.3) -> byte digits <= 275 (exact):
    three local carry folds at byte granularity."""
    def up(x):
        pad = [(1, 0)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad)[:-1]

    for _ in range(3):
        cols = (cols & 0xFF) + up(cols >> 8)
    return cols


def rns_to_limbs_exact(x, ctx: RnsContext, nlimbs: int = 16,
                       reduce_mod: int | None = None):
    """(35, ...) plain canonical residues (integer X < M1) ->
    (nlimbs, ...) u16-limb integers, EXACT on device: Shenoy-Kumaresan
    alpha from the redundant channel pins the CRT multiple, then
    X = sum lambda_i*(M1/p_i) - alpha*M1 accumulates in u8-limb
    columns. reduce_mod=N reduces X (must be < 8N) into [0, N) by a
    4N/2N/N conditional-subtract descent -- the path that converts
    device h(x) coefficients into MSM scalar limbs."""
    import za_tpu.engine.field as F  # noqa: PLC0415 -- cycle-free

    cache = getattr(ctx, "_r2l_cache", None)
    if cache is None:
        cache = _r2l_consts(ctx)
        ctx._r2l_cache = cache
    consts, m1_bytes, w1, m1p_r, m1inv_r, nbytes = cache

    lam = ch_mul_const(x[B1], w1, ctx, B1)  # (17, ...)

    # exact alpha: (S_r - x_r) * M1^-1 mod p_r
    pr_p = np.uint32(ctx.pr)
    eps_r = np.uint32((1 << 16) - ctx.pr)
    s_r = jnp.zeros_like(lam[0])
    for i in range(K_BASE):
        s_r = _fold3(s_r + lam[i] * np.uint32(m1p_r[i]), eps_r, pr_p)
    d_r = s_r + pr_p - x[PR]
    d_r = jnp.where(d_r >= pr_p, d_r - pr_p, d_r)
    alpha = _fold3(d_r * np.uint32(m1inv_r), eps_r, pr_p)  # < 17 (S-K)

    # S byte columns: sum_i lam_i * bytes(M1/p_i): products < 2^24,
    # 17 terms -> < 2^28.1 per column (u32-exact)
    bshape = (nbytes,) + (1,) * (x.ndim - 1)
    s_cols = None
    for i in range(K_BASE):
        term = lam[i][None] * jnp.asarray(consts[i]).reshape(bshape)
        s_cols = term if s_cols is None else s_cols + term
    a_cols = alpha[None] * jnp.asarray(m1_bytes).reshape(bshape)

    def to_u16(cols):
        b = _byte_fold(cols)  # bytes <= 275
        w16 = b[0::2] + (b[1::2] << 8)  # < 2^17: exact in carry_prop
        return F.carry_prop(w16)

    X, _ = F.sub_borrow(to_u16(s_cols), to_u16(a_cols))
    # the borrow is 0 by S-K exactness (X = S - alpha*M1 >= 0)

    if reduce_mod is not None:
        L = X.shape[0]
        for mult in (4, 2, 1):  # X < 8N -> [0, N)
            cvec = np.zeros(L, dtype=np.uint32)
            limbs = F.int_to_limbs(mult * reduce_mod)
            cvec[: len(limbs)] = limbs
            cb = jnp.asarray(cvec).reshape((L,) + (1,) * (X.ndim - 1))
            d, br = F.sub_borrow(X, jnp.broadcast_to(cb, X.shape))
            X = jnp.where(br == 0, d, X)
    return X[:nlimbs]
