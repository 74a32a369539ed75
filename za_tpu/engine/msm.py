"""Pippenger multi-scalar multiplication on device.

Scatter-conflict-free formulation: the point stream is split across K
lanes; each lane serially accumulates its points into its OWN bucket
array (buckets laid out (B, K) so a step's K updates always hit K
distinct rows -- per-step gather/add/scatter with unique indices).
Lane bucket arrays are then tree-reduced, buckets are weighted by a
suffix associative scan, and windows combine by Horner doubling.

Total point-add count = n*windows + O(2^c log) -- the same as serial
Pippenger, fully vectorized, no data-dependent control flow (digit-0
points land in bucket 0 which carries weight 0).

Replaces bellman's CPU multiexp worker pool (SURVEY.md section 2.3);
the sharded variant splits the point stream per device and reduces
bucket sums across the mesh (za_tpu.engine.mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import field as F
from .ec import FieldOps, point_add, point_double, point_identity_like

SCALAR_BITS = 254


def pick_window(n: int) -> int:
    """Window size heuristic: bucket work ~ 2^c log2(2^c) vs n per window."""
    if n <= 1:
        return 2
    c = max(2, int(np.log2(max(n, 2))) - 3)
    return min(c, 13)


def digits_from_limbs(scalars, c: int):
    """(16, n) plain u16 limbs -> (windows, n) uint32 digits of c bits."""
    n = scalars.shape[1]
    windows = (SCALAR_BITS + c - 1) // c
    padded = jnp.concatenate(
        [scalars, jnp.zeros((2, n), dtype=jnp.uint32)], axis=0
    )
    outs = []
    for w in range(windows):
        bit = w * c
        j, sh = bit // F.LIMB_BITS, bit % F.LIMB_BITS
        v = padded[j] >> sh
        if sh:
            v = v | (padded[j + 1] << (F.LIMB_BITS - sh))
            v = v | (padded[j + 2] << (2 * F.LIMB_BITS - sh))
        else:
            v = v | (padded[j + 1] << F.LIMB_BITS)
        outs.append(v & ((1 << c) - 1))
    return jnp.stack(outs)


def _tree_reduce(pts, ops: FieldOps, axis_len: int):
    """Reduce point pytree along the trailing batch axis by halving."""
    while axis_len > 1:
        half = axis_len // 2
        odd = axis_len - 2 * half

        def split(a):
            return (
                jax.tree_util.tree_map(lambda x: x[..., :half], a),
                jax.tree_util.tree_map(lambda x: x[..., half : 2 * half], a),
                jax.tree_util.tree_map(lambda x: x[..., 2 * half :], a),
            )

        lo, hi, rest = split(pts)
        red = point_add(lo, hi, ops)
        if odd:
            pts = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=-1), red, rest
            )
            axis_len = half + odd
        else:
            pts = red
            axis_len = half
    return pts


def _weighted_bucket_sum(buckets, ops: FieldOps, B: int,
                         style: str = "scan"):
    """sum_{b=1}^{B-1} b * bucket_b; trailing axis B -> trailing axis 1.

    style='scan': the classic running/total sequential scan -- tiny
    compiled graph, O(B) loop iterations (CPU tests).
    style='tree'/'hybrid': suffix sums via associative scan + tree
    reduction -- log(B) wide passes, no sequential loop."""
    if style in ("tree", "hybrid"):
        tail = jax.tree_util.tree_map(lambda x: x[..., 1:], buckets)

        def add_fn(a, b):
            return point_add(a, b, ops)

        axis = jax.tree_util.tree_leaves(tail)[0].ndim - 1
        suffix = jax.lax.associative_scan(
            add_fn, tail, reverse=True, axis=axis
        )
        return _tree_reduce(suffix, ops, B - 1)

    tail = jax.tree_util.tree_map(
        lambda x: jnp.moveaxis(x[..., 1:], -1, 0)[::-1, ..., None], buckets
    )  # (B-1, ..., 1) high bucket first
    first = jax.tree_util.tree_map(lambda x: x[0], tail)

    def body(carry, bucket):
        running, total = carry
        running = point_add(running, bucket, ops)
        total = point_add(total, running, ops)
        return (running, total), None

    rest = jax.tree_util.tree_map(lambda x: x[1:], tail)
    (_, total), _ = jax.lax.scan(body, (first, first), rest)
    return total


def _lane_reduce(buckets, ops: FieldOps, K: int, style: str = "scan"):
    """Combine the K per-lane bucket arrays: (.., B, K) -> (.., B).

    'hybrid' tree-reduces down to 8 lanes (log K - 3 wide passes) then
    scans the rest -- few graph instantiations, no long narrow loops."""
    if style in ("tree", "hybrid"):
        stop = 8 if style == "hybrid" else 1
        k = K
        while k > stop:
            half = k // 2
            lo = jax.tree_util.tree_map(lambda x: x[..., :half], buckets)
            hi = jax.tree_util.tree_map(
                lambda x: x[..., half : 2 * half], buckets
            )
            rest = jax.tree_util.tree_map(lambda x: x[..., 2 * half :], buckets)
            red = point_add(lo, hi, ops)
            buckets = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=-1), red, rest
            )
            k = half + (k - 2 * half)
        if k == 1:
            return jax.tree_util.tree_map(lambda x: x[..., 0], buckets)
        return _lane_reduce(buckets, ops, k, "scan")
    lanes_first = jax.tree_util.tree_map(
        lambda x: jnp.moveaxis(x, -1, 0), buckets
    )  # (K, .., B)
    first = jax.tree_util.tree_map(lambda x: x[0], lanes_first)
    rest = jax.tree_util.tree_map(lambda x: x[1:], lanes_first)

    def lane_body(acc, lane):
        return point_add(acc, lane, ops), None

    lane_sum, _ = jax.lax.scan(lane_body, first, rest)
    return lane_sum


def auto_params(n: int, bytes_budget: int = 600 << 20,
                is_g2: bool = False) -> tuple[int, int]:
    """(window c, lanes K) balancing three costs per window: sequential
    accumulation steps (n/K iterations), lane/bucket reduction work
    (B*K point adds -- must stay well under n), and bucket memory."""
    c = pick_window(n)
    lanes = max(8, min(2048, n // 8))
    point_bytes = (6 if is_g2 else 3) * 64
    # reduction work cap: B*K <= n/2 (except tiny n)
    while c > 2 and (1 << c) * lanes > max(n // 2, 4096):
        if lanes > 8:
            lanes //= 2
        else:
            c -= 1
    while c > 2 and (1 << c) * lanes * point_bytes > bytes_budget:
        c -= 1
    return c, lanes


def msm_limbs(px_py_pz, scalars, ops: FieldOps, c: int | None = None,
              lanes: int = 256, reduce_style: str = "scan",
              layout: str = "limb"):
    """MSM over projective Montgomery points and plain u16-limb scalars.

    px_py_pz: point pytree (X, Y, Z), each leaf (16, n)
    scalars:  (16, n) uint32 (16-bit digits, plain form)
    layout='packed' stores buckets point-major so the per-step
    gather/scatter moves contiguous rows; 'limb' keeps limb-major
    arrays (smallest graphs, CPU tests).
    returns a single projective point pytree with trailing batch dim 1.
    """
    first_leaf = jax.tree_util.tree_leaves(px_py_pz)[0]
    n = first_leaf.shape[-1]
    if c is None:
        c = pick_window(n)
    B = 1 << c
    K = min(lanes, n)
    rows = -(-n // K)
    n_pad = rows * K

    if n_pad != n:
        pad = n_pad - n

        def padp(x):
            return jnp.concatenate(
                [x, jnp.zeros(x.shape[:-1] + (pad,), dtype=x.dtype)], axis=-1
            )

        px_py_pz = jax.tree_util.tree_map(padp, px_py_pz)
        scalars = jnp.concatenate(
            [scalars, jnp.zeros((F.NLIMBS, pad), dtype=jnp.uint32)], axis=-1
        )

    digits = digits_from_limbs(scalars, c)  # (windows, n_pad), LSB window first
    windows = digits.shape[0]
    digits = digits.reshape(windows, rows, K).astype(jnp.int32)
    digits = digits[::-1]  # MSB window first for Horner

    is_g2 = isinstance(px_py_pz[0], tuple)
    lane_ids = jnp.arange(K, dtype=jnp.int32)

    bucket_proto = jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape[:-1] + (B * K,), dtype=x.dtype), px_py_pz
    )

    pts_packed = _pack_point(px_py_pz) if layout == "packed" else None

    def window_sum(dw):
        """dw: (rows, K) digits -> weighted bucket sum, batch dim 1."""
        if layout == "packed":
            ident_pt = point_identity_like(bucket_proto[0], ops, is_g2)
            ident = _pack_point(ident_pt)  # (B*K, W)

            def body(step, buckets):
                idx = dw[step] * K + lane_ids
                acc = _unpack_point(buckets[idx], is_g2)  # row gather
                pt = _unpack_point(
                    jax.lax.dynamic_slice_in_dim(
                        pts_packed, step * K, K, 0
                    ),
                    is_g2,
                )
                new = point_add(acc, pt, ops)
                return buckets.at[idx].set(
                    _pack_point(new), unique_indices=True
                )

            packed = jax.lax.fori_loop(0, rows, body, ident)
            unpacked = _unpack_point(packed, is_g2)
            buckets = jax.tree_util.tree_map(
                lambda x: x.reshape(x.shape[:-1] + (B, K)), unpacked
            )
            lane_sum = _lane_reduce(buckets, ops, K, reduce_style)
            return _weighted_bucket_sum(lane_sum, ops, B, reduce_style)

        ident = point_identity_like(bucket_proto[0], ops, is_g2)

        def body(step, buckets):
            idx = dw[step] * K + lane_ids  # (K,) unique within the step
            acc = jax.tree_util.tree_map(lambda x: x[..., idx], buckets)
            pt = jax.tree_util.tree_map(
                lambda x: jax.lax.dynamic_slice_in_dim(x, step * K, K, -1),
                px_py_pz,
            )
            new = point_add(acc, pt, ops)
            return jax.tree_util.tree_map(
                lambda b, v: b.at[..., idx].set(v, unique_indices=True),
                buckets, new,
            )

        buckets = jax.lax.fori_loop(0, rows, body, ident)
        buckets = jax.tree_util.tree_map(
            lambda x: x.reshape(x.shape[:-1] + (B, K)), buckets
        )
        lane_sum = _lane_reduce(buckets, ops, K, reduce_style)  # (.., B)
        return _weighted_bucket_sum(lane_sum, ops, B, reduce_style)

    # Horner over windows, MSB first; one compiled window body (lax.scan)
    def scan_body(carry, dw):
        shifted = jax.lax.fori_loop(
            0, c, lambda _, p: point_double(p, ops), carry
        )
        return point_add(shifted, window_sum(dw), ops), None

    ident1 = point_identity_like(
        jax.tree_util.tree_map(lambda x: x[..., :1], px_py_pz)[0], ops, is_g2
    )
    result, _ = jax.lax.scan(scan_body, ident1, digits)
    return result


# -- fixed-base batch scalar multiplication (trusted setup) -------------------
# The setup's pk queries are thousands-to-millions of scalar multiples of
# the SAME generator (u_i(tau)*G1 etc., SURVEY.md section 2.3): a window
# table of generator multiples turns each into `windows` gathered adds.


def generator_doubles(base_point_dev, ops: FieldOps):
    """D_i = 2^i * G for i in 0..SCALAR_BITS (one scan of doublings);
    returns a pytree with leading axis SCALAR_BITS+1, trailing dim 1."""

    def body(cur, _):
        return point_add(cur, cur, ops), cur

    _, doubles = jax.lax.scan(
        body, base_point_dev, None, length=SCALAR_BITS + 1
    )
    return doubles  # [i] = 2^i * G


def fixed_base_table(base_point_dev, ops: FieldOps, c: int):
    """T[w, d] = d * 2^(c*w) * G as a pytree with leading (windows,) and
    trailing (B,) axes. Built from the doubling ladder with c masked
    B-wide add passes per window (one compiled body via scan)."""
    windows = (SCALAR_BITS + c - 1) // c
    B = 1 << c
    is_g2 = isinstance(base_point_dev[0], tuple)
    doubles = generator_doubles(base_point_dev, ops)
    # bit masks: bit j of digit d, shaped (c, B)
    d_ids = np.arange(B, dtype=np.int64)
    bits = np.stack([(d_ids >> j) & 1 for j in range(c)]).astype(bool)
    bits_dev = jnp.asarray(bits)

    ident_B = point_identity_like(
        jax.tree_util.tree_map(
            lambda x: jnp.zeros(x.shape[1:-1] + (B,), dtype=x.dtype), doubles
        )[0],
        ops, is_g2,
    )

    def per_window(w_doubles):
        """w_doubles: pytree of the c ladder points for this window."""

        def bit_body(j, acc):
            dj = jax.tree_util.tree_map(lambda x: x[j], w_doubles)  # (.., 1)
            added = point_add(
                acc,
                jax.tree_util.tree_map(
                    lambda x: jnp.broadcast_to(
                        x, x.shape[:-1] + (B,)
                    ),
                    dj,
                ),
                ops,
            )
            mask = bits_dev[j]  # (B,) bool
            return jax.tree_util.tree_map(
                lambda a, b: jnp.where(mask, a, b), added, acc
            )

        return jax.lax.fori_loop(0, c, bit_body, ident_B), None

    # group the ladder into per-window slices (windows, c, .., 1); the
    # last window may run past bit 254 -- pad the ladder with identity
    pad = windows * c - (SCALAR_BITS + 1)
    if pad > 0:
        ident1 = point_identity_like(
            jax.tree_util.tree_map(lambda x: x[0], doubles)[0], ops, is_g2
        )
        extra = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(
                x[None], (pad,) + x.shape
            ),
            ident1,
        )
        doubles = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b], axis=0), doubles, extra
        )
    else:
        doubles = jax.tree_util.tree_map(
            lambda x: x[: windows * c], doubles
        )
    grouped = jax.tree_util.tree_map(
        lambda x: x.reshape((windows, c) + x.shape[1:]), doubles
    )
    _, table = jax.lax.scan(
        lambda carry, wd: (carry, per_window(wd)[0]), 0, grouped
    )
    return table  # leading (windows,), trailing (B,)


def fixed_base_msm(table, scalars, ops: FieldOps, c: int):
    """points_i = scalars_i * G via the window table: `windows` gathered
    B->n point adds, fully batched over n.

    scalars: (16, n) plain u16 limbs; returns projective pytree with
    trailing axis n."""
    digits = digits_from_limbs(scalars, c).astype(jnp.int32)  # (windows, n)
    n = scalars.shape[-1]
    is_g2 = isinstance(table[0], tuple)
    ident = point_identity_like(
        jax.tree_util.tree_map(
            lambda x: jnp.zeros(x.shape[1:-1] + (n,), dtype=x.dtype), table
        )[0],
        ops, is_g2,
    )

    def body(acc, wd):
        tbl_w, dig_w = wd
        pts = jax.tree_util.tree_map(lambda x: x[..., dig_w], tbl_w)
        return point_add(acc, pts, ops), None

    acc, _ = jax.lax.scan(body, ident, (table, digits))
    return acc

# -- grouped window-parallel MSM ----------------------------------------------
# The per-window formulation above runs windows sequentially (Horner),
# so every window pays the accumulation loop's and the reductions'
# dispatch latency separately -- at small/medium n the MSM becomes
# latency-bound. Here ALL windows of ALL (same-size) MSMs accumulate
# in one pass: the bucket store gains leading (M, W) axes, each
# accumulation step batches M*W*K points, the lane/bucket reductions
# run once over wide arrays, and only the final Horner window combine
# (c doublings per window on batch-M points) is sequential.


def _pack_point_md(pt):
    """point pytree with leaves (16, ...) -> (..., limbs*coords)."""
    leaves = jax.tree_util.tree_leaves(pt)
    return jnp.concatenate([jnp.moveaxis(l, 0, -1) for l in leaves], axis=-1)


def _unpack_point_md(packed, is_g2: bool):
    """(..., limbs*coords) -> point pytree with leaves (16, ...)."""
    cols = [
        jnp.moveaxis(packed[..., i * F.NLIMBS : (i + 1) * F.NLIMBS], -1, 0)
        for i in range(packed.shape[-1] // F.NLIMBS)
    ]
    if is_g2:
        return ((cols[0], cols[1]), (cols[2], cols[3]), (cols[4], cols[5]))
    return (cols[0], cols[1], cols[2])


#: max simultaneous point additions in one wide pass -- bounds XLA temp
#: memory (a point_add holds several (32, batch) u32 temps: ~800B/point)
FOLD_CAP = 1 << 18


def auto_params_grouped(n: int, M: int, is_g2: bool = False,
                        bytes_budget: int = 4 << 30) -> tuple[int, int]:
    """(window c, lanes K) for the grouped MSM.

    Cost model: the accumulation loop is n/K sequential steps (the
    dominant latency at any size), reductions are wide passes whose
    work M*W*B*K must stay small next to n*W*M, and the bucket store
    M*W*B*K points must fit the memory budget."""
    point_bytes = (6 if is_g2 else 3) * F.NLIMBS * 4

    def W(c):
        return (SCALAR_BITS + c - 1) // c

    c = pick_window(n)
    # weighted-bucket-sum passes run at batch M*W*B: keep them foldable
    while c > 2 and M * W(c) * (1 << c) > FOLD_CAP:
        c -= 1
    B = 1 << c
    lanes = 512
    # bucket memory and reduction-work caps (reduction work stays under
    # ~n/4 adds per window beyond a 64k floor where it is trivial)
    while lanes > 8 and (
        M * W(c) * B * lanes * point_bytes > bytes_budget
        or B * lanes > max(n // 4, 1 << 16)
    ):
        lanes //= 2
    return c, lanes


def msm_limbs_grouped(points, scalars, ops: FieldOps, c: int,
                      lanes: int, reduce_style: str = "tree"):
    """M same-size MSMs at once, all windows in parallel.

    points:  point pytree, leaves (16, M, n) (projective Montgomery)
    scalars: (16, M, n) uint32 plain-form 16-bit digits
    returns point pytree with leaves (16, M).
    """
    first_leaf = jax.tree_util.tree_leaves(points)[0]
    M, n = first_leaf.shape[1], first_leaf.shape[2]
    B = 1 << c
    K = min(lanes, n)
    rows = -(-n // K)
    n_pad = rows * K
    is_g2 = isinstance(points[0], tuple)

    if n_pad != n:
        pad = n_pad - n

        def padp(x):
            return jnp.concatenate(
                [x, jnp.zeros(x.shape[:-1] + (pad,), dtype=x.dtype)], axis=-1
            )

        points = jax.tree_util.tree_map(padp, points)
        scalars = padp(scalars)

    # digits: (16, M, n_pad) -> (W, M*n_pad) -> (rows, M, W, K)
    digits = digits_from_limbs(scalars.reshape(F.NLIMBS, M * n_pad), c)
    W = digits.shape[0]
    digits = (
        digits.reshape(W, M, rows, K)
        .transpose(2, 1, 0, 3)
        .astype(jnp.int32)
    )  # (rows, M, W, K), windows LSB-first

    pts_packed = _pack_point_md(points)  # (M, n_pad, cols)
    cols = pts_packed.shape[-1]

    ident_mw = point_identity_like(
        jax.tree_util.tree_map(
            lambda x: jnp.zeros((F.NLIMBS, M, W, B * K), dtype=x.dtype),
            points,
        )[0],
        ops, is_g2,
    )
    buckets0 = _pack_point_md(ident_mw)  # (M, W, B*K, cols)

    lane_ids = jnp.arange(K, dtype=jnp.int32)
    m_ids = jnp.arange(M)[:, None, None]
    w_ids = jnp.arange(W)[None, :, None]

    def body(step, buckets):
        d = jax.lax.dynamic_index_in_dim(
            digits, step, 0, keepdims=False
        )  # (M, W, K)
        idx = d * K + lane_ids
        acc = _unpack_point_md(buckets[m_ids, w_ids, idx], is_g2)
        pts = jax.lax.dynamic_slice_in_dim(
            pts_packed, step * K, K, 1
        )  # (M, K, cols)
        pts = jnp.broadcast_to(pts[:, None], (M, W, K, cols))
        new = point_add(acc, _unpack_point_md(pts, is_g2), ops)
        return buckets.at[m_ids, w_ids, idx].set(
            _pack_point_md(new), unique_indices=True
        )

    buckets = jax.lax.fori_loop(0, rows, body, buckets0)
    # (M, W, B*K, cols) -> leaves (16, M, W, B, K)
    pt_buckets = _unpack_point_md(
        buckets.reshape(M, W, B, K, cols), is_g2
    )

    # fold the lane axis down in fixed-shape scan chunks first so no
    # single wide pass exceeds FOLD_CAP simultaneous point adds (the
    # tree/scan reductions below then stay within temp-memory bounds)
    group = M * W * B
    K_cur = K
    K1 = K_cur
    while K1 > 1 and K1 % 2 == 0 and group * K1 > FOLD_CAP:
        K1 //= 2
    if K1 < K_cur:
        K2 = K_cur // K1

        def to_chunks(x):
            x = x.reshape(x.shape[:-1] + (K1, K2))
            return jnp.moveaxis(x, -1, 0)  # (K2, ..., K1)

        chunked = jax.tree_util.tree_map(to_chunks, pt_buckets)
        first = jax.tree_util.tree_map(lambda x: x[0], chunked)
        rest = jax.tree_util.tree_map(lambda x: x[1:], chunked)

        def fold(carry, sl):
            return point_add(carry, sl, ops), None

        pt_buckets, _ = jax.lax.scan(fold, first, rest)
        K_cur = K1

    lane_sum = _lane_reduce(pt_buckets, ops, K_cur, reduce_style)  # (.., B)
    wsum = _weighted_bucket_sum(lane_sum, ops, B, reduce_style)
    # trailing axis 1 (tree) or none (scan) -> leaves (16, M, W)
    wsum = jax.tree_util.tree_map(
        lambda x: x.reshape((F.NLIMBS, M, W)), wsum
    )

    # Horner over windows, MSB first, batch M
    per_w = jax.tree_util.tree_map(
        lambda x: jnp.moveaxis(x, -1, 0)[::-1], wsum
    )  # leaves (W, 16, M)

    def horner(carry, ws):
        shifted = jax.lax.fori_loop(
            0, c, lambda _, p: point_double(p, ops), carry
        )
        return point_add(shifted, ws, ops), None

    ident_m = point_identity_like(
        jax.tree_util.tree_map(lambda x: x[0], per_w)[0], ops, is_g2
    )
    result, _ = jax.lax.scan(horner, ident_m, per_w)
    return result


# -- dense (scatter-free) MSM -------------------------------------------------
# The dense formulation does zero data-dependent movement (no gathers
# or scatters): radix-4 digits select per point among {O, P, 2P, 3P}
# (elementwise where), each window's selection tree-reduces, and
# windows fold Horner-style inside one scan. Work = ceil(254/2) * n
# point adds, all dense elementwise; the 2P/3P tables are two batched
# adds computed in-program.


def msm_limbs_dense(points, scalars, ops: FieldOps, lanes: int = 128):
    """M same-size MSMs, dense radix-4, no gathers/scatters.

    All 127 windows accumulate SIMULTANEOUSLY (windows are a tensor
    axis, so a step's point-add batch is W*M*lanes wide) over n/lanes
    chunk steps; lanes then fold by recursive doubling (dynamic roll);
    only the final Horner window combine is narrow. The compiled graph
    holds ~6 point-add instantiations regardless of n (XLA compile
    time, not FLOPs, was the prover bottleneck at scale).

    points:  point pytree, leaves (16, M, n) (projective Montgomery)
    scalars: (16, M, n) uint32 plain-form 16-bit digits
    returns point pytree with leaves (16, M).
    """
    first_leaf = jax.tree_util.tree_leaves(points)[0]
    M, n = first_leaf.shape[1], first_leaf.shape[2]
    is_g2 = isinstance(points[0], tuple)

    L = 1
    while L * 2 <= min(lanes, n):
        L *= 2
    C = -(-n // L)
    n_pad = C * L
    if n_pad != n:
        def padp(x):
            return jnp.concatenate(
                [x, jnp.zeros(x.shape[:-1] + (n_pad - n,), dtype=x.dtype)],
                axis=-1,
            )

        points = jax.tree_util.tree_map(padp, points)
        scalars = padp(scalars)

    t2 = point_add(points, points, ops)
    t3 = point_add(t2, points, ops)

    def rsh(x):  # (16, M, n_pad) -> (16, M, C, L)
        return x.reshape(x.shape[:-1] + (C, L))

    tabs = [jax.tree_util.tree_map(rsh, t) for t in (points, t2, t3)]

    # 2-bit digits of all windows: (16, M, n) u16 limbs -> (W, M, C, L)
    shifts = jnp.arange(0, F.LIMB_BITS, 2, dtype=jnp.uint32)
    d_all = (scalars[:, None] >> shifts[None, :, None, None]) & 3
    W = (SCALAR_BITS + 1) // 2  # 127 two-bit windows
    digits = (
        d_all.reshape(F.NLIMBS * (F.LIMB_BITS // 2), M, n_pad)[:W]
        .reshape(W, M, C, L)
        .transpose(2, 0, 1, 3)
        .astype(jnp.int32)
    )  # (C, W, M, L), window w = bits [2w, 2w+2), LSB-first

    ident_wml = point_identity_like(
        jax.tree_util.tree_map(
            lambda x: jnp.zeros((F.NLIMBS, W, M, L), dtype=x.dtype), points
        )[0],
        ops, is_g2,
    )

    def step_body(step, acc):
        d = jax.lax.dynamic_index_in_dim(
            digits, step, 0, keepdims=False
        )  # (W, M, L)
        chunk = [
            jax.tree_util.tree_map(
                lambda x: jax.lax.dynamic_index_in_dim(
                    x, step, 2, keepdims=False
                )[:, None],
                t,
            )
            for t in tabs
        ]  # leaves (16, 1, M, L), broadcast over W in the selects

        def pick(i, p1, p2, p3):
            out = jnp.where(d == 1, p1, i)
            out = jnp.where(d == 2, p2, out)
            return jnp.where(d == 3, p3, out)

        sel = jax.tree_util.tree_map(pick, ident_wml, *chunk)
        return point_add(acc, sel, ops)

    acc = jax.lax.fori_loop(0, C, step_body, ident_wml)
    return _fold_and_horner(acc, ops, is_g2, L)


def lane_fold(acc, ops: FieldOps, L: int):
    """Recursive-doubling lane fold: leaves (.., L) -> (..) totals.
    After log2(L) roll+add rounds every lane holds the sum; one
    point-add instantiation, L always a pow2."""
    def fold_body(s, a):
        rolled = jax.tree_util.tree_map(
            lambda x: jnp.roll(x, jnp.left_shift(1, s), axis=-1), a
        )
        return point_add(a, rolled, ops)

    acc = jax.lax.fori_loop(0, L.bit_length() - 1, fold_body, acc)
    return jax.tree_util.tree_map(lambda x: x[..., 0], acc)


def horner_windows(wsum, ops: FieldOps, is_g2: bool, window_bits: int,
                   pvary_axis: str | None = None):
    """Combine per-window sums (leaves (rows, W, M)) MSB-first with
    window_bits doublings per step; returns leaves (rows, M)."""
    per_w = jax.tree_util.tree_map(
        lambda x: jnp.moveaxis(x, -2, 0)[::-1], wsum
    )  # leaves (W, .., M)

    def horner(carry, s_w):
        shifted = jax.lax.fori_loop(
            0, window_bits, lambda _, p: point_double(p, ops), carry
        )
        return point_add(shifted, s_w, ops), None

    ident_m = point_identity_like(
        jax.tree_util.tree_map(lambda x: x[0], per_w)[0], ops, is_g2
    )
    if pvary_axis is not None:
        ident_m = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, pvary_axis, to="varying"), ident_m
        )
    result, _ = jax.lax.scan(horner, ident_m, per_w)
    return result


def _fold_and_horner(acc, ops: FieldOps, is_g2: bool, L: int,
                     window_bits: int = 2):
    """Shared dense-MSM tail: lane fold + Horner window combine.

    acc: point pytree, leaves (rows, W, M, L) per-lane window sums.
    Returns leaves (rows, M)."""
    wsum = lane_fold(acc, ops, L)
    return horner_windows(wsum, ops, is_g2, window_bits)


# -- signed-digit dense MSM ---------------------------------------------------
# The radix-4 dense MSM does ceil(254/2) = 127 point adds per point.
# Signed base-2^c digits halve the table span (digits in [-2^(c-1),
# 2^(c-1)], negation is a Y-flip): at c=4 the work drops to 64 adds +
# 7 table-build adds per point (~1.8x). Representation-agnostic over
# FieldOps -- used with the RNS ops (engine/rns.py) and the limb ops.


def signed_digits(scalars, c: int):
    """(16, ...) plain u16-limb scalars (< 2^254) -> (W, ...) int32
    signed digits, value = sum d_w * 2^(c*w), d_w in [-2^(c-1), 2^(c-1)].

    Closed form (no carry scan): with A_w = floor(s/2^(c*w) + 1/2),
    d_w = A_w - 2^c*A_{w+1} = raw_w + topbit(raw_{w-1}) -
    2^c*topbit(raw_w), where topbit(r) = r >> (c-1)."""
    assert 16 % c == 0, "c must divide the limb width"
    shape = scalars.shape
    flat = scalars.reshape(F.NLIMBS, -1)
    W = -(-254 // c)
    # no-carry-out precondition of the closed-form recode: the top
    # window must have at least one bit of headroom (scalars < 2^254,
    # so c*W >= 255 keeps the top digit < 2^(c-1) and the final carry
    # zero). c=2 (W=127, c*W=254) would silently drop a carry.
    assert c * W >= 255, (
        f"signed_digits: c={c} leaves no top-window headroom "
        f"(c*W={c * W} < 255); scalars >= 2^253 would decode wrong"
    )
    raw = digits_from_limbs(flat, c)[:W].astype(jnp.int32)  # (W, n)
    top = raw >> (c - 1)  # 0/1
    prev_top = jnp.concatenate([jnp.zeros_like(top[:1]), top[:-1]])
    d = raw + prev_top - (top << c)
    return d.reshape((W,) + shape[1:])


def _tree_zeros(pt):
    return jax.tree_util.tree_map(jnp.zeros_like, pt)


def _tree_where(cond, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(cond, x, y), a, b
    )


def point_neg(pt, ops: FieldOps):
    """(X, Y, Z) -> (X, -Y, Z), representation-agnostic: -Y as
    ops.sub(0, Y) (limb: N - Y; RNS: offset - Y)."""
    X, Y, Z = pt
    return (X, ops.sub(_tree_zeros(Y), Y), Z)


def build_multiples(points, ops: FieldOps, half: int):
    """[P, 2P, ..., half*P] as a list of point pytrees (half-1 batched
    adds)."""
    tabs = [points]
    for _ in range(half - 1):
        tabs.append(point_add(tabs[-1], points, ops))
    return tabs


def signed_window_sums(points, scalars, ops: FieldOps, c: int, L: int,
                       pvary_axis: str | None = None):
    """Per-lane window sums of the signed-dense MSM: the shard-local
    stage. points leaves (rows, M, n) with L | n; scalars (16, M, n).
    Returns point pytree with leaves (rows, W, M, L). pvary_axis marks
    the identity carry device-varying when run under shard_map."""
    first_leaf = jax.tree_util.tree_leaves(points)[0]
    M, n = first_leaf.shape[-2], first_leaf.shape[-1]
    is_g2 = isinstance(points[0], tuple)
    half = 1 << (c - 1)
    C = n // L

    tabs = build_multiples(points, ops, half)

    def rsh(x):  # (.., M, n) -> (.., M, C, L)
        return x.reshape(x.shape[:-1] + (C, L))

    tabs = [jax.tree_util.tree_map(rsh, t) for t in tabs]

    d = signed_digits(scalars, c)  # (W, M, n)
    W = d.shape[0]
    digits = (
        d.reshape(W, M, C, L).transpose(2, 0, 1, 3)
    )  # (C, W, M, L) int32

    ident_wml = point_identity_like(
        jax.tree_util.tree_map(
            lambda x: jnp.zeros(
                x.shape[:-2] + (W, M, L), dtype=x.dtype
            ),
            points,
        )[0],
        ops, is_g2,
    )
    if pvary_axis is not None:
        ident_wml = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, pvary_axis, to="varying"), ident_wml
        )

    def step_body(step, acc):
        dw = jax.lax.dynamic_index_in_dim(
            digits, step, 0, keepdims=False
        )  # (W, M, L)
        chunk = [
            jax.tree_util.tree_map(
                lambda x: jnp.expand_dims(
                    jax.lax.dynamic_index_in_dim(
                        x, step, x.ndim - 2, keepdims=False
                    ),
                    -3,
                ),
                t,
            )
            for t in tabs
        ]  # leaves (.., 1, M, L); broadcast over W in the selects
        ad = jnp.abs(dw)  # (W, M, L), right-aligned broadcast

        sel = chunk[0]
        for k in range(2, half + 1):
            sel = _tree_where(ad == k, chunk[k - 1], sel)
        X, Y, Z = sel
        neg = dw < 0
        Yn = ops.sub(_tree_zeros(Y), Y)
        sel = (X, _tree_where(neg, Yn, Y), Z)
        added = point_add(acc, sel, ops)
        return _tree_where(dw == 0, acc, added)

    return jax.lax.fori_loop(0, C, step_body, ident_wml)


def msm_signed_dense(points, scalars, ops: FieldOps, c: int = 4,
                     lanes: int = 128):
    """M same-size MSMs, signed radix-2^c, scatter/gather-free.

    points:  point pytree, leaves (rows, M, n) (projective Montgomery,
             limb or RNS rows)
    scalars: (16, M, n) uint32 plain-form 16-bit digits
    returns point pytree with leaves (rows, M).

    All ceil(254/c) windows accumulate simultaneously (windows are a
    tensor axis; one point-add instantiation per chunk step); lanes
    fold by recursive doubling; Horner combines windows with c
    doublings each. Work: (W + 2^(c-1) - 1) * n point adds."""
    first_leaf = jax.tree_util.tree_leaves(points)[0]
    n = first_leaf.shape[-1]
    is_g2 = isinstance(points[0], tuple)

    L = 1
    while L * 2 <= min(lanes, n):
        L *= 2
    C = -(-n // L)
    n_pad = C * L
    if n_pad != n:
        def padp(x):
            return jnp.concatenate(
                [x, jnp.zeros(x.shape[:-1] + (n_pad - n,), dtype=x.dtype)],
                axis=-1,
            )

        points = jax.tree_util.tree_map(padp, points)
        scalars = padp(scalars)

    acc = signed_window_sums(points, scalars, ops, c, L)
    return _fold_and_horner(acc, ops, is_g2, L, window_bits=c)


# -- packed bucket storage ----------------------------------------------------
# The bucket accumulation gathers/scatters K arbitrary rows per step.
# Limb-major arrays make that a per-ELEMENT gather;
# packing each point's 3*16 (G1) or 6*16 (G2) limbs into one contiguous
# row turns it into K contiguous-row copies plus a cheap transpose.


def _pack_point(pt):
    """point pytree with trailing batch axis n -> (n, limbs*coords)."""
    leaves = jax.tree_util.tree_leaves(pt)  # each (16, n)
    return jnp.concatenate([l.T for l in leaves], axis=1)


def _unpack_point(packed, is_g2: bool):
    """(n, limbs*coords) -> point pytree with trailing batch axis n."""
    cols = [
        packed[:, i * F.NLIMBS : (i + 1) * F.NLIMBS].T
        for i in range(packed.shape[1] // F.NLIMBS)
    ]
    if is_g2:
        return (
            (cols[0], cols[1]),
            (cols[2], cols[3]),
            (cols[4], cols[5]),
        )
    return (cols[0], cols[1], cols[2])
