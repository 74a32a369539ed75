"""Multi-device sharding: MSM and NTT over a jax.sharding.Mesh.

The communication design (SURVEY.md section 2.4):

  * MSM: bases/scalars split per device along the point-stream axis;
    each device runs local Pippenger bucket accumulation + lane
    reduction; the per-window bucket arrays are combined across
    devices (all_gather + local point-add reduce -- the point-group
    analogue of psum), then weighted and Horner-combined identically
    on every device.
  * NTT: four-step decomposition n = n1*n2 with n1 = D devices: an
    all_to_all redistributes between the decimated and contiguous
    layouts; inner/outer NTTs are device-local; the inter-factor
    twiddle multiply is elementwise.

Everything is shard_map over a 1-D mesh axis "d"; the collectives run
over NVLink between the GPUs of one host and over the virtual CPU mesh
in tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..curve import R
from . import ec, field as F, msm as MSM, ntt as NTT
from .field import FR

AXIS = "d"


def _pvary(tree):
    """Mark a freshly-built constant pytree as device-varying so scan
    carries type-check inside shard_map."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.pcast(x, AXIS, to="varying"), tree
    )


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(
            f"mesh needs {n} devices, have {len(devs)} (virtual CPU "
            "meshes: XLA_FLAGS=--xla_force_host_platform_device_count)"
        )
    if n & (n - 1):
        raise RuntimeError(f"mesh size must be a power of two, got {n}")
    return Mesh(np.array(devs[:n]), (AXIS,))


# -- sharded MSM --------------------------------------------------------------


def _msm_local_window_buckets(px_py_pz, dw, ops, B, K, rows):
    """Local bucket accumulation + lane reduce for one window
    (the shard-local part of MSM.msm_limbs.window_sum)."""
    lane_ids = jnp.arange(K, dtype=jnp.int32)
    bucket_proto = jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape[:-1] + (B * K,), dtype=x.dtype), px_py_pz
    )
    is_g2 = isinstance(px_py_pz[0], tuple)
    ident = _pvary(MSM.point_identity_like(bucket_proto[0], ops, is_g2))

    def body(step, buckets):
        idx = dw[step] * K + lane_ids
        acc = jax.tree_util.tree_map(lambda x: x[..., idx], buckets)
        pt = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, step * K, K, -1),
            px_py_pz,
        )
        new = ec.point_add(acc, pt, ops)
        return jax.tree_util.tree_map(
            lambda b, v: b.at[..., idx].set(v, unique_indices=True),
            buckets, new,
        )

    buckets = jax.lax.fori_loop(0, rows, body, ident)
    buckets = jax.tree_util.tree_map(
        lambda x: x.reshape(x.shape[:-1] + (B, K)), buckets
    )
    return buckets


def msm_limbs_sharded(px_py_pz, scalars, ops, c: int, lanes: int,
                      reduce_style: str = "scan"):
    """Shard-local body run under shard_map: local buckets, all_gather
    bucket arrays over the mesh axis, reduce, weight, Horner."""
    first_leaf = jax.tree_util.tree_leaves(px_py_pz)[0]
    n_local = first_leaf.shape[-1]
    B = 1 << c
    K = min(lanes, n_local)
    rows = -(-n_local // K)
    is_g2 = isinstance(px_py_pz[0], tuple)

    digits = MSM.digits_from_limbs(scalars, c)
    windows = digits.shape[0]
    digits = digits.reshape(windows, rows, K).astype(jnp.int32)[::-1]

    def window_sum(dw):
        buckets = _msm_local_window_buckets(px_py_pz, dw, ops, B, K, rows)
        lane_sum = MSM._lane_reduce(buckets, ops, K, reduce_style)  # (.., B)
        # combine bucket arrays across chips: gather + point-add reduce
        gathered = jax.lax.all_gather(lane_sum, AXIS)  # (D, .., B)
        fst = jax.tree_util.tree_map(lambda x: x[0], gathered)
        rst = jax.tree_util.tree_map(lambda x: x[1:], gathered)

        def dev_body(acc, dev):
            return ec.point_add(acc, dev, ops), None

        total, _ = jax.lax.scan(dev_body, fst, rst)
        return MSM._weighted_bucket_sum(total, ops, B, reduce_style)

    def scan_body(carry, dw):
        shifted = jax.lax.fori_loop(
            0, c, lambda _, p: ec.point_double(p, ops), carry
        )
        return ec.point_add(shifted, window_sum(dw), ops), None

    ident1 = _pvary(
        MSM.point_identity_like(
            jax.tree_util.tree_map(lambda x: x[..., :1], px_py_pz)[0],
            ops, is_g2,
        )
    )
    result, _ = jax.lax.scan(scan_body, ident1, digits)
    # every device computed the identical reduction; expose it with a
    # leading device axis so the out_spec stays shard-varying (the vma
    # checker cannot statically infer post-all_gather replication)
    return jax.tree_util.tree_map(lambda x: x[None], result)


def sharded_msm_fn(mesh: Mesh, ops, c: int, lanes: int, is_g2: bool,
                   reduce_style: str = "scan"):
    """Build the jitted sharded MSM callable for given window params.

    Inputs are sharded along the trailing point axis; every shard
    computes the identical result (device 0's copy is returned)."""
    if is_g2:
        pt_spec = ((P(None, AXIS),) * 2,) * 3
        out_spec = ((P(AXIS, None, None),) * 2,) * 3
    else:
        pt_spec = (P(None, AXIS),) * 3
        out_spec = (P(AXIS, None, None),) * 3

    fn = shard_map(
        partial(msm_limbs_sharded, ops=ops, c=c, lanes=lanes,
                reduce_style=reduce_style),
        mesh=mesh,
        in_specs=(pt_spec, P(None, AXIS)),
        out_specs=out_spec,
    )

    @jax.jit
    def run(points, scalars):
        out = fn(points, scalars)
        return jax.tree_util.tree_map(lambda x: x[0], out)

    return run


# -- sharded signed-dense MSM -------------------------------------------------
# Point stream and scalars split per device along n; each device
# computes its chunk's per-lane window sums and lane-folds them locally;
# the per-window partial sums (leaves (rows, W, M)) are combined across
# devices with an all_gather + point-add reduce (the point-group psum);
# the Horner window combine then runs identically everywhere.


def signed_msm_sharded(points, scalars, ops, c: int, L: int):
    """Shard-local body (runs under shard_map)."""
    first_leaf = jax.tree_util.tree_leaves(points)[0]
    is_g2 = isinstance(points[0], tuple)
    acc = MSM.signed_window_sums(
        points, scalars, ops, c, L, pvary_axis=AXIS
    )
    wsum = MSM.lane_fold(acc, ops, L)  # (rows, W, M)

    gathered = jax.lax.all_gather(wsum, AXIS)  # leaves (D, rows, W, M)
    fst = jax.tree_util.tree_map(lambda x: x[0], gathered)
    rst = jax.tree_util.tree_map(lambda x: x[1:], gathered)

    def dev_body(a, dev):
        return ec.point_add(a, dev, ops), None

    total, _ = jax.lax.scan(dev_body, fst, rst)
    result = MSM.horner_windows(total, ops, is_g2, c, pvary_axis=AXIS)
    # replicated result; expose with a leading device axis (see
    # msm_limbs_sharded)
    return jax.tree_util.tree_map(lambda x: x[None], result)


def sharded_signed_msm_fn(mesh: Mesh, ops, c: int = 4, lanes: int = 8,
                          is_g2: bool = False):
    """Jitted sharded signed-dense MSM. points leaves (rows, M, n) and
    scalars (16, M, n) sharded on n; n/D must be a multiple of lanes."""
    if is_g2:  # flat-Fq2 leaves (35, 2, M, n)
        pt_spec = (P(None, None, None, AXIS),) * 3
        out_spec = (P(AXIS, None, None, None),) * 3
    else:
        pt_spec = (P(None, None, AXIS),) * 3
        out_spec = (P(AXIS, None, None),) * 3

    fn = shard_map(
        partial(signed_msm_sharded, ops=ops, c=c, L=lanes),
        mesh=mesh,
        in_specs=(pt_spec, P(None, None, AXIS)),
        out_specs=out_spec,
    )

    @jax.jit
    def run(points, scalars):
        out = fn(points, scalars)
        return jax.tree_util.tree_map(lambda x: x[0], out)

    return run


# -- sharded batch-affine tree MSM --------------------------------------------
# The staged AffineTables' chunk axis C is sharded across the mesh
# (C % D == 0, staging pads the chunk count); each device runs the SAME
# per-chunk tree as single-device over its local chunks, producing
# per-window projective sums (leaves (35[,2], W, M)); an all_gather +
# point-add reduce combines windows across devices; Horner runs
# replicated.


def _gather_reduce_horner(wsum, ops, is_g2: bool, window_bits: int = 4):
    """all_gather per-window sums over the mesh axis, point-add reduce
    across devices, Horner combine (replicated); returns leaves with a
    leading device axis (see msm_limbs_sharded)."""
    gathered = jax.lax.all_gather(wsum, AXIS)  # leaves (D, .., W, M)
    fst = jax.tree_util.tree_map(lambda x: x[0], gathered)
    rst = jax.tree_util.tree_map(lambda x: x[1:], gathered)

    def dev_body(a, dev):
        return ec.point_add(a, dev, ops), None

    total, _ = jax.lax.scan(dev_body, fst, rst)
    result = MSM.horner_windows(total, ops, is_g2, window_bits,
                                pvary_axis=AXIS)
    return jax.tree_util.tree_map(lambda x: x[None], result)


def sharded_tree_msm_fn(mesh: Mesh, ops, is_g2: bool):
    """Jitted sharded batch-affine tree MSM over staged AffineTables.

    tx/ty: (C, HALF, 35[, 2], M, S) u16 sharded on C; ident (C, M, S)
    bool sharded on C; scalars (16, M, C*S) u32 sharded on the point
    axis (chunk-major layout makes the two shardings line up).
    C/D local chunks per device; same tree as single-device."""
    from . import msm_tree as MT

    ws_fn = partial(MT.tree_window_sums, pvary_axis=AXIS)

    def body(tx, ty, ident, scalars):
        tabs = MT.AffineTables(tx=tx, ty=ty, ident=ident, n=0,
                               is_g2=is_g2)
        wsum = ws_fn(tabs, scalars, ops)
        return _gather_reduce_horner(wsum, ops, is_g2)

    tab_nd = 6 if is_g2 else 5
    tab_spec = P(AXIS, *([None] * (tab_nd - 1)))
    out_nd = 3 if is_g2 else 2  # result leaves (35[, 2], M)
    out_spec = (P(AXIS, *([None] * out_nd)),) * 3

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(tab_spec, tab_spec, P(AXIS, None, None),
                  P(None, None, AXIS)),
        out_specs=out_spec,
    )

    @jax.jit
    def run(tx, ty, ident, scalars):
        out = fn(tx, ty, ident, scalars)
        return jax.tree_util.tree_map(lambda x: x[0], out)

    return run


# -- sharded R1CS matvec --------------------------------------------------------
# A/B/C sparse rows partitioned by constraint row (SURVEY.md section
# 2.4 row 3): each device owns a contiguous row block [d*m/D, (d+1)*m/D)
# and that block's nnz entries (host-padded to equal length); the
# witness vector is replicated; per-shard segment_sum matvec; outputs
# concatenate along the domain axis (already the NTT's shard layout).


def sharded_matvec_fn(mesh: Mesh, m: int, nnz_shard: int):
    """(16, nv) Mont witness (replicated), per-shard entries
    (coeffs (D, 16, nnz), colidx (D, nnz), rowidx (D, nnz) with
    row indices LOCAL to the shard) -> (16, m) plain-form, sharded."""
    D = mesh.devices.size
    m_loc = m // D

    def body(z_mont, coeffs, colidx, rowidx):
        prod = F.mont_mul(coeffs[0], z_mont[:, colidx[0]], FR)
        sums = jax.ops.segment_sum(
            prod.T, rowidx[0], num_segments=m_loc,
            indices_are_sorted=True,
        ).T  # (16, m_loc) digit sums
        lo = sums & F.MASK
        hi = sums >> F.LIMB_BITS
        wide = jnp.zeros((2 * F.NLIMBS, m_loc), dtype=jnp.uint32)
        wide = wide.at[: F.NLIMBS].add(lo)
        wide = wide.at[1 : F.NLIMBS + 1].add(hi)
        return F.redc_wide(wide, FR)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(None, None), P(AXIS, None, None), P(AXIS, None),
            P(AXIS, None),
        ),
        out_specs=P(None, AXIS),
    )
    return jax.jit(fn)


# -- sharded RNS R1CS matvec --------------------------------------------------
# The RNS port of sharded_matvec_fn: channel products via Montgomery
# RNS, u32 segment sums (row length <= 2^16 guaranteed by the packer),
# channel fold, then one bound-reset mul (engine._matvec_rns_jit).


def sharded_matvec_rns_fn(mesh: Mesh, m: int, nnz_shard: int):
    """(35, nv) Montgomery-RNS witness (replicated), per-shard entries
    (coeffs (D, 35, nnz) Montgomery-RNS, colidx (D, nnz), rowidx
    (D, nnz) local) -> (35, m) Montgomery-RNS, sharded on the domain."""
    from . import rns as RNS

    ctx = RNS.RR
    D = mesh.devices.size
    m_loc = m // D
    m1rep = ctx.ints_to_rns([ctx.m1 % ctx.modulus])[:, 0]

    def body(z_rns, coeffs, colidx, rowidx):
        prod = RNS.mont_mul_rns(coeffs[0], z_rns[:, colidx[0]], ctx)
        sums = jax.ops.segment_sum(
            prod.T, rowidx[0], num_segments=m_loc,
            indices_are_sorted=True,
        ).T  # (35, m_loc) u32 channel sums
        canon = RNS._fold3(sums, ctx.eps[:, None], ctx.p[:, None])
        # bound reset: full mont mul by rep(M1 mod r) divides by M1,
        # bringing the represented integer back under 4N
        return RNS.mont_mul_rns(canon, RNS._b(m1rep, canon), ctx)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(None, None), P(AXIS, None, None), P(AXIS, None),
            P(AXIS, None),
        ),
        out_specs=P(None, AXIS),
    )
    return jax.jit(fn)


# -- sharded four-step NTT ----------------------------------------------------


class ShardedDomain:
    """Tables for the four-step NTT of size n over D devices: n = D * n2.

    Global data layout: contiguous shards of n/D elements per device.
    Matrix view M[j1, j2] = x[j1 + D*j2] (decimation-in-time by D);
    inner NTTs of size n2 run per j1-row (one row per device after an
    all_to_all), the outer size-D NTTs across j1 are computed directly
    as a dense twiddle contraction (D is small)."""

    def __init__(self, size: int, n_devices: int):
        assert size % (n_devices * n_devices) == 0, (
            "four-step layout needs D^2 | n"
        )
        self.size = size
        self.D = n_devices
        self.n2 = size // n_devices
        from ..groth16.domain import Domain

        h = Domain(size)
        self.omega = h.omega
        self.sub = NTT.DeviceDomain(self.n2)  # per-row local domain

        # inter-factor twiddles: w_n^(j1*k2) for the owned row j1 = device
        # index; shape (D, 16, n2) uploaded sharded
        tw = np.empty((n_devices, F.NLIMBS, self.n2), dtype=np.uint32)
        tw_inv = np.empty_like(tw)
        w = self.omega
        winv = pow(w, R - 2, R)
        for j1 in range(n_devices):
            row = [
                FR.to_mont_int(pow(w, j1 * k2, R)) for k2 in range(self.n2)
            ]
            tw[j1] = F.ints_to_limbs(row)
            row_inv = [
                FR.to_mont_int(pow(winv, j1 * k2, R)) for k2 in range(self.n2)
            ]
            tw_inv[j1] = F.ints_to_limbs(row_inv)
        self.tw = tw
        self.tw_inv = tw_inv

        # outer size-D DFT matrices (Montgomery):  W[k1, j1] = w_D^(j1*k1)
        wD = pow(self.omega, self.n2, R)
        wDinv = pow(wD, R - 2, R)
        self.WD = np.array(
            [
                [FR.to_mont_int(pow(wD, (j1 * k1) % n_devices, R))
                 for j1 in range(n_devices)]
                for k1 in range(n_devices)
            ],
            dtype=object,
        )
        self.WDinv = np.array(
            [
                [FR.to_mont_int(pow(wDinv, (j1 * k1) % n_devices, R))
                 for j1 in range(n_devices)]
                for k1 in range(n_devices)
            ],
            dtype=object,
        )
        self.size_inv = FR.to_mont_int(pow(size, R - 2, R))


def _fourstep_local(x_loc, tw_loc, wd_row, sub_table, dd: "ShardedDomain",
                    inverse: bool):
    """Shard-local four-step NTT body (runs under shard_map).

    x_loc:   (16, n2) contiguous shard of the input
    tw_loc:  (1, 16, n2) this device's inter-factor twiddle row
    wd_row:  (1, D, 16) this device's row of the size-D DFT matrix
    returns the contiguous shard of the transform (natural order).
    """
    D, n2 = dd.D, dd.n2
    # step A: contiguous -> decimated-by-D rows (all_to_all).
    # Element t of the local shard is global g = d*n2 + t and belongs to
    # row r = t mod D at column d*(n2/D) + t//D; swapping (q, r) makes
    # each destination's piece contiguous for the same-axis all_to_all.
    x2 = jnp.swapaxes(x_loc.reshape(F.NLIMBS, n2 // D, D), 1, 2)
    row = jax.lax.all_to_all(x2, AXIS, split_axis=1, concat_axis=1)
    row = row.reshape(F.NLIMBS, n2)
    # step B: local size-n2 NTT over the owned row
    row = NTT._ntt_core(row, sub_table, n2)
    # step C: inter-factor twiddle
    row = F.mont_mul(row, tw_loc[0], FR)
    # step D: outer size-D DFT as a dense contraction over gathered rows
    allrows = jax.lax.all_gather(row, AXIS)          # (D, 16, n2)
    allrows = jnp.moveaxis(allrows, 0, 1)            # (16, D, n2)
    w = jnp.transpose(wd_row[0], (1, 0))[..., None]  # (16, D, 1)
    prods = F.mont_mul(allrows, jnp.broadcast_to(w, allrows.shape), FR)
    out = prods[:, 0]
    for j in range(1, D):
        out = F.add_mod(out, prods[:, j], FR)
    if inverse:
        sinv = jnp.asarray(F.int_to_limbs(dd.size_inv))[:, None]
        out = F.mont_mul(out, jnp.broadcast_to(sinv, out.shape), FR)
    return out


def _wd_limbs(mat_obj) -> np.ndarray:
    D = mat_obj.shape[0]
    out = np.empty((D, D, F.NLIMBS), dtype=np.uint32)
    for i in range(D):
        for j in range(D):
            out[i, j] = F.int_to_limbs(int(mat_obj[i, j]))
    return out


def sharded_ntt_fn(mesh: Mesh, dd: ShardedDomain, inverse: bool = False):
    """Jitted sharded NTT: (16, n) sharded on axis 1 -> same sharding.

    Forward maps coefficients to evaluations (natural order), inverse
    maps evaluations back to coefficients."""
    tw = jnp.asarray(dd.tw_inv if inverse else dd.tw)
    wd = jnp.asarray(_wd_limbs(dd.WDinv if inverse else dd.WD))
    table = dd.sub.w_inv if inverse else dd.sub.w_fwd

    def body(x_loc, tw_loc, wd_row):
        return _fourstep_local(x_loc, tw_loc, wd_row, table, dd, inverse)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS, None, None), P(AXIS, None, None)),
        out_specs=P(None, AXIS),
    )

    @jax.jit
    def run(x):
        return fn(x, tw, wd)

    return run


# -- sharded four-step RNS NTT ------------------------------------------------
# The RNS port of ShardedDomain/sharded_ntt_fn: identical data motion
# (all_to_all redistribution, local sub-NTT, inter-factor twiddle,
# all_gather + dense size-D DFT), field ops in Montgomery RNS.  Bounds:
# sub-NTT butterflies grow <= 8N per stage from < 4N; the outer DFT
# sums D fresh mul outputs (< 4N each, <= 32N at D=8) -- inside the
# 512N mont contract.


class ShardedRnsDomain:
    """Four-step tables for size n over D devices, Montgomery RNS."""

    def __init__(self, size: int, n_devices: int):
        assert size % (n_devices * n_devices) == 0, (
            "four-step layout needs D^2 | n"
        )
        from . import ntt_rns as NR
        from ..groth16.domain import Domain

        self.size = size
        self.D = n_devices
        self.n2 = size // n_devices
        h = Domain(size)
        self.omega = h.omega
        sub = Domain(self.n2)
        self.sub_fwd = NR.geom_table(sub.omega, max(self.n2 // 2, 1))
        self.sub_inv = NR.geom_table(
            sub.omega_inv, max(self.n2 // 2, 1)
        )

        from . import rns as RNS

        # inter-factor twiddles w_n^(j1*k2), device j1's row: (D, 35, n2)
        # -- row j1 is the geometric series of w^j1, device-built
        # (host big-int pow per ROW only; see ntt_rns.geom_table)
        tw = np.empty((n_devices, RNS.N_CH, self.n2), dtype=np.uint16)
        tw_inv = np.empty_like(tw)
        w = self.omega
        winv = pow(w, R - 2, R)
        for j1 in range(n_devices):
            tw[j1] = np.asarray(NR.geom_table(pow(w, j1, R), self.n2))
            tw_inv[j1] = np.asarray(
                NR.geom_table(pow(winv, j1, R), self.n2)
            )
        self.tw = tw
        self.tw_inv = tw_inv

        # outer size-D DFT matrices: (D, D, 35) rows per device
        wD = pow(self.omega, self.n2, R)
        wDinv = pow(wD, R - 2, R)

        def dft(base):
            out = np.empty(
                (n_devices, n_devices, RNS.N_CH), dtype=np.uint16
            )
            for k1 in range(n_devices):
                out[k1] = NR._mont_table(
                    [pow(base, (j1 * k1) % n_devices, R)
                     for j1 in range(n_devices)]
                ).T
            return out

        self.WD = dft(wD)
        self.WDinv = dft(wDinv)
        self.size_inv = jnp.asarray(
            NR._mont_table([pow(size, R - 2, R)])
        )


def _fourstep_local_rns(x_loc, tw_loc, wd_row, sub_table,
                        dd: "ShardedRnsDomain", inverse: bool):
    """Shard-local four-step RNS NTT body (under shard_map).

    x_loc:  (35, n2) contiguous shard
    tw_loc: (1, 35, n2) this device's inter-factor twiddle row
    wd_row: (1, D, 35) this device's row of the size-D DFT matrix
    """
    from . import ntt_rns as NR, rns as RNS

    ctx = RNS.RR
    D, n2 = dd.D, dd.n2
    # step A: contiguous -> decimated-by-D rows (all_to_all)
    x2 = jnp.swapaxes(x_loc.reshape(RNS.N_CH, n2 // D, D), 1, 2)
    row = jax.lax.all_to_all(x2, AXIS, split_axis=1, concat_axis=1)
    row = row.reshape(RNS.N_CH, n2)
    # step B: local size-n2 NTT over the owned row
    row = NR._ntt_core(row, sub_table, n2)
    # step C: inter-factor twiddle (bound reset to < 4N)
    row = RNS.mont_mul_rns(row, tw_loc[0], ctx)
    # step D: outer size-D DFT over gathered rows
    allrows = jax.lax.all_gather(row, AXIS)            # (D, 35, n2)
    w = jnp.transpose(wd_row[0], (1, 0))[:, :, None]   # (35, D, 1)
    prods = RNS.mont_mul_rns(
        jnp.moveaxis(allrows, 0, 1),                   # (35, D, n2)
        jnp.broadcast_to(w, (RNS.N_CH, D, n2)), ctx,
    )
    out = prods[:, 0]
    for j in range(1, D):
        out = RNS.ch_add(out, prods[:, j], ctx)
    if inverse:
        out = RNS.mont_mul_rns(
            out, jnp.broadcast_to(dd.size_inv, out.shape), ctx
        )
    return out


def sharded_ntt_rns_fn(mesh: Mesh, dd: "ShardedRnsDomain",
                       inverse: bool = False, gput=None):
    """Jitted sharded RNS NTT: (35, n) sharded on axis 1 -> same.

    gput(arr, spec): optional placement hook for the twiddle tables
    (multi-host runs must build them as global arrays)."""
    if gput is None:
        gput = lambda a, spec: jnp.asarray(a)  # noqa: E731
    tw = gput(dd.tw_inv if inverse else dd.tw, P(AXIS, None, None))
    wd = gput(dd.WDinv if inverse else dd.WD, P(AXIS, None, None))
    table = dd.sub_inv if inverse else dd.sub_fwd

    def body(x_loc, tw_loc, wd_row):
        return _fourstep_local_rns(x_loc, tw_loc, wd_row, table, dd,
                                   inverse)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS, None, None), P(AXIS, None, None)),
        out_specs=P(None, AXIS),
    )

    # tables go in as ARGUMENTS: a multi-host global array cannot be
    # closed over inside jit (spans non-addressable devices)
    run = jax.jit(lambda x, tw_, wd_: fn(x, tw_, wd_))
    return lambda x: run(x, tw, wd)
