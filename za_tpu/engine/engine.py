"""TpuEngine: the prover-facing compute facade.

Implements the HostEngine interface (msm_g1 / msm_g2 / h_coeffs) on
JAX devices: witness R1CS evaluation as a segment-sum sparse matvec,
the QAP quotient via device coset NTT, and Pippenger MSMs. Pure-jnp
kernels run identically on the CPU backend (tests: 8 virtual devices)
and the GPU; jitted callables are cached per shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..curve import G1Point, G2Point, R
from ..groth16.domain import Domain
from ..groth16.r1cs import R1CS
from . import ec, field as F, msm as MSM, ntt as NTT
from .field import FR
from .profile import BackendProfile, resolve_profile


import logging as _logging
import os as _os
import time as _time

_metrics_log = _logging.getLogger("za_tpu.metrics")


class _StageTimer:
    """Per-stage device timing, enabled with ZA_METRICS=1 (or -v CLI).

    done() blocks until the stage's result is ready, so enabling
    metrics serializes the stages (off by default)."""

    enabled = _os.environ.get("ZA_METRICS", "0") != "0"

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if self.enabled:
            self.t0 = _time.monotonic()
        return self

    def done(self, result=None):
        """Wait for the result and log; returns the result unchanged."""
        if self.enabled and result is not None:
            jax.block_until_ready(result)
        return result

    def __exit__(self, *exc):
        if self.enabled:
            _metrics_log.info(
                "[stage] %s: %.3fs", self.name,
                _time.monotonic() - self.t0,
            )


def _pad_pow2ish(n: int, align: int = 8) -> int:
    """Round up to the next power of two: MSM shapes collapse onto a
    handful of sizes so the a/b1/l/h queries share compiled kernels."""
    size = align
    while size < n:
        size <<= 1
    return size


_to_mont_fr_jit = None


def _to_mont_fr(arr):
    """(16, n) plain Fr limbs -> Montgomery form on device."""
    global _to_mont_fr_jit
    if _to_mont_fr_jit is None:
        _to_mont_fr_jit = jax.jit(lambda a: F.to_mont(a, FR))
    return _to_mont_fr_jit(jnp.asarray(arr))


def _enable_compilation_cache():
    """Persist XLA compilations across processes (kernels are reused
    per pk shape; first-compile cost is paid once per machine).

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is set here; otherwise the cache lives in ``.jax_cache``
    at the root of the checkout."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    root = _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)
    )))
    jax.config.update(
        "jax_compilation_cache_dir", _os.path.join(root, ".jax_cache")
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


class TpuEngine:
    """Stateless facade; caches jitted kernels and device domains.

    Every per-platform choice (MSM formulation, tree MSM, NTT layout)
    comes from one BackendProfile resolved here from
    ``jax.default_backend()`` (engine/profile.py); explicit arguments
    override the profile's MSM choices.  lanes/window default to
    throughput-oriented auto sizing."""

    def __init__(self, lanes: int | None = None, window: int | None = None,
                 reduce_style: str | None = None,
                 msm_style: str | None = None,
                 mesh_devices: int | None = None,
                 profile: BackendProfile | None = None):
        _enable_compilation_cache()
        if profile is None:
            profile = resolve_profile(jax.default_backend())
        self.profile = profile
        dev = jax.devices()[0]
        _logging.getLogger("za_tpu").info(
            "engine: platform=%s device_kind=%s devices=%d profile=%s",
            dev.platform, dev.device_kind, len(jax.devices()), profile,
        )
        self.lanes = lanes
        self.window = window
        # multi-device: shard MSM point streams, R1CS matvec rows, and
        # the NTT domain over a 1-D device mesh (SURVEY.md section
        # 2.4). mesh_devices=N uses the first N visible devices;
        # requires msm_style "rns".
        self.mesh = None
        self._mesh_d = 1
        if mesh_devices is not None and mesh_devices > 1:
            from . import mesh as MESH

            self.mesh = MESH.make_mesh(mesh_devices)
            self._mesh_d = mesh_devices
            if msm_style is None:
                msm_style = "rns"
            elif msm_style != "rns":
                raise ValueError(
                    "mesh_devices>1 requires msm_style='rns': only the "
                    "RNS MSM has a sharded path (other styles would "
                    "silently run single-device MSMs)"
                )
        self.reduce_style = reduce_style or "scan"
        self.layout = "limb"
        # 'rns' = signed radix-16 dense MSM (or the batch-affine tree)
        # over the RNS field engine (engine/rns.py); 'dense' =
        # scatter-free radix-4 limb select + tree reduce; 'grouped' =
        # limb bucket accumulation (optimal work count)
        self.msm_style = msm_style or profile.msm_style
        # batched multi-MSM dispatch: required by the rns/mesh paths
        # (msm_g1_many is their only entry); CPU limb tests keep the
        # per-window scan path (graph size)
        self.use_grouped = self.msm_style == "rns" or self.mesh is not None
        # batch-affine tree MSM (engine/msm_tree): ~6 Montgomery muls
        # per point-add vs 14 for the complete projective adds of the
        # signed-dense MSM, for queries of at least _tree_min points
        self.msm_tree = (
            self.msm_style == "rns"
            and profile.msm_tree
            and _os.environ.get("ZA_MSM_TREE", "1") != "0"
        )
        # tree sizes (_tree_min, _tree_chunk, ZA_SCATTER_MIN): not
        # measured on the H100, where the tree is off
        self._tree_min = int(_os.environ.get("ZA_TREE_MIN", str(1 << 15)))
        # resolved ONCE here (not at staging time) so toggling the env
        # var between proves cannot silently reuse stale staged tables
        # of the other layout -- the flag is part of stage_params' key
        self._tree_g2 = _os.environ.get("ZA_TREE_G2", "1") != "0"
        self._domains: dict[int, NTT.DeviceDomain] = {}
        self._jit_cache: dict = {}

    def _tree_chunk(self, n: int) -> int:
        """Column-chunk size for batch-affine tree staging.  ZA_TREE_CHUNK
        pins it; otherwise 2^15, and 2^14 from 2^19 points on, where the
        G2 tables' per-chunk staging transients grow with the chunk."""
        env = _os.environ.get("ZA_TREE_CHUNK")
        if env:
            return int(env)
        return 1 << 14 if n >= (1 << 19) else 1 << 15

    # -- MSM -----------------------------------------------------------------

    def _msm_params(self, n: int, is_g2: bool) -> tuple[int, int]:
        c, lanes = MSM.auto_params(n, is_g2=is_g2)
        if self.window is not None:
            c = self.window
        if self.lanes is not None:
            lanes = self.lanes
        return c, lanes

    def _msm_jit(self, kind: str, n: int, c: int, lanes: int):
        key = (kind, n, c, lanes, self.reduce_style)
        if key not in self._jit_cache:
            ops = ec.G1_OPS if kind == "g1" else ec.G2_OPS

            def run(points, scalars):
                return MSM.msm_limbs(
                    points, scalars, ops, c=c, lanes=lanes,
                    reduce_style=self.reduce_style, layout=self.layout,
                )

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def msm_g1(self, points: list[G1Point], scalars) -> G1Point:
        if self.use_grouped:
            return self.msm_g1_many([points], [scalars])[0]
        n = _pad_pow2ish(len(points))
        pts = list(points) + [None] * (n - len(points))
        dev_pts = ec.g1_points_to_device(pts)
        dev_scs = self._scalars_limbs(scalars, n)
        c, lanes = self._msm_params(n, is_g2=False)
        X, Y, Z = self._msm_jit("g1", n, c, lanes)(dev_pts, dev_scs)
        return ec.g1_point_from_device(X, Y, Z)

    def msm_g2(self, points: list[G2Point], scalars) -> G2Point:
        if self.use_grouped:
            return self.msm_g2_many([points], [scalars])[0]
        n = _pad_pow2ish(len(points))
        pts = list(points) + [None] * (n - len(points))
        dev_pts = ec.g2_points_to_device(pts)
        dev_scs = self._scalars_limbs(scalars, n)
        c, lanes = self._msm_params(n, is_g2=True)
        X, Y, Z = self._msm_jit("g2", n, c, lanes)(dev_pts, dev_scs)
        return ec.g2_point_from_device(X, Y, Z)

    # -- grouped same-shape MSMs (window-parallel) -----------------------------

    def stage_g1(self, points: list[G1Point]):
        """Host points -> device arrays once (pk staging, in the
        engine's MSM representation); the result can be passed to
        msm_g1_many in place of a point list."""
        if self.msm_style == "rns":
            return ec.g1_points_to_rns(points)
        return ec.g1_points_to_device(points)

    def stage_g2(self, points: list[G2Point]):
        if self.msm_style == "rns":
            return ec.g2_points_to_rns(points)
        return ec.g2_points_to_device(points)

    @staticmethod
    def _g1_limb_coords(q, n_pad: int):
        """Query (point list or format.RawG1Query) -> (x, y, z) numpy
        (16, n_pad) u32 limb arrays, identity-padded."""
        if hasattr(q, "x"):  # RawG1Query
            k = len(q)
            if k == n_pad:
                return q.x, q.y, q.z
            out = []
            for name, a in (("x", q.x), ("y", q.y), ("z", q.z)):
                b = np.zeros((F.NLIMBS, n_pad), np.uint32)
                b[:, :k] = a
                if name == "y":
                    b[0, k:] = 1
                out.append(b)
            return tuple(out)
        pts = list(q) + [None] * (n_pad - len(q))
        xs = [0 if p is None else p[0] for p in pts]
        ys = [1 if p is None else p[1] for p in pts]
        zs = [0 if p is None else 1 for p in pts]
        return tuple(F.ints_to_limbs(v) for v in (xs, ys, zs))

    @staticmethod
    def _g2_limb_coords(q, n_pad: int):
        """-> (x0, x1, y0, y1, z0, z1) numpy (16, n_pad) u32."""
        if hasattr(q, "x0"):  # RawG2Query
            k = len(q)
            arrs = [q.x0, q.x1, q.y0, q.y1, q.z0,
                    np.zeros((F.NLIMBS, k), np.uint32)]
            if k == n_pad:
                return tuple(arrs)
            out = []
            for i, a in enumerate(arrs):
                b = np.zeros((F.NLIMBS, n_pad), np.uint32)
                b[:, :k] = a
                if i == 2:  # y0 identity
                    b[0, k:] = 1
                out.append(b)
            return tuple(out)
        pts = list(q) + [None] * (n_pad - len(q))
        x0 = [0 if p is None else p[0].c0 for p in pts]
        x1 = [0 if p is None else p[0].c1 for p in pts]
        y0 = [1 if p is None else p[1].c0 for p in pts]
        y1 = [0 if p is None else p[1].c1 for p in pts]
        z0 = [0 if p is None else 1 for p in pts]
        z1 = [0] * len(pts)
        return tuple(
            F.ints_to_limbs(v) for v in (x0, x1, y0, y1, z0, z1)
        )

    def stage_g1_stacked(self, queries, curve_check: bool = False,
                         n_pad: int | None = None):
        """M G1 queries (point lists or RawG1Query limb arrays, padded
        to the longest) -> ONE stacked device tree with leaves
        (35, M, n) (rns) / (16, M, n) (limb) in the grouped-MSM layout:
        msm_g1_many consumes it with zero per-call staging.

        curve_check=True runs the batched on-device curve-membership
        check (the raw pk parse skips per-point host checks)."""
        n = n_pad or max(len(q) for q in queries)
        M = len(queries)
        coords = [self._g1_limb_coords(q, n) for q in queries]
        big = [
            np.concatenate([c[i] for c in coords], axis=1)
            for i in range(3)
        ]  # (16, M*n) each
        if self.msm_style == "rns":
            from . import rns as RNS

            staged = tuple(
                ec._limbs_to_rns_mont(b, RNS.RQ) for b in big
            )
        else:
            staged = tuple(ec._to_mont_dev(jnp.asarray(b)) for b in big)
        staged = jax.tree_util.tree_map(
            lambda x: x.reshape(x.shape[:-1] + (M, n)), staged
        )
        if curve_check:
            self._assert_g1_on_curve(staged)
        return self._globalize_stacked(staged)

    def stage_g2_stacked(self, queries, curve_check: bool = False,
                         n_pad: int | None = None):
        n = n_pad or max(len(q) for q in queries)
        M = len(queries)
        coords = [self._g2_limb_coords(q, n) for q in queries]
        pairs = []
        for i in (0, 2, 4):  # (c0, c1) per coordinate
            c0 = np.concatenate([c[i] for c in coords], axis=1)
            c1 = np.concatenate([c[i + 1] for c in coords], axis=1)
            pairs.append((c0, c1))
        if self.msm_style == "rns":
            from . import rns as RNS

            def cv(c0, c1):
                both = ec._limbs_to_rns_mont(
                    np.concatenate([c0, c1], axis=1), RNS.RQ
                )
                k = c0.shape[1]
                return jnp.stack([both[:, :k], both[:, k:]], axis=1)

            staged = tuple(cv(c0, c1) for c0, c1 in pairs)
            staged = jax.tree_util.tree_map(
                lambda x: x.reshape(x.shape[:-1] + (M, n)), staged
            )
        else:
            staged = tuple(
                (ec._to_mont_dev(jnp.asarray(c0)),
                 ec._to_mont_dev(jnp.asarray(c1)))
                for c0, c1 in pairs
            )
            staged = jax.tree_util.tree_map(
                lambda x: x.reshape(x.shape[:-1] + (M, n)), staged
            )
        if curve_check:
            self._assert_g2_on_curve(staged)
        return self._globalize_stacked(staged)

    def _globalize_stacked(self, staged):
        """Multi-process: re-place stacked query trees as global
        arrays sharded on the point axis (the dense mesh MSM's
        in_spec); single-process/no-mesh: pass through."""
        if not self._multiproc():
            return staged
        from jax.sharding import PartitionSpec as P

        from . import mesh as MESH

        def put(a):
            spec = P(*([None] * (a.ndim - 1)), MESH.AXIS)
            return self._gput(np.asarray(a), spec)

        return jax.tree_util.tree_map(put, staged)

    # -- batch-affine tree staging (engine/msm_tree) -----------------

    def _chunked_scatter_jit(self, shapes, k: int):
        """In-place chunked-table assembly for the memory-lean path:
        all three (C, ...) destinations are DONATED and updated in ONE
        dispatch per block; each block rechunks to (k, ..., S) and
        lands with a dynamic_update_slice -- no whole-table
        concatenate/moveaxis transients (the G2 staging at 2^20 ran
        out of device memory on exactly those)."""
        key = ("scatter", shapes, k)
        fn = self._jit_cache.get(key)
        if fn is None:
            S = shapes[0][-1]

            def upd(big, blk):
                r = blk.reshape(blk.shape[:-1] + (k, S))
                r = jnp.moveaxis(r, -2, 0)
                idx_len = len(big.shape)
                return lambda c0: jax.lax.dynamic_update_slice(
                    big, r, (c0,) + (0,) * (idx_len - 1)
                )

            def fn_(btx, bty, bid, ax, ay, ident, c0):
                return (
                    upd(btx, ax)(c0),
                    upd(bty, ay)(c0),
                    upd(bid, ident)(c0),
                )

            fn = jax.jit(fn_, donate_argnums=(0, 1, 2))
            self._jit_cache[key] = fn
        return fn

    def _assemble_tables(self, build_blocks, C: int, S: int, M: int,
                         n: int, is_g2: bool, block: int):
        """Drive block-wise table builds into a preallocated chunked
        device layout (see _chunked_scatter_jit)."""
        from . import msm_tree as MT, rns as RNS

        ch = (RNS.N_CH, 2) if is_g2 else (RNS.N_CH,)
        total = C * S
        if self._multiproc():
            # multi-host: blocks build on local devices, assemble in
            # HOST memory, upload once as a global sharded array
            htx = np.zeros((C, MT.HALF) + ch + (M, S), np.uint16)
            hty = np.zeros_like(htx)
            hid = np.zeros((C, M, S), bool)

            def host_scatter(dst, blk, lo, k):
                r = np.asarray(blk)
                r = np.moveaxis(
                    r.reshape(r.shape[:-1] + (k, S)), -2, 0
                )
                dst[lo // S : lo // S + k] = r

            for lo in range(0, total, block):
                hi = min(lo + block, total)
                k = (hi - lo) // S
                ax, ay, ident = build_blocks(lo, hi)
                host_scatter(htx, ax, lo, k)
                host_scatter(hty, ay, lo, k)
                host_scatter(hid, ident, lo, k)
            return self._shard_tables(MT.AffineTables(
                tx=htx, ty=hty, ident=hid, n=n, is_g2=is_g2,
            ))
        # two single-process assembly strategies:
        #  * concat (default): collect block tables, one fused
        #    concat+rechunk -- fastest, but transiently holds ~3x the
        #    table bytes in device memory
        #  * donated scatter: preallocate the (C, ...) tables and land
        #    each block with an in-place dynamic_update_slice --
        #    transient = one block; used above ZA_SCATTER_MIN bytes of
        #    tables, at one dispatch per block
        nbytes = 2 * (C * S) * MT.HALF * int(np.prod(ch)) * M * 2
        scatter_min = int(
            _os.environ.get("ZA_SCATTER_MIN", str(1 << 30))
        )
        lean = is_g2 and nbytes > scatter_min
        if not lean:
            xs, ys, ids = [], [], []
            for lo in range(0, total, block):
                hi = min(lo + block, total)
                ax, ay, ident = build_blocks(lo, hi)
                xs.append(ax)
                ys.append(ay)
                ids.append(ident)
            return self._shard_tables(
                MT.chunkify_tables(xs, ys, ids, C, S, n, is_g2)
            )
        u16 = jnp.uint16
        big_tx = jnp.zeros((C, MT.HALF) + ch + (M, S), dtype=u16)
        big_ty = jnp.zeros_like(big_tx)
        big_id = jnp.zeros((C, M, S), dtype=jnp.bool_)
        shapes = (big_tx.shape, big_ty.shape, big_id.shape)
        for lo in range(0, total, block):
            hi = min(lo + block, total)
            k = (hi - lo) // S
            ax, ay, ident = build_blocks(lo, hi)
            sc = self._chunked_scatter_jit(shapes, k)
            big_tx, big_ty, big_id = sc(
                big_tx, big_ty, big_id, ax, ay, ident,
                jnp.int32(lo // S),
            )
        return self._shard_tables(MT.AffineTables(
            tx=big_tx, ty=big_ty, ident=big_id, n=n, is_g2=is_g2,
        ))

    def stage_g1_affine(self, queries, n_pad: int | None = None,
                        curve_check: bool = False,
                        chunk: int | None = None,
                        block: int = 1 << 16):
        """M G1 queries -> chunked u16 affine {1P..8P} tables for the
        batch-affine tree MSM.  Staged block-wise so the projective
        form never materializes whole (1120 B/point resident)."""
        from . import msm_tree as MT, rns as RNS

        n = n_pad or max(len(q) for q in queries)
        S = min(chunk or self._tree_chunk(n), _pad_pow2ish(n))
        C = -(-n // S)
        if self._mesh_d > 1:  # chunk axis shards across the mesh
            C = -(-C // self._mesh_d) * self._mesh_d
        total = C * S
        coords = [self._g1_limb_coords(q, total) for q in queries]
        M = len(queries)
        if block % S:
            block = S * max(block // S, 1)

        def build(lo, hi):
            big = [
                np.concatenate([c[i][:, lo:hi] for c in coords], axis=1)
                for i in range(3)
            ]
            staged = tuple(
                ec._limbs_to_rns_mont(b, RNS.RQ).reshape(
                    RNS.N_CH, M, hi - lo
                )
                for b in big
            )
            if curve_check:
                self._assert_g1_on_curve(staged)
            return MT.build_tables_block(staged, is_g2=False)

        return self._assemble_tables(build, C, S, M, n, is_g2=False,
                                     block=block)

    def stage_g2_affine(self, queries, n_pad: int | None = None,
                        curve_check: bool = False,
                        chunk: int | None = None,
                        block: int = 1 << 15):
        from . import msm_tree as MT, rns as RNS

        n = n_pad or max(len(q) for q in queries)
        S = min(chunk or self._tree_chunk(n), _pad_pow2ish(n))
        C = -(-n // S)
        if self._mesh_d > 1:
            C = -(-C // self._mesh_d) * self._mesh_d
        total = C * S
        coords = [self._g2_limb_coords(q, total) for q in queries]
        M = len(queries)
        if block % S:
            block = S * max(block // S, 1)

        def build(lo, hi):
            blk = hi - lo

            def cv(i):
                c0 = np.concatenate(
                    [c[i][:, lo:hi] for c in coords], axis=1
                )
                c1 = np.concatenate(
                    [c[i + 1][:, lo:hi] for c in coords], axis=1
                )
                both = ec._limbs_to_rns_mont(
                    np.concatenate([c0, c1], axis=1), RNS.RQ
                )
                k = M * blk
                pair = jnp.stack([both[:, :k], both[:, k:]], axis=1)
                return pair.reshape(RNS.N_CH, 2, M, blk)

            staged = tuple(cv(i) for i in (0, 2, 4))
            if curve_check:
                self._assert_g2_on_curve(staged)
            return MT.build_tables_block(staged, is_g2=True)

        return self._assemble_tables(build, C, S, M, n, is_g2=True,
                                     block=block)

    def _multiproc(self) -> bool:
        """True when this engine runs under jax.distributed with >1
        process: every host->device upload that feeds a sharded jit
        must then build a GLOBAL array (each process contributes the
        shards its local devices own)."""
        return self.mesh is not None and jax.process_count() > 1

    def _gput(self, arr, spec):
        """Host array -> device array placed per `spec` over the mesh:
        device_put single-process, global-array assembly multi-process
        (engine/dist.py, the DCN path)."""
        from jax.sharding import NamedSharding

        if self.mesh is None:
            return jnp.asarray(arr)
        if not self._multiproc():
            return jax.device_put(
                jnp.asarray(arr), NamedSharding(self.mesh, spec)
            )
        from . import dist as DIST

        return DIST.host_to_global(self.mesh, np.asarray(arr), spec)

    def _shard_tables(self, tabs):
        """Place chunked affine tables with the chunk axis sharded
        over the mesh (no-op single-device)."""
        if self.mesh is None:
            return tabs
        from dataclasses import replace

        from jax.sharding import PartitionSpec as P

        from . import mesh as MESH

        def put(a):
            spec = P(MESH.AXIS, *([None] * (a.ndim - 1)))
            if self._multiproc():
                a = np.asarray(a)  # local build -> global assembly
            return self._gput(a, spec)

        return replace(tabs, tx=put(tabs.tx), ty=put(tabs.ty),
                       ident=put(tabs.ident))

    def _tree_jit(self, kind: str, C: int, S: int, M: int):
        key = ("tree", kind, C, S, M, self._mesh_d)
        if key not in self._jit_cache:
            from . import msm_tree as MT

            is_g2 = kind == "g2"
            ops = (
                ec.make_g2_ops_rns() if is_g2 else ec.make_g1_ops_rns()
            )
            if self.mesh is not None:
                from . import mesh as MESH

                self._jit_cache[key] = MESH.sharded_tree_msm_fn(
                    self.mesh, ops, is_g2
                )
                return self._jit_cache[key]

            def run(tx, ty, ident, scalars):
                tabs = MT.AffineTables(
                    tx=tx, ty=ty, ident=ident, n=0, is_g2=is_g2
                )
                return MT.msm_affine_tree(tabs, scalars, ops)

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _msm_many_tree(self, kind: str, tabs, scalars_list):
        """Grouped MSM over staged affine tables: scalar upload +
        one jitted tree-MSM dispatch."""
        C, S, M = tabs.chunks, tabs.chunk_cols, tabs.m
        n_pad = C * S
        assert len(scalars_list) == M, "one scalar vector per query"
        with _StageTimer(f"msm.{kind}.scalars") as st:
            dev_map: dict = {}
            devs = []
            for s in scalars_list:
                if isinstance(s, jnp.ndarray):
                    devs.append(s)
                    continue
                k = id(s)
                if k not in dev_map:
                    dev_map[k] = self.witness_limbs_dev(s)
                devs.append(dev_map[k])
            shapes = tuple(a.shape for a in devs)
            key = ("padstack", shapes, n_pad)
            fn = self._jit_cache.get(key)
            if fn is None:

                def fn_(*arrs):
                    padded = [
                        jnp.pad(a, ((0, 0), (0, n_pad - a.shape[1])))
                        for a in arrs
                    ]
                    return jnp.stack(padded, axis=1)

                fn = jax.jit(fn_)
                self._jit_cache[key] = fn
            scalars = st.done(fn(*devs))
        with _StageTimer(f"msm.{kind}.tree[C={C},S={S},M={M}]") as st:
            X, Y, Z = st.done(
                self._tree_jit(kind, C, S, M)(
                    tabs.tx, tabs.ty, tabs.ident, scalars
                )
            )
        return self._msm_unstage(kind, X, Y, Z, M)

    # -- batched device curve-membership checks (checked deser at
    #    array speed; the Raw*Query pk parse defers to these) ---------

    def _assert_g1_on_curve(self, staged):
        from . import rns as RNS

        if self.msm_style != "rns":
            return  # limb staging comes from host-parsed (checked) points
        ctx = RNS.RQ
        fn = self._jit_cache.get(("curve_check", "g1"))
        if fn is None:

            def fn_(X, Y, Z):
                y2z = RNS.mont_mul_rns(
                    RNS.mont_mul_rns(Y, Y, ctx), Z, ctx
                )
                x3 = RNS.mont_mul_rns(
                    RNS.mont_mul_rns(X, X, ctx), X, ctx
                )
                z3 = RNS.mont_mul_rns(
                    RNS.mont_mul_rns(Z, Z, ctx), Z, ctx
                )
                z3_3 = RNS.ch_add(RNS.ch_add(z3, z3, ctx), z3, ctx)
                rhs = RNS.ch_add(x3, z3_3, ctx)          # < 16N
                d = RNS.ch_sub_off(y2z, rhs, ctx)        # == 0 mod q
                plain = RNS.from_mont_rns(d, ctx)
                limbs = RNS.rns_to_limbs_exact(
                    plain, ctx, nlimbs=16, reduce_mod=ctx.modulus
                )
                return jnp.all(limbs == 0)

            fn = jax.jit(fn_)
            self._jit_cache[("curve_check", "g1")] = fn
        if not bool(fn(*staged)):
            from ..groth16.format import FormatError

            raise FormatError("pk g1 query point not on curve")

    def _assert_g2_on_curve(self, staged):
        from . import rns as RNS
        from ..curve import B2, Q as QMOD

        if self.msm_style != "rns":
            return
        ctx = RNS.RQ
        fn = self._jit_cache.get(("curve_check", "g2"))
        if fn is None:
            ops = ec.make_g2_ops_rns()
            b2c = np.stack(
                [
                    ctx.ints_to_rns([ctx.to_mont_int(B2.c0 % QMOD)])[:, 0],
                    ctx.ints_to_rns([ctx.to_mont_int(B2.c1 % QMOD)])[:, 0],
                ],
                axis=1,
            )  # (35, 2)

            def fn_(X, Y, Z):
                y2z = ops.mul(ops.mul(Y, Y), Z)
                x3 = ops.mul(ops.mul(X, X), X)
                z3 = ops.mul(ops.mul(Z, Z), Z)
                shape = (RNS.N_CH, 2) + (1,) * (X.ndim - 2)
                bz3 = ops.mul(
                    z3, jnp.broadcast_to(
                        jnp.asarray(b2c).reshape(shape), z3.shape
                    ),
                )
                rhs = RNS.ch_add(x3, bz3, ctx)
                d = RNS.ch_sub_off(y2z, rhs, ctx)
                plain = RNS.from_mont_rns(d, ctx)
                limbs = RNS.rns_to_limbs_exact(
                    plain, ctx, nlimbs=16, reduce_mod=ctx.modulus
                )
                return jnp.all(limbs == 0)

            fn = jax.jit(fn_)
            self._jit_cache[("curve_check", "g2")] = fn
        if not bool(fn(*staged)):
            from ..groth16.format import FormatError

            raise FormatError("pk g2 query point not on curve")

    # -- device-layout pk disk cache ----------------------------------
    # The staged affine tables cost ~40-60 s of XLA table-building per
    # process (SURVEY.md section 5 checkpoint row: "limb-packed
    # device-layout cache").  stage_params persists them next to the
    # pk (<pk>.devcache, hooked up by helper.prove) keyed by pk digest
    # + layout metadata; later processes upload the saved bytes
    # instead of rebuilding.

    DEVCACHE_VERSION = 1

    def _devcache_meta(self) -> dict:
        import os as _os

        return {
            "version": self.DEVCACHE_VERSION,
            "msm_style": self.msm_style,
            "mesh_d": self._mesh_d,
            "tree_g2": self._tree_g2,
            "tree_min": self._tree_min,
            "chunk": _os.environ.get("ZA_TREE_CHUNK") or "auto-v2",
        }

    def _load_devcache(self, path: str, digest: str):
        """<pk>.devcache is a DIRECTORY of raw .npy files + meta.json:
        memory-mapped loads skip the zip extract/CRC pass an .npz
        would pay (the upload is h2d-bandwidth-bound; this removes
        the host-side copy)."""
        import json
        import os as _os

        from . import msm_tree as MT

        meta_path = _os.path.join(path, "meta.json")
        if not _os.path.exists(meta_path):
            return None
        try:
            with open(meta_path, "r", encoding="utf-8") as f:
                meta = json.load(f)
            want = dict(self._devcache_meta(), digest=digest)
            ns = meta.pop("n", None)
            if meta != want or ns is None:
                return None

            def ld(name):
                return np.load(
                    _os.path.join(path, name + ".npy"),
                    mmap_mode="r", allow_pickle=False,
                )

            staged = {}
            for name in ("g1abl", "g1h"):
                staged[name] = self._shard_tables(MT.AffineTables(
                    tx=jnp.asarray(ld(f"{name}_tx")),
                    ty=jnp.asarray(ld(f"{name}_ty")),
                    ident=jnp.asarray(ld(f"{name}_id")),
                    n=int(ns[name]), is_g2=False,
                ))
            if _os.path.exists(_os.path.join(path, "b_g2x_tx.npy")):
                staged["b_g2x"] = self._shard_tables(MT.AffineTables(
                    tx=jnp.asarray(ld("b_g2x_tx")),
                    ty=jnp.asarray(ld("b_g2x_ty")),
                    ident=jnp.asarray(ld("b_g2x_id")),
                    n=int(ns["b_g2x"]), is_g2=True,
                ))
            else:  # dense-staged G2 (small query / ZA_TREE_G2=0)
                staged["b_g2x"] = tuple(
                    jnp.asarray(ld(f"b_g2x_{i}")) for i in range(3)
                )
            return staged
        except Exception as exc:  # noqa: BLE001 -- cache is best-effort
            _metrics_log.info("devcache load failed (%s); restaging", exc)
            return None

    def _save_devcache(self, path: str, digest: str, staged) -> None:
        import json
        import os as _os
        import shutil

        from . import msm_tree as MT

        try:
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            _os.makedirs(tmp, exist_ok=True)

            def sv(name, a):
                np.save(_os.path.join(tmp, name + ".npy"),
                        np.asarray(a), allow_pickle=False)

            ns = {}
            for name in ("g1abl", "g1h"):
                t = staged[name]
                sv(f"{name}_tx", t.tx)
                sv(f"{name}_ty", t.ty)
                sv(f"{name}_id", t.ident)
                ns[name] = int(t.n)
            b2 = staged["b_g2x"]
            if isinstance(b2, MT.AffineTables):
                sv("b_g2x_tx", b2.tx)
                sv("b_g2x_ty", b2.ty)
                sv("b_g2x_id", b2.ident)
                ns["b_g2x"] = int(b2.n)
            else:
                for i, a in enumerate(b2):
                    sv(f"b_g2x_{i}", a)
            meta = dict(self._devcache_meta(), digest=digest, n=ns)
            with open(_os.path.join(tmp, "meta.json"), "w",
                      encoding="utf-8") as f:
                json.dump(meta, f, sort_keys=True)
            if _os.path.isfile(path):  # pre-directory-format cache
                _os.unlink(path)
            shutil.rmtree(path, ignore_errors=True)
            _os.replace(tmp, path)
        except Exception as exc:  # noqa: BLE001
            _metrics_log.info("devcache save failed: %s", exc)

    def stage_params(self, params, r1cs):
        """Stage the pk query vectors (a / b_g1 / l / h / b_g2) onto the
        device ONCE per process, cached on the params object: repeat
        proves against the same pk skip every host->device conversion
        (the reference reloads the pk per prove, helper.rs:92-98; a
        deployed prover holds it in HBM).

        The four G1 queries are padded to one power-of-two length and
        staged as a single pre-stacked (35, 4, n) tree, so every prove
        dispatches the grouped MSM kernel directly on resident HBM."""
        key = (self.msm_style, self._mesh_d, self.msm_tree,
               self._tree_g2, self._tree_min)
        cached = getattr(params, "_staged_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        from ..groth16.setup import expand_queries

        params = expand_queries(params, r1cs)
        n_common = _pad_pow2ish(
            max(len(params.a), len(params.b_g1), len(params.l),
                len(params.h))
        )

        def padded(q):
            return list(q) + [None] * (n_common - len(q))

        def padded_q(q):
            if hasattr(q, "expand"):  # Raw*Query: padding in staging
                return q
            return padded(q)

        # raw-parsed queries skipped the per-point host curve check;
        # run the batched device check instead (checked-deser parity)
        raw = hasattr(params.a, "x") or hasattr(params.b_g2, "x0")
        n2 = _pad_pow2ish(len(params.b_g2))
        b2q = params.b_g2
        if not hasattr(b2q, "expand"):
            b2q = list(b2q) + [None] * (n2 - len(b2q))
        n_abl = _pad_pow2ish(
            max(len(params.a), len(params.b_g1), len(params.l))
        )
        if self.msm_tree and n_abl >= self._tree_min:
            # batch-affine tree staging: a/b_g1/l share one table
            # group at their own size; h (the ~2x-longer domain
            # query) gets its own -- no padding the short queries up
            # to the h length
            # tree staging is chunk-aligned, not pow2-padded: a query
            # barely over 2^k stays ~2^k (the dense kernel's pow2ish
            # padding would double the tables AND the MSM work)
            cache_path = getattr(params, "_devcache_path", None)
            digest = getattr(params, "_devcache_digest", "")
            if cache_path:
                with _StageTimer("stage.devcache.load"):
                    staged = self._load_devcache(cache_path, digest)
                if staged is not None:
                    params._staged_cache = (key, staged)
                    return staged
            with _StageTimer("stage.tree.g1abl") as st:
                g1abl = self.stage_g1_affine(
                    [params.a, params.b_g1, params.l],
                    curve_check=raw,
                )
                st.done(g1abl.tx)
            with _StageTimer("stage.tree.g1h") as st:
                g1h = self.stage_g1_affine(
                    [params.h], curve_check=raw,
                )
                st.done(g1h.tx)
            with _StageTimer("stage.tree.b_g2") as st:
                # ZA_TREE_G2=0 pins G2 to the dense kernel (escape
                # hatch; resolved once in __init__ -- cache-key safe)
                if self._tree_g2 and n2 >= self._tree_min:
                    b_g2x = self.stage_g2_affine(
                        [params.b_g2], curve_check=raw
                    )
                    st.done(b_g2x.tx)
                else:  # small G2: the fused dense kernel wins
                    b_g2x = self.stage_g2_stacked(
                        [b2q], curve_check=raw, n_pad=n2
                    )
                    st.done(b_g2x)
            staged = {"g1abl": g1abl, "g1h": g1h, "b_g2x": b_g2x}
            if cache_path:
                with _StageTimer("stage.devcache.save"):
                    self._save_devcache(cache_path, digest, staged)
            params._staged_cache = (key, staged)
            return staged
        with _StageTimer("stage.g1x4") as st:
            g1x4 = self.stage_g1_stacked(
                [padded_q(params.a), padded_q(params.b_g1),
                 padded_q(params.l), padded_q(params.h)],
                curve_check=raw, n_pad=n_common,
            )
            st.done(g1x4)
        with _StageTimer("stage.b_g2") as st:
            b_g2x = self.stage_g2_stacked([b2q], curve_check=raw,
                                          n_pad=n2)
            st.done(b_g2x)
        staged = {"g1x4": g1x4, "b_g2x": b_g2x}
        params._staged_cache = (key, staged)
        return staged

    def _scalars_limbs(self, scalars, n: int):
        """list[int] or plain-form (16, k) limb array -> (16, n) padded
        (device arrays stay on device -- the h scalars feed the MSM
        without a host round trip)."""
        if isinstance(scalars, jnp.ndarray):
            k = scalars.shape[1]
            if k < n:
                scalars = jnp.pad(scalars, ((0, 0), (0, n - k)))
            return scalars
        if isinstance(scalars, np.ndarray):
            arr = np.asarray(scalars, dtype=np.uint32)
            k = arr.shape[1]
            if k < n:
                arr = np.pad(arr, ((0, 0), (0, n - k)))
            return arr
        scs = [s % R for s in scalars] + [0] * (n - len(scalars))
        return F.ints_to_limbs(scs)

    def _grouped_jit(self, kind: str, M: int, n: int, c: int, lanes: int):
        if self.msm_style == "rns":
            # the rns branch always runs c=4 with at most 128 lanes (not
            # measured on the H100); normalize the cache key so different
            # auto-computed lane values don't duplicate compiles of
            # identical kernels
            c = 4
            lanes = min(self.lanes or 128, 128)
        key = ("grp", kind, M, n, c, lanes, self.reduce_style,
               self.msm_style)
        if key not in self._jit_cache:
            if self.msm_style == "rns":
                ops = (
                    ec.make_g1_ops_rns() if kind == "g1"
                    else ec.make_g2_ops_rns()
                )
                if self.mesh is not None:
                    from . import mesh as MESH

                    n_loc = max(n // self._mesh_d, 1)
                    L = 1
                    while L * 2 <= min(lanes, n_loc):
                        L *= 2
                    self._jit_cache[key] = MESH.sharded_signed_msm_fn(
                        self.mesh, ops, c=4, lanes=L,
                        is_g2=(kind == "g2"),
                    )
                    return self._jit_cache[key]

                def run(points, scalars):
                    return MSM.msm_signed_dense(
                        points, scalars, ops, c=4, lanes=lanes,
                    )

                self._jit_cache[key] = jax.jit(run)
                return self._jit_cache[key]
            ops = ec.G1_OPS if kind == "g1" else ec.G2_OPS

            if self.msm_style == "dense":
                def run(points, scalars):
                    return MSM.msm_limbs_dense(points, scalars, ops)
            else:
                def run(points, scalars):
                    return MSM.msm_limbs_grouped(
                        points, scalars, ops, c=c, lanes=lanes,
                        reduce_style=self.reduce_style,
                    )

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _msm_many(self, kind: str, points_list, scalars_list):
        from . import msm_tree as MT

        if isinstance(points_list, MT.AffineTables):
            return self._msm_many_tree(kind, points_list, scalars_list)
        is_g2 = kind == "g2"
        if isinstance(points_list, tuple):
            # pre-stacked staged tree (stage_g1_stacked): leaves
            # already (rows, [2,] M, n) -- zero per-call staging
            return self._msm_many_stacked(
                kind, points_list, scalars_list
            )
        M = len(points_list)
        if self.msm_style == "rns":
            stage = ec.g2_points_to_rns if is_g2 else ec.g1_points_to_rns
        else:
            stage = (
                ec.g2_points_to_device if is_g2 else ec.g1_points_to_device
            )

        def npoints(p):
            if isinstance(p, tuple):  # staged device arrays
                import jax.tree_util as jtu

                return jtu.tree_leaves(p)[0].shape[-1]
            return len(p)

        n = _pad_pow2ish(max(npoints(p) for p in points_list))
        with _StageTimer(f"msm.{kind}.stage") as st:
            devp, devs = [], []
            for pts, scs in zip(points_list, scalars_list):
                if isinstance(pts, tuple):
                    k = npoints(pts)
                    if k < n:  # pad columns with the identity (0:1:0)
                        ident = stage([None] * (n - k))
                        pts = jax.tree_util.tree_map(
                            lambda a, b: jnp.concatenate(
                                [jnp.asarray(a), b], axis=-1
                            ),
                            pts, ident,
                        )
                else:
                    pts = stage(list(pts) + [None] * (n - len(pts)))
                devp.append(pts)
                devs.append(self._scalars_limbs(scs, n))
            points = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs, axis=-2), *devp
            )
            scalars = st.done(
                jnp.stack([jnp.asarray(s) for s in devs], axis=1)
            )
        c, lanes = MSM.auto_params_grouped(n, M, is_g2=is_g2)
        if self.window is not None:
            c = self.window
        if self.lanes is not None:
            lanes = self.lanes
        with _StageTimer(f"msm.{kind}.kernel[n={n},M={M}]") as st:
            X, Y, Z = st.done(
                self._grouped_jit(kind, M, n, c, lanes)(points, scalars)
            )
        return self._msm_unstage(kind, X, Y, Z, M)

    def _msm_many_stacked(self, kind: str, points, scalars_list):
        """Grouped MSM over a pre-stacked staged tree: only the scalar
        upload and the kernel dispatch happen per call."""
        is_g2 = kind == "g2"
        leaf = jax.tree_util.tree_leaves(points)[0]
        M, n = leaf.shape[-2], leaf.shape[-1]
        assert len(scalars_list) == M, "one scalar vector per query"
        with _StageTimer(f"msm.{kind}.scalars") as st:
            # upload each distinct scalar vector once (the witness z
            # feeds several queries), pad + stack on device: at 2^20
            # this is ~134 MB h2d instead of 537 MB
            dev_map: dict = {}
            devs = []
            for s in scalars_list:
                if isinstance(s, jnp.ndarray):
                    devs.append(s)
                    continue
                k = id(s)
                if k not in dev_map:
                    dev_map[k] = self.witness_limbs_dev(s)
                devs.append(dev_map[k])
            shapes = tuple(a.shape for a in devs)
            key = ("padstack", shapes, n)
            fn = self._jit_cache.get(key)
            if fn is None:

                def fn_(*arrs):
                    padded = [
                        jnp.pad(a, ((0, 0), (0, n - a.shape[1])))
                        for a in arrs
                    ]
                    return jnp.stack(padded, axis=1)

                fn = jax.jit(fn_)
                self._jit_cache[key] = fn
            scalars = st.done(fn(*devs))
        c, lanes = MSM.auto_params_grouped(n, M, is_g2=is_g2)
        if self.window is not None:
            c = self.window
        if self.lanes is not None:
            lanes = self.lanes
        with _StageTimer(f"msm.{kind}.kernel[n={n},M={M}]") as st:
            X, Y, Z = st.done(
                self._grouped_jit(kind, M, n, c, lanes)(points, scalars)
            )
        return self._msm_unstage(kind, X, Y, Z, M)

    def _msm_unstage(self, kind: str, X, Y, Z, M: int):
        is_g2 = kind == "g2"
        if self.msm_style == "rns":
            Xn, Yn, Zn = np.asarray(X), np.asarray(Y), np.asarray(Z)
            if is_g2:
                return [
                    ec.g2_point_from_rns(
                        Xn[:, :, i], Yn[:, :, i], Zn[:, :, i]
                    )
                    for i in range(M)
                ]
            return [
                ec.g1_point_from_rns(Xn[:, i], Yn[:, i], Zn[:, i])
                for i in range(M)
            ]
        if is_g2:
            return [
                ec.g2_point_from_device(
                    (X[0][:, i], X[1][:, i]),
                    (Y[0][:, i], Y[1][:, i]),
                    (Z[0][:, i], Z[1][:, i]),
                )
                for i in range(M)
            ]
        return [
            ec.g1_point_from_device(X[:, i], Y[:, i], Z[:, i])
            for i in range(M)
        ]

    def msm_g1_many(self, points_list, scalars_list) -> list[G1Point]:
        """M same-size G1 MSMs in one grouped window-parallel kernel.
        Entries of points_list may be host point lists or staged device
        arrays (stage_g1); scalars entries may be int lists or plain
        (16, k) limb arrays."""
        return self._msm_many("g1", points_list, scalars_list)

    def msm_g2_many(self, points_list, scalars_list) -> list[G2Point]:
        return self._msm_many("g2", points_list, scalars_list)

    # -- fixed-base scalar multiplication (trusted setup) --------------------

    def _fixed_base_jit(self, kind: str, n: int, c: int):
        key = ("fb", kind, n, c)
        if key not in self._jit_cache:
            ops = ec.G1_OPS if kind == "g1" else ec.G2_OPS

            def run(base, scalars):
                table = MSM.fixed_base_table(base, ops, c)
                pts = MSM.fixed_base_msm(table, scalars, ops, c)
                if kind == "g1":
                    return ec.normalize_g1(*pts)
                return ec.normalize_g2(*pts)

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def fixed_base_g1(self, scalars: list[int], c: int = 8) -> list[G1Point]:
        """[s_i * G1 for s_i] -- the setup's pk-query builder."""
        from ..curve import G1_GEN

        n = _pad_pow2ish(len(scalars))
        scs = [s % R for s in scalars] + [0] * (n - len(scalars))
        base = ec.g1_points_to_device([G1_GEN])
        x, y, z = self._fixed_base_jit("g1", n, c)(base, F.ints_to_limbs(scs))
        return ec.g1_batch_from_device(x, y, z)[: len(scalars)]

    def fixed_base_g2(self, scalars: list[int], c: int = 8) -> list[G2Point]:
        from ..curve import G2_GEN

        n = _pad_pow2ish(len(scalars))
        scs = [s % R for s in scalars] + [0] * (n - len(scalars))
        base = ec.g2_points_to_device([G2_GEN])
        x, y, z = self._fixed_base_jit("g2", n, c)(base, F.ints_to_limbs(scs))
        return ec.g2_batch_from_device(x, y, z)[: len(scalars)]

    # -- QAP h(x) ------------------------------------------------------------

    def _domain(self, size: int) -> NTT.DeviceDomain:
        if size not in self._domains:
            self._domains[size] = NTT.DeviceDomain(
                size, fourstep=self.profile.ntt_fourstep
            )
        return self._domains[size]

    def _matvec_jit(self, m: int, nnz: int):
        """Sparse R1CS matvec piece: one compile shared by the A/B/C
        matrices (nnz is pow2-padded in _pack_rows) and by both the
        h-coeffs and satisfiability paths."""
        key = ("mv", m, nnz)
        if key not in self._jit_cache:

            def run(z_mont, coeffs, colidx, rowidx):
                prod = F.mont_mul(coeffs, z_mont[:, colidx], FR)
                sums = jax.ops.segment_sum(
                    prod.T, rowidx, num_segments=m,
                    indices_are_sorted=True,
                ).T  # (16, m) digit sums < 2^32
                # widen to 32 columns (< 2^17 digits) then REDC -> plain
                lo = sums & F.MASK
                hi = sums >> F.LIMB_BITS
                wide = jnp.zeros((2 * F.NLIMBS, m), dtype=jnp.uint32)
                wide = wide.at[: F.NLIMBS].add(lo)
                wide = wide.at[1 : F.NLIMBS + 1].add(hi)
                return F.redc_wide(wide, FR)  # plain form

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _piece(self, name: str):
        """Small elementwise pieces (shape-polymorphic via jax.jit)."""
        fn = self._jit_cache.get(("piece", name))
        if fn is None:
            if name == "mv_finish":  # plain matvec result -> Mont + base
                def fn_(plain, base):
                    return F.add_mod(F.to_mont(plain, FR), base, FR)
            elif name == "h_combine":  # (A*B - C) / Z on the coset
                def fn_(a_c, b_c, c_c, zi):
                    hc = F.sub_mod(F.mont_mul(a_c, b_c, FR), c_c, FR)
                    return F.mont_mul(
                        hc, jnp.broadcast_to(zi[:, None], hc.shape), FR
                    )
            elif name == "sat_check":  # Az o Bz == Cz (plain operands)
                def fn_(az, bz, cz):
                    lhs = F.mont_mul(F.to_mont(az, FR), bz, FR)
                    return jnp.all(lhs == cz)
            elif name == "from_mont":
                def fn_(x):
                    return F.from_mont(x, FR)
            else:  # pragma: no cover
                raise KeyError(name)
            fn = jax.jit(fn_)
            self._jit_cache[("piece", name)] = fn
        return fn

    def h_coeffs(self, r1cs: R1CS, z: list[int], domain: Domain) -> list[int]:
        return F.limbs_to_ints(self.h_coeffs_limbs(r1cs, z, domain))

    @staticmethod
    def _pack_rows(rows):
        coeffs, cols, rowids = [], [], []
        for k, row in enumerate(rows):
            for var, coeff in row:
                coeffs.append(coeff)
                cols.append(var)
                rowids.append(k)
        if not coeffs:  # keep shapes non-empty
            coeffs, cols, rowids = [0], [0], [0]
        # pow2-pad nnz with zero-coefficient entries so the A/B/C
        # matvecs share one compiled kernel; padding repeats the last
        # row id, keeping the ids sorted (segment_sum is told so)
        nnz = _pad_pow2ish(len(coeffs))
        pad = nnz - len(coeffs)
        coeffs += [0] * pad
        cols += [0] * pad
        rowids += [rowids[-1]] * pad
        return (
            _to_mont_fr(F.ints_to_limbs(coeffs)),
            jnp.asarray(np.array(cols, dtype=np.int32)),
            jnp.asarray(np.array(rowids, dtype=np.int32)),
        )

    def _r1cs_entries(self, r1cs: R1CS):
        """Packed sparse (coeff, col, row) triples, cached on the r1cs."""
        ent = getattr(r1cs, "_dev_entries", None)
        if ent is None:
            ent = (
                self._pack_rows(r1cs.a_rows),
                self._pack_rows(r1cs.b_rows),
                self._pack_rows(r1cs.c_rows),
            )
            r1cs._dev_entries = ent
        return ent

    def r1cs_satisfied(self, r1cs: R1CS, z: list[int]) -> bool:
        """Az o Bz == Cz over all rows as device sparse matvecs (the
        reference's satisfies_with_signals, constraint.rs:29-67, which
        is a host-side Python loop in the golden model)."""
        n = max(r1cs.num_constraints, 1)
        if self.msm_style == "rns":
            if self.mesh is not None:
                return self._r1cs_satisfied_rns_mesh(r1cs, z, n)
            return self._r1cs_satisfied_rns(r1cs, z, n)
        a_ent, b_ent, c_ent = self._r1cs_entries(r1cs)
        z_mont = _to_mont_fr(F.ints_to_limbs([v % R for v in z]))
        az = self._matvec_jit(n, a_ent[1].shape[0])(z_mont, *a_ent)
        bz = self._matvec_jit(n, b_ent[1].shape[0])(z_mont, *b_ent)
        cz = self._matvec_jit(n, c_ent[1].shape[0])(z_mont, *c_ent)
        return bool(self._piece("sat_check")(az, bz, cz))

    def _r1cs_satisfied_rns(self, r1cs: R1CS, z: list[int], n: int) -> bool:
        """Sat check on the RNS matvec: (Az*Bz - Cz) reduced to
        canonical limbs must be zero everywhere.

        Runs the matvecs at DOMAIN size (padded rows are all-zero and
        trivially satisfied) and stashes the legs: the h(x) pipeline
        needs exactly these Az/Bz/Cz vectors next, so a prove
        immediately after the check skips its three matvecs."""
        from . import rns as RNS
        from ..groth16.domain import Domain

        ctx = RNS.RR
        m = Domain.for_constraints(n + r1cs.num_inputs).size
        ent = self._r1cs_entries_rns(r1cs)
        z_rns = self._rns_piece_to_mont()(self.witness_limbs_dev(z))
        legs = [
            self._matvec_rns_jit(m, e[1].shape[0])(z_rns, *e)
            for e in ent
        ]
        self._sat_legs = ((id(r1cs), id(z), m), tuple(legs))
        fn = self._jit_cache.get(("rns_piece", "sat"))
        if fn is None:
            m1rep = ctx.ints_to_rns([ctx.m1 % ctx.modulus])[:, 0]

            def fn_(az, bz, cz):
                lhs = RNS.mont_mul_rns(az, bz, ctx)          # (azbz)~
                rhs = RNS.mont_mul_rns(cz, RNS._b(m1rep, cz), ctx)
                d = RNS.ch_sub_off(lhs, rhs, ctx,
                                   off_vec=ctx.sub_off8)     # < 12N
                plain = RNS.from_mont_rns(d, ctx)            # < 4N
                limbs = RNS.rns_to_limbs_exact(
                    plain, ctx, nlimbs=16, reduce_mod=ctx.modulus
                )
                return jnp.all(limbs == 0)

            fn = jax.jit(fn_)
            self._jit_cache[("rns_piece", "sat")] = fn
        return bool(fn(*legs))

    def _r1cs_satisfied_rns_mesh(self, r1cs: R1CS, z, n: int) -> bool:
        """Sat check with the A/B/C matvecs sharded by constraint-row
        block over the mesh (the h-pipeline's matvec layout; padded
        rows are all-zero and trivially satisfied)."""
        from jax.sharding import PartitionSpec as P

        from . import mesh as MESH, rns as RNS
        from ..groth16.domain import Domain

        D = self._mesh_d
        # domain-size rows when the mesh-h layout fits (D^2 | m): the
        # packed entries, matvec, AND resulting legs are then shared
        # with the h(x) pipeline; tiny domains pad to D instead
        m = Domain.for_constraints(n + r1cs.num_inputs).size
        if m % (D * D) == 0:
            _tools, packed, mv = self._mesh_h_tools_rns(r1cs, m)
        else:
            m = -(-n // D) * D
            ent = getattr(r1cs, "_dev_entries_sat_rns", None)
            if ent is None or ent[0] != m:
                A = MESH.AXIS
                packed = tuple(
                    (
                        self._gput(e[0], P(A, None, None)),
                        self._gput(e[1], P(A, None)),
                        self._gput(e[2], P(A, None)),
                    )
                    for e in (
                        self._pack_rows_sharded_rns(rows, m, D)
                        for rows in (
                            r1cs.a_rows, r1cs.b_rows, r1cs.c_rows
                        )
                    )
                )
                ent = (m, packed)
                r1cs._dev_entries_sat_rns = ent
            _, packed = ent
            nnz = packed[0][1].shape[1]
            mv_key = ("mesh_mv_rns", m, nnz)
            mv = self._jit_cache.get(mv_key)
            if mv is None:
                mv = MESH.sharded_matvec_rns_fn(self.mesh, m, nnz)
                self._jit_cache[mv_key] = mv
        z_rns = self._rns_piece_to_mont()(self.witness_limbs_dev(z))
        legs = [mv(z_rns, *e) for e in packed]
        self._sat_legs = ((id(r1cs), id(z), m), tuple(legs))
        ctx = RNS.RR
        fn = self._jit_cache.get(("rns_piece", "sat"))
        if fn is None:
            m1rep = ctx.ints_to_rns([ctx.m1 % ctx.modulus])[:, 0]

            def fn_(az, bz, cz):
                lhs = RNS.mont_mul_rns(az, bz, ctx)
                rhs = RNS.mont_mul_rns(cz, RNS._b(m1rep, cz), ctx)
                d = RNS.ch_sub_off(lhs, rhs, ctx,
                                   off_vec=ctx.sub_off8)
                plain = RNS.from_mont_rns(d, ctx)
                limbs = RNS.rns_to_limbs_exact(
                    plain, ctx, nlimbs=16, reduce_mod=ctx.modulus
                )
                return jnp.all(limbs == 0)

            fn = jax.jit(fn_)
            self._jit_cache[("rns_piece", "sat")] = fn
        return bool(fn(*legs))

    @staticmethod
    def _pack_rows_sharded(rows, m: int, D: int):
        """Sparse rows -> per-shard (coeffs (D, 16, nnz), colidx
        (D, nnz), rowidx (D, nnz)) with row indices local to the
        shard's [d*m/D, (d+1)*m/D) block and nnz padded to the max
        shard (zero-coefficient entries are harmless)."""
        m_loc = m // D
        per = [[[], [], []] for _ in range(D)]
        for k, row in enumerate(rows):
            d = k // m_loc
            for var, coeff in row:
                per[d][0].append(coeff)
                per[d][1].append(var)
                per[d][2].append(k - d * m_loc)
        nnz = _pad_pow2ish(max(max(len(p[0]) for p in per), 1))
        coeffs = np.zeros((F.NLIMBS, D, nnz), dtype=np.uint32)
        cols = np.zeros((D, nnz), dtype=np.int32)
        rowids = np.zeros((D, nnz), dtype=np.int32)
        for d in range(D):
            c, v, r = per[d]
            if c:
                coeffs[:, d, : len(c)] = F.ints_to_limbs(c)
                cols[d, : len(c)] = v
                rowids[d, : len(c)] = r
                rowids[d, len(c):] = r[-1]  # sorted ids for segment_sum
        cm = _to_mont_fr(jnp.asarray(coeffs.reshape(F.NLIMBS, D * nnz)))
        return (
            jnp.moveaxis(cm.reshape(F.NLIMBS, D, nnz), 0, 1),
            jnp.asarray(cols),
            jnp.asarray(rowids),
        )

    def _mesh_h_tools(self, r1cs: R1CS, m: int):
        """Sharded matvec + NTT callables for domain size m (cached)."""
        from . import mesh as MESH

        key = ("mesh_h", m)
        tools = self._jit_cache.get(key)
        if tools is None:
            D = self._mesh_d
            dd = MESH.ShardedDomain(m, D)
            tools = {
                "ntt": MESH.sharded_ntt_fn(self.mesh, dd, inverse=False),
                "intt": MESH.sharded_ntt_fn(self.mesh, dd, inverse=True),
                "mv": None,  # filled per-nnz below
            }
            self._jit_cache[key] = tools
        ent = getattr(r1cs, "_dev_entries_sharded", None)
        if ent is None:
            D = self._mesh_d
            ent = tuple(
                self._pack_rows_sharded(rows, m, D)
                for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows)
            )
            r1cs._dev_entries_sharded = ent
        nnz = ent[0][1].shape[1]
        mv_key = ("mesh_mv", m, nnz)
        mv = self._jit_cache.get(mv_key)
        if mv is None:
            from . import mesh as MESH

            mv = MESH.sharded_matvec_fn(self.mesh, m, nnz)
            self._jit_cache[mv_key] = mv
        return tools, ent, mv

    def _h_coeffs_limbs_mesh(self, r1cs: R1CS, z: list[int],
                             domain: Domain) -> np.ndarray:
        """h(x) with every heavy stage sharded over the mesh: per-row
        sharded A/B/C matvecs (segment_sum per shard), four-step NTTs
        with all_to_all over the mesh axis, elementwise stages under
        jit (GSPMD propagates the domain sharding)."""
        m = domain.size
        tools, ent, mv = self._mesh_h_tools(r1cs, m)
        dom = self._domain(m)
        z_mont = _to_mont_fr(F.ints_to_limbs([v % R for v in z]))

        n = r1cs.num_constraints
        az0 = np.zeros((F.NLIMBS, m), dtype=np.uint32)
        az0[:, n : n + r1cs.num_inputs] = np.asarray(z_mont)[
            :, : r1cs.num_inputs
        ]
        zero0 = jnp.zeros((F.NLIMBS, m), dtype=jnp.uint32)
        finish = self._piece("mv_finish")
        scale = NTT._scale()

        def leg(e, base):
            plain = mv(z_mont, *e)
            evals = finish(plain, base)
            coeffs = tools["intt"](evals)
            return tools["ntt"](scale(coeffs, dom.coset_pow))

        a_c = leg(ent[0], jnp.asarray(az0))
        b_c = leg(ent[1], zero0)
        c_c = leg(ent[2], zero0)
        hc = self._piece("h_combine")(a_c, b_c, c_c, dom.z_coset_inv)
        h = tools["intt"](hc)
        h = self._piece("from_mont")(scale(h, dom.coset_inv_nofold))
        assert not np.asarray(h[:, m - 1 :]).any(), (
            "h(x) degree overflow: witness unsatisfied?"
        )
        return h[:, : m - 1]

    # -- RNS mesh h(x) pipeline (multi-chip default) --------------------------

    @staticmethod
    def _pack_rows_sharded_rns(rows, m: int, D: int):
        """Sparse rows -> per-shard RNS triples (coeffs (D, 35, nnz)
        Montgomery-RNS, colidx (D, nnz), rowidx (D, nnz) shard-local),
        nnz padded to the max shard."""
        from . import rns as RNS
        from ..curve import R as FR_MOD

        m_loc = m // D
        per = [[[], [], []] for _ in range(D)]
        for k, row in enumerate(rows):
            assert len(row) <= (1 << 16), (
                "constraint row too long for u32 channel sums"
            )
            d = k // m_loc
            for var, coeff in row:
                per[d][0].append(coeff * RNS.RR.m1 % FR_MOD)
                per[d][1].append(var)
                per[d][2].append(k - d * m_loc)
        nnz = _pad_pow2ish(max(max(len(p[0]) for p in per), 1))
        coeffs = np.zeros((D, RNS.N_CH, nnz), dtype=np.uint16)
        cols = np.zeros((D, nnz), dtype=np.int32)
        rowids = np.zeros((D, nnz), dtype=np.int32)
        for d in range(D):
            c, v, r = per[d]
            if c:
                coeffs[d, :, : len(c)] = RNS.RR.ints_to_rns(c)
                cols[d, : len(c)] = v
                rowids[d, : len(c)] = r
                rowids[d, len(c):] = r[-1]  # sorted ids for segment_sum
        return (coeffs, cols, rowids)  # host; placed by the caller

    def _mesh_h_tools_rns(self, r1cs: R1CS, m: int):
        """Sharded RNS matvec + NTT callables for domain size m."""
        from . import mesh as MESH

        key = ("mesh_h_rns", m)
        tools = self._jit_cache.get(key)
        if tools is None:
            D = self._mesh_d
            dd = MESH.ShardedRnsDomain(m, D)
            tools = {
                "ntt": MESH.sharded_ntt_rns_fn(self.mesh, dd,
                                               inverse=False,
                                               gput=self._gput),
                "intt": MESH.sharded_ntt_rns_fn(self.mesh, dd,
                                                inverse=True,
                                                gput=self._gput),
            }
            self._jit_cache[key] = tools
        ent = getattr(r1cs, "_dev_entries_sharded_rns", None)
        if ent is None:
            from jax.sharding import PartitionSpec as P

            from . import mesh as MESH

            D = self._mesh_d
            A = MESH.AXIS
            ent = tuple(
                (
                    self._gput(e[0], P(A, None, None)),
                    self._gput(e[1], P(A, None)),
                    self._gput(e[2], P(A, None)),
                )
                for e in (
                    self._pack_rows_sharded_rns(rows, m, D)
                    for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows)
                )
            )
            r1cs._dev_entries_sharded_rns = ent
        nnz = ent[0][1].shape[1]
        mv_key = ("mesh_mv_rns", m, nnz)
        mv = self._jit_cache.get(mv_key)
        if mv is None:
            from . import mesh as MESH

            mv = MESH.sharded_matvec_rns_fn(self.mesh, m, nnz)
            self._jit_cache[mv_key] = mv
        return tools, ent, mv

    def _h_coeffs_limbs_mesh_rns(self, r1cs: R1CS, z: list[int],
                                 domain: Domain) -> np.ndarray:
        """h(x) with every heavy stage sharded AND in Montgomery RNS:
        per-row sharded matvecs, four-step NTTs with all_to_all over
        the mesh axis, RNS combine, exact CRT out (the multi-chip
        analogue of _h_coeffs_limbs_rns -- same per-chip kernels as
        single-chip, so the mesh path no longer decelerates)."""
        from . import rns as RNS

        m = domain.size
        tools, ent, mv = self._mesh_h_tools_rns(r1cs, m)
        z_rns = self._rns_piece_to_mont()(self.witness_limbs_dev(z))

        from jax.sharding import PartitionSpec as P

        n = r1cs.num_constraints
        az0 = self._rns_az0_jit(m, n, r1cs.num_inputs)(z_rns)
        zero0 = self._gput(
            np.zeros((RNS.N_CH, m), dtype=np.uint32), P(None, None)
        )
        finish = self._rns_piece("mv_finish")
        scale = self._rns_piece_scale()

        dom = self._rns_mesh_scalars(m)

        stash = getattr(self, "_sat_legs", None)
        reuse = None
        if stash is not None and stash[0] == (id(r1cs), id(z), m):
            reuse = stash[1]  # sat check already ran these matvecs
        self._sat_legs = None

        def leg(e, base, pre):
            mv_out = pre if pre is not None else mv(z_rns, *e)
            evals = finish(mv_out, base)
            coeffs = tools["intt"](evals)
            return tools["ntt"](scale(coeffs, dom["coset_pow"]))

        a_c = leg(ent[0], az0, reuse and reuse[0])
        b_c = leg(ent[1], zero0, reuse and reuse[1])
        c_c = leg(ent[2], zero0, reuse and reuse[2])
        hc = self._rns_piece("h_combine")(
            a_c, b_c, c_c, dom["z_coset_inv"]
        )
        h_rns = scale(tools["intt"](hc), dom["coset_inv"])
        h = self._rns_piece("to_scalars")(h_rns)
        assert not np.asarray(h[:, m - 1 :]).any(), (
            "h(x) degree overflow: witness unsatisfied?"
        )
        return h[:, : m - 1]

    def _rns_mesh_scalars(self, m: int):
        """Coset scaling vectors for the mesh RNS pipeline (the sharded
        NTT folds 1/n into its inverse, so the coset-inverse vector has
        no 1/n factor)."""
        from . import ntt_rns as NR

        key = ("rns_mesh_scal", m)
        d = self._jit_cache.get(key)
        if d is None:
            from jax.sharding import PartitionSpec as P

            from ..groth16.domain import Domain as HostDomain

            h = HostDomain(m)
            d = {
                "coset_pow": self._gput(
                    np.asarray(NR.geom_table(h.coset_gen, m)),
                    P(None, None),
                ),
                "coset_inv": self._gput(
                    np.asarray(NR.geom_table(h.coset_gen_inv, m)),
                    P(None, None),
                ),
                "z_coset_inv": self._gput(
                    NR._mont_table([h.z_coset_inv]), P(None, None)
                ),
            }
            self._jit_cache[key] = d
        return d

    def _rns_piece_scale(self):
        from . import rns as RNS

        fn = self._jit_cache.get(("rns_piece", "scale"))
        if fn is None:
            fn = jax.jit(
                lambda x, v: RNS.mont_mul_rns(
                    x, jnp.broadcast_to(v, x.shape), RNS.RR
                )
            )
            self._jit_cache[("rns_piece", "scale")] = fn
        return fn

    # -- RNS h(x) pipeline (single-device default) ---------------------------

    def _rns_domain(self, size: int):
        from . import ntt_rns as NR

        key = ("rns_dom", size)
        dom = self._jit_cache.get(key)
        if dom is None:
            dom = NR.RnsDomain(size, fourstep=self.profile.ntt_fourstep)
            self._jit_cache[key] = dom
        return dom

    def _r1cs_entries_rns(self, r1cs: R1CS):
        """Sparse triples with Montgomery-RNS coefficients (cached)."""
        from . import rns as RNS

        ent = getattr(r1cs, "_dev_entries_rns", None)
        if ent is None:
            from ..curve import R as FR_MOD

            def pack(rows):
                coeffs, cols, rowids = [], [], []
                for k, row in enumerate(rows):
                    assert len(row) <= (1 << 16), (
                        "constraint row too long for u32 channel sums"
                    )
                    for var, coeff in row:
                        coeffs.append(coeff * RNS.RR.m1 % FR_MOD)
                        cols.append(var)
                        rowids.append(k)
                if not coeffs:
                    coeffs, cols, rowids = [0], [0], [0]
                nnz = _pad_pow2ish(len(coeffs))
                pad = nnz - len(coeffs)
                return (
                    # u16 residues: mont_mul_rns widens on use (halves
                    # the resident matvec coefficient tables)
                    jnp.asarray(
                        RNS.RR.ints_to_rns(coeffs + [0] * pad)
                        .astype(np.uint16)
                    ),
                    jnp.asarray(np.array(cols + [0] * pad, dtype=np.int32)),
                    jnp.asarray(np.array(rowids + [rowids[-1]] * pad,
                                         dtype=np.int32)),
                )

            ent = tuple(pack(r) for r in (r1cs.a_rows, r1cs.b_rows,
                                          r1cs.c_rows))
            r1cs._dev_entries_rns = ent
        return ent

    def _matvec_rns_jit(self, m: int, nnz: int):
        """RNS sparse matvec: channel products, u32 segment sums (row
        length <= 2^16 guaranteed above), channel fold, then one
        const-mul by rep(M1 mod r) to reset the integer bound to < 4N
        while preserving the Montgomery form."""
        from . import rns as RNS

        key = ("mv_rns", m, nnz)
        if key not in self._jit_cache:
            ctx = RNS.RR
            m1rep = ctx.ints_to_rns([ctx.m1 % ctx.modulus])[:, 0]

            def run(z_rns, coeffs, colidx, rowidx):
                prod = RNS.mont_mul_rns(coeffs, z_rns[:, colidx], ctx)
                sums = jax.ops.segment_sum(
                    prod.T, rowidx, num_segments=m,
                    indices_are_sorted=True,
                ).T  # (35, m) u32 channel sums
                p = ctx.p[:, None]
                canon = RNS._fold3(sums, ctx.eps[:, None], p)
                # full RNS Montgomery mul by rep(M1 mod r): divides by
                # M1, so the represented integer (< nnz_row * 4N after
                # the sum) resets to < 4N while the Montgomery form is
                # preserved (a channel mul would NOT reduce mod r)
                return RNS.mont_mul_rns(canon, RNS._b(m1rep, canon), ctx)

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _rns_piece(self, name: str):
        from . import rns as RNS

        ctx = RNS.RR
        fn = self._jit_cache.get(("rns_piece", name))
        if fn is None:
            if name == "mv_finish":  # matvec output + base evals
                def fn_(mv, base):
                    return RNS.ch_add(mv, base, ctx)
            elif name == "h_combine":  # (A*B - C) / Z on the coset
                m1rep = ctx.ints_to_rns([ctx.m1 % ctx.modulus])[:, 0]

                def fn_(a_c, b_c, c_c, zi):
                    ab = RNS.mont_mul_rns(a_c, b_c, ctx)  # < 4N
                    # bound-reset mul (NTT outputs reach ~164N; the 8N
                    # sub offset needs the subtrahend < 8N)
                    c_red = RNS.mont_mul_rns(
                        c_c, RNS._b(m1rep, c_c), ctx
                    )
                    hc = RNS.ch_sub_off(
                        ab, c_red, ctx, off_vec=ctx.sub_off8
                    )
                    return RNS.mont_mul_rns(
                        hc, jnp.broadcast_to(zi, hc.shape), ctx
                    )
            elif name == "to_scalars":  # Mont RNS -> plain u16 limbs
                def fn_(x):
                    plain = RNS.from_mont_rns(x, ctx)  # < 4N plain
                    return RNS.rns_to_limbs_exact(
                        plain, ctx, nlimbs=16, reduce_mod=ctx.modulus
                    )
            else:  # pragma: no cover
                raise KeyError(name)
            fn = jax.jit(fn_)
            self._jit_cache[("rns_piece", name)] = fn
        return fn

    def _h_coeffs_limbs_rns(self, r1cs: R1CS, z: list[int],
                            domain: Domain) -> np.ndarray:
        """h(x) entirely in Montgomery RNS: matvec -> iNTT -> coset NTT
        -> combine -> coset iNTT -> exact CRT out to scalar limbs."""
        from . import ntt_rns as NR, rns as RNS

        ctx = RNS.RR
        m = domain.size
        ent = self._r1cs_entries_rns(r1cs)
        dom = self._rns_domain(m)

        with _StageTimer("h.z_to_rns") as st:
            z_rns = st.done(
                self._rns_piece_to_mont()(self.witness_limbs_dev(z))
            )

        # input-preservation rows: az[n+i] = z_i (bellman layout),
        # built on device (a host build would d2h the whole witness)
        n = r1cs.num_constraints
        az0 = self._rns_az0_jit(m, n, r1cs.num_inputs)(z_rns)
        zero0 = jnp.zeros((RNS.N_CH, m), dtype=jnp.uint32)
        finish = self._rns_piece("mv_finish")

        # a preceding r1cs_satisfied stashed its domain-size Az/Bz/Cz
        # matvec outputs; reuse them (the sat check and h(x) need the
        # same three vectors -- saves ~1s of duplicate matvecs at 2^20)
        stash = getattr(self, "_sat_legs", None)
        reuse = None
        if stash is not None and stash[0] == (id(r1cs), id(z), m):
            reuse = stash[1]
        self._sat_legs = None

        def leg(name, e, base, pre):
            if pre is not None:
                mv = pre
            else:
                with _StageTimer(f"h.matvec.{name}") as st:
                    mv = st.done(
                        self._matvec_rns_jit(m, e[1].shape[0])(
                            z_rns, *e
                        )
                    )
            with _StageTimer(f"h.ntt.{name}") as st:
                evals = finish(mv, base)
                return st.done(
                    NR.coset_ntt_steps(dom, NR.intt_steps(dom, evals))
                )

        a_c = leg("a", ent[0], az0, reuse and reuse[0])
        b_c = leg("b", ent[1], zero0, reuse and reuse[1])
        c_c = leg("c", ent[2], zero0, reuse and reuse[2])
        with _StageTimer("h.combine+intt") as st:
            hc = self._rns_piece("h_combine")(
                a_c, b_c, c_c, dom.z_coset_inv
            )
            h_rns = st.done(NR.coset_intt_steps(dom, hc))
        with _StageTimer("h.to_scalars") as st:
            h = st.done(self._rns_piece("to_scalars")(h_rns))
        assert not np.asarray(h[:, m - 1 :]).any(), (
            "h(x) degree overflow: witness unsatisfied?"
        )
        return h[:, : m - 1]  # device-resident: feeds the MSM directly

    def witness_limbs_dev(self, z):
        """Witness (list[int] or (16, nv) limb array) -> (16, nv) u32
        device array; ONE host conversion + ONE u16 upload per prove,
        shared by the sat check, the h pipeline, and the MSM scalars
        (cached per witness object)."""
        if isinstance(z, jnp.ndarray):
            return z
        if self._multiproc():
            from jax.sharding import PartitionSpec as P

            if isinstance(z, np.ndarray):
                arr = z.astype(np.uint32)
            else:
                arr = F.ints_to_limbs([v % R for v in z])
            return self._gput(arr, P(None, None))  # replicated global
        widen = self._jit_cache.get("widen_u16")
        if widen is None:
            widen = jax.jit(lambda a: a.astype(jnp.uint32))
            self._jit_cache["widen_u16"] = widen
        if isinstance(z, np.ndarray):
            return widen(jnp.asarray(z.astype(np.uint16)))
        cached = self._jit_cache.get("witness_cache")
        if cached is not None and cached[0] is z:
            return cached[1]
        arr = F.ints_to_limbs([v % R for v in z]).astype(np.uint16)
        dev = widen(jnp.asarray(arr))
        # keyed by object identity; holding the list keeps the id valid
        self._jit_cache["witness_cache"] = (z, dev)
        return dev

    def _rns_az0_jit(self, m: int, n: int, ni: int):
        """Device builder for the input-preservation base vector:
        zeros (35, m) with columns n..n+ni = z_rns[:, :ni]."""
        from . import rns as RNS

        key = ("rns_az0", m, n, ni)
        fn = self._jit_cache.get(key)
        if fn is None:

            def fn_(z_rns):
                az = jnp.zeros((RNS.N_CH, m), dtype=jnp.uint32)
                return jax.lax.dynamic_update_slice(
                    az, z_rns[:, :ni], (0, n)
                )

            fn = jax.jit(fn_)
            self._jit_cache[key] = fn
        return fn

    def _rns_piece_to_mont(self):
        from . import rns as RNS

        fn = self._jit_cache.get(("rns_piece", "to_mont"))
        if fn is None:
            fn = jax.jit(
                lambda limbs: RNS.to_mont_rns(
                    RNS.limbs_to_rns(limbs, RNS.RR), RNS.RR
                )
            )
            self._jit_cache[("rns_piece", "to_mont")] = fn
        return fn

    def h_coeffs_limbs(self, r1cs: R1CS, z: list[int],
                       domain: Domain) -> np.ndarray:
        """h_0..h_{m-2} as a plain-form (16, m-1) limb array -- feeds
        msm_g1_many directly without a host int round-trip."""
        if self.mesh is not None and domain.size >= self._mesh_d ** 2:
            # the four-step sharded NTT needs D^2 | m; tiny domains
            # stay single-device
            if self.msm_style == "rns":
                return self._h_coeffs_limbs_mesh_rns(r1cs, z, domain)
            return self._h_coeffs_limbs_mesh(r1cs, z, domain)
        if self.msm_style == "rns":
            return self._h_coeffs_limbs_rns(r1cs, z, domain)
        m = domain.size
        a_ent, b_ent, c_ent = self._r1cs_entries(r1cs)
        dom = self._domain(m)

        z_mont = _to_mont_fr(F.ints_to_limbs([v % R for v in z]))

        # input-preservation rows: az[n+i] = z_i (bellman domain layout)
        n = r1cs.num_constraints
        az0 = np.zeros((F.NLIMBS, m), dtype=np.uint32)
        az0[:, n : n + r1cs.num_inputs] = np.asarray(z_mont)[
            :, : r1cs.num_inputs
        ]
        zero0 = jnp.zeros((F.NLIMBS, m), dtype=jnp.uint32)

        # piecewise device calls: every piece's compile is shared
        # across the A/B/C legs, the fwd/inv NTTs, and across proofs
        # (this cache keeps the jits in-process; the persistent XLA
        # cache keeps them across processes)
        finish = self._piece("mv_finish")

        def leg(ent, base):
            plain = self._matvec_jit(m, ent[1].shape[0])(z_mont, *ent)
            evals = finish(plain, base)
            return NTT.coset_ntt_steps(dom, NTT.intt_steps(dom, evals))

        a_c = leg(a_ent, jnp.asarray(az0))
        b_c = leg(b_ent, zero0)
        c_c = leg(c_ent, zero0)
        hc = self._piece("h_combine")(a_c, b_c, c_c, dom.z_coset_inv)
        h = self._piece("from_mont")(NTT.coset_intt_steps(dom, hc))
        assert not np.asarray(h[:, m - 1 :]).any(), (
            "h(x) degree overflow: witness unsatisfied?"
        )
        return h[:, : m - 1]
