"""Kernel engine v2: per-model sweep kernels + one combiner call per group.

Compilation budget stays O(M + K) like the original kernel engine, but
dispatch count per group drops from ~3 calls per 16k-sample chunk to
``len(group) + 1`` calls per ~1M-sample bucket: each model kernel scans
all chunks of a padded bucket inside one compiled program and materializes
its outputs (N_pad, No[, d]) in device memory, and a single combiner
contracts the stacked outputs into the MLBLUE sums, so the per-call
dispatch cost is paid per bucket, not per chunk.

Randomness: theta is regenerated inside every model kernel from the same
``fold_in(key, global_index)`` stream, so coupled models see identical
inputs without materializing or communicating theta.

Meshes: the sweep is shard_mapped over the 'samples' axis (each shard owns
a contiguous index range; outputs concatenate into the sharded bucket
array).  If the mesh also has a 'model' axis, the user's evaluate_model
runs inside shard_map and may use collectives over it (the nested-MPI
pattern, reference blue_models.py:121-130).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.mesh import MODEL_AXIS, SAMPLE_AXIS, fetch_global
from .jax_engine import SampleSums


class KernelEngineV2:
    def __init__(self, sample_input_fn: Callable, eval_model_fn: Callable,
                 n_models: int, No: int, batch_size: int = 16384,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 max_bucket: int = 1 << 19,
                 eval_model_batched_fn: Optional[Callable] = None):
        self.sample_input_fn = sample_input_fn
        self.eval_model_fn = eval_model_fn
        # optional natively-batched model path (e.g. a fused Pallas
        # kernel): fn(l, thetas (B, ...)) -> (B,) + out_shape.  Used in
        # the sweep bodies instead of vmap(eval_model_fn) when given.
        self.eval_model_batched_fn = eval_model_batched_fn
        self.n_models = n_models
        self.No = No
        self.batch = int(batch_size)
        self.mesh = mesh
        self.n_sample_shards = 1
        self.model_parallel = False
        if mesh is not None:
            names = mesh.axis_names
            self.model_parallel = (MODEL_AXIS in names
                                   and mesh.shape[MODEL_AXIS] > 1)
            if SAMPLE_AXIS in names:
                self.n_sample_shards = mesh.shape[SAMPLE_AXIS]
            elif not self.model_parallel:
                self.n_sample_shards = mesh.devices.size
        self.max_bucket = int(max_bucket)
        self._sweeps = {}      # (l, n_pad_shard, with_theta) -> jitted fn
        self._combiners = {}   # id by shapes via jit cache

    # ------------------------------------------------------------------ #

    def _tiers(self):
        """Padded buffer sizes per shard, smallest to largest.  Fixed
        tiers keep the compile count at O(tiers) per model; the sweep's
        inner fori_loop bound is dynamic, so compute scales with N --
        but the combiner contracts the FULL padded buffer, so a mid tier
        matters for the (common) groups sized well under the cap."""
        S = self.n_sample_shards
        B = self.batch
        big = max(1, self.max_bucket // (S * B)) * B
        mid = min(8 * B, big)
        return sorted({B, mid, big})

    def _bucket(self, N: int):
        """(n_pad_per_shard, n_buckets) for a request of N samples."""
        S = self.n_sample_shards
        per_shard = -(-int(N) // S)
        tiers = self._tiers()
        n_pad = next((t for t in tiers if per_shard <= t), tiers[-1])
        total = n_pad * S
        n_buckets = -(-int(N) // total)
        return n_pad, n_buckets

    def _out_struct(self):
        if not hasattr(self, "_out_struct_cache"):
            th = jax.eval_shape(self.sample_input_fn, jax.random.key(0))
            probe = lambda t: jnp.asarray(self.eval_model_fn(0, t))
            if self.mesh is not None:
                # bind the mesh axes so model-parallel evaluations (which
                # call axis_index/psum over 'model') shape-check correctly
                from jax.sharding import PartitionSpec as P
                probe = jax.shard_map(probe, mesh=self.mesh, in_specs=P(),
                                      out_specs=P(), check_vma=False)
            out = jax.eval_shape(
                probe,
                jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), th))
            dim = int(sum(int(np.prod(x.shape)) if x.shape else 1
                          for x in jax.tree.leaves(th)))
            self._out_struct_cache = (out.shape, out.dtype, dim)
        return self._out_struct_cache

    def _sweep(self, l: int, n_pad: int, with_theta: bool):
        keyt = (l, n_pad, with_theta)
        if keyt in self._sweeps:
            return self._sweeps[keyt]
        B = self.batch
        n_chunks = n_pad // B
        sample_input = self.sample_input_fn
        eval_model = self.eval_model_fn
        eval_batched = self.eval_model_batched_fn
        out_shape, out_dtype, theta_dim = self._out_struct()

        def shard_body(key, base, N, shard_offset):
            # chunks past the requested N are skipped: dynamic loop bound,
            # static buffer shapes
            remaining = N - (base + shard_offset)
            n_active = jnp.clip(-(-remaining // B), 0, n_chunks)

            out_buf = jnp.zeros((n_pad,) + out_shape, out_dtype)
            th_buf = jnp.zeros((n_pad, theta_dim)) if with_theta else None

            def body(c, bufs):
                ob, tb = bufs
                idx = base + shard_offset + c * B + jnp.arange(B)
                keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
                theta = jax.vmap(sample_input)(keys)
                if eval_batched is not None:
                    out = jnp.asarray(eval_batched(l, theta)).astype(
                        out_dtype)
                else:
                    out = jax.vmap(lambda t: jnp.asarray(
                        eval_model(l, t)))(theta)
                start = jnp.asarray(c * B)
                zero = jnp.zeros((), start.dtype)
                ob = jax.lax.dynamic_update_slice(
                    ob, out, (start,) + (zero,) * len(out_shape))
                if with_theta:
                    th = jnp.concatenate(
                        [x.reshape(B, -1).astype(jnp.float64)
                         for x in jax.tree.leaves(theta)], axis=1)
                    tb = jax.lax.dynamic_update_slice(tb, th, (start, zero))
                return ob, tb

            out_buf, th_buf = jax.lax.fori_loop(
                0, n_active, body, (out_buf, th_buf))
            if with_theta:
                return out_buf, th_buf
            return out_buf

        if self.mesh is None or self.mesh.devices.size == 1:
            fn = jax.jit(lambda key, base, N: shard_body(key, base, N, 0))
        else:
            from jax.sharding import PartitionSpec as P

            def sharded(key, base, N):
                if SAMPLE_AXIS in self.mesh.axis_names:
                    s = jax.lax.axis_index(SAMPLE_AXIS)
                else:
                    s = 0
                return shard_body(key, base, N, s * n_pad)

            samp = (P(SAMPLE_AXIS) if SAMPLE_AXIS in self.mesh.axis_names
                    else P())
            out_spec = (samp, samp) if with_theta else samp
            fn = jax.jit(jax.shard_map(
                sharded, mesh=self.mesh, in_specs=(P(), P(), P()),
                out_specs=out_spec, check_vma=False))
        self._sweeps[keyt] = fn
        return fn

    # Number of requests one multi-sweep program serves.  Fixed (not a
    # ladder) so the compile count stays O(models x tiers) -- padding
    # requests carry N = 0 and contribute ZERO chunks to the dynamic
    # loop bound, so the only waste is buffer zeros.
    _MULTI_R = 8

    def _sweep_multi(self, l: int, n_pad: int):
        """Multi-request sweep: one compiled program evaluates model
        ``l`` for up to _MULTI_R independent (key, base, N) requests --
        the portfolio fan-out of VERDICT r5 item 1a.  The solve
        portfolio used to dispatch one sweep per (group, model); this
        batches every group's request for the same model/tier into one
        dispatch.  The
        per-request streams are IDENTICAL to the single sweep's
        (fold_in(key_r, global_index)), so the sums are bit-equal."""
        keyt = (l, n_pad, "multi")
        if keyt in self._sweeps:
            return self._sweeps[keyt]
        B = self.batch
        n_chunks = n_pad // B
        R = self._MULTI_R
        sample_input = self.sample_input_fn
        eval_model = self.eval_model_fn
        eval_batched = self.eval_model_batched_fn
        out_shape, out_dtype, _ = self._out_struct()

        def shard_body(keys, bases, Ns, shard_offset):
            # per-request active chunk counts; the flat loop runs their
            # exact SUM (a vmap over requests would instead pay
            # R x max_chunks under the while-loop masking rule)
            rem = Ns - (bases + shard_offset)
            act = jnp.clip(-(-rem // B), 0, n_chunks)          # (R,)
            cum = jnp.cumsum(act)
            out_buf = jnp.zeros((R, n_pad) + out_shape, out_dtype)

            def body(t, ob):
                r = jnp.searchsorted(cum, t, side="right")
                prev = jnp.where(r > 0, cum[jnp.maximum(r - 1, 0)], 0)
                j = t - prev
                idx = bases[r] + shard_offset + j * B + jnp.arange(B)
                ks = jax.vmap(
                    lambda i: jax.random.fold_in(keys[r], i))(idx)
                theta = jax.vmap(sample_input)(ks)
                if eval_batched is not None:
                    out = jnp.asarray(eval_batched(l, theta)).astype(
                        out_dtype)
                else:
                    out = jax.vmap(lambda th: jnp.asarray(
                        eval_model(l, th)))(theta)
                zero = jnp.zeros((), jnp.int32)
                starts = (r.astype(jnp.int32),
                          (j * B).astype(jnp.int32))
                return jax.lax.dynamic_update_slice(
                    ob, out[None], starts + (zero,) * len(out_shape))

            return jax.lax.fori_loop(0, cum[-1], body, out_buf)

        if self.mesh is None or self.mesh.devices.size == 1:
            fn = jax.jit(lambda keys, bases, Ns:
                         shard_body(keys, bases, Ns, 0))
        else:
            from jax.sharding import PartitionSpec as P

            def sharded(keys, bases, Ns):
                if SAMPLE_AXIS in self.mesh.axis_names:
                    s = jax.lax.axis_index(SAMPLE_AXIS)
                else:
                    s = 0
                return shard_body(keys, bases, Ns, s * n_pad)

            samp = (P(None, SAMPLE_AXIS)
                    if SAMPLE_AXIS in self.mesh.axis_names else P())
            fn = jax.jit(jax.shard_map(
                sharded, mesh=self.mesh, in_specs=(P(), P(), P()),
                out_specs=samp, check_vma=False))
        self._sweeps[keyt] = fn
        return fn

    def _act_rows(self, n_pad: int, base: int, N: int) -> int:
        """Per-shard row count the combiner must contract for this
        bucket, rounded UP to a power-of-4 multiple of the batch so the
        combiner compiles O(log) programs per tier instead of one per N.
        The sweep's fori_loop already skips chunks past N, so rows beyond
        the active prefix are zeros the contraction can safely drop --
        contracting the FULL padded tier instead was measured 11% slower
        over the bench solve portfolio (mid-N groups land in tiers up to
        32x their need)."""
        B = self.batch
        need = max(int(N) - int(base), 0)
        # the bucket's index range fills sequentially, so shard 0 owns
        # the densest prefix: its active rows bound every shard's
        per_shard = min(need, n_pad)
        chunks = max(-(-per_shard // B), 1)
        p4 = 1
        while p4 < chunks:
            p4 *= 4
        return min(p4 * B, n_pad)

    def _combine(self, outs, base, N, n_pad: int, act: int):
        """outs: tuple of k (S*n_pad, No[, d]) device arrays (or an
        already stacked (k, ...) array) -> SampleSums parts.  The stack
        happens INSIDE the jitted program: a host-level jnp.stack was one
        more dispatched program per bucket (VERDICT r5 item 1a).
        Contracts only each shard's first ``act`` rows (see _act_rows);
        row r of shard s maps to global index base + s*n_pad + r."""
        return self._get_combiners(n_pad, act)[0](outs, base, N)

    def _combine_rows(self, bufs, rows_idx, base, N, n_pad: int,
                      act: int):
        """Multi-sweep variant: ``bufs`` is a tuple of k per-model
        multi-sweep outputs of shape (R, S*n_pad, No[, d]) and
        ``rows_idx`` the (k,) request lanes to combine for this group."""
        return self._get_combiners(n_pad, act)[1](bufs, rows_idx,
                                                  base, N)

    def _get_combiners(self, n_pad: int, act: int):
        key = (n_pad, act)
        if key not in self._combiners:
            S = self.n_sample_shards

            def core(outs, base, N):
                if outs.ndim == 3:
                    outs = outs[..., None]
                k = outs.shape[0]
                if act < n_pad:
                    # (k, S, n_pad, ...) -> per-shard prefix -> flatten
                    outs = outs.reshape((k, S, n_pad) + outs.shape[2:])
                    outs = outs[:, :, :act]
                    outs = outs.reshape((k, S * act) + outs.shape[3:])
                P = jnp.transpose(outs, (1, 2, 0, 3)).astype(jnp.float64)
                rows = P.shape[0]
                r = jnp.arange(rows)
                idx = base + (r // act) * n_pad + (r % act)
                ok = jnp.all(jnp.isfinite(P), axis=(1, 2, 3))
                w = ((idx < N) & ok).astype(jnp.float64)
                nf = jnp.sum((idx < N) & ~ok)
                P = jnp.where(jnp.isfinite(P), P, 0.0)
                se = jnp.einsum('bnld,b->nld', P, w)
                sc = jnp.einsum('bnid,bnjd,b->nij', P, P, w)
                D = P[:, :, :, None, :] - P[:, :, None, :, :]
                d1 = jnp.einsum('bnijd,b->nijd', D, w)
                d2 = jnp.einsum('bnijd,bnijd,b->nij', D, D, w)
                return se, sc, d1, d2, nf

            @jax.jit
            def combine(outs, base, N):
                if isinstance(outs, (tuple, list)):
                    outs = jnp.stack(outs)
                return core(outs, base, N)

            @jax.jit
            def combine_rows(bufs, rows_idx, base, N):
                # bufs: tuple of k multi-sweep outputs (R, S*n_pad, ...)
                # -- slice each model's request lane in-program (a host-
                # level gather would be one more dispatched op per group)
                outs = jnp.stack([
                    jax.lax.dynamic_index_in_dim(b, rows_idx[i], axis=0,
                                                 keepdims=False)
                    for i, b in enumerate(bufs)])
                return core(outs, base, N)

            self._combiners[key] = (combine, combine_rows)
        return self._combiners[key]

    # ------------------------------------------------------------------ #

    def precompile(self, models=None, parallel: bool = True,
                   group_sizes=(1, 2, 3, 4), collect: bool = False):
        """Warm every buffer tier (see _tiers: up to three per model) of
        every model sweep and the combiners, concurrently (XLA
        compilation releases the GIL; sequential cold compiles otherwise
        land in the middle of the first solve).  ``collect=True`` also
        warms the theta-returning sweep variant that samplefile
        collection dispatches (a distinct program per tier)."""
        import concurrent.futures as cf
        tiers = self._tiers()
        key = jax.random.key(0)
        models = list(range(self.n_models) if models is None else models)
        out_shape, out_dtype, _ = self._out_struct()
        sizes = [k for k in group_sizes if k <= self.n_models]

        R = self._MULTI_R
        legacy = os.environ.get("BLUEST_TPU_PORTFOLIO_SWEEP", "0") == "0"

        def warm_sweep(arg):
            l, n_pad, kind = arg
            if kind == "hot" and not legacy:
                # the hot path dispatches the multi-request sweep
                out = self._sweep_multi(l, n_pad)(
                    jnp.stack([key] * R),
                    jnp.zeros(R, jnp.int64),
                    jnp.asarray([1] + [0] * (R - 1), jnp.int64))
            else:
                out = self._sweep(l, n_pad, kind == "theta")(key, 0, 1)
            jax.block_until_ready(out)

        def warm_combiner(arg):
            k, n_pad, act = arg
            total = n_pad * self.n_sample_shards
            # the hot path slices request lanes out of multi-sweep
            # buffers in-program (_combine_rows); legacy/top-up paths
            # take a tuple, collect runs the stacked-array signature --
            # warm what will run
            if legacy:
                dummy = tuple(jnp.zeros((total,) + out_shape, out_dtype)
                              for _ in range(k))
                part = self._combine(dummy, 0, 1, n_pad, act)
            else:
                bufs = tuple(jnp.zeros((R, total) + out_shape, out_dtype)
                             for _ in range(k))
                part = self._combine_rows(
                    bufs, jnp.zeros(k, jnp.int32), 0, 1, n_pad, act)
            if collect:
                dummy = jnp.stack(
                    [jnp.zeros((total,) + out_shape, out_dtype)
                     for _ in range(k)])
                part = self._combine(dummy, 0, 1, n_pad, act)
            # multi-bucket accumulation adds (sample_sums) and the
            # problem-level non-finite top-up adds are tiny per-shape
            # programs too; each costs a compile if it first appears
            # mid-solve
            jax.block_until_ready(tuple(a + b for a, b in zip(part, part)))

        def _act_ladder(n_pad):
            # every (n_pad, act) pair _act_rows can produce for this
            # tier, DERIVED from _act_rows itself so the two can never
            # desynchronize (a missed key = a cold combiner compile
            # mid-solve)
            return sorted({self._act_rows(n_pad, 0, n)
                           for n in range(1, n_pad + 1, self.batch)}
                          | {self._act_rows(n_pad, 0, n_pad)})

        jobs = [(l, t, "hot") for l in models for t in tiers]
        if collect:
            # collect runs dispatch legacy singles: ls[0]'s carries
            # theta, the other positions the plain variant
            jobs += [(l, t, "theta") for l in models for t in tiers]
            jobs += [(l, t, "single") for l in models for t in tiers]
        cjobs = [(k, t, a) for k in sizes for t in tiers
                 for a in _act_ladder(t)]
        if parallel and len(jobs) > 1:
            with cf.ThreadPoolExecutor(max_workers=8) as ex:
                futs = [ex.submit(warm_sweep, j) for j in jobs]
                futs += [ex.submit(warm_combiner, j) for j in cjobs]
                for f in futs:
                    f.result()
        else:
            for j in jobs:
                warm_sweep(j)
            for j in cjobs:
                warm_combiner(j)

    def sample_sums(self, ls, key, N: int, collect: bool = False,
                    on_chunk: Optional[Callable] = None):
        """MLBLUE sums for group ``ls`` over N samples.  With
        ``collect=True`` the per-sample outputs + inputs are returned in
        bulk, or -- when ``on_chunk(vals, thetas, attempted_rows)`` is
        given -- streamed per bucket so the caller (a snapshot
        CollectSink) bounds host memory on XL runs."""
        ls = [int(l) for l in ls]
        N = int(N)
        if N <= 0:
            # zero-sample request: the bucket loop below never runs and
            # acc would stay None (TypeError on unpack); return exact
            # zero sums in the combiner's shapes
            out_shape, _dt, _ = self._out_struct()
            No = out_shape[0]
            d = out_shape[1] if len(out_shape) > 1 else 1
            k = len(ls)
            z = jnp.zeros
            sums = SampleSums(z((No, k, d)), z((No, k, k)),
                              z((No, k, k, d)), z((No, k, k)),
                              jnp.zeros((), jnp.int32))
            if collect and on_chunk is None:
                th_shape = jax.eval_shape(self.sample_input_fn,
                                          jax.random.key(0))
                return (sums,
                        np.zeros((0, No, k, d) if len(out_shape) > 1
                                 else (0, No, k)),
                        np.zeros((0,) + tuple(th_shape.shape)))
            return sums
        if not collect and os.environ.get(
                "BLUEST_TPU_PORTFOLIO_SWEEP", "0") != "0":
            # hot path: the multi-request sweep machinery (one request);
            # this keeps top-ups/pilot calls on the SAME compiled
            # programs the portfolio fan-out uses
            return self.portfolio_sums([(ls, key, N)])[0]
        n_pad, n_buckets = self._bucket(N)
        total = n_pad * self.n_sample_shards

        acc = None
        vals, thetas = [], []
        for b in range(n_buckets):
            base = b * total
            outs_list = []
            th = None
            for pos, l in enumerate(ls):
                want_theta = collect and pos == 0
                res = self._sweep(l, n_pad, want_theta)(key, base, N)
                if want_theta:
                    out, th = res
                else:
                    out = res
                outs_list.append(out)
            # collect runs still materialize the stacked array (the
            # snapshot fetch wants one gather); the hot path hands the
            # tuple straight to the combiner, which stacks in-program
            # (BLUEST_TPU_FUSE_STACK=0 restores the dispatched stack --
            # the A/B handle for tools/ab_sample.py)
            fuse = os.environ.get("BLUEST_TPU_FUSE_STACK", "1") != "0"
            outs = (tuple(outs_list) if fuse and not collect
                    else jnp.stack(outs_list))
            act = self._act_rows(n_pad, base, N)
            part = self._combine(outs, base, N, n_pad, act)
            acc = part if acc is None else tuple(
                a + b2 for a, b2 in zip(acc, part))
            if collect:
                idx = base + np.arange(total)
                # sample-sharded under a multi-process mesh: fetch via a
                # replicating gather (plain np.asarray raises on arrays
                # spanning non-addressable devices); every process runs
                # this same collective, only process 0's sink persists
                o = fetch_global(outs)
                axes = (1, 2, 0) if o.ndim == 3 else (1, 2, 0, 3)
                ovals = o.transpose(axes)          # (total, No, k[, d])
                # drop non-finite rows: the combiner masks them out of
                # the sums, and the problem-level top-up re-samples the
                # deficit (appending its own snapshots), so filtering
                # keeps "snapshot rows == samples covered by the sums"
                finite = np.isfinite(ovals).all(
                    axis=tuple(range(1, ovals.ndim)))
                sel = (idx < N) & finite
                if on_chunk is not None:
                    on_chunk(ovals[sel], fetch_global(th)[sel],
                             int(min(total, N - base)))
                else:
                    vals.append(ovals[sel])
                    thetas.append(fetch_global(th)[sel])
        se, sc, d1, d2, nf = acc
        sums = SampleSums(se, sc, d1, d2, nf)
        if collect and on_chunk is None:
            return sums, np.concatenate(vals), np.concatenate(thetas)
        return sums

    def portfolio_sums(self, reqs):
        """MLBLUE sums for a PORTFOLIO of groups in one fan-out
        (VERDICT r5 item 1a): ``reqs`` is a list of (ls, key, N).

        Every (group, bucket, model) unit job is binned by (model,
        tier) and served by _sweep_multi slabs of _MULTI_R requests, so
        the whole portfolio dispatches ~#models sweep programs instead
        of ~sum(len(group)); one _combine_rows per (group, bucket)
        slices its lanes in-program.  Per-request sample streams are
        identical to sample_sums', so the returned sums are bit-equal
        to the sequential path.  Returns [SampleSums] aligned with
        ``reqs`` (zero-sums for N <= 0, matching sample_sums)."""
        R = self._MULTI_R
        # plan: jobs[(l, n_pad)] -> list of (key, base, N); slot refs
        plans = []
        jobs = {}
        for ls, key, N in reqs:
            ls = [int(l) for l in ls]
            N = int(N)
            if N <= 0:
                plans.append(None)
                continue
            n_pad, n_buckets = self._bucket(N)
            total = n_pad * self.n_sample_shards
            buckets = []
            for b in range(n_buckets):
                base = b * total
                slots = []
                for l in ls:
                    entry = jobs.setdefault((l, n_pad), [])
                    entry.append((key, base, N))
                    slots.append((l, len(entry) - 1))
                buckets.append((base, slots))
            plans.append((ls, N, n_pad, buckets))
        # dispatch one multi-sweep per (model, tier) slab of R requests
        slabs = {}
        for (l, n_pad), entries in jobs.items():
            outs = []
            for s in range(0, len(entries), R):
                chunk = entries[s:s + R]
                pad_key = chunk[0][0]        # N = 0 lanes: zero chunks
                keys = [c[0] for c in chunk] + \
                    [pad_key] * (R - len(chunk))
                bases = [c[1] for c in chunk] + [0] * (R - len(chunk))
                Ns = [c[2] for c in chunk] + [0] * (R - len(chunk))
                outs.append(self._sweep_multi(l, n_pad)(
                    jnp.stack(keys), jnp.asarray(bases),
                    jnp.asarray(Ns)))
            slabs[(l, n_pad)] = outs
        # combine each group's lanes
        results = []
        for plan, (ls, key, N) in zip(plans, reqs):
            if plan is None:
                results.append(self.sample_sums(ls, key, 0))
                continue
            ls_i, N, n_pad, buckets = plan
            acc = None
            for base, slots in buckets:
                bufs = tuple(slabs[(l, n_pad)][idx // R]
                             for l, idx in slots)
                rows = jnp.asarray([idx % R for _l, idx in slots],
                                   dtype=jnp.int32)
                act = self._act_rows(n_pad, base, N)
                part = self._combine_rows(bufs, rows, base, N,
                                          n_pad, act)
                acc = part if acc is None else tuple(
                    a + b2 for a, b2 in zip(acc, part))
            results.append(SampleSums(*acc))
        return results
