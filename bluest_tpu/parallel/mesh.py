"""Device mesh helpers.

The reference distributes Monte Carlo sampling with mpi4py (blue_fn.py:9,
106-110, 179-187).  Here distribution is a jax.sharding.Mesh: the sample
axis replaces the MPI rank split, psum replaces allreduce(SUM), and a
second 'model' axis is available for models that are themselves
distributed (the nested-communicator pattern of the reference,
blue_models.py:121-130)."""

from __future__ import annotations

import itertools
import os
from typing import Optional, Sequence

import jax
import numpy as np

SAMPLE_AXIS = "samples"
MODEL_AXIS = "model"

_BARRIER_SEQ = itertools.count()


def _coord_barrier(tag: str, timeout_s: Optional[float] = None) -> None:
    """Align every process at the gRPC coordination service.

    XLA:CPU's Gloo backend exchanges communicator addresses through the
    coordination KV store with a HARD-CODED ~30s deadline, so the first
    collective over a new device set dies whenever the processes reach it
    more than 30s apart -- and cold-compile skew between processes can
    run to minutes.  The coordination-service barrier has a configurable timeout
    (BLUEST_TPU_DIST_BARRIER_S, default 1200s), so barriering here first
    absorbs the skew and the Gloo rendezvous that follows sees aligned
    peers.  SPMD discipline: every process must reach these barriers in
    the same order (the sequence number is part of the barrier id).
    No-op single-process."""
    try:
        from jax._src import distributed
        client = distributed.global_state.client
    except Exception:
        client = None
    if client is None or jax.process_count() == 1:
        return
    if timeout_s is None:
        timeout_s = float(os.environ.get("BLUEST_TPU_DIST_BARRIER_S",
                                         "1200"))
    client.wait_at_barrier("bluest_%s_%d" % (tag, next(_BARRIER_SEQ)),
                           timeout_in_ms=int(timeout_s * 1000))


def _warm_mesh_cliques(mesh: jax.sharding.Mesh) -> jax.sharding.Mesh:
    """Establish the Gloo cliques a mesh's collectives will use.

    XLA:CPU caches one communicator per (device set, rank) for the life
    of the process (cpu_cliques.cc), so running one tiny psum over every
    mesh axis -- immediately, while the processes are still aligned --
    makes every later program's collectives over those axes
    rendezvous-free, immune to the 30s Gloo deadline under compile skew.
    Returns the mesh for chaining.  No-op single-process."""
    if jax.process_count() == 1:
        return mesh
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    _coord_barrier("mesh_warm")

    def _ones():
        vals = [jax.lax.psum(jnp.float32(1.0), ax)
                for ax in mesh.axis_names]
        # the replicated output also exercises the full-device clique
        return sum(vals)

    f = jax.jit(jax.shard_map(_ones, mesh=mesh, in_specs=(),
                              out_specs=P(), check_vma=False))
    jax.block_until_ready(f())
    return mesh


def sample_mesh(n_devices: Optional[int] = None) -> jax.sharding.Mesh:
    """1D mesh over all (or the first n) devices for sample parallelism."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.sharding.Mesh(np.array(devs), (SAMPLE_AXIS,))


def sample_model_mesh(n_sample: int, n_model: int) -> jax.sharding.Mesh:
    """2D (samples, model) mesh: the JAX equivalent of nested MPI
    communicators -- each model instance spans ``n_model`` devices, with
    ``n_sample`` such instances running independent samples."""
    devs = jax.devices()
    if n_sample * n_model > len(devs):
        raise ValueError("mesh larger than device count")
    arr = np.array(devs[:n_sample * n_model]).reshape(n_sample, n_model)
    return jax.sharding.Mesh(arr, (SAMPLE_AXIS, MODEL_AXIS))


def initialize_distributed(**kwargs) -> None:
    """Multi-host initialization hook (jax.distributed) -- replaces
    `mpiexec` process management for multi-host jobs.

    After init (the one moment every process is provably in lockstep)
    this warms the full-device Gloo clique, so first-dispatch collectives
    of later, arbitrarily-skewed programs (engine psums, snapshot
    allgathers) reuse the cached communicator instead of attempting a
    30s-deadline rendezvous mid-pipeline."""
    jax.distributed.initialize(**kwargs)
    if jax.process_count() > 1:
        _warm_mesh_cliques(sample_mesh())


def fetch_global(x) -> np.ndarray:
    """``np.asarray`` for arrays that may span non-addressable devices.

    Under ``jax.distributed`` a sample-sharded engine output lives partly
    on other processes' devices and a direct fetch raises.  Gather it
    through a replicating collective instead, so every process receives
    the full logical array -- the JAX analog of the reference's
    rank-0 snapshot gather (blue_fn.py:189-199).  COLLECTIVE: in a
    multi-process run every process must call this on the same array.
    Single-process (or already fully-addressable) arrays take the plain
    fetch path untouched."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        # align first: the allgather itself traces/compiles per process,
        # and if its Gloo clique is new the rendezvous deadline is 30s --
        # far below the compile skew processes can accumulate.
        # is_fully_addressable is a global property of the array, so
        # every process takes this branch for the same inputs.
        _coord_barrier("fetch_global")
        # tiled=True: required for global (non-fully-addressable) input;
        # the result is the full logical array, replicated on every host
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def dcn_sample_model_mesh(n_model: Optional[int] = None) -> jax.sharding.Mesh:
    """Multi-host 2D mesh laid out for the interconnect hierarchy.

    The sample axis varies ACROSS processes (hosts) and the model axis
    stays WITHIN one process's local devices.  Monte Carlo sampling only
    communicates on the sample axis once, in the final psum of the small
    sum arrays -- cheap even over the network between hosts (DCN) --
    while an internally-distributed model (the reference's nested-MPI
    pattern, blue_models.py:121-130) does per-sample collectives on the
    model axis, which this layout keeps among one host's devices (on an
    H100 host, NVLink peers all to all).  This is BASELINE config 5's
    mesh: call
    ``initialize_distributed`` on every process, then build this mesh
    and pass it as ``params["mesh"]``.

    ``n_model``: devices per model instance (must divide the local device
    count; default all local devices, i.e. one model instance per
    process).  With ``n_model=1`` the model axis is dropped and the
    result is a 1D cross-process sample mesh.
    """
    procs = jax.process_count()
    local = jax.local_device_count()
    if n_model is None:
        n_model = local
    n_model = int(n_model)
    if n_model < 1 or local % n_model:
        raise ValueError(
            "n_model=%d must divide the local device count %d so a model "
            "instance never straddles a host boundary" % (n_model, local))
    # order globally by (process, per-process position) so each mesh row
    # (model axis) is one process's contiguous devices
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    rows = procs * (local // n_model)
    if n_model == 1:
        return _warm_mesh_cliques(
            jax.sharding.Mesh(np.array(devs), (SAMPLE_AXIS,)))
    arr = np.array(devs).reshape(rows, n_model)
    return _warm_mesh_cliques(
        jax.sharding.Mesh(arr, (SAMPLE_AXIS, MODEL_AXIS)))
