"""Multi-host runtime: a jax.distributed process group replaces the MPI farm.

Reference analogue (SURVEY.md §3.4): trajectories are farmed over hosts with
mpi4py — rank 0 mkdirs + bcasts a run id, every rank samples its own ICs,
launches one binary per trajectory, and walltimes are gathered back
(/root/reference/device/submit_nlse.py:80-137); SLURM job arrays do the same
at coarser grain (finalized_scripts/nlse_2d_launch.sh:12-68).

Replacement: ONE SPMD process group. `jax.distributed.initialize` joins
every process into a single JAX runtime whose global device list spans all
cards; the datagen batch axis is sharded over a global mesh, each process
samples only the runs that land on its own cards
(`jax.make_array_from_process_local_data`), the jitted trajectory
program runs collectively, and each host archives only its addressable output
shards — per-host HDF5 writing with zero cross-host data motion.

The same code path doubles as a LOCAL multi-process CPU cluster for testing
(coordinator on localhost, JAX_PLATFORMS=cpu per process) — see
benchmarks/multihost_scaling.py and tests/test_multihost.py.
"""

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize_from_env", "initialize", "global_mesh",
           "make_global_batch", "local_shards", "host_batch_block",
           "process_seed", "ENV_COORD", "ENV_NPROCS", "ENV_PID",
           "ENV_LOCAL_DEVICES"]

ENV_COORD = "NLS_COORDINATOR"
ENV_NPROCS = "NLS_NUM_PROCESSES"
ENV_PID = "NLS_PROCESS_ID"
ENV_LOCAL_DEVICES = "NLS_LOCAL_DEVICES"

_LOOPBACK = ("localhost", "127.0.0.1", "::1", "[::1]")


def initialize(coordinator, num_processes, process_id,
               local_device_ids=None, platform=None):
    """Join this process into a jax.distributed group.

    Must run before any other JAX call creates a backend. The explicit form
    is for clusters without a resource manager JAX recognizes, and for the
    local multi-process CPU simulation used in tests (platform="cpu").

    `local_device_ids` are the ids of the cards this process drives on its
    host. Left out, a group whose coordinator is a loopback address (every
    process on one host) gives process i card i, and any other group lets
    each process open all of its host's cards (one process per host). A
    process that opened every card of a shared host would reserve most of
    each card's memory for itself and leave the others none.
    """
    if platform:
        # must land before backend init; the CPU proxy workers pin
        # themselves to the CPU here so they never open a card
        jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        # cross-process CPU collectives need an explicit transport; gloo is
        # bundled with jaxlib.
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    elif local_device_ids is None and \
            coordinator.rsplit(":", 1)[0] in _LOOPBACK:
        local_device_ids = [int(process_id)]
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=int(num_processes),
                               process_id=int(process_id),
                               local_device_ids=local_device_ids)


def initialize_from_env():
    """Initialize from NLS_* env vars if present; no-op otherwise.

    Returns True when a multi-process group was joined. Set
        NLS_COORDINATOR=host:port  NLS_NUM_PROCESSES=N  NLS_PROCESS_ID=i
    (the launcher in benchmarks/multihost_scaling.py does this), and
    NLS_LOCAL_DEVICES=j[,k...] to name this process's cards on its host
    (`initialize`'s local_device_ids), or rely on your resource manager +
    a bare `jax.distributed.initialize()`.
    """
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    cards = os.environ.get(ENV_LOCAL_DEVICES)
    initialize(coord, os.environ[ENV_NPROCS], os.environ[ENV_PID],
               local_device_ids=([int(c) for c in cards.split(",")]
                                 if cards else None),
               platform=os.environ.get("JAX_PLATFORMS") or None)
    return True


def global_mesh(axis_names=("batch",), shape=None):
    """Mesh over ALL global devices (every process must build the same mesh).

    Default: one flat batch axis across hosts — the reference farm's
    parallelism structure. jax.devices() in a process group enumerates every
    host's devices in process order, so the batch axis naturally maps
    host-major: contiguous batch blocks live on one host and the trajectory
    program needs no DCN traffic at all (like the MPI farm, but one program).
    """
    devices = jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def make_global_batch(mesh, local_data, batch_axis="batch"):
    """Assemble a global batch-sharded jax.Array from per-process data.

    `local_data` is this process's (B_local, ...) block; every process calls
    this collectively and the result is a global (B_local * nprocs, ...)
    array sharded over `batch_axis`. Single-process: a plain device_put.
    """
    local_data = np.asarray(local_data)
    spec = P(batch_axis, *([None] * (local_data.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local_data, sharding)
    return jax.make_array_from_process_local_data(sharding, local_data)


def local_shards(arr, axis=0):
    """This process's shards of a global array as host numpy blocks.

    Returns a list of (global_start, block) sorted by position along `axis`;
    concatenating the blocks gives this host's contiguous data when the batch
    axis is host-major (global_mesh default). This is the per-host fetch for
    archiving: no collective, no cross-host transfer.
    """
    out = []
    for s in arr.addressable_shards:
        idx = s.index[axis]
        start = idx.start or 0
        out.append((start, np.asarray(s.data)))
    out.sort(key=lambda t: t[0])
    return out


def host_batch_block(arr, nproc, pid):
    """This host's host-major (b_local, ...) block of a global array whose
    axis 0 (batch) is sharded host-major and whose REMAINING axes may also
    be sharded over this host's local devices (grid sharding: the datagen
    --shard-grid x multi-host path). Assembles the spatial fragments of
    each batch row from the addressable shards' global indices — the
    grid-sharded generalization of local_shards(). No collective, no
    cross-host transfer.

    Returns (block, rows): block (b_local, ...) numpy, rows the global batch
    indices [pid*b_local, (pid+1)*b_local).
    """
    b_local = arr.shape[0] // max(nproc, 1)
    start = pid * b_local
    out = np.empty((b_local,) + tuple(arr.shape[1:]), arr.dtype)
    covered = np.zeros(out.shape, bool)
    for sh in arr.addressable_shards:
        idx = tuple(sh.index)
        bs = idx[0] if idx else slice(None)
        b0 = bs.start or 0
        b1 = arr.shape[0] if bs.stop is None else bs.stop
        lo, hi = max(b0, start), min(b1, start + b_local)
        if lo >= hi:
            continue
        data = np.asarray(sh.data)
        dst = (slice(lo - start, hi - start),) + idx[1:]
        out[dst] = data[lo - b0:hi - b0]
        covered[dst] = True
    if not covered.all():
        raise RuntimeError(
            f"host {pid}: addressable shards do not cover batch rows "
            f"[{start}, {start + b_local}) — non-host-major mesh?")
    return out, np.arange(start, start + b_local)


def process_seed(seed, process_index=None):
    """Per-host RNG seed sequence: SeedSequence(seed).spawn keyed by process.

    The reference seeds each SLURM array task with its job id
    (nlse_2d_launch.sh:68) — independent streams per task, reproducible per
    (seed, task). Same contract here per (seed, process_id).
    """
    pid = jax.process_index() if process_index is None else process_index
    return np.random.SeedSequence(seed).spawn(pid + 1)[pid]
