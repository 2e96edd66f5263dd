"""Trajectory-batch parallelism: vmap over runs, shard the batch axis.

This is the replacement for the reference's embarrassingly-parallel
farms (mpi4py rank-per-trajectory in device/submit_nlse.py:80-137 and SLURM
job arrays in finalized_scripts/nlse_2d_launch.sh): a batch of initial
conditions becomes a leading array axis, `vmap` turns the per-trajectory step
into a batched step, and a NamedSharding over the mesh's "batch" axis spreads
trajectories across devices with zero communication — the same parallelism
structure, one process instead of hundreds.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from nlsolvers_tpu.models.evolve import evolve

__all__ = ["batched_step", "batched_evolve", "shard_batch"]


def batched_step(problem):
    """vmap a Problem's step over a leading batch axis (step index shared)."""
    return jax.vmap(problem.step, in_axes=(0, None))


def shard_batch(tree, mesh, batch_axis="batch"):
    """Place a batched pytree with its leading axis sharded over the mesh."""
    def put(x):
        spec = P(batch_axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)


def batched_evolve(problem, states0, num_snapshots, snapshot_freq,
                   mesh=None, batch_axis="batch", jit=True):
    """Evolve a batch of trajectories; snapshots get shape (B, S, ...).

    `states0` is the batched state pytree (leading axis = trajectory). If a
    mesh is given, inputs are sharded over its batch axis first; XLA keeps the
    whole evolution communication-free across that axis.
    """
    if mesh is not None:
        states0 = shard_batch(states0, mesh, batch_axis)
    step = batched_step(problem)
    observe = jax.vmap(problem.observe)

    fn = partial(evolve, step)
    if jit:
        fn = jax.jit(fn, static_argnums=(1, 2), static_argnames=("observe",))
    snaps = fn(states0, num_snapshots, snapshot_freq, observe=observe)
    # evolve stacks snapshots on axis 0 -> (S, B, ...); put batch first.
    return jax.tree.map(lambda x: jnp.moveaxis(x, 0, 1), snaps)
