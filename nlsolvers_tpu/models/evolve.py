"""Trajectory engine: a whole run is ONE jitted scan.

The reference's drivers loop in C++ with per-step kernel launches and stream
snapshots to the host (nlse_dev.hpp:323-334); here the outer scan over
snapshot intervals and the inner fori_loop over steps compile into a single
XLA program, and the snapshot stack comes back as one device array.

Snapshot cadence parity (e.g. host/drivers/kg_driver.cpp:105-121): snapshot 0
is the initial condition; snapshot k is the state after k*snapshot_freq steps,
k = 1..num_snapshots-1. The reference computes nt-1 steps but discards the
trailing (nt - (num_snapshots-1)*freq - 1) of them — we simply don't run them.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["evolve", "evolve_guarded", "simulate"]


def evolve(step_fn, state0, num_snapshots, snapshot_freq, observe=None):
    """Run (num_snapshots-1) * snapshot_freq steps, recording snapshots.

    Args:
      step_fn: (state, step_index) -> state; step_index counts from 1 as in the
        reference drivers (used e.g. for stochastic noise keys and the sEWI
        bootstrap on step 1).
      state0: initial solver state (any pytree).
      observe: state -> snapshot pytree; defaults to identity.

    Returns:
      Snapshot pytree with a leading axis of length num_snapshots; entry 0 is
      observe(state0).
    """
    if observe is None:
        observe = lambda s: s

    def outer(carry, _):
        state, idx = carry

        def inner(i, st):
            return step_fn(st, idx + i)

        state = lax.fori_loop(0, snapshot_freq, inner, state)
        return (state, idx + snapshot_freq), observe(state)

    (_, _), snaps = lax.scan(outer, (state0, 1),
                             None, length=num_snapshots - 1)
    first = jax.tree.map(lambda x: jnp.asarray(x)[None], observe(state0))
    return jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                        first, snaps)


def evolve_guarded(step_fn, state0, num_snapshots, snapshot_freq,
                   observe=None, batched=False, scalars=None,
                   finite_reduce=None):
    """evolve() with an in-loop stability guard + optional on-generation
    scalar series — the equivalent of the reference's gen-2 on-device
    NaN-check and energy kernels (device/sg_solver_dev.hpp:7-90).

    Every snapshot is finiteness-checked ON DEVICE inside the jitted loop;
    the trajectory is a lax.while_loop over snapshot intervals that EXITS
    EARLY once every batch lane has gone non-finite, so a diverging run
    stops at its first bad snapshot instead of burning all nt steps
    (a single-lane run bails immediately; in a vmapped batch, lanes run in
    lockstep, so compute is saved only when the whole batch is dead — the
    SIMD reality of the hardware).

    Args:
      batched: when True, leading axis of each observed leaf is the batch;
        finiteness reduces over the trailing axes only.
      scalars: optional {name: fn(state) -> scalar-per-lane} recorded at
        every snapshot (entry 0 = the IC), e.g. mass/energy during
        generation.
      finite_reduce: optional reducer applied to the per-lane finiteness
        bits before they drive the early exit. Under shard_map this MUST
        all-reduce across the spatial mesh (psum the bad bits) — a
        shard-local verdict would give shards different while_loop trip
        counts and deadlock the halo collectives inside the step.

    Returns:
      (snaps, bad_at, series): snaps as in evolve() — snapshots past the
      early exit are zero-filled; bad_at int32 (per lane) = index of the
      first non-finite snapshot, num_snapshots if the run stayed finite;
      series {name: (num_snapshots,) + lane shape}.
    """
    if observe is None:
        observe = lambda s: s
    scalars = scalars or {}
    S = num_snapshots

    def finite_of(snap):
        leaves = jax.tree.leaves(snap)

        def red(x):
            fin = jnp.isfinite(x) if jnp.issubdtype(x.dtype, jnp.inexact) \
                else jnp.ones(x.shape, bool)
            return jnp.all(fin, axis=tuple(range(1, x.ndim)) if batched
                           else None)

        ok = red(leaves[0])
        for leaf in leaves[1:]:
            ok = ok & red(leaf)
        if finite_reduce is not None:
            ok = finite_reduce(ok)
        return ok                       # (B,) bool, or scalar bool

    snap0 = observe(state0)
    bufs = jax.tree.map(
        lambda x: jnp.zeros((S,) + jnp.shape(x), jnp.asarray(x).dtype)
        .at[0].set(x), snap0)
    series = {k: fn(state0) for k, fn in scalars.items()}
    series = {k: jnp.zeros((S,) + jnp.shape(v), jnp.asarray(v).dtype)
              .at[0].set(v) for k, v in series.items()}
    ok0 = finite_of(snap0)
    bad0 = jnp.where(ok0, jnp.int32(S), jnp.int32(0))

    def cond(carry):
        s, _, ok, _, _, _ = carry
        return (s < S) & jnp.any(ok)

    def body(carry):
        s, state, ok, bad_at, bufs, series = carry
        # step-index cadence identical to evolve(): snapshot s is the state
        # after s * snapshot_freq steps, indices counting from 1
        idx0 = (s - 1) * snapshot_freq + 1

        def inner(i, st):
            return step_fn(st, idx0 + i)

        state = lax.fori_loop(0, snapshot_freq, inner, state)
        snap = observe(state)
        bufs = jax.tree.map(lambda b, x: b.at[s].set(x), bufs, snap)
        series = {k: series[k].at[s].set(scalars[k](state)) for k in series}
        fin = finite_of(snap)
        bad_at = jnp.where(ok & ~fin, s.astype(jnp.int32), bad_at)
        return (s + 1, state, ok & fin, bad_at, bufs, series)

    carry = (jnp.int32(1), state0, ok0, bad0, bufs, series)
    _, _, _, bad_at, bufs, series = lax.while_loop(cond, body, carry)
    return bufs, bad_at, series


@partial(jax.jit, static_argnums=(0, 2, 3, 4))
def simulate(step_fn, state0, num_snapshots, snapshot_freq, observe=None):
    """Jitted evolve; step_fn/observe must be hashable (e.g. module functions
    or functools.partial closures built once)."""
    return evolve(step_fn, state0, num_snapshots, snapshot_freq, observe)
