"""Batched trajectory engine: one compiled program for a whole datagen sweep.

The reference generates each trajectory in its own subprocess (one GPU, one
binary invocation per run — finalized_scripts/complex_launcher_2d.py:145-166),
re-reading the operator and re-allocating device buffers every time. Here the
per-trajectory coefficient fields m(x) and c(x) are *traced arguments* of a
single jitted scan, so:

  * one XLA compilation serves every run in the sweep (fields change, the
    program does not);
  * a batch of trajectories evolves as one vmapped program, sharded over the
    mesh's batch axis across devices (the replacement for the reference's
    SLURM-array / mpi4py farms, SURVEY.md section 2.6);
  * complex state enters and leaves packed as stacked (real, imag) pairs
    (utils/complexio.py), the archive layout datagen reads back.

Trajectory functions return snapshot stacks shaped (B, S, ...) where entry
s=0 is the initial condition, matching the drivers' snapshot cadence
(models/evolve.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from nlsolvers_tpu.config import real_dtype_of
from nlsolvers_tpu.models import nlse as nlse_mod
from nlsolvers_tpu.models import realwave as rw
from nlsolvers_tpu.models.evolve import evolve, evolve_guarded
from nlsolvers_tpu.models.nonlinearities import (NLSE_KINDS, REALWAVE_KINDS,
                                                 nlse_density, realwave_g,
                                                 realwave_potential)
from nlsolvers_tpu.ops import boundaries as bc
from nlsolvers_tpu.ops import operators as ops
from nlsolvers_tpu.parallel.batch import shard_batch

__all__ = ["make_nlse_trajectory_fn", "make_realwave_trajectory_fn"]


def _lap_builder(shape, dx, variant, rdtype):
    """Returns lap_of(c): per-sample Laplacian closure; c may be a tracer."""
    dim = len(shape)

    def lap_of(c):
        if c is None:
            if dim == 2:
                return ops.laplacian_2d(shape, dx, dx, variant=variant,
                                        dtype=rdtype)
            return ops.laplacian_3d(shape, dx, variant=variant, dtype=rdtype)
        if dim == 2:
            return ops.anisotropic_laplacian_2d(c, dx, dx)
        return ops.anisotropic_laplacian_3d(c, dx, variant=variant)

    return lap_of


def _neumann(shape, apply_bc):
    if not apply_bc:
        return lambda u: u
    return (bc.neumann_no_velocity_2d if len(shape) == 2
            else bc.neumann_no_velocity_3d)


def _vmap_fields(single, has_c):
    """vmap (state, m[, c]) with the step index broadcast."""
    if has_c:
        return jax.vmap(single, in_axes=(0, None, 0, 0))
    return jax.vmap(lambda st, i, m: single(st, i, m, None),
                    in_axes=(0, None, 0))


def make_nlse_trajectory_fn(kind, shape, Lx, dt, *, integrator="ss2",
                            krylov_m=10, sigma1=1.0, sigma2=-0.1, kappa=1.0,
                            dtype=jnp.complex64, variant="reference",
                            apply_bc=True, reorth=True, use_c=True,
                            mesh=None, batch_axis="batch", guard=False,
                            record_energy=False, boundary="noflux"):
    """Builds traj(u0_packed, m, c, num_snapshots, snapshot_freq).

    u0_packed: (B, 2, *shape) real — stacked (real, imag) per trajectory.
    m, c:      (B, *shape) real coefficient fields (c ignored if use_c=False).
    Returns    (B, S, 2, *shape) real — packed complex snapshot stacks.

    With guard=True the loop carries the in-loop stability guard
    (models/evolve.evolve_guarded): returns (snaps, bad_at[, series]) where
    bad_at is (B,) int32 (= S when the lane stayed finite) and, with
    record_energy=True, series = {"mass": (B, S)} recorded on device during
    generation (mass = sum |u|^2 dV — the conserved NLSE invariant; gen-2
    reference analogue: device/sg_solver_dev.hpp:7-90).

    The returned function is jitted once; every datagen run in a sweep reuses
    the same executable. With a mesh, inputs are sharded over `batch_axis`.
    """
    assert kind in NLSE_KINDS
    assert boundary in ("noflux", "radiating", "none")
    rdtype = real_dtype_of(dtype)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    lap_of = _lap_builder(shape, dx, variant, rdtype)
    if boundary == "radiating":
        if len(shape) != 2:
            raise ValueError("radiating BC is 2D only (boundaries.hpp:59)")
        apply_boundary = lambda u, m_f: bc.radiating_nlse_2d(u, m_f, dx, dx)
    else:
        fixed = _neumann(shape, apply_bc and boundary == "noflux")
        apply_boundary = lambda u, m_f: fixed(u)
    two_state = integrator in ("sewi", "sewi_fused", "gautschi")

    def single_step(state, i, m_f, c_f):
        lap = lap_of(c_f)
        rho = nlse_density(kind, m_f, sigma1=sigma1, sigma2=sigma2,
                           kappa=kappa)
        if integrator == "ss2":
            u = nlse_mod.ss2_step(state, lap, rho, dt, m=krylov_m,
                                  reorth=reorth)
            return apply_boundary(u, m_f)
        if integrator == "sewi":
            two_step = nlse_mod.sewi_step
        elif integrator == "sewi_fused":
            two_step = partial(nlse_mod.sewi_step, fuse_exp_sinc=True)
        else:
            two_step = nlse_mod.gautschi_step
        u, u_prev = state

        def boot(_):
            return nlse_mod.sewi_first_step(u, lap, rho, dt, m=krylov_m,
                                            reorth=reorth)

        def normal(_):
            return two_step(u, u_prev, lap, rho, dt, m=krylov_m,
                            reorth=reorth)

        u_new, u_prev_new = lax.cond(i == 1, boot, normal, None)
        return apply_boundary(u_new, m_f), u_prev_new

    vstep = _vmap_fields(single_step, use_c)

    dV = dx ** len(shape)
    spatial_axes = tuple(range(1, len(shape) + 1))

    def mass_of(state):
        u = state[0] if two_state else state
        return jnp.sum(jnp.abs(u) ** 2, axis=spatial_axes) * dV   # (B,)

    @partial(jax.jit, static_argnums=(3, 4))
    def traj(u0_packed, m, c, num_snapshots, snapshot_freq):
        u0 = lax.complex(u0_packed[:, 0].astype(rdtype),
                         u0_packed[:, 1].astype(rdtype))
        state0 = (u0, u0) if two_state else u0
        observe = (lambda s: s[0]) if two_state else (lambda s: s)

        if use_c:
            step = lambda st, i: vstep(st, i, m, c)
        else:
            step = lambda st, i: vstep(st, i, m)

        def pack(snaps):
            snaps = jnp.moveaxis(snaps, 0, 1)              # (B, S, *shape)
            return jnp.stack([jnp.real(snaps), jnp.imag(snaps)], axis=2)

        if not guard:
            snaps = evolve(step, state0, num_snapshots, snapshot_freq,
                           observe=observe)                # (S, B, *shape)
            return pack(snaps)
        scalars = {"mass": mass_of} if record_energy else None
        snaps, bad_at, series = evolve_guarded(
            step, state0, num_snapshots, snapshot_freq, observe=observe,
            batched=True, scalars=scalars)
        series = {k: jnp.moveaxis(v, 0, 1) for k, v in series.items()}
        return (pack(snaps), bad_at) + ((series,) if record_energy else ())

    if mesh is None:
        return traj

    def sharded(u0_packed, m, c, num_snapshots, snapshot_freq):
        args = (u0_packed, m) + ((c,) if use_c and c is not None else ())
        placed = shard_batch(args, mesh, batch_axis)
        if use_c and c is not None:
            u0_packed, m, c = placed
        else:
            u0_packed, m = placed
        return traj(u0_packed, m, c, num_snapshots, snapshot_freq)

    return sharded


def make_realwave_trajectory_fn(kind, shape, Lx, dt, *, integrator="gautschi",
                                krylov_m=10, noise_strength=0.0, seed=0,
                                dtype=jnp.float32, variant="reference",
                                apply_bc=True, reorth=True, use_c=True,
                                mesh=None, batch_axis="batch", guard=False,
                                record_energy=False):
    """Builds traj(u0, v0, m, c, num_snapshots, snapshot_freq).

    u0, v0, m, c: (B, *shape) real. Returns (u_traj, v_traj), each
    (B, S, *shape): the field and its finite-difference velocity
    v = (u - u_past)/dt (kg_driver.cpp:112).

    guard=True appends bad_at (B,) int32 to the return (early-exit stability
    guard, models/evolve.evolve_guarded); record_energy=True additionally
    appends {"energy": (B, S)} — the discrete conserved energy
    (kinetic + gradient + potential, the on-device analogue of
    analysis/energy.energy_terms) recorded during generation.

    kind may additionally be "stochastic_phi4": Stoermer-Verlet with
    counter-based per-(sample, step) noise keys — reproducible, unlike the
    reference's time(nullptr)+idx seeding (stochastic_phi4.cuh:27).
    """
    stochastic = kind == "stochastic_phi4"
    if not stochastic:
        assert kind in REALWAVE_KINDS
    rdtype = real_dtype_of(dtype)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    lap_of = _lap_builder(shape, dx, variant, rdtype)
    neumann = _neumann(shape, apply_bc)
    if not stochastic:
        g = realwave_g(kind)
        filter_func = "mod_cosine" if kind == "sine_gordon" else "id_sqrt"
    base_key = jax.random.PRNGKey(seed)

    def single_step(state, i, m_f, c_f, key=None):
        lap = lap_of(c_f)
        u, u_past = state
        if stochastic:
            u_new, u_past_new = rw.stochastic_sv_step(
                u, u_past, key, lap, m_f, dt, noise_strength)
        elif integrator == "gautschi":
            omega2 = lambda w: -lap(w)
            u_new, u_past_new = rw.gautschi_step(
                u, u_past, omega2, m_f, g, dt, m=krylov_m,
                filter_func=filter_func, reorth=reorth)
        else:
            u_new, u_past_new = rw.sv_step(u, u_past, lap, m_f, g, dt)
        return neumann(u_new), u_past_new

    if stochastic:
        if use_c:
            vstep = jax.vmap(single_step, in_axes=(0, None, 0, 0, 0))
        else:
            vstep = jax.vmap(lambda st, i, m, k: single_step(st, i, m, None,
                                                             k),
                             in_axes=(0, None, 0, 0))
    else:
        vstep = _vmap_fields(single_step, use_c)

    dV = dx ** len(shape)
    spatial_axes = tuple(range(1, len(shape) + 1))
    potential_density = realwave_potential(kind)

    def energy_of(state):
        u, u_past = state
        v = (u - u_past) / dt
        grad2 = sum(jnp.gradient(u, dx, axis=a) ** 2 for a in spatial_axes)
        dens = (0.5 * v ** 2 + 0.5 * grad2 + potential_density(u))
        return jnp.sum(dens, axis=spatial_axes) * dV       # (B,)

    @partial(jax.jit, static_argnums=(4, 5))
    def traj(u0, v0, m, c, num_snapshots, snapshot_freq):
        u0 = jnp.asarray(u0, rdtype)
        v0 = jnp.asarray(v0, rdtype)
        state0 = (u0, u0 - dt * v0)        # u_past = u0 - dt v0

        def step(st, i):
            if stochastic:
                B = u0.shape[0]
                keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                    jax.random.fold_in(base_key, i), jnp.arange(B))
                if use_c:
                    return vstep(st, i, m, c, keys)
                return vstep(st, i, m, keys)
            if use_c:
                return vstep(st, i, m, c)
            return vstep(st, i, m)

        def observe(st):
            u, u_past = st
            return u, (u - u_past) / dt

        if not guard:
            u_s, v_s = evolve(step, state0, num_snapshots, snapshot_freq,
                              observe=observe)             # (S, B, *shape)
            return jnp.moveaxis(u_s, 0, 1), jnp.moveaxis(v_s, 0, 1)
        scalars = {"energy": energy_of} if record_energy else None
        (u_s, v_s), bad_at, series = evolve_guarded(
            step, state0, num_snapshots, snapshot_freq, observe=observe,
            batched=True, scalars=scalars)
        series = {k: jnp.moveaxis(v, 0, 1) for k, v in series.items()}
        out = (jnp.moveaxis(u_s, 0, 1), jnp.moveaxis(v_s, 0, 1), bad_at)
        return out + ((series,) if record_energy else ())

    if mesh is None:
        return traj

    def sharded(u0, v0, m, c, num_snapshots, snapshot_freq):
        args = (u0, v0, m) + ((c,) if use_c and c is not None else ())
        placed = shard_batch(args, mesh, batch_axis)
        if use_c and c is not None:
            u0, v0, m, c = placed
        else:
            u0, v0, m = placed
        return traj(u0, v0, m, c, num_snapshots, snapshot_freq)

    return sharded
