"""High-level problem builders: equation + integrator -> jittable step closures.

This is the layer the datagen pipeline drives. It replaces the reference's ~40
C++ driver main()s (host/drivers/*.cpp, device/drivers/*.cpp): where the
reference spawns one subprocess per trajectory with argv + .npy files, a
Problem here is a pair of pure functions (init, step) that compile into a
single XLA program via models/evolve.py, and batch via vmap.

Grid conventions follow the drivers exactly: a grid of nx points spans
[-Lx, Lx] with dx = 2 Lx/(nx-1) (e.g. nlse_cubic_driver.cpp:46-47), dt = T/nt,
and the no-flux ghost ring is part of the nx x ny field with the Neumann copy
applied after every step.
"""

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nlsolvers_tpu.config import (default_complex_dtype, default_krylov_m,
                                  default_real_dtype, real_dtype_of)
from nlsolvers_tpu.models import boussinesq as bq
from nlsolvers_tpu.models import nlse as nlse_mod
from nlsolvers_tpu.models import realwave as rw
from nlsolvers_tpu.models.evolve import evolve
from nlsolvers_tpu.models.nonlinearities import (NLSE_KINDS, REALWAVE_KINDS,
                                                 nlse_density, realwave_g)
from nlsolvers_tpu.ops import boundaries as bcs
from nlsolvers_tpu.ops import operators as ops
from nlsolvers_tpu.utils.complexio import unpack_complex

__all__ = ["Problem", "nlse_problem", "realwave_problem",
           "stochastic_phi4_problem", "boussinesq_problem", "run"]


@dataclass(frozen=True)
class Problem:
    """A fully-specified evolution problem.

    step:    (state, step_index) -> state (pure, jittable)
    init:    builds the initial state from fields (u0 [, v0])
    observe: state -> snapshot pytree
    meta:    static description (equation, integrator, grid, dt, ...)
    """
    step: Callable
    init: Callable
    observe: Callable
    meta: dict


def run(problem, state0, num_snapshots, snapshot_freq, jit=True):
    """Evolve and return the observed snapshot stack (index 0 = initial)."""
    fn = partial(evolve, problem.step, observe=problem.observe)
    if jit:
        fn = jax.jit(fn, static_argnums=(1, 2))
    return fn(state0, num_snapshots, snapshot_freq)


def _nlse_operator(shape, dx, dy, c_field, variant, rdtype):
    if variant == "separated":
        # the per-direction pair (laplacians.hpp:220-269) applied as
        # Lx u + Ly u — sums EXACTLY to the full 2D no-flux operator incl.
        # its -3 corner diagonal (-1.5 + -1.5), which is where that quirk
        # comes from. Exposed for dimension-split integrator experiments.
        if c_field is not None or len(shape) != 2:
            raise ValueError("variant='separated' is 2D isotropic only")
        apply_x, apply_y = ops.separated_laplacian_2d(shape, dx, dy,
                                                      dtype=rdtype)
        return lambda u: apply_x(u) + apply_y(u)
    if c_field is not None:
        if len(shape) == 2:
            return ops.anisotropic_laplacian_2d(c_field, dx, dy)
        return ops.anisotropic_laplacian_3d(c_field, dx,
                                            variant=variant)
    if len(shape) == 2:
        return ops.laplacian_2d(shape, dx, dy, variant=variant, dtype=rdtype)
    return ops.laplacian_3d(shape, dx, variant=variant, dtype=rdtype)


def _neumann(shape):
    return (bcs.neumann_no_velocity_2d if len(shape) == 2
            else bcs.neumann_no_velocity_3d)


def _init_field(u0, shape, dtype):
    """Initial field on the device in `dtype`, from host numpy or a device
    array. Complex problems also take the packed (2, *shape) real (re, im)
    stack of utils/complexio.pack_complex."""
    if (np.issubdtype(dtype, np.complexfloating) and not np.iscomplexobj(u0)
            and np.shape(u0) == (2,) + tuple(shape)):
        return unpack_complex(jnp.asarray(u0, real_dtype_of(dtype))
                              ).astype(dtype)
    return jnp.asarray(u0, dtype)


def nlse_problem(kind, shape, Lx, dt, *, m_field=None, c_field=None,
                 sigma1=1.0, sigma2=-0.1, kappa=1.0, integrator="ss2",
                 krylov_m=None, dtype=default_complex_dtype,
                 variant="reference", apply_bc=True, reorth=True,
                 bc="noflux"):
    """NLSE family: i u_t + div(c grad u) + rho_kind(u) u = 0.

    kind in {"cubic", "cubic_quintic", "saturable"}; integrator in
    {"ss2", "sewi", "sewi_fused", "gautschi"}. `shape` is the full grid
    (ny, nx) or (nz, ny, nx); the domain is [-Lx, Lx]^d.

    bc: "noflux" (reference production BC), "radiating" (experimental
    radiating envelope, boundaries.hpp:59-121, 2D only), or "none".
    apply_bc=False is the legacy spelling of bc="none".

    variant additionally accepts "separated": the per-direction (Lx, Ly)
    pair (laplacians.hpp:220-269) applied as Lx u + Ly u — identical matrix
    to the full 2D no-flux operator.

    Parity: m_field defaults to ZERO like the reference NLSE drivers
    (nlse_cubic_driver.cpp:64: m = VectorXd::Zero unless an m file is given),
    i.e. linear Schroedinger unless m is supplied. Krylov m defaults: 20 for
    2D (nlse_cubic_driver_2d.cpp:105), 10 for 3D.
    """
    assert kind in NLSE_KINDS
    assert bc in ("noflux", "radiating", "none")
    rdtype = real_dtype_of(dtype)
    dim = len(shape)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    if krylov_m is None:
        krylov_m = {"cubic": 20, "cubic_quintic": 15,
                    "saturable": 15}[kind] if dim == 2 else 10
    if m_field is None:
        m_field = np.zeros(shape, rdtype)
    m_field = np.asarray(m_field, rdtype)
    if not apply_bc:
        bc = "none"

    lap = _nlse_operator(shape, dx, dx, c_field, variant, rdtype)
    rho = nlse_density(kind, m_field, sigma1=sigma1, sigma2=sigma2, kappa=kappa)
    if bc == "radiating":
        if dim != 2:
            raise ValueError("radiating BC is 2D only (boundaries.hpp:59)")
        neumann = lambda u: bcs.radiating_nlse_2d(u, m_field, dx, dx)
    elif bc == "noflux":
        neumann = _neumann(shape)
    else:
        neumann = lambda u: u

    def init_field(u0):
        return _init_field(u0, shape, dtype)

    if integrator == "ss2":
        def step(state, i):
            del i
            u = nlse_mod.ss2_step(state, lap, rho, dt, m=krylov_m,
                                  reorth=reorth)
            return neumann(u)

        init = init_field
        observe = lambda s: s

    elif integrator in ("sewi", "sewi_fused", "gautschi"):
        # "sewi_fused" applies exp(i dt L) sinc(dt L) as one matrix function
        # (2 Lanczos/step instead of 3; see models/nlse.sewi_step).
        if integrator == "sewi":
            two_step = nlse_mod.sewi_step
        elif integrator == "sewi_fused":
            two_step = partial(nlse_mod.sewi_step, fuse_exp_sinc=True)
        else:
            two_step = nlse_mod.gautschi_step

        def step(state, i):
            u, u_prev = state

            def boot(_):
                return nlse_mod.sewi_first_step(u, lap, rho, dt, m=krylov_m,
                                                reorth=reorth)

            def normal(_):
                return two_step(u, u_prev, lap, rho, dt, m=krylov_m,
                                reorth=reorth)

            u_new, u_prev_new = lax.cond(i == 1, boot, normal, None)
            return neumann(u_new), u_prev_new

        def init(u0):
            u0 = init_field(u0)
            return (u0, u0)

        observe = lambda s: s[0]
    else:
        raise ValueError(f"unknown NLSE integrator {integrator!r}")

    meta = dict(equation=f"nlse_{kind}", integrator=integrator, shape=shape,
                Lx=Lx, dx=dx, dt=dt, krylov_m=krylov_m, dim=dim, bc=bc,
                variant=variant,
                params=dict(sigma1=sigma1, sigma2=sigma2, kappa=kappa))
    return Problem(step, init, observe, meta)


def realwave_problem(kind, shape, Lx, dt, *, m_field=None, c_field=None,
                     integrator="gautschi", krylov_m=default_krylov_m,
                     dtype=default_real_dtype, variant="reference",
                     apply_bc=True, reorth=True):
    """Real-wave family: u_tt = div(c grad u) - m g_kind(u).

    kind in {"sine_gordon", "double_sine_gordon", "hyperbolic_sine_gordon",
    "klein_gordon", "phi4"}; integrator in {"gautschi", "sv"}.
    State is (u, u_past); init takes (u0, v0) with u_past = u0 - dt v0
    (kg_driver.cpp:71). Observed snapshot is (u, v) with v = (u - u_past)/dt
    (kg_driver.cpp:112).
    """
    assert kind in REALWAVE_KINDS
    rdtype = real_dtype_of(dtype)
    dim = len(shape)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    if m_field is None:
        m_field = np.ones(shape, rdtype)
    m_field = np.asarray(m_field, rdtype)
    g = realwave_g(kind)

    lap = _nlse_operator(shape, dx, dx, c_field, variant, rdtype)
    # Gautschi needs L = Omega^2; all reference matfuncs use |lambda| so the
    # sign is immaterial (see ops/krylov.py docstring) — we pass -Lap (PSD).
    omega2 = lambda u: -lap(u)
    neumann = _neumann(shape) if apply_bc else (lambda u: u)
    filter_func = "mod_cosine" if kind == "sine_gordon" else "id_sqrt"

    if integrator == "gautschi":
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = rw.gautschi_step(
                u, u_past, omega2, m_field, g, dt, m=krylov_m,
                filter_func=filter_func, reorth=reorth)
            return neumann(u_new), u_past_new
    elif integrator == "sv":
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = rw.sv_step(u, u_past, lap, m_field, g, dt)
            return neumann(u_new), u_past_new
    else:
        raise ValueError(f"unknown real-wave integrator {integrator!r}")

    def init(u0, v0=None):
        u0 = jnp.asarray(u0, dtype)
        if v0 is None:
            v0 = jnp.zeros_like(u0)
        return (u0, u0 - dt * jnp.asarray(v0, dtype))

    def observe(state):
        u, u_past = state
        return u, (u - u_past) / dt

    meta = dict(equation=kind, integrator=integrator, shape=shape, Lx=Lx,
                dx=dx, dt=dt, krylov_m=krylov_m, dim=dim,
                filter=filter_func)
    return Problem(step, init, observe, meta)


def stochastic_phi4_problem(shape, Lx, dt, *, m_field=None,
                            noise_strength=0.1, seed=0,
                            dtype=default_real_dtype, variant="reference",
                            apply_bc=True):
    """Stochastic phi-4 with SV stepping (device SP4Solver parity).

    Counter-based noise: the per-step key is fold_in(seed_key, step_index), so
    trajectories are reproducible — unlike the reference's time(nullptr)+idx
    seeding (stochastic_phi4.cuh:27).
    """
    rdtype = real_dtype_of(dtype)
    dim = len(shape)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    if m_field is None:
        m_field = np.ones(shape, rdtype)
    m_field = np.asarray(m_field, rdtype)
    lap = _nlse_operator(shape, dx, dx, None, variant, rdtype)
    neumann = _neumann(shape) if apply_bc else (lambda u: u)
    base_key = jax.random.PRNGKey(seed)

    def step(state, i):
        u, u_past = state
        key = jax.random.fold_in(base_key, i)
        u_new, u_past_new = rw.stochastic_sv_step(
            u, u_past, key, lap, m_field, dt, noise_strength)
        return neumann(u_new), u_past_new

    def init(u0, v0=None):
        u0 = jnp.asarray(u0, dtype)
        if v0 is None:
            v0 = jnp.zeros_like(u0)
        return (u0, u0 - dt * jnp.asarray(v0, dtype))

    def observe(state):
        u, u_past = state
        return u, (u - u_past) / dt

    meta = dict(equation="stochastic_phi4", integrator="sv", shape=shape,
                Lx=Lx, dx=dx, dt=dt, dim=dim,
                noise_strength=noise_strength, seed=seed)
    return Problem(step, init, observe, meta)


def boussinesq_problem(shape, Lx, dt, *, integrator="gautschi",
                       krylov_m=default_krylov_m, dtype=default_real_dtype,
                       variant="reference", apply_bc=True, reorth=True):
    """Boussinesq: u_tt - Lap u + 3 (u^2)_xx - u_xxxx = 0 (gen-1 capability)."""
    rdtype = real_dtype_of(dtype)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    omega2 = bq.boussinesq_omega2(shape, dx, dtype=rdtype, variant=variant)
    neumann = _neumann(shape) if apply_bc else (lambda u: u)

    if integrator == "gautschi":
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = bq.gautschi_step(u, u_past, omega2, dx, dt,
                                                 m=krylov_m, reorth=reorth)
            return neumann(u_new), u_past_new
    elif integrator == "sv":
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = bq.stiff_sv_step(u, u_past, omega2, dx, dt)
            return neumann(u_new), u_past_new
    else:
        raise ValueError(f"unknown Boussinesq integrator {integrator!r}")

    def init(u0, v0=None):
        u0 = jnp.asarray(u0, dtype)
        if v0 is None:
            v0 = jnp.zeros_like(u0)
        return (u0, u0 - dt * jnp.asarray(v0, dtype))

    def observe(state):
        u, u_past = state
        return u, (u - u_past) / dt

    meta = dict(equation="boussinesq", integrator=integrator, shape=shape,
                Lx=Lx, dx=dx, dt=dt, krylov_m=krylov_m, dim=len(shape))
    return Problem(step, init, observe, meta)
