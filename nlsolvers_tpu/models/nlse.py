"""NLSE time steppers: SS2 Strang splitting, sEWI, and the comparison Gautschi.

All steppers are pure functions of (state, operator closures); a full
trajectory is one `lax.scan` (see models/evolve.py). tau = i*dt throughout,
matching the reference drivers ("important to propagate this in complex time",
nlse_cubic_solver.hpp:58-59).

Parity map:
  ss2_step      <-> NLSESolver::step (nlse_cubic_solver.hpp:54-74) and the
                    device path NLSESolverDevice::step (nlse_dev.hpp:187-203)
  sewi_step     <-> NLSESolverDevice::step_sewi (nlse_dev.hpp:205-238):
                    u' = exp(2 tau L) u_prev - 2 tau exp(tau L) sinc(dt L) B(u)
  gautschi_step <-> NLSECubicGautschiSolver::step
                    (nlse_cubic_gautschi_solver.hpp:17-40; flagged there as
                    "has issues ... for comparison, not data generation"):
                    u' = exp(-2 tau L) u_prev + 2 tau exp(-tau L) sinc(dt L) B(u)
"""

import jax.numpy as jnp
import numpy as np

from nlsolvers_tpu.ops.krylov import MATFUNCS, expm_apply, matfunc_apply
from nlsolvers_tpu.config import default_krylov_m

__all__ = ["ss2_step", "sewi_step", "gautschi_step", "sewi_first_step",
           "gautschi_phi1_bootstrap"]


def ss2_step(u, lap, rho_fn, dt, m=default_krylov_m, reorth=True,
             axis_names=()):
    """One SS2 Strang step: half nonlinear phase, full linear expm, half phase."""
    tau = np.asarray(1j * dt, u.dtype)   # numpy scalar: safe jit constant
    u = jnp.exp(0.5 * tau * rho_fn(u)) * u
    u = expm_apply(lap, u, tau, m=m, reorth=reorth, axis_names=axis_names)
    u = jnp.exp(0.5 * tau * rho_fn(u)) * u
    return u


def _B(u, rho_fn):
    """sEWI source term B(u) = -rho(u) u (nlse.cuh:71-84)."""
    return -rho_fn(u) * u


def sewi_step(u, u_prev, lap, rho_fn, dt, m=default_krylov_m, reorth=True,
              axis_names=(), fuse_exp_sinc=False):
    """One sEWI (exponential wave integrator) step; returns (u_new, u).

    Device semantics (nlse_dev.hpp:205-238):
      psi   = sinc(dt L) B(u)        (real time in the sinc)
      u_new = exp(2 i dt L) u_prev - 2 (i dt) exp(i dt L) psi

    With `fuse_exp_sinc` the product exp(i dt L) sinc(dt L) is applied as ONE
    matrix function of L in a single Krylov projection of B(u) — 2 Lanczos
    runs per step instead of the reference's 3. This is NOT bit-identical to
    the sequential form (each sequential matfunc re-projects onto its own
    Krylov space), but the approximation error is the same order in both —
    f(L)v error ~ the best degree-(m-1) polynomial approximation of f on the
    spectrum — so it's a faster integrator variant, off by default for
    reference parity.
    """
    tau = np.asarray(1j * dt, u.dtype)   # numpy scalar: safe jit constant
    if fuse_exp_sinc:
        # NB asymmetric on purpose: the exp factor takes imaginary time tau
        # (passed as t below) while the sinc factor takes REAL dt, matching
        # the sequential form's sinc(dt L) then exp(tau L). Both are written
        # explicitly so the fused function stays correct even if a caller
        # passes a t != tau.
        exp_sinc = lambda _t, lam: (MATFUNCS["exp"](tau, lam)
                                    * MATFUNCS["sinc"](dt, lam))
        e1 = matfunc_apply(lap, _B(u, rho_fn), tau, exp_sinc, m=m,
                           reorth=reorth, axis_names=axis_names)
    else:
        psi = matfunc_apply(lap, _B(u, rho_fn), dt, "sinc", m=m,
                            reorth=reorth, axis_names=axis_names)
        e1 = expm_apply(lap, psi, tau, m=m, reorth=reorth,
                        axis_names=axis_names)
    e2 = expm_apply(lap, u_prev, 2.0 * tau, m=m, reorth=reorth,
                    axis_names=axis_names)
    return e2 - 2.0 * tau * e1, u


def sewi_first_step(u, lap, rho_fn, dt, m=default_krylov_m, reorth=True,
                    axis_names=()):
    """sEWI bootstrap: u_prev := u, then one SS2 step (nlse_dev.hpp:206-209)."""
    return ss2_step(u, lap, rho_fn, dt, m=m, reorth=reorth,
                    axis_names=axis_names), u


def gautschi_step(u, u_prev, lap, rho_fn, dt, m=default_krylov_m, reorth=True,
                  axis_names=(), convention="cubic"):
    """Host comparison 'Gautschi' NLSE step; returns (u_new, u).

    The reference ships two sign conventions of this two-step scheme:
      convention="cubic" (nlse_cubic_gautschi_solver.hpp:17-40):
        u' = exp(-2 tau L) u_prev + 2 tau exp(-tau L) sinc(dt L) B(u)
      convention="plus"  (nlse_cubic_quintic_gautschi_solver.hpp:16-41 and
        nlse_saturating_gautschi_solver.hpp:11-44 — the V2 form the cubic
        header keeps commented out):
        u' = exp(+2 tau L) u_prev - 2 tau exp(+tau L) sinc(dt L) B(u)
    Both are flagged by the reference author as comparison-only.
    """
    tau = np.asarray(1j * dt, u.dtype)   # numpy scalar: safe jit constant
    sgn = -1.0 if convention == "cubic" else 1.0
    psi = matfunc_apply(lap, _B(u, rho_fn), dt, "sinc", m=m, reorth=reorth,
                        axis_names=axis_names)
    e1 = expm_apply(lap, psi, sgn * tau, m=m, reorth=reorth,
                    axis_names=axis_names)
    e2 = expm_apply(lap, u_prev, sgn * 2.0 * tau, m=m, reorth=reorth,
                    axis_names=axis_names)
    return e2 - sgn * 2.0 * tau * e1, u


def gautschi_phi1_bootstrap(u, lap, rho_fn, dt, bc_fn=None, pre_steps=10,
                            m=default_krylov_m, reorth=True, axis_names=()):
    """First-order Gautschi bootstrap: `pre_steps` substeps of
    u <- exp(tau_s L) u - tau_s^2 phi1(tau_s^2 L) B(u),  tau_s = i dt/pre_steps.

    Replicates the quintic/saturating Gautschi drivers' init loop
    (nlse_cubic_quintic_gautschi_driver.cpp:103-131): their
    phi1m_multiply(solver, tau_s*L, B, tau_s) evaluates
    (tau_s L)^{-1} (exp(tau_s * (tau_s L)) - 1) B = tau_s phi1(tau_s^2 L) B
    via a Krylov expm plus a SparseLU solve; in the tau_s^2 |lambda| << 1
    regime both ways equal the phi1 matrix function to roundoff, so here it
    is ONE Krylov projection (no sparse factorization).
    """
    taus = np.asarray(1j * dt / pre_steps, u.dtype)
    for _ in range(pre_steps):
        filt = matfunc_apply(lap, _B(u, rho_fn), taus * taus, "phi1", m=m,
                             reorth=reorth, axis_names=axis_names)
        u = expm_apply(lap, u, taus, m=m, reorth=reorth,
                       axis_names=axis_names) - taus * taus * filt
        if bc_fn is not None:
            u = bc_fn(u)
    return u
