"""Pointwise nonlinearities for the equation families.

NLSE densities rho(u) multiply the phase exp(0.5 tau rho) in SS2 and enter the
sEWI B-term B(u) = -rho(u) * u. Real-wave g(u) enters u_tt = Lap u - m g(u).

Parity notes (each vs the reference's production form):
  * cubic:          rho = m |u|^2            (nlse_cubic_solver.hpp:62-66)
  * cubic_quintic:  rho = m (s1 |u|^2 + s2 |u|^4)
                                             (nlse_cubic_quintic_solver.hpp:16-21)
  * saturable:      rho = m |u|^2 / (1 + kappa |u|^2) — the device form
    (nlse_saturating.cuh:13-18). The host version divides by (1 + kappa*u)
    (nlse_saturating_solver.hpp:17-18), an acknowledged bug; we implement the
    correct device form, selectable via `host_compat=True` for A/B parity.
  * sine_gordon:          g = sin(u)          (sg_single_solver.hpp:54)
  * double_sine_gordon:   g = sin(u) + 0.6 sin(2u) — the code's form
    (sg_double_solver.hpp:17-18); the header comment says sin(u)+sin(u/2) but
    the implementation uses 0.6*sin(2u). We follow the code.
  * hyperbolic_sine_gordon: g = sinh(u)       (sg_hyperbolic_solver.hpp:17-18)
  * klein_gordon:         g = u^3 — the code applies -m u^3 despite the header
    comment saying m*u (kg_solver.hpp:8,17). We follow the code.
  * phi4:                 g = u - u^3         (phi4_solver.hpp:17-18)
"""

import jax.numpy as jnp

__all__ = ["nlse_density", "realwave_g",
           "realwave_potential", "NLSE_KINDS", "REALWAVE_KINDS"]

NLSE_KINDS = ("cubic", "cubic_quintic", "saturable")
REALWAVE_KINDS = ("sine_gordon", "double_sine_gordon", "hyperbolic_sine_gordon",
                  "klein_gordon", "phi4")


def nlse_density(kind, m, *, sigma1=1.0, sigma2=-0.1, kappa=1.0,
                 host_compat=False):
    """Returns rho(u) (a real field) for the given NLSE variant."""
    if kind == "cubic":
        def rho(u):
            return m * (u.real**2 + u.imag**2)
    elif kind == "cubic_quintic":
        def rho(u):
            a = u.real**2 + u.imag**2
            return m * (sigma1 * a + sigma2 * a * a)
    elif kind == "saturable":
        if host_compat:
            # reference host quirk: denominator uses u itself, giving a complex
            # "density"; kept only for parity studies.
            def rho(u):
                a = u.real**2 + u.imag**2
                return m * a / (1.0 + kappa * u)
        else:
            def rho(u):
                a = u.real**2 + u.imag**2
                return m * a / (1.0 + kappa * a)
    else:
        raise ValueError(f"unknown NLSE kind {kind!r}")
    return rho


def realwave_g(kind):
    """Returns g(u) for u_tt = Lap u - m g(u)."""
    return {
        "sine_gordon": jnp.sin,
        "double_sine_gordon": lambda u: jnp.sin(u) + 0.6 * jnp.sin(2.0 * u),
        "hyperbolic_sine_gordon": jnp.sinh,
        "klein_gordon": lambda u: u**3,
        "phi4": lambda u: u - u**3,
    }[kind]


def realwave_potential(kind):
    """Potential energy density V(u) for the on-generation energy series,
    matching analysis/energy.energy_terms (the reference's vocabulary,
    process_h5/ensemble_processing.py:48-89, incl. its phi4/KG quirks) plus
    the integral of g for the kinds the analysis tables leave out."""
    return {
        "sine_gordon": lambda u: 1.0 - jnp.cos(u),
        "double_sine_gordon": lambda u: (1.0 - jnp.cos(u)
                                         + 0.3 * (1.0 - jnp.cos(2.0 * u))),
        "hyperbolic_sine_gordon": lambda u: jnp.cosh(u) - 1.0,
        "klein_gordon": lambda u: 0.5 * u ** 4,
        "phi4": lambda u: u ** 2 - u ** 4,
        "stochastic_phi4": lambda u: u ** 2 - u ** 4,
    }[kind]
