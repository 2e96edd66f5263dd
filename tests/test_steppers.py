"""Stepper parity tests vs numpy ports of the reference step() functions, plus
conservation sanity checks (the reference's own quality gate, SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlsolvers_tpu.models import problems
from nlsolvers_tpu.models.evolve import evolve
import reference_ops as ref
import reference_steppers as rs

RNG = np.random.default_rng(7)

N_INT = 14          # interior size; full grid nf = 16
NF = N_INT + 2
LX = 3.0
DX = 2 * LX / (NF - 1)
DT = 4e-3


def gaussian_ic(nf, complex_=False, k=1.0):
    x = np.linspace(-LX, LX, nf)
    X, Y = np.meshgrid(x, x, indexing="ij")
    u = np.exp(-(X**2 + Y**2))
    if complex_:
        u = u * np.exp(1j * k * X)
    return u


def test_nlse_ss2_parity():
    L = ref.build_laplacian_noflux(N_INT, N_INT, DX, DX)
    m = RNG.uniform(0.5, 1.5, (NF, NF))
    u = gaussian_ic(NF, complex_=True)
    prob = problems.nlse_problem("cubic", (NF, NF), LX, DT,
                                 m_field=m, krylov_m=10,
                                 dtype=jnp.complex128)
    state = prob.init(u)
    uref = u.reshape(-1).astype(complex)
    for i in range(3):
        state = prob.step(state, i + 1)
        uref = rs.nlse_ss2_step(uref, L, m.reshape(-1), DT, 10)
        uref = rs.neumann_bc(uref.reshape(NF, NF)).reshape(-1)
    np.testing.assert_allclose(np.asarray(state).reshape(-1), uref,
                               rtol=1e-9, atol=1e-11)


def test_nlse_sewi_parity():
    L = ref.build_laplacian_noflux(N_INT, N_INT, DX, DX)
    m = RNG.uniform(0.5, 1.5, (NF, NF))
    u = gaussian_ic(NF, complex_=True, k=2.0)
    prob = problems.nlse_problem("cubic", (NF, NF), LX, DT,
                                 m_field=m, krylov_m=10, integrator="sewi",
                                 dtype=jnp.complex128)
    state = prob.init(u)
    # reference bootstrap: u_prev = u0, first step = SS2
    uref = u.reshape(-1).astype(complex)
    uref_prev = uref.copy()
    for i in range(1, 4):
        state = prob.step(state, i)
        if i == 1:
            uref = rs.nlse_ss2_step(uref, L, m.reshape(-1), DT, 10)
        else:
            uref, uref_prev = rs.nlse_sewi_step(uref, uref_prev, L,
                                                m.reshape(-1), DT, 10)
        uref = rs.neumann_bc(uref.reshape(NF, NF)).reshape(-1)
    np.testing.assert_allclose(np.asarray(state[0]).reshape(-1), uref,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("kind,gnp,filter_", [
    ("klein_gordon", lambda x: x**3, "id_sqrt"),
    ("sine_gordon", np.sin, "mod_cosine"),
    ("phi4", lambda x: x - x**3, "id_sqrt"),
    ("double_sine_gordon", lambda x: np.sin(x) + 0.6 * np.sin(2 * x),
     "id_sqrt"),
    ("hyperbolic_sine_gordon", np.sinh, "id_sqrt"),
])
def test_realwave_gautschi_parity(kind, gnp, filter_):
    # KG driver convention: L = -Lap (kg_driver.cpp:92); ours passes -Lap too.
    L = -ref.build_laplacian_noflux(N_INT, N_INT, DX, DX)
    m = RNG.uniform(0.5, 1.5, (NF, NF))
    u0 = 0.3 * gaussian_ic(NF)
    v0 = 0.05 * RNG.standard_normal((NF, NF))
    prob = problems.realwave_problem(kind, (NF, NF), LX, DT, m_field=m,
                                     krylov_m=10, dtype=jnp.float64)
    state = prob.init(u0, v0)
    uref = u0.reshape(-1).copy()
    uref_past = (u0 - DT * v0).reshape(-1)
    for i in range(3):
        state = prob.step(state, i + 1)
        uref, uref_past = rs.realwave_gautschi_step(
            uref, uref_past, L, m.reshape(-1), DT, gnp, 10, filter_)
        uref = rs.neumann_bc(uref.reshape(NF, NF)).reshape(-1)
    np.testing.assert_allclose(np.asarray(state[0]).reshape(-1), uref,
                               rtol=1e-9, atol=1e-11)


def test_sign_gordon_sign_insensitivity():
    """sg_single_driver passes +Lap where kg_driver passes -Lap; the |lambda|
    convention must make both identical."""
    Lp = ref.build_laplacian_noflux(N_INT, N_INT, DX, DX)
    m = np.ones((NF, NF))
    u0 = 0.3 * gaussian_ic(NF)
    up = u0.reshape(-1).copy()
    a1, _ = rs.realwave_gautschi_step(up, up, Lp, m.reshape(-1), DT, np.sin,
                                      10, "mod_cosine")
    a2, _ = rs.realwave_gautschi_step(up, up, -Lp, m.reshape(-1), DT, np.sin,
                                      10, "mod_cosine")
    np.testing.assert_allclose(a1, a2, atol=1e-10)


@pytest.mark.parametrize("kind,gnp", [
    ("sine_gordon", np.sin),
    ("klein_gordon", lambda x: x**3),
])
def test_realwave_sv_parity(kind, gnp):
    # SV drivers pass +Lap (kg_sv_driver.cpp:93)
    L = ref.build_laplacian_noflux(N_INT, N_INT, DX, DX)
    m = RNG.uniform(0.5, 1.5, (NF, NF))
    u0 = 0.3 * gaussian_ic(NF)
    v0 = np.zeros((NF, NF))
    prob = problems.realwave_problem(kind, (NF, NF), LX, DT, m_field=m,
                                     integrator="sv", dtype=jnp.float64)
    state = prob.init(u0, v0)
    uref = u0.reshape(-1).copy()
    uref_past = uref.copy()
    for i in range(4):
        state = prob.step(state, i + 1)
        uref, uref_past = rs.realwave_sv_step(uref, uref_past, L,
                                              m.reshape(-1), DT, gnp)
        uref = rs.neumann_bc(uref.reshape(NF, NF)).reshape(-1)
    np.testing.assert_allclose(np.asarray(state[0]).reshape(-1), uref,
                               rtol=1e-10, atol=1e-12)


def test_nlse_mass_conservation():
    """SS2 conserves mass up to Krylov error — the reference's quality gate."""
    m = np.ones((NF, NF))
    u0 = gaussian_ic(NF, complex_=True)
    prob = problems.nlse_problem("cubic", (NF, NF), LX, DT, m_field=m,
                                 krylov_m=12, dtype=jnp.complex128,
                                 apply_bc=False)
    state = prob.init(u0)
    mass0 = float(jnp.sum(jnp.abs(state) ** 2))
    for i in range(50):
        state = prob.step(state, i + 1)
    mass = float(jnp.sum(jnp.abs(state) ** 2))
    assert abs(mass - mass0) / mass0 < 1e-8


def test_evolve_snapshot_cadence():
    m = np.ones((NF, NF))
    u0 = gaussian_ic(NF, complex_=True)
    prob = problems.nlse_problem("cubic", (NF, NF), LX, DT, m_field=m,
                                 krylov_m=8, dtype=jnp.complex128)
    state = prob.init(u0)
    snaps = evolve(prob.step, state, num_snapshots=4, snapshot_freq=3,
                   observe=prob.observe)
    assert snaps.shape == (4, NF, NF)
    np.testing.assert_allclose(np.asarray(snaps[0]), u0, atol=1e-12)
    # snapshot k == state after 3k sequential steps
    st = prob.init(u0)
    for i in range(9):
        st = prob.step(st, i + 1)
    np.testing.assert_allclose(np.asarray(snaps[3]), np.asarray(st),
                               rtol=1e-9, atol=1e-14)


def test_stochastic_phi4_runs_and_reproducible():
    u0 = 0.1 * gaussian_ic(NF)
    prob = problems.stochastic_phi4_problem((NF, NF), LX, DT,
                                            noise_strength=0.05, seed=3,
                                            dtype=jnp.float64)
    s1 = prob.init(u0)
    s2 = prob.init(u0)
    for i in range(5):
        s1 = prob.step(s1, i + 1)
        s2 = prob.step(s2, i + 1)
    np.testing.assert_array_equal(np.asarray(s1[0]), np.asarray(s2[0]))
    assert np.all(np.isfinite(np.asarray(s1[0])))


def test_boussinesq_runs_stable():
    u0 = 0.05 * gaussian_ic(NF)
    prob = problems.boussinesq_problem((NF, NF), LX, 1e-3, krylov_m=10,
                                       dtype=jnp.float64)
    state = prob.init(u0)
    for i in range(5):
        state = prob.step(state, i + 1)
    u = np.asarray(state[0])
    assert np.all(np.isfinite(u))
    assert np.abs(u).max() < 10.0


def test_nlse_3d_smoke():
    nf = 10
    x = np.linspace(-LX, LX, nf)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    u0 = np.exp(-(X**2 + Y**2 + Z**2)) * np.exp(1j * X)
    m = np.ones((nf, nf, nf))
    prob = problems.nlse_problem("cubic", (nf, nf, nf), LX, DT, m_field=m,
                                 krylov_m=8, dtype=jnp.complex128)
    state = prob.init(u0)
    mass0 = float(jnp.sum(jnp.abs(state) ** 2))
    for i in range(5):
        state = prob.step(state, i + 1)
    mass = float(jnp.sum(jnp.abs(state) ** 2))
    assert np.isfinite(mass)
    assert abs(mass - mass0) / mass0 < 1e-3  # BC copy breaks exactness mildly


def test_realwave_3d_smoke():
    nf = 8
    u0 = 0.2 * RNG.standard_normal((nf, nf, nf))
    prob = problems.realwave_problem("klein_gordon", (nf, nf, nf), LX, DT,
                                     krylov_m=6, dtype=jnp.float64)
    state = prob.init(u0)
    for i in range(3):
        state = prob.step(state, i + 1)
    assert np.all(np.isfinite(np.asarray(state[0])))


def test_nlse_sewi_fused_close_to_sequential():
    """sewi_fused applies exp(i dt L) sinc(dt L) in one Krylov projection;
    it is a different (equally accurate) approximation, so trajectories stay
    close to plain sewi at the Krylov-error scale."""
    m = RNG.uniform(0.5, 1.5, (NF, NF))
    u = gaussian_ic(NF, complex_=True, k=2.0)
    out = {}
    for integ in ("sewi", "sewi_fused"):
        prob = problems.nlse_problem("cubic", (NF, NF), LX, DT,
                                     m_field=m, krylov_m=12,
                                     integrator=integ,
                                     dtype=jnp.complex128)
        state = prob.init(u)
        for i in range(1, 6):
            state = prob.step(state, i)
        out[integ] = np.asarray(prob.observe(state))
    scale = np.linalg.norm(out["sewi"])
    assert np.linalg.norm(out["sewi"] - out["sewi_fused"]) / scale < 1e-8
    # and the bootstrap step (i == 1) is identical by construction


def test_nlse_sewi_default_m_field_stays_finite():
    """sEWI with the default m = 0 (linear Schroedinger): B(u) = 0 every
    step, so this regression-guards the zero-vector Lanczos path end to end.
    The solution must stay finite and mass-conserving."""
    n = 32
    rng = np.random.default_rng(3)
    u0 = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    u0 = u0 * np.exp(-((np.linspace(-1, 1, n)[:, None]) ** 2
                       + np.linspace(-1, 1, n)[None, :] ** 2) * 4)
    prob = problems.nlse_problem("cubic", (n, n), 5.0, 1e-3,
                                 integrator="sewi", krylov_m=8)
    out = np.asarray(problems.run(prob, prob.init(u0), 4, 3))
    assert np.isfinite(out.view(np.float64)).all()
    mass0 = np.sum(np.abs(out[0]) ** 2)
    mass1 = np.sum(np.abs(out[-1]) ** 2)
    # drift is Krylov truncation of exp(i dt L) at m=8, not roundoff
    assert abs(mass1 - mass0) / mass0 < 1e-3


def test_nlse_separated_variant_matches_full_operator():
    """variant='separated' (Lx u + Ly u, laplacians.hpp:220-269) must evolve
    identically to the full 2D no-flux operator — the per-direction
    diagonals sum to the full matrix including its -3 corner quirk."""
    n = 24
    rng = np.random.default_rng(4)
    u0 = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    m = np.ones((n, n))
    out = {}
    for variant in ("reference", "separated"):
        prob = problems.nlse_problem("cubic", (n, n), 5.0, 1e-3, m_field=m,
                                     integrator="ss2", krylov_m=8,
                                     dtype=jnp.complex128, variant=variant)
        out[variant] = np.asarray(problems.run(prob, prob.init(u0), 3, 4))
    np.testing.assert_allclose(out["separated"], out["reference"],
                               rtol=1e-12, atol=1e-13)


def test_nlse_radiating_bc_stability_smoke():
    """bc='radiating' (boundaries.hpp:59-121): an outgoing wavepacket must
    stay finite, and the radiating ring must not reflect mass back in — the
    run's mass may shrink (energy leaves) but must not grow."""
    n = 48
    Lx = 10.0
    x = np.linspace(-Lx, Lx, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    # packet launched toward the +x boundary
    u0 = np.exp(-((X - 5.0) ** 2 + Y**2) / 2.0) * np.exp(2.0j * X)
    m = np.ones((n, n))
    prob = problems.nlse_problem("cubic", (n, n), Lx, 2e-3, m_field=m,
                                 integrator="ss2", krylov_m=8,
                                 dtype=jnp.complex128, bc="radiating")
    assert prob.meta["bc"] == "radiating"
    traj = np.asarray(problems.run(prob, prob.init(u0), 6, 20))
    assert np.isfinite(traj.view(np.float64)).all()
    mass = np.sum(np.abs(traj) ** 2, axis=(1, 2))
    assert mass[-1] <= mass[0] * 1.02, mass


@pytest.mark.parametrize("kind", ["host_complex", "packed", "device"])
@pytest.mark.parametrize("integrator", ["ss2", "sewi"])
def test_problem_init_inputs(kind, integrator):
    """Problem.init takes the IC as a host complex numpy array, as the
    packed (2, *shape) real (re, im) stack of utils/complexio, or as a
    device array, and yields the same complex state in the problem dtype."""
    from nlsolvers_tpu.utils.complexio import pack_complex

    z = gaussian_ic(NF, complex_=True)
    prob = problems.nlse_problem("cubic", (NF, NF), LX, DT, krylov_m=6,
                                 integrator=integrator, dtype=jnp.complex64)
    u0 = {"host_complex": z,
          "packed": np.asarray(pack_complex(jnp.asarray(z))),
          "device": jnp.asarray(z, jnp.complex64)}[kind]
    state = prob.init(u0)
    got = prob.observe(state)
    assert got.dtype == jnp.complex64 and got.shape == (NF, NF)
    np.testing.assert_allclose(np.asarray(got), z.astype(np.complex64),
                               rtol=1e-6, atol=1e-7)
    # the state steps the same whatever the input form
    want = prob.step(prob.init(z), 1)
    np.testing.assert_array_equal(np.asarray(prob.observe(prob.step(state, 1))),
                                  np.asarray(prob.observe(want)))
