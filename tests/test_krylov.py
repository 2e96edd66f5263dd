"""Krylov/matfunc tests against dense-eigendecomposition and SciPy oracles.

Ports the reference's verification designs:
  * device/test_lanczos.cpp — Lanczos basis/tridiagonal sanity on random inputs;
  * nlsolvers/scipy-test/check_krylov_compute.py — expm_multiply vs SciPy;
  * device/test_matfunc_prec.cpp — the real trig matfunc family vs a dense
    f(t sqrt(|lambda|)) evaluation.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg
import scipy.sparse.linalg

from nlsolvers_tpu.ops import krylov
from nlsolvers_tpu.ops import operators as ops
import reference_ops as ref

RNG = np.random.default_rng(42)


def dense_matvec(L):
    Lj = jnp.asarray(L)

    def mv(u):
        return (Lj @ u.reshape(-1)).reshape(u.shape)

    return mv


def test_lanczos_orthonormal_and_projection():
    n = 40
    A = RNG.standard_normal((n, n))
    A = (A + A.T) / 2
    u = RNG.standard_normal(n)
    m = 12
    V, alpha, beta, beta0 = krylov.lanczos(dense_matvec(A), jnp.asarray(u), m)
    V = np.asarray(V)
    np.testing.assert_allclose(V @ V.T, np.eye(m), atol=1e-10)
    np.testing.assert_allclose(beta0, np.linalg.norm(u), rtol=1e-12)
    # V T V^T should reproduce A on the Krylov subspace:
    T = np.diag(np.asarray(alpha)) + np.diag(np.asarray(beta), 1) \
        + np.diag(np.asarray(beta), -1)
    # Projection identity A V_j = V T e_j for j < m-1 (last column truncated)
    AV = A @ V[: m - 1].T
    VT = V.T @ T[:, : m - 1]
    np.testing.assert_allclose(AV, VT, atol=1e-8)


def test_lanczos_complex_hermitian():
    n = 30
    A = RNG.standard_normal((n, n))
    A = (A + A.T) / 2  # real symmetric applied to complex vectors (NLSE case)
    u = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    m = 10
    V, alpha, beta, beta0 = krylov.lanczos(dense_matvec(A), jnp.asarray(u), m)
    V = np.asarray(V)
    G = np.conj(V) @ V.T
    np.testing.assert_allclose(G, np.eye(m), atol=1e-10)
    assert np.isrealobj(np.asarray(alpha))


@pytest.mark.parametrize("m", [10, 20])
def test_expm_vs_scipy(m):
    """The scipy-test/check_krylov_compute.py oracle on the 2D Laplacian."""
    n_int = 14
    nf = n_int + 2
    dx = 2 * 5.0 / (nf - 1)
    L = ref.build_laplacian_noflux(n_int, n_int, dx, dx)
    u = RNG.standard_normal(nf * nf) + 1j * RNG.standard_normal(nf * nf)
    dt = 1e-2
    t = 1j * dt
    want = scipy.sparse.linalg.expm_multiply(t * L, u)
    mv = dense_matvec(L)
    got = krylov.expm_apply(mv, jnp.asarray(u.reshape(nf, nf)), t, m=m)
    err = np.linalg.norm(np.asarray(got).reshape(-1) - want) / np.linalg.norm(want)
    assert err < 1e-9


REAL_FUNCS = {
    "cos_sqrt": lambda t, lam: np.cos(t * np.sqrt(np.abs(lam))),
    "id_sqrt": lambda t, lam: t * np.sqrt(np.abs(lam)),
    "sinc2_sqrt_half":
        lambda t, lam: np.sinc(t / 2 * np.sqrt(np.abs(lam)) / np.pi) ** 2,
    "sinc2_sqrt": lambda t, lam: np.sinc(t * np.sqrt(np.abs(lam)) / np.pi) ** 2,
    "mod_cosine":
        lambda t, lam: (np.cos(t * np.sqrt(np.abs(lam)) / 2) ** 2
                        * np.sinc(t * np.sqrt(np.abs(lam)) / np.pi)) ** 2,
}



def _np_sinc(x):
    return np.sinc(x / np.pi)


def _np_phi1(x):
    safe = np.where(np.abs(x) < 1e-8, 1.0, x)
    return np.where(np.abs(x) < 1e-8, 1.0, np.expm1(safe) / safe)


# numpy twins of every krylov.MATFUNCS entry, f(t, lam) on the eigenvalues
NP_FUNCS = dict(REAL_FUNCS,
                exp=lambda t, lam: np.exp(t * lam),
                sinc=lambda t, lam: _np_sinc(t * lam),
                phi1=lambda t, lam: _np_phi1(t * lam))

# (complex field, t, operator sign) per function, as the integrators call
# them: SS2/sEWI apply exp(i dt L), sinc(dt L) and the Gautschi-NLSE
# bootstrap phi1(-(dt/p)^2 L) to complex fields of L (<= 0); the real-wave
# Gautschi step applies the sqrt family to real fields of -L (>= 0).
FUNC_USE = {"exp": (True, 1j * 1e-2, 1.0), "sinc": (True, 1e-2, 1.0),
            "phi1": (True, -1e-4, 1.0)}
FUNC_USE.update({f: (False, 1e-2, -1.0) for f in REAL_FUNCS})

# Each operator family the stencils implement, with its dense f64 twin
# built index by index in reference_ops (2D grids are 12^2, 3D 6^3).
NF2, NF3, DXO = 12, 6, 0.5
_C2 = 1.0 + 0.5 * np.random.default_rng(3).random((NF2, NF2))
_C3 = 1.0 + 0.5 * np.random.default_rng(4).random((NF3,) * 3)


def _operator_case(name):
    """(stencil closure, dense matrix, field shape) for an operator id."""
    s2, s3 = (NF2, NF2), (NF3,) * 3
    if name == "2d-iso-reference":
        return (ops.laplacian_2d(s2, DXO, DXO, dtype=jnp.float64),
                ref.build_laplacian_noflux(NF2 - 2, NF2 - 2, DXO, DXO), s2)
    if name == "2d-iso-clean":
        return (ops.laplacian_2d(s2, DXO, DXO, variant="clean",
                                 dtype=jnp.float64),
                ref.build_conservative_laplacian(s2, DXO), s2)
    if name == "2d-iso-separated":
        ax, ay = ops.separated_laplacian_2d(s2, DXO, DXO, dtype=jnp.float64)
        Lx, Ly = ref.build_separated_laplacian_noflux(NF2 - 2, DXO, DXO)
        return (lambda u: ax(u) + ay(u)), Lx + Ly, s2
    if name == "2d-aniso":
        return (ops.anisotropic_laplacian_2d(_C2, DXO, DXO),
                ref.build_anisotropic_laplacian_noflux(
                    NF2 - 2, NF2 - 2, DXO, DXO, _C2.reshape(-1)), s2)
    if name == "3d-iso-reference":
        return (ops.laplacian_3d(s3, DXO, dtype=jnp.float64),
                ref.build_laplacian_noflux_3d(NF3 - 2, NF3 - 2, NF3 - 2,
                                              DXO), s3)
    if name == "3d-iso-clean":
        return (ops.laplacian_3d(s3, DXO, variant="clean", dtype=jnp.float64),
                ref.build_conservative_laplacian(s3, DXO), s3)
    if name == "3d-aniso-reference":
        return (ops.anisotropic_laplacian_3d(_C3, DXO),
                ref.build_anisotropic_laplacian_noflux_3d(
                    NF3 - 2, DXO, _C3.reshape(-1)), s3)
    assert name == "3d-aniso-clean"
    return (ops.anisotropic_laplacian_3d(_C3, DXO, variant="clean"),
            ref.build_conservative_laplacian(s3, DXO, _C3), s3)


OPERATOR_CASES = ["2d-iso-reference", "2d-iso-clean", "2d-iso-separated",
                  "2d-aniso", "3d-iso-reference", "3d-iso-clean",
                  "3d-aniso-reference", "3d-aniso-clean"]

# Krylov dimension and tolerance against the exact f(tL)u. exp, sinc and
# phi1 converge to rounding at m=16. The sqrt family is evaluated on |Ritz
# values| with T's last diagonal entry left at zero as in the reference
# (eigen_krylov_real.hpp:14,23-49) and converges more slowly: m=30 holds it
# to the 1e-7 of the test_matfunc_prec.cpp port below (worst case here
# 5e-10). id_sqrt's f has a |lambda|^(1/2) kink at 0 on top, so it is held
# to 1e-3 (worst 5.4e-4) — an inherent property the reference shares, not
# an implementation error; the algorithm-parity check holds every function
# to 1e-9.
DENSE_M = {f: 30 for f in REAL_FUNCS}
DENSE_TOL = dict({f: 1e-7 for f in REAL_FUNCS}, id_sqrt=1e-3)


@pytest.mark.parametrize("func", sorted(krylov.MATFUNCS))
@pytest.mark.parametrize("case", OPERATOR_CASES)
def test_matfunc_stencil_vs_dense_oracle(case, func):
    """Every matrix function through every stencil family, in f64 against
    (1) the numpy port of the reference Lanczos + f(T) pipeline on the
    dense matrix (same algorithm: agreement to rounding), and (2) the exact
    f(tL)u from scipy expm / dense eigh (Krylov truncation error only)."""
    stencil, L, shape = _operator_case(case)
    is_complex, t, sign = FUNC_USE[func]
    rng = np.random.default_rng(OPERATOR_CASES.index(case))
    u = rng.standard_normal(L.shape[0])
    if is_complex:
        u = u + 1j * rng.standard_normal(L.shape[0])
    A = sign * L
    op = stencil if sign > 0 else (lambda v: -stencil(v))
    m = DENSE_M.get(func, 16)
    got = np.asarray(krylov.matfunc_apply(
        op, jnp.asarray(u.reshape(shape)), t, func, m=m)).reshape(-1)

    same_alg = ref.matfunc_multiply(A.astype(u.dtype), u, t, NP_FUNCS[func],
                                    m=m)
    np.testing.assert_allclose(got, same_alg, rtol=1e-9, atol=1e-9)

    if func == "exp":
        truth = scipy.linalg.expm(t * A) @ u
    else:
        lam, Q = np.linalg.eigh(A)
        truth = Q @ (NP_FUNCS[func](t, lam) * (Q.T @ u))
    err = np.linalg.norm(got - truth) / np.linalg.norm(truth)
    assert err < DENSE_TOL.get(func, 1e-10), err


@pytest.mark.parametrize("func", sorted(REAL_FUNCS))
def test_real_matfuncs_vs_dense(func):
    """test_matfunc_prec.cpp analogue at its stiffer operating point (dx=0.2,
    |lambda| up to 200): Krylov f(t sqrt(L)) u at m=25 vs dense eigh."""
    scalar = REAL_FUNCS[func]
    n_int = 12
    nf = n_int + 2
    dx = 0.2
    L = -ref.build_laplacian_noflux(n_int, n_int, dx, dx)  # PSD-ish
    u = RNG.standard_normal(nf * nf)
    t = 1e-2
    lam, Q = np.linalg.eigh(L)
    want = Q @ (scalar(t, lam) * (Q.T @ u))
    got = krylov.matfunc_apply(dense_matvec(L), jnp.asarray(u.reshape(nf, nf)),
                               t, func, m=25)
    err = np.linalg.norm(np.asarray(got).reshape(-1) - want) / np.linalg.norm(want)
    assert err < DENSE_TOL[func]


@pytest.mark.parametrize("func", sorted(REAL_FUNCS))
def test_real_matfuncs_algorithm_parity(func):
    """Exact-algorithm parity: our fused Lanczos apply vs a numpy port of the
    reference's lanczos_L + f(T) pipeline, same m, same inputs."""
    scalar = REAL_FUNCS[func]
    n_int = 12
    nf = n_int + 2
    dx = 0.2
    L = -ref.build_laplacian_noflux(n_int, n_int, dx, dx)
    u = RNG.standard_normal(nf * nf)
    t = 1e-2
    m = 10
    want = ref.matfunc_multiply(L, u, t, scalar, m=m)
    got = krylov.matfunc_apply(dense_matvec(L), jnp.asarray(u.reshape(nf, nf)),
                               t, func, m=m)
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want,
                               rtol=1e-9, atol=1e-9)


def test_expm_algorithm_parity_complex():
    """Complex expm parity vs the numpy reference pipeline (tau = i dt)."""
    n_int = 10
    nf = n_int + 2
    dx = 0.3
    L = ref.build_laplacian_noflux(n_int, n_int, dx, dx)
    u = RNG.standard_normal(nf * nf) + 1j * RNG.standard_normal(nf * nf)
    t = 1j * 2e-2
    m = 10
    want = ref.matfunc_multiply(L.astype(complex), u, t,
                                lambda tt, lam: np.exp(tt * lam), m=m)
    got = krylov.expm_apply(dense_matvec(L), jnp.asarray(u.reshape(nf, nf)),
                            t, m=m)
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want,
                               rtol=1e-9, atol=1e-9)


def test_matfunc_apply_multi_matches_singles():
    """One shared Lanczos decomposition == separate per-func runs (exactly:
    Lanczos is deterministic in u, so the Gautschi filter/cos sharing in
    models/realwave.gautschi_step changes nothing numerically)."""
    n_int = 16
    nf = n_int + 2
    dx = 0.15
    L = ref.build_laplacian_noflux(n_int, n_int, dx, dx)
    mv = dense_matvec(-L)
    u = jnp.asarray(RNG.standard_normal((nf, nf)))
    dt = 1e-2
    specs = ((dt, "id_sqrt"), (dt, "cos_sqrt"), (dt / 2, "sinc2_sqrt_half"))
    outs = krylov.matfunc_apply_multi(mv, u, specs, m=10)
    assert len(outs) == 3
    for (t, func), got in zip(specs, outs):
        single = krylov.matfunc_apply(mv, u, t, func, m=10)
        np.testing.assert_allclose(np.asarray(got), np.asarray(single),
                                   rtol=1e-13, atol=1e-13)


def test_matfunc_apply_multi_complex_exp():
    """Multi with complex t (SS2's tau = i dt) on a complex field."""
    n_int = 12
    nf = n_int + 2
    dx = 0.2
    L = ref.build_laplacian_noflux(n_int, n_int, dx, dx)
    mv = dense_matvec(L)
    u = jnp.asarray((RNG.standard_normal((nf, nf))
                     + 1j * RNG.standard_normal((nf, nf))))
    tau = 1j * 1e-3
    outs = krylov.matfunc_apply_multi(mv, u, ((tau, "exp"), (1e-3, "sinc")),
                                      m=12)
    for (t, func), got in zip(((tau, "exp"), (1e-3, "sinc")), outs):
        single = krylov.matfunc_apply(mv, u, t, func, m=12)
        np.testing.assert_allclose(np.asarray(got), np.asarray(single),
                                   rtol=1e-13, atol=1e-13)


def test_matfunc_zero_vector_is_zero():
    """f(L) 0 = 0, not NaN: sEWI's B(u) is identically zero with the
    reference's default m = 0 (nlse_cubic_driver.cpp:64), and the raw
    division by ||v|| would poison the whole step. Covers real and complex
    dtypes and the multi-spec path."""
    n_int = 10
    L = ref.build_laplacian_noflux(n_int, n_int, 0.2, 0.2)
    mv = dense_matvec(L)
    nf = n_int + 2
    for z in (jnp.zeros((nf, nf)), jnp.zeros((nf, nf), jnp.complex128)):
        out = krylov.matfunc_apply(mv, z, 1e-3, "sinc", m=8)
        assert np.isfinite(np.asarray(out)).all()
        np.testing.assert_array_equal(np.asarray(out), 0.0)
    outs = krylov.matfunc_apply_multi(mv, jnp.zeros((nf, nf)),
                                      ((1e-3, "cos_sqrt"), (1e-3, "id_sqrt")),
                                      m=8)
    for o in outs:
        np.testing.assert_array_equal(np.asarray(o), 0.0)


def test_lanczos_safe_norm_matches_raw_division():
    """The safe normalization is bit-identical to raw division on nonzero
    inputs (it only rewrites the norm when it is exactly zero)."""
    n = 30
    A = RNG.standard_normal((n, n))
    A = (A + A.T) / 2
    u = RNG.standard_normal(n)
    V, alpha, beta, beta0 = krylov.lanczos(dense_matvec(A), jnp.asarray(u), 8)
    raw_v0 = u / np.linalg.norm(u)
    np.testing.assert_array_equal(np.asarray(V[0]), raw_v0)
