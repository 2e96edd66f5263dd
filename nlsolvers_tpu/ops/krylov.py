"""Lanczos matrix-function core: y = f(t·g(L)) u for matrix-free operators.

Replacement for the reference's Krylov pipeline
(host/include/eigen_krylov_real.hpp, eigen_krylov_complex.hpp;
device/include/lanczos.hpp, lanczos_complex.hpp, matfunc_real.hpp,
matfunc_complex.hpp), in plain jnp/lax left to XLA. Differences by design:

* The operator is a matrix-free closure (stencil) that XLA fuses into one
  loop, not a cuSPARSE CSR SpMV.
* The whole Lanczos iteration lives inside one jitted `lax.fori_loop`; the
  m x m tridiagonal eigendecomposition runs on-device via `jnp.linalg.eigh`
  (m <= 20, trivial) — zero host round trips, unlike the reference device path
  which stages T entries through the host every iteration
  (lanczos_complex.hpp, pointer-mode-host dots; noted as its serialization
  bottleneck in SURVEY.md section 3.1).
* Full reorthogonalization is one fused pair of matvecs against the V block
  (projection + reconstruction), the batched analogue of the reference's
  two-Dgemv MGS (lanczos.hpp:208-267). Zero-initialized columns beyond the
  current iteration contribute nothing, so no masking is needed.
* For Hermitian operators the Rayleigh quotients are mathematically real; we
  store T as a real tridiagonal even in the complex case (the reference keeps
  complex storage whose imaginary parts are rounding noise).

Function-table parity (all applied to eigenvalues `lam` of T):
  exp            exp(t*lam),  t may be complex     (eigen_krylov_complex.hpp:54-83)
  sinc           sinc(t*lam)                       (eigen_krylov_complex.hpp:85-103)
  cos_sqrt       cos(t*sqrt(|lam|))                (eigen_krylov_real.hpp:57-87)
  sinc2_sqrt     sinc(t*sqrt(|lam|))^2             (eigen_krylov_real.hpp:89-123)
  id_sqrt        t*sqrt(|lam|)                     (eigen_krylov_real.hpp:125-152)
  sinc2_sqrt_half sinc(t/2*sqrt(|lam|))^2          (eigen_krylov_real.hpp:154-183)
  mod_cosine     (cos(th/2)^2 * sinc(th))^2, th=t*sqrt(|lam|)
                                                   (eigen_krylov_real.hpp:185-209)
The sqrt(|lam|) absolute values are reference semantics: its drivers pass +Delta
or -Delta inconsistently (e.g. sg_single_driver.cpp:93 vs kg_driver.cpp:92) and
rely on |lam| making the sign irrelevant. Reproduced verbatim.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nlsolvers_tpu.config import default_krylov_m, real_dtype_of

__all__ = ["lanczos", "tridiag_eigh", "matfunc_apply", "matfunc_apply_multi",
           "expm_apply", "MATFUNCS"]

# At default precision XLA may run f32 matmuls on the GPU in TF32, which
# keeps ~10 mantissa bits (~3 decimal digits). In the Lanczos projections,
# the T eigendecomposition and the coefficient solve that loss compounds
# step over step into energy drift orders of magnitude above f32 roundoff.
# Every dot/matmul in this module therefore pins HIGHEST (full f32): these
# are bandwidth-bound GEMVs and m x m ops, so TF32 would buy nothing.
_HI = jax.lax.Precision.HIGHEST


def _sinc(x):
    """sin(x)/x with the reference's 1e-8 guard (eigen_krylov_real.hpp:93)."""
    safe = jnp.where(jnp.abs(x) < 1e-8, 1.0, x)
    return jnp.where(jnp.abs(x) < 1e-8, 1.0, jnp.sin(safe) / safe)


def _mod_cosine(theta):
    """Gautschi mod-cosine filter: cos(th/2)^2 * sinc(th), guarded at 1e-12."""
    safe = jnp.where(jnp.abs(theta) < 1e-12, 1.0, theta)
    val = jnp.cos(safe / 2.0) ** 2 * jnp.sin(safe) / safe
    return jnp.where(jnp.abs(theta) < 1e-12, 1.0, val)


def _phi1(x):
    """phi_1(x) = (exp(x) - 1)/x, -> 1 at 0 (guard mirrors _sinc's).

    Used by the Gautschi-NLSE drivers' first-order bootstrap
    (nlse_cubic_gautschi_solver.hpp phi1m_multiply: expm then a SparseLU
    solve of tau*L — here a single matrix function, same object)."""
    safe = jnp.where(jnp.abs(x) < 1e-8, 1.0, x)
    return jnp.where(jnp.abs(x) < 1e-8, 1.0, (jnp.exp(safe) - 1.0) / safe)


MATFUNCS = {
    "exp": lambda t, lam: jnp.exp(t * lam),
    "sinc": lambda t, lam: _sinc(t * lam),
    "phi1": lambda t, lam: _phi1(t * lam),
    "cos_sqrt": lambda t, lam: jnp.cos(t * jnp.sqrt(jnp.abs(lam))),
    "sinc2_sqrt": lambda t, lam: _sinc(t * jnp.sqrt(jnp.abs(lam))) ** 2,
    "id_sqrt": lambda t, lam: t * jnp.sqrt(jnp.abs(lam)),
    "sinc2_sqrt_half":
        lambda t, lam: _sinc(t / 2.0 * jnp.sqrt(jnp.abs(lam))) ** 2,
    "mod_cosine": lambda t, lam: _mod_cosine(t * jnp.sqrt(jnp.abs(lam))) ** 2,
}


def lanczos(matvec, u, m, reorth=True, axis_names=()):
    """m-step (Hermitian) Lanczos of a matrix-free operator.

    Args:
      matvec: closure applying the symmetric/Hermitian operator to a field.
      u: start field, any shape, real or complex dtype.
      m: Krylov dimension (static).
      reorth: full reorthogonalization against all previous basis vectors
        (the reference always does this: eigen_krylov_real.hpp:31-38).
      axis_names: mesh axis names the field is spatially sharded over (inside
        shard_map). All inner products / norms are psum-reduced across them,
        so the iteration runs on distributed grids — new capability vs the
        reference, whose operator is always a single-device CSR (SURVEY.md §5).

    Returns:
      V: (m,) + u.shape Krylov basis, alpha: (m,) real diagonal of T,
      beta: (m-1,) real off-diagonal of T, beta0: real norm of u.

    Matches the reference recurrence (eigen_krylov_real.hpp:8-55) including the
    absence of a breakdown early-exit (commented out there as well).
    """
    vs, alphas, betas, beta0 = _lanczos_cols(matvec, u, m, reorth=reorth,
                                             axis_names=axis_names)
    rdtype = real_dtype_of(u.dtype)
    V = jnp.stack(vs) if m > 1 else vs[0][None]
    # alpha[m-1] stays 0: the reference's loop never writes T(m-1, m-1) either
    # (zero-initialized, eigen_krylov_real.hpp:14,23-49), and f(T) sees that 0.
    zero = jnp.zeros((), rdtype) * beta0   # data-derived zero: stays
    # shard-varying inside shard_map over extra (e.g. batch) mesh axes.
    alpha = jnp.stack(alphas + [zero]) if alphas else jnp.zeros((m,), rdtype)
    beta = jnp.stack(betas) if betas else jnp.zeros((0,), rdtype)
    return V, alpha, beta, beta0


def _lanczos_cols(matvec, u, m, reorth=True, axis_names=()):
    """Lanczos keeping the basis as a list of columns (no (m, n) stack).

    Internal form used by matfunc_apply: the final linear combination is a
    fused multiply-add chain over the columns, so the basis never needs to be
    materialized as one contiguous array — at 1024^2, m=10 that saves a
    ~160 MB/step copy (benchmarks/ab_lanczos.py).
    """
    axis_names = tuple(axis_names)
    rdtype = real_dtype_of(u.dtype)

    def gsum(x):
        return lax.psum(x, axis_names) if axis_names else x

    def gnorm(x):
        s = gsum(jnp.sum(jnp.real(x) ** 2 + (jnp.imag(x) ** 2
                                             if jnp.iscomplexobj(x) else 0.0)))
        return jnp.sqrt(s).astype(rdtype)

    def vdot(a, b):
        return gsum(jnp.vdot(a.reshape(-1), b.reshape(-1), precision=_HI))

    # Safe normalization: a zero start vector (e.g. sEWI's B(u) with the
    # reference's default m = 0, nlse_cubic_driver.cpp:64) or an exact
    # mid-iteration breakdown yields ZERO columns instead of NaN. The
    # reference divides by the raw norm (eigen_krylov_complex.hpp:21,46 —
    # its launchers always supply a nonzero m, so it never trips); when the
    # norm is positive this is bit-identical to the raw division, and
    # matfunc_apply scales the final combination by beta0, so f(L)·0 = 0.
    def safe_div(x, nrm):
        return (x / jnp.where(nrm > 0, nrm, 1)).astype(u.dtype)

    beta0 = gnorm(u)
    v0 = safe_div(u, beta0)

    n = u.size

    # The iteration is UNROLLED over j (m <= 20 always): with a static j the
    # full-reorthogonalization projection touches only the j+1 columns that
    # exist so far, instead of a fixed (m, n) block where m-j-1 rows are
    # still zero. The basis lives as a python list of columns; the per-
    # iteration jnp.stack is a real copy; the alternatives are a
    # preallocated (m, n) buffer updated with .at[j].set (XLA may copy the
    # whole buffer per set) and per-column vdots (one reduction kernel per
    # column). benchmarks/ab_lanczos.py A/Bs the three layouts.
    vs = [v0]
    alphas = []
    betas = []
    for j in range(m - 1):
        vj = vs[j]
        w = matvec(vj).astype(u.dtype)
        if j > 0:
            w = w - betas[j - 1] * vs[j - 1]
        if reorth:
            # One fused classical-Gram-Schmidt pass: a single (j+1, n)
            # projection matvec yields alpha (= last entry, the Rayleigh
            # quotient v_j . w) AND the full-reorthogonalization
            # coefficients, then one reconstruction matvec subtracts every
            # component. Numerically this is the reference's MGS alpha-step
            # + full reorth (lanczos.hpp:208-267) collapsed into two
            # bandwidth-optimal passes over the live basis; the Rayleigh
            # quotient is identical, the reorth correction agrees to
            # rounding (tests/test_krylov.py pins both).
            Vm = jnp.stack([v.reshape(n) for v in vs])      # (j+1, n)
            proj = gsum(jnp.matmul(jnp.conj(Vm), w.reshape(n),
                                   precision=_HI))          # (j+1,)
            a = jnp.real(proj[j]).astype(rdtype)
            w = w - jnp.matmul(proj, Vm, precision=_HI).reshape(u.shape)
        else:
            a = jnp.real(vdot(vj, w)).astype(rdtype)
            w = w - a * vj
        b = gnorm(w)
        vs.append(safe_div(w, b))
        alphas.append(a)
        betas.append(b)

    return vs, alphas, betas, beta0


def tridiag_eigh(alpha, beta):
    """Eigendecomposition of the real symmetric tridiagonal T(alpha, beta).

    Pinned to full-f32 matmul precision: any matmul inside the eigh
    expansion run in TF32 would corrupt the eigenvectors at ~1e-3, which
    would dominate the whole matfunc's error budget (see _HI note above).

    The QR-based solver is requested explicitly (LAPACK/cuSOLVER syevd).
    For matrices this small the GPU default is Jacobi (syevj), whose f32
    eigenvectors measured 1.8e-6 from orthogonal on an H100 against 8e-7
    for syevd; a non-orthogonal Q makes exp(i dt T) non-unitary, which took
    the 1024^2 complex64 SS2 mass drift from 8e-6 to 1.1e-3 over 1000 steps
    (and syevj was the slower of the two). The CPU backend runs syevd
    either way.
    """
    T = jnp.diag(alpha) + jnp.diag(beta, 1) + jnp.diag(beta, -1)
    with jax.default_matmul_precision("highest"):
        Q, lam = lax.linalg.eigh(
            T, implementation=lax.linalg.EighImplementation.QR)
    return lam, Q


def matfunc_apply(matvec, u, t, func, m=default_krylov_m, reorth=True,
                  axis_names=()):
    """y = beta0 * V @ (Q f(t, D) Q^T e1) — the full reference matfunc apply.

    `func` is a key of MATFUNCS or a callable (t, lam) -> f values. `t` may be
    complex (for "exp" with tau = i*dt as in SS2). With `axis_names` the whole
    pipeline runs on spatially sharded fields: the tiny T eigh is computed
    redundantly per shard (it is replicated after the psums), which costs
    nothing and needs no extra communication.
    """
    return matfunc_apply_multi(matvec, u, ((t, func),), m=m, reorth=reorth,
                               axis_names=axis_names)[0]


def matfunc_apply_multi(matvec, u, specs, m=default_krylov_m, reorth=True,
                        axis_names=()):
    """[f1(t1 L) u, f2(t2 L) u, ...] from ONE Lanczos decomposition of u.

    `specs` is a sequence of (t, func) pairs. All outputs share the same
    Krylov basis V and tridiagonal T, so each result is BIT-IDENTICAL to a
    standalone matfunc_apply call with that spec — Lanczos is deterministic
    in u — while the expensive iteration (matvecs + reorthogonalization) runs
    once. The reference always re-runs Lanczos per matfunc even on the same
    vector (e.g. the Gautschi step's filter + cos pair, sg_single_solver.hpp:
    52-57 — 3 Lanczos runs where 2 suffice); this is a structural win on
    every Gautschi-type stepper. Returns a tuple, one field per spec.
    """
    specs = tuple(specs)
    vs, alphas, betas, beta0 = _lanczos_cols(matvec, u, m, reorth=reorth,
                                             axis_names=axis_names)
    rdtype = real_dtype_of(u.dtype)
    zero = jnp.zeros((), rdtype) * beta0   # data-derived, shard-varying
    alpha = jnp.stack(alphas + [zero]) if alphas else jnp.zeros((m,), rdtype)
    beta = jnp.stack(betas) if betas else jnp.zeros((0,), rdtype)
    lam, Q = tridiag_eigh(alpha, beta)
    outs = []
    for t, func in specs:
        f = MATFUNCS[func] if isinstance(func, str) else func
        fvals = f(np.asarray(t), lam)   # numpy scalar: safe jit constant
        # y = beta0 * V (Q f(D) Q^T e1); Q^T e1 is Q's first row. The tiny
        # m-vector algebra may promote to 64-bit (np scalar t under x64); the
        # field-sized result always stays in the state dtype — otherwise a
        # float32 scan carry silently becomes float64 mid-trajectory.
        coef = (beta0 * jnp.matmul(Q, fvals * Q[0, :],
                                   precision=_HI)).astype(u.dtype)
        # Fused multiply-add chain over the live columns: one HBM pass, no
        # contiguous (m, n) stack of the basis (see _lanczos_cols docstring).
        # Multiple specs re-walk the same columns; XLA fuses the chains into
        # one read of each v_i.
        out = coef[0] * vs[0]
        for i in range(1, m):
            out = out + coef[i] * vs[i]
        outs.append(out.astype(u.dtype))
    return tuple(outs)


def expm_apply(matvec, u, t, m=default_krylov_m, reorth=True, axis_names=()):
    """exp(t L) u — reference `expm_multiply` (eigen_krylov_complex.hpp:54-83)."""
    return matfunc_apply(matvec, u, t, "exp", m=m, reorth=reorth,
                         axis_names=axis_names)
