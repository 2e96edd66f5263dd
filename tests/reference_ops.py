"""Dense numpy re-creations of the reference's sparse operator builders.

These reproduce, triplet for triplet, the CSR constructions in
`/root/reference/nlsolvers/common/include/laplacians.hpp` (and the root gen-1
`laplacians.hpp` biharmonic), so operator unit tests can check the matrix-free
stencils against the exact matrices the reference would build — including its
quirks (corner diagonals, 3D y-seam couplings).
"""

import numpy as np


def build_laplacian_noflux(nx, ny, dx, dy):
    """laplacians.hpp:10-52. Full grid is (nx+2) x (nx+2); returns (N, N)."""
    assert nx == ny
    nf = nx + 2
    N = nf * nf
    L = np.zeros((N, N))
    for i in range(N):
        boundary = i < nf or i >= N - nf or i % nf == 0 or i % nf == nf - 1
        L[i, i] = -3.0 if boundary else -4.0
    for i in range(N - 1):
        if (i + 1) % nf != 0:
            L[i, i + 1] += 1.0
            L[i + 1, i] += 1.0
    for i in range(N - nf):
        L[i, i + nf] += 1.0
        L[i + nf, i] += 1.0
    return L / (dx * dy)


def build_anisotropic_laplacian_noflux(nx, ny, dx, dy, c):
    """laplacians.hpp:54-103. c is flat of length (nx+2)^2."""
    assert nx == ny
    nf = nx + 2
    N = nf * nf
    L = np.zeros((N, N))
    diag = np.zeros(N)
    for i in range(N - 1):
        if (i + 1) % nf != 0:
            w = 0.5 * (c[i] + c[i + 1])
            L[i, i + 1] += w
            L[i + 1, i] += w
            diag[i] += w
            diag[i + 1] += w
    for i in range(N - nf):
        w = 0.5 * (c[i] + c[i + nf])
        L[i, i + nf] += w
        L[i + nf, i] += w
        diag[i] += w
        diag[i + nf] += w
    L[np.arange(N), np.arange(N)] -= diag
    return L / (dx * dy)


def build_laplacian_noflux_3d(nx, ny, nz, dx):
    """laplacians.hpp:105-156, including the unconditional y-neighbor loop."""
    assert nx == ny == nz
    nf = nx + 2
    plane = nf * nf
    N = plane * nf
    L = np.zeros((N, N))
    for k in range(nf):
        for j in range(nf):
            for i in range(nf):
                idx = k * plane + j * nf + i
                boundary = (k in (0, nf - 1) or j in (0, nf - 1)
                            or i in (0, nf - 1))
                L[idx, idx] = -5.0 if boundary else -6.0
    for i in range(N - 1):
        if (i + 1) % nf != 0:
            L[i, i + 1] += 1.0
            L[i + 1, i] += 1.0
    for i in range(N - nf):  # note: crosses plane seams, as in the reference
        L[i, i + nf] += 1.0
        L[i + nf, i] += 1.0
    for i in range(N - plane):
        L[i, i + plane] += 1.0
        L[i + plane, i] += 1.0
    return L / (dx * dx)


def build_anisotropic_laplacian_noflux_3d(nx, dx, c):
    """laplacians.hpp:158-218 (same seam quirk). c flat of length (nx+2)^3."""
    nf = nx + 2
    plane = nf * nf
    N = plane * nf
    L = np.zeros((N, N))
    diag = np.zeros(N)
    for i in range(N - 1):
        if (i + 1) % nf != 0:
            w = 0.5 * (c[i] + c[i + 1])
            L[i, i + 1] += w
            L[i + 1, i] += w
            diag[i] += w
            diag[i + 1] += w
    for i in range(N - nf):
        w = 0.5 * (c[i] + c[i + nf])
        L[i, i + nf] += w
        L[i + nf, i] += w
        diag[i] += w
        diag[i + nf] += w
    for i in range(N - plane):
        w = 0.5 * (c[i] + c[i + plane])
        L[i, i + plane] += w
        L[i + plane, i] += w
        diag[i] += w
        diag[i + plane] += w
    L[np.arange(N), np.arange(N)] -= diag
    return L / (dx * dx)


def build_conservative_laplacian(shape, dx, c=None):
    """variant="clean": the exact conservative no-flux operator on a grid of
    any dimension — neighbours along each axis couple with weight
    (c_a + c_b)/2 (1 without c), no plane seams, and each diagonal entry is
    minus the sum of its row's couplings. Returns (N, N), scaled 1/dx^2."""
    shape = tuple(shape)
    N = int(np.prod(shape))
    c = np.ones(N) if c is None else np.asarray(c, float).reshape(N)
    idx = np.arange(N).reshape(shape)
    L = np.zeros((N, N))
    for ax in range(len(shape)):
        lo = np.take(idx, np.arange(shape[ax] - 1), axis=ax).reshape(-1)
        hi = np.take(idx, np.arange(1, shape[ax]), axis=ax).reshape(-1)
        for a, b in zip(lo, hi):
            w = 0.5 * (c[a] + c[b])
            L[a, b] += w
            L[b, a] += w
            L[a, a] -= w
            L[b, b] -= w
    return L / (dx * dx)


def build_separated_laplacian_noflux(nx, dx, dy):
    """laplacians.hpp:220-269. Returns (Lx, Ly)."""
    nf = nx + 2
    N = nf * nf
    Lx = np.zeros((N, N))
    Ly = np.zeros((N, N))
    for j in range(nf):
        for i in range(nf):
            idx = j * nf + i
            corner = (i in (0, nf - 1)) and (j in (0, nf - 1))
            val_x = -2.0
            val_y = -2.0
            if i in (0, nf - 1):
                val_x = -1.5 if corner else -1.0
            if j in (0, nf - 1):
                val_y = -1.5 if corner else -1.0
            Lx[idx, idx] = val_x
            Ly[idx, idx] = val_y
            if i < nf - 1:
                Lx[idx, idx + 1] += 1.0
                Lx[idx + 1, idx] += 1.0
            if j < nf - 1:
                Ly[idx, idx + nf] += 1.0
                Ly[idx + nf, idx] += 1.0
    return Lx / (dx * dx), Ly / (dy * dy)


def build_xxxx_noflux(nx, dx):
    """Root laplacians.hpp:158-200 (gen-1 biharmonic, x-direction only)."""
    nf = nx + 2
    N = nf * nf
    L = np.zeros((N, N))
    for j in range(nf):
        for i in range(nf):
            idx = j * nf + i
            if i in (0, nf - 1):
                L[idx, idx] += 2.0
                L[idx, idx + 1 if i == 0 else idx - 1] += -2.0
            elif i in (1, nf - 2):
                L[idx, idx + 1 if i == 1 else idx - 1] += -2.0
                L[idx, idx] += 4.0
                L[idx, idx + 2 if i == 1 else idx - 2] += -2.0
            else:
                L[idx, idx - 2] += 1.0
                L[idx, idx - 1] += -4.0
                L[idx, idx] += 6.0
                L[idx, idx + 1] += -4.0
                L[idx, idx + 2] += 1.0
    return L / dx**4


def lanczos_L(L, u, m):
    """Numpy port of the reference Lanczos (eigen_krylov_real.hpp:8-55),
    including MGS full reorthogonalization. Works for real and complex u."""
    n = L.shape[0]
    V = np.zeros((n, m), dtype=u.dtype)
    T = np.zeros((m, m), dtype=u.dtype)
    beta = np.linalg.norm(u)
    V[:, 0] = u / beta
    for j in range(m - 1):
        w = L @ V[:, j]
        if j > 0:
            w = w - T[j - 1, j] * V[:, j - 1]
        T[j, j] = np.vdot(V[:, j], w)
        w = w - T[j, j] * V[:, j]
        for i in range(j + 1):
            coeff = np.vdot(V[:, i], w)
            w = w - coeff * V[:, i]
        T[j + 1, j] = np.linalg.norm(w)
        T[j, j + 1] = T[j + 1, j]
        V[:, j + 1] = w / T[j + 1, j]
    return V, T, beta


def matfunc_multiply(L, u, t, f, m=10):
    """Reference f(T) apply: beta * V Q f(t, lam) Q^H e1 (eigen_krylov_*.hpp)."""
    V, T, beta = lanczos_L(L, u, m)
    lam, Q = np.linalg.eigh(T)
    e1 = np.zeros(m)
    e1[0] = 1.0
    return beta * V @ (Q @ (f(t, lam) * (np.conj(Q.T) @ e1)))
