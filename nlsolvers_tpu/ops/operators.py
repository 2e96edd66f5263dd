"""Matrix-free finite-difference operators on no-flux grids.

Replacements for the reference's CSR sparse matrices
(`nlsolvers/common/include/laplacians.hpp`). A 5/7-point stencil is a handful
of shifted adds that XLA fuses into a single pass over device memory —
building a CSR matrix and doing SpMV (the reference's cuSPARSE design) would
cost extra memory for the index arrays and extra bandwidth to read them.
Every operator here is a closure `apply(u) -> Lu` acting on fields shaped
`(..., ny, nx)` (2D) or `(..., nz, ny, nx)` (3D); leading axes are batch
axes, so the same closure is `vmap`/sharding transparent.

Reference-parity notes (each verified against dense matrices in
tests/reference_ops.py):

* `laplacian_2d` reproduces `build_laplacian_noflux` (laplacians.hpp:10-52)
  exactly: diagonal -4 in the interior, -3 on the entire boundary ring
  *including corners* (the reference comments "missing: corners!" — corner rows
  have only two neighbor couplings yet keep diagonal -3, so corner row sums are
  -1, not 0). `variant="clean"` instead uses diagonal = -(#existing neighbors),
  the exact conservative no-flux operator.

* `laplacian_3d` reproduces `build_laplacian_noflux_3d` (laplacians.hpp:105-156)
  including its seam quirk: the y-neighbor triplet loop couples flat indices
  i <-> i+(nx+2) for *all* i, which in (z,y,x) order links the last y-row of
  each z-plane to the first y-row of the next plane. We express that exactly by
  running the y-neighbor sum over the merged (z*y, x) view. `variant="clean"`
  drops the seam couplings and uses diagonal = -(#neighbors).

* `anisotropic_laplacian_2d/_3d` reproduce the finite-volume div(c grad u)
  builders (laplacians.hpp:54-103,158-218): face coupling = arithmetic mean of
  the two cell c-values, diagonal = -sum of the row's couplings (these are
  exactly conservative — no corner quirk). The 3D version has the same y-seam
  quirk under `variant="reference"`.

* `separated_laplacian_2d` reproduces `build_separated_laplacian_noflux`
  (laplacians.hpp:220-269): per-direction 1D operators with diagonals
  -2 (interior) / -1 (that direction's boundary) / -1.5 (corners).

* `biharmonic_x` reproduces `build_xxxx_noflux` (root laplacians.hpp:158-200,
  used by the gen-1 Boussinesq solver): 1D fourth derivative along x with the
  reference's one-sided closures, including its idiosyncratic near-boundary row
  (4, -2, -2) at i=1 touching u[i+1], u[i+2].

All operators scale like the reference: 2D by 1/(dx*dy), 3D by 1/dx^2
(the reference asserts cubic/square grids), biharmonic by 1/dx^4.
"""

from functools import partial

import numpy as np
import jax.numpy as jnp
from jax import lax

__all__ = [
    "laplacian_2d",
    "laplacian_3d",
    "anisotropic_laplacian_2d",
    "anisotropic_laplacian_3d",
    "separated_laplacian_2d",
    "biharmonic_x",
    "neighbor_sum",
]


def _const_or_traced(c):
    """Concrete coefficient fields become numpy (jit-embedded constants);
    tracers pass through so operators can close over per-trajectory c that is
    an argument of the surrounding jit/vmap (pipeline/engine.py)."""
    import jax

    if isinstance(c, jax.core.Tracer):
        return c
    return np.asarray(c)


def _zeros_slice(u, axis):
    """A width-1 zero slab along `axis` (negative axis indices supported)."""
    shape = list(u.shape)
    shape[axis] = 1
    return jnp.zeros(shape, u.dtype)


def neighbor_sum(u, axis):
    """Sum of existing (non-wrapping) nearest neighbors along one axis.

    Cell i receives u[i-1] + u[i+1] where those neighbors exist, 0 otherwise.
    This is the matrix-free analogue of the off-diagonal 1-couplings in the
    reference CSR builders.
    """
    n = u.shape[axis]
    fwd = lax.slice_in_dim(u, 1, n, axis=axis)      # u[i+1] seen by cell i
    bwd = lax.slice_in_dim(u, 0, n - 1, axis=axis)  # u[i-1] seen by cell i
    z = _zeros_slice(u, axis)
    return (jnp.concatenate([fwd, z], axis=axis)
            + jnp.concatenate([z, bwd], axis=axis))


def _boundary_mask_2d(ny, nx):
    m = np.zeros((ny, nx), np.float64)
    m[0, :] = m[-1, :] = 1.0
    m[:, 0] = m[:, -1] = 1.0
    return m


def _boundary_mask_3d(nz, ny, nx):
    m = np.zeros((nz, ny, nx), np.float64)
    m[0], m[-1] = 1.0, 1.0
    m[:, 0, :] = m[:, -1, :] = 1.0
    m[:, :, 0] = m[:, :, -1] = 1.0
    return m


def _neighbor_count_2d(ny, nx):
    c = np.full((ny, nx), 4.0)
    c[0, :] -= 1.0
    c[-1, :] -= 1.0
    c[:, 0] -= 1.0
    c[:, -1] -= 1.0
    return c


def _neighbor_count_3d(nz, ny, nx):
    c = np.full((nz, ny, nx), 6.0)
    for ax, n in ((0, nz), (1, ny), (2, nx)):
        sl = [slice(None)] * 3
        sl[ax] = 0
        c[tuple(sl)] -= 1.0
        sl[ax] = n - 1
        c[tuple(sl)] -= 1.0
    return c


def laplacian_2d(shape, dx, dy, variant="reference", dtype=jnp.float32):
    """Matrix-free 5-point no-flux Laplacian on an (ny, nx) grid.

    Parity target: `build_laplacian_noflux(nx-2, ny-2, dx, dy)` applied to the
    full nx*ny grid, as the drivers do (host/drivers/nlse_cubic_driver.cpp:84).
    """
    ny, nx = shape
    if variant == "reference":
        diag = -4.0 + _boundary_mask_2d(ny, nx)     # -3 on the whole ring
    elif variant == "clean":
        diag = -_neighbor_count_2d(ny, nx)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    diag = np.asarray(diag, dtype)   # numpy: jit-embedded constant
    scale = 1.0 / (dx * dy)

    def apply(u):
        nb = neighbor_sum(u, -1) + neighbor_sum(u, -2)
        return (nb + diag * u) * scale

    return apply


def laplacian_3d(shape, dx, variant="reference", dtype=jnp.float32):
    """Matrix-free 7-point no-flux Laplacian on an (nz, ny, nx) grid.

    Parity target: `build_laplacian_noflux_3d` (laplacians.hpp:105-156),
    including (variant="reference") its cross-plane y-seam couplings.
    """
    nz, ny, nx = shape
    if variant == "reference":
        diag = -6.0 + _boundary_mask_3d(nz, ny, nx)  # -5 anywhere on boundary
    elif variant == "clean":
        diag = -_neighbor_count_3d(nz, ny, nx)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    diag = np.asarray(diag, dtype)   # numpy: jit-embedded constant
    scale = 1.0 / (dx * dx)

    def apply(u):
        batch = u.shape[:-3]
        nb = neighbor_sum(u, -1) + neighbor_sum(u, -3)
        if variant == "reference":
            # y-neighbors over the merged (z*y, x) view: couples consecutive
            # rows across plane seams exactly like the flat-index loop at
            # laplacians.hpp:140-143.
            v = u.reshape(batch + (nz * ny, nx))
            nb = nb + neighbor_sum(v, -2).reshape(u.shape)
        else:
            nb = nb + neighbor_sum(u, -2)
        return (nb + diag * u) * scale

    return apply


def anisotropic_laplacian_2d(c, dx, dy):
    """Finite-volume div(c grad u) with no-flux boundaries on an (ny, nx) grid.

    Face coupling between adjacent cells = (c_a + c_b)/2; each cell's diagonal
    is minus the sum of its face couplings, so the operator is exactly
    conservative (parity: laplacians.hpp:54-103). Scaled 1/(dx*dy).
    """
    c = _const_or_traced(c)
    wx = 0.5 * (c[..., :, :-1] + c[..., :, 1:])   # faces along x
    wy = 0.5 * (c[..., :-1, :] + c[..., 1:, :])   # faces along y
    scale = 1.0 / (dx * dy)

    def apply(u):
        fx = wx * (u[..., :, 1:] - u[..., :, :-1])
        fy = wy * (u[..., 1:, :] - u[..., :-1, :])
        out = jnp.zeros(jnp.broadcast_shapes(u.shape, c.shape),
                        jnp.result_type(u, wx))
        out = out.at[..., :, :-1].add(fx)
        out = out.at[..., :, 1:].add(-fx)
        out = out.at[..., :-1, :].add(fy)
        out = out.at[..., 1:, :].add(-fy)
        return out * scale

    return apply


def anisotropic_laplacian_3d(c, dx, variant="reference"):
    """Finite-volume div(c grad u) on an (nz, ny, nx) grid, scaled 1/dx^2.

    Parity: `build_anisotropic_laplacian_noflux_3d` (laplacians.hpp:158-218).
    With variant="reference" the y-face loop runs over the merged (z*y) axis,
    reproducing the reference's cross-plane seam couplings.
    """
    c = _const_or_traced(c)
    nz, ny, nx = c.shape[-3:]
    scale = 1.0 / (dx * dx)

    wx = 0.5 * (c[..., :, :, :-1] + c[..., :, :, 1:])
    wz = 0.5 * (c[..., :-1, :, :] + c[..., 1:, :, :])
    if variant == "reference":
        cm = c.reshape(c.shape[:-3] + (nz * ny, nx))
        wy = 0.5 * (cm[..., :-1, :] + cm[..., 1:, :])
    elif variant == "clean":
        wy = 0.5 * (c[..., :, :-1, :] + c[..., :, 1:, :])
    else:
        raise ValueError(f"unknown variant {variant!r}")

    def apply(u):
        batch = jnp.broadcast_shapes(u.shape[:-3], c.shape[:-3])
        out = jnp.zeros(batch + (nz, ny, nx), jnp.result_type(u, wx))

        fx = wx * (u[..., :, :, 1:] - u[..., :, :, :-1])
        out = out.at[..., :, :, :-1].add(fx)
        out = out.at[..., :, :, 1:].add(-fx)

        fz = wz * (u[..., 1:, :, :] - u[..., :-1, :, :])
        out = out.at[..., :-1, :, :].add(fz)
        out = out.at[..., 1:, :, :].add(-fz)

        if variant == "reference":
            um = u.reshape(u.shape[:-3] + (nz * ny, nx))
            fy = wy * (um[..., 1:, :] - um[..., :-1, :])
            om = out.reshape(batch + (nz * ny, nx))
            om = om.at[..., :-1, :].add(fy)
            om = om.at[..., 1:, :].add(-fy)
            out = om.reshape(batch + (nz, ny, nx))
        else:
            fy = wy * (u[..., :, 1:, :] - u[..., :, :-1, :])
            out = out.at[..., :, :-1, :].add(fy)
            out = out.at[..., :, 1:, :].add(-fy)

        return out * scale

    return apply


def separated_laplacian_2d(shape, dx, dy, dtype=jnp.float32):
    """Per-direction 1D no-flux Laplacians (Lx, Ly) on an (ny, nx) grid.

    Parity: `build_separated_laplacian_noflux` (laplacians.hpp:220-269).
    Diagonals: -2 interior, -1 on that direction's boundary, -1.5 at corners.
    Returns (apply_x, apply_y).
    """
    ny, nx = shape
    col = np.arange(nx)[None, :].repeat(ny, 0)
    row = np.arange(ny)[:, None].repeat(nx, 1)
    x_edge = (col == 0) | (col == nx - 1)
    y_edge = (row == 0) | (row == ny - 1)
    corner = x_edge & y_edge
    diag_x = np.where(x_edge, -1.0, -2.0)
    diag_x[corner] = -1.5
    diag_y = np.where(y_edge, -1.0, -2.0)
    diag_y[corner] = -1.5
    diag_x = np.asarray(diag_x, dtype)
    diag_y = np.asarray(diag_y, dtype)

    def apply_x(u):
        return (neighbor_sum(u, -1) + diag_x * u) / (dx * dx)

    def apply_y(u):
        return (neighbor_sum(u, -2) + diag_y * u) / (dy * dy)

    return apply_x, apply_y


def biharmonic_x(shape, dx, dtype=jnp.float32):
    """1D fourth derivative along x with the reference's boundary closures.

    Parity: `build_xxxx_noflux` (root laplacians.hpp:158-200), used by the
    gen-1 Boussinesq solver. Row stencils (columns, per x-index i):
      i = 0      :  2 u0 - 2 u1
      i = nx-1   :  2 u[-1] - 2 u[-2]
      i = 1      :  4 u1 - 2 u2 - 2 u3     (the reference's one-sided row)
      i = nx-2   :  4 u[-2] - 2 u[-3] - 2 u[-4]
      interior   :  u[i-2] - 4 u[i-1] + 6 u[i] - 4 u[i+1] + u[i+2]
    Scaled by 1/dx^4.
    """
    ny, nx = shape
    scale = 1.0 / dx**4

    # Dense 1D operator row bank (nx, nx), applied via matmul on the last axis:
    # nx is at most a few thousand, but a matmul would be O(nx^2) per row —
    # instead build it as shifted adds with per-column coefficient masks.
    col = np.arange(nx)
    interior = (col >= 2) & (col <= nx - 3)

    # Coefficients for u[i+k] gathered as masked shifts.
    def coef(k):
        """Per-column coefficient multiplying u[i+k] in row i."""
        c = np.zeros(nx)
        c[interior] = {-2: 1.0, -1: -4.0, 0: 6.0, 1: -4.0, 2: 1.0}[k]
        # boundary rows
        if k == 0:
            c[0] = c[nx - 1] = 2.0
            c[1] = c[nx - 2] = 4.0
        if k == 1:
            c[0] = -2.0       # row 0 touches u1
            c[1] = -2.0       # row 1 touches u2
        if k == 2:
            c[1] = -2.0       # row 1 touches u3
        if k == -1:
            c[nx - 1] = -2.0  # last row touches u[-2]
            c[nx - 2] = -2.0  # row nx-2 touches u[-3]
        if k == -2:
            c[nx - 2] = -2.0  # row nx-2 touches u[-4]
        return c

    coefs = {k: np.asarray(coef(k), dtype) for k in (-2, -1, 0, 1, 2)}

    def shift(u, k):
        """u[i+k] with zeros where out of range, along the last axis."""
        if k == 0:
            return u
        if k > 0:
            body = u[..., k:]
            pad = jnp.zeros(u.shape[:-1] + (k,), u.dtype)
            return jnp.concatenate([body, pad], axis=-1)
        body = u[..., :k]
        pad = jnp.zeros(u.shape[:-1] + (-k,), u.dtype)
        return jnp.concatenate([pad, body], axis=-1)

    def apply(u):
        out = jnp.zeros_like(u)
        for k, c in coefs.items():
            out = out + c * shift(u, k)
        return out * scale

    return apply
