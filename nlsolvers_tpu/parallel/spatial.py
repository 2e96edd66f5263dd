"""Spatial domain decomposition: grids sharded over a device mesh.

NEW capability relative to the reference, which never decomposes a grid —
one trajectory always owns one whole device there (SURVEY.md §5, "the operator
is global CSR"). Here the (ny, nx) grid is split over mesh axes, the 5-point
stencil exchanges one-deep halos with `lax.ppermute` with mesh neighbors, and
every Lanczos inner product / norm is a `psum` (ops/krylov.py axis_names).

Everything runs inside `shard_map`; the helpers below build *local* operator
closures that are drop-in replacements for the single-device stencils in
ops/operators.py, verified bit-for-bit against them in tests/test_parallel.py.

Layout notes:
  * halo slabs are width-1; the edge shard of each mesh axis receives zeros
    from ppermute (no wraparound pairs), which is exactly the no-flux stencil's
    missing-neighbor semantics — the halo IS the boundary condition.
  * the reference-variant diagonal (-4/-3 ring) and the Neumann ghost copies
    need global coordinates, reconstructed from lax.axis_index.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nlsolvers_tpu.config import real_dtype_of
from nlsolvers_tpu.models import nlse as nlse_mod
from nlsolvers_tpu.models import realwave as rw
from nlsolvers_tpu.models.nonlinearities import nlse_density, realwave_g

__all__ = [
    "halo_neighbor_sum",
    "sharded_laplacian_2d",
    "sharded_anisotropic_laplacian_2d",
    "sharded_anisotropic_laplacian_3d",
    "sharded_neumann_2d",
    "sharded_laplacian_3d",
    "sharded_neumann_3d",
    "make_sharded_nlse_step",
    "make_sharded_realwave_step",
    "make_sharded_nlse_trajectory_fn",
    "make_sharded_realwave_trajectory_fn",
]


def _axis_size(axis_name):
    return lax.psum(1, axis_name)


def _recv_from_next(slab, axis_name):
    """Each shard receives the given slab from its successor (last gets 0)."""
    size = lax.axis_size(axis_name)
    perm = [(i, i - 1) for i in range(1, size)]
    return lax.ppermute(slab, axis_name, perm)


def _recv_from_prev(slab, axis_name):
    """Each shard receives the given slab from its predecessor (first gets 0)."""
    size = lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(size - 1)]
    return lax.ppermute(slab, axis_name, perm)


def halo_neighbor_sum(u, axis, axis_name):
    """Distributed analogue of ops.operators.neighbor_sum along one grid axis
    sharded over `axis_name`: u[i-1] + u[i+1] with cross-shard halos and zeros
    at the global ends."""
    n = u.shape[axis]
    fwd = lax.slice_in_dim(u, 1, n, axis=axis)
    bwd = lax.slice_in_dim(u, 0, n - 1, axis=axis)
    first = lax.slice_in_dim(u, 0, 1, axis=axis)
    last = lax.slice_in_dim(u, n - 1, n, axis=axis)
    halo_next = _recv_from_next(first, axis_name)  # successor's first row
    halo_prev = _recv_from_prev(last, axis_name)   # predecessor's last row
    return (jnp.concatenate([fwd, halo_next], axis=axis)
            + jnp.concatenate([halo_prev, bwd], axis=axis))


def _global_coords(local_shape, axis_names):
    """Global (row, col) index arrays of the local block, each (lny, lnx)."""
    lny, lnx = local_shape
    ay, ax = axis_names
    gy = (lax.axis_index(ay) * lny
          + lax.broadcasted_iota(jnp.int32, (lny, lnx), 0))
    gx = (lax.axis_index(ax) * lnx
          + lax.broadcasted_iota(jnp.int32, (lny, lnx), 1))
    return gy, gx


def sharded_laplacian_2d(global_shape, dx, dy, axis_names,
                         variant="reference", dtype=jnp.float32):
    """Local closure for the 2D no-flux Laplacian on a (ay, ax)-sharded grid.

    Semantics identical to ops.operators.laplacian_2d on the gathered global
    array (parity: laplacians.hpp:10-52, including the -3 ring diagonal).
    """
    NY, NX = global_shape
    ay, ax = axis_names
    scale = 1.0 / (dx * dy)

    def apply(u):
        lny, lnx = u.shape[-2:]
        gy, gx = _global_coords((lny, lnx), axis_names)
        ring = ((gy == 0) | (gy == NY - 1) | (gx == 0) | (gx == NX - 1))
        if variant == "reference":
            diag = jnp.where(ring, -3.0, -4.0).astype(dtype)
        elif variant == "clean":
            nnb = (4.0
                   - (gy == 0) - (gy == NY - 1)
                   - (gx == 0) - (gx == NX - 1))
            diag = (-nnb).astype(dtype)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        nb = (halo_neighbor_sum(u, -1, ax) + halo_neighbor_sum(u, -2, ay))
        return (nb + diag * u) * scale

    return apply


def sharded_neumann_2d(global_shape, axis_names):
    """Local closure for the Neumann ghost copy on a sharded grid.

    Same update order as boundaries.hpp:41-57: edge rows over interior global
    columns first, then full edge columns. Uses where-masks on global
    coordinates; requires local blocks of at least 2 rows/cols.
    """
    NY, NX = global_shape

    def apply(u):
        lny, lnx = u.shape[-2:]
        gy, gx = _global_coords((lny, lnx), axis_names)
        interior_x = (gx >= 1) & (gx <= NX - 2)
        u = jnp.where((gy == 0) & interior_x, u[..., 1:2, :], u)
        u = jnp.where((gy == NY - 1) & interior_x, u[..., -2:-1, :], u)
        u = jnp.where(gx == 0, u[..., :, 1:2], u)
        u = jnp.where(gx == NX - 1, u[..., :, -2:-1], u)
        return u

    return apply


def _global_coords_3d(local_shape, axis_names):
    """Global (z, y, x) index arrays of the local block."""
    lnz, lny, lnx = local_shape
    az, ay, ax = axis_names
    shape = (lnz, lny, lnx)
    gz = (lax.axis_index(az) * lnz
          + lax.broadcasted_iota(jnp.int32, shape, 0))
    gy = (lax.axis_index(ay) * lny
          + lax.broadcasted_iota(jnp.int32, shape, 1))
    gx = (lax.axis_index(ax) * lnx
          + lax.broadcasted_iota(jnp.int32, shape, 2))
    return gz, gy, gx


def sharded_laplacian_3d(global_shape, dx, axis_names,
                         variant="clean", dtype=jnp.float32):
    """Local closure for the 3D no-flux Laplacian on a (az, ay, ax)-sharded
    grid, scaled 1/dx^2 like the reference (laplacians.hpp:105-156).

    variant="clean" (diagonal = -#neighbors, no seam couplings) works under
    any sharding. variant="reference" reproduces the cross-plane y-seam quirk
    (SURVEY.md, ops/operators.py laplacian_3d) and is only supported when the
    z and y mesh axes are singletons — the seam links the last y-row of each
    z-plane to the next plane's first row, which stays shard-local only if
    z*y is unsplit; a ValueError at trace time keeps wrong answers impossible.
    """
    NZ, NY, NX = global_shape
    az, ay, ax = axis_names
    scale = 1.0 / (dx * dx)

    def apply(u):
        lnz, lny, lnx = u.shape[-3:]
        gz, gy, gx = _global_coords_3d((lnz, lny, lnx), axis_names)
        boundary = ((gz == 0) | (gz == NZ - 1) | (gy == 0) | (gy == NY - 1)
                    | (gx == 0) | (gx == NX - 1))
        nb = (halo_neighbor_sum(u, -1, ax)
              + halo_neighbor_sum(u, -3, az))
        if variant == "reference":
            if lnz != NZ or lny != NY:
                raise ValueError(
                    "variant='reference' 3D sharding requires unsplit z and "
                    "y axes (the y-seam quirk is not shard-local); use "
                    "variant='clean' or shard only gx")
            diag = jnp.where(boundary, -5.0, -6.0).astype(dtype)
            # y-neighbors over the merged (z*y, x) view — the reference's
            # flat-index loop couples across plane seams (laplacians.hpp:140).
            v = u.reshape(u.shape[:-3] + (lnz * lny, lnx))
            nb = nb + neighbor_sum_local(v, -2).reshape(u.shape)
        elif variant == "clean":
            nnb = (6.0
                   - (gz == 0) - (gz == NZ - 1)
                   - (gy == 0) - (gy == NY - 1)
                   - (gx == 0) - (gx == NX - 1))
            diag = (-nnb).astype(dtype)
            nb = nb + halo_neighbor_sum(u, -2, ay)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        return (nb + diag * u) * scale

    return apply


def sharded_anisotropic_laplacian_2d(global_shape, dx, dy, axis_names):
    """Local closure for finite-volume div(c grad u) on a sharded 2D grid.

    Semantics identical to ops.operators.anisotropic_laplacian_2d on the
    gathered global array (laplacians.hpp:54-103): face coupling = mean of
    the two cell c values, conservative diagonal. Cross-shard faces use
    ppermute'd edge columns/rows of BOTH u and c; global-boundary faces are
    masked to zero (no flux). Returns apply(u, c) — c is a per-call local
    field so per-trajectory coefficient sweeps stay one compiled program.
    """
    NY, NX = global_shape
    ay, ax = axis_names
    scale = 1.0 / (dx * dy)

    def apply(u, c):
        lny, lnx = u.shape[-2:]
        gy, gx = _global_coords((lny, lnx), axis_names)
        return (_aniso_flux_axis(u, c, -1, ax, gx, NX)
                + _aniso_flux_axis(u, c, -2, ay, gy, NY)) * scale

    return apply


def _aniso_flux_axis(u, c, axis, axis_name, gc, N):
    """Conservative flux divergence along ONE sharded axis: returns
    f_i - f_{i-1} where f_i = 0.5(c_i + c_{i+1})(u_{i+1} - u_i), with
    cross-shard faces from ppermute'd edge slabs of BOTH u and c and
    no-flux (zero) faces at the global ends (mask by global coord `gc`).

    Shared helper of sharded_anisotropic_laplacian_{2d,3d}; semantics match
    the face terms of ops.operators.anisotropic_laplacian_* per axis
    (laplacians.hpp:54-103, 158-218)."""
    n = u.shape[axis]
    u_first = lax.slice_in_dim(u, 0, 1, axis=axis)
    u_last = lax.slice_in_dim(u, n - 1, n, axis=axis)
    c_first = lax.slice_in_dim(c, 0, 1, axis=axis)
    c_last = lax.slice_in_dim(c, n - 1, n, axis=axis)

    u_next = jnp.concatenate([lax.slice_in_dim(u, 1, n, axis=axis),
                              _recv_from_next(u_first, axis_name)],
                             axis=axis)
    c_next = jnp.concatenate([lax.slice_in_dim(c, 1, n, axis=axis),
                              _recv_from_next(c_first, axis_name)],
                             axis=axis)
    f = 0.5 * (c + c_next) * (u_next - u)
    f = jnp.where(gc == N - 1, 0.0, f)            # no face past the domain

    u_prev_edge = _recv_from_prev(u_last, axis_name)
    c_prev_edge = _recv_from_prev(c_last, axis_name)
    f_edge = 0.5 * (c_prev_edge + c_first) * (u_first - u_prev_edge)
    f_back = jnp.concatenate([f_edge,
                              lax.slice_in_dim(f, 0, n - 1, axis=axis)],
                             axis=axis)
    f_back = jnp.where(gc == 0, 0.0, f_back)      # no face before the domain
    return f - f_back


def sharded_anisotropic_laplacian_3d(global_shape, dx, axis_names,
                                     variant="clean"):
    """Local closure for finite-volume div(c grad u) on a sharded 3D grid,
    scaled 1/dx^2. Returns apply(u, c) — c is a per-call local field.

    Semantics identical to ops.operators.anisotropic_laplacian_3d on the
    gathered global array (laplacians.hpp:158-218). variant="clean"
    (plane-local y faces) works under any sharding. variant="reference"
    reproduces the merged (z*y)-axis face loop whose seam couples the last
    y-row of each plane to the next plane's first row; that seam is only
    shard-local when the z and y mesh axes are singletons — guarded with a
    trace-time ValueError like sharded_laplacian_3d.
    """
    NZ, NY, NX = global_shape
    az, ay, ax = axis_names
    scale = 1.0 / (dx * dx)

    def apply(u, c):
        lnz, lny, lnx = u.shape[-3:]
        gz, gy, gx = _global_coords_3d((lnz, lny, lnx), axis_names)
        out = (_aniso_flux_axis(u, c, -1, ax, gx, NX)
               + _aniso_flux_axis(u, c, -3, az, gz, NZ))
        if variant == "clean":
            out = out + _aniso_flux_axis(u, c, -2, ay, gy, NY)
        elif variant == "reference":
            if lnz != NZ or lny != NY:
                raise ValueError(
                    "variant='reference' 3D anisotropic sharding requires "
                    "unsplit z and y axes (the merged-row seam is not "
                    "shard-local); use variant='clean' or shard only gx")
            R = lnz * lny
            um = u.reshape(u.shape[:-3] + (R, lnx))
            cm = c.reshape(c.shape[:-3] + (R, lnx))
            wy = 0.5 * (cm[..., :-1, :] + cm[..., 1:, :])
            fy = wy * (um[..., 1:, :] - um[..., :-1, :])
            zrow = jnp.zeros(fy.shape[:-2] + (1, lnx), fy.dtype)
            f = jnp.concatenate([fy, zrow], axis=-2)       # face to row+1
            fb = jnp.concatenate([zrow, fy], axis=-2)      # face to row-1
            out = out + (f - fb).reshape(u.shape)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        return out * scale

    return apply


def neighbor_sum_local(u, axis):
    """Shard-local neighbor sum (no halo) — for merged-view seam terms."""
    n = u.shape[axis]
    fwd = lax.slice_in_dim(u, 1, n, axis=axis)
    bwd = lax.slice_in_dim(u, 0, n - 1, axis=axis)
    shape = list(u.shape)
    shape[axis] = 1
    z = jnp.zeros(shape, u.dtype)
    return (jnp.concatenate([fwd, z], axis=axis)
            + jnp.concatenate([z, bwd], axis=axis))


def sharded_neumann_3d(global_shape, axis_names):
    """Neumann ghost copy on a sharded 3D grid (boundaries_3d.hpp:8-31
    semantics via where-masks; requires local blocks >= 2 in each direction).
    """
    NZ, NY, NX = global_shape

    def apply(u):
        lnz, lny, lnx = u.shape[-3:]
        gz, gy, gx = _global_coords_3d((lnz, lny, lnx), axis_names)
        int_z = (gz >= 1) & (gz <= NZ - 2)
        int_y = (gy >= 1) & (gy <= NY - 2)
        # Same update order as ops.boundaries.neumann_no_velocity_3d:
        # x faces (interior y,z), y faces (interior z), z faces (all).
        u = jnp.where((gx == 0) & int_y & int_z, u[..., :, :, 1:2], u)
        u = jnp.where((gx == NX - 1) & int_y & int_z, u[..., :, :, -2:-1], u)
        u = jnp.where((gy == 0) & int_z, u[..., :, 1:2, :], u)
        u = jnp.where((gy == NY - 1) & int_z, u[..., :, -2:-1, :], u)
        u = jnp.where(gz == 0, u[..., 1:2, :, :], u)
        u = jnp.where(gz == NZ - 1, u[..., -2:-1, :, :], u)
        return u

    return apply


def _sharded_lap(global_shape, dx, axis_names, variant, rdtype):
    if len(global_shape) == 2:
        return sharded_laplacian_2d(global_shape, dx, dx, axis_names,
                                    variant=variant, dtype=rdtype)
    return sharded_laplacian_3d(global_shape, dx, axis_names,
                                variant=variant, dtype=rdtype)


def _sharded_neumann(global_shape, axis_names):
    if len(global_shape) == 2:
        return sharded_neumann_2d(global_shape, axis_names)
    return sharded_neumann_3d(global_shape, axis_names)


def _sharded_aniso(global_shape, dx, axis_names, variant):
    if len(global_shape) == 2:
        return sharded_anisotropic_laplacian_2d(global_shape, dx, dx,
                                                axis_names)
    return sharded_anisotropic_laplacian_3d(global_shape, dx, axis_names,
                                            variant=variant)


def _spec(mesh_axes, batch_axis):
    if batch_axis is None:
        return P(*mesh_axes)
    return P(batch_axis, *mesh_axes)


def make_sharded_nlse_step(kind, global_shape, Lx, dt, mesh,
                           axis_names=("gy", "gx"), batch_axis=None,
                           sigma1=1.0, sigma2=-0.1, kappa=1.0,
                           krylov_m=10, dtype=jnp.complex64,
                           variant="reference", apply_bc=True, reorth=True,
                           use_c=False):
    """Builds a jitted SS2 step over a spatially sharded (optionally also
    trajectory-batched) grid.

    Returns step(u_packed, m_field) -> u_packed, operating on GLOBAL arrays:
    u_packed is (2, *grid) stacked real/imag (or (2, B, *grid) with a batch
    axis), m_field is (*grid) / (B, *grid). Shardings follow the mesh axes;
    3D grids take axis_names=("gz", "gy", "gx"). With use_c=True the step
    takes an extra anisotropy field and applies the finite-volume
    div(c grad u) operator with cross-shard face fluxes (2D and 3D).
    """
    nx = global_shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    rdtype = real_dtype_of(dtype)

    if use_c:
        aniso = _sharded_aniso(global_shape, dx, axis_names, variant)
    else:
        lap = _sharded_lap(global_shape, dx, axis_names, variant, rdtype)
    neumann = (_sharded_neumann(global_shape, axis_names) if apply_bc
               else (lambda u: u))

    def local_single(u, mloc, cloc=None):
        op = (lambda v: aniso(v, cloc)) if use_c else lap
        rho = nlse_density(kind, mloc, sigma1=sigma1, sigma2=sigma2,
                           kappa=kappa)
        u = nlse_mod.ss2_step(u, op, rho, dt, m=krylov_m, reorth=reorth,
                              axis_names=axis_names)
        return neumann(u)

    def local_step(u_packed, mloc, cloc=None):
        u = lax.complex(u_packed[0], u_packed[1])
        if batch_axis is None:
            u = local_single(u, mloc, cloc)
        elif use_c:
            u = jax.vmap(local_single)(u, mloc, cloc)
        else:
            u = jax.vmap(local_single)(u, mloc)
        return jnp.stack([jnp.real(u), jnp.imag(u)])

    grid_spec = _spec(axis_names, batch_axis)
    u_spec = (P(None, *axis_names) if batch_axis is None
              else P(None, batch_axis, *axis_names))
    in_specs = ((u_spec, grid_spec, grid_spec) if use_c
                else (u_spec, grid_spec))
    sharded = jax.shard_map(local_step, mesh=mesh,
                            in_specs=in_specs,
                            out_specs=u_spec, check_vma=False)
    return jax.jit(sharded)


def make_sharded_realwave_step(kind, global_shape, Lx, dt, mesh,
                               axis_names=("gy", "gx"), batch_axis=None,
                               integrator="gautschi", krylov_m=10,
                               dtype=jnp.float32, variant="reference",
                               apply_bc=True, reorth=True, use_c=False):
    """Builds a jitted real-wave step (Gautschi or SV) on a sharded grid.

    Returns step(u, u_past, m_field) -> (u_new, u) on GLOBAL (*grid) arrays
    (or (B, *grid) with batch_axis); 3D takes axis_names=("gz", "gy", "gx").
    With use_c=True the step takes an extra anisotropy field and the
    operator is the finite-volume div(c grad u) with cross-shard face
    fluxes (the reference real-wave drivers' anisotropic L,
    sg_single_solver.hpp:42-59).
    """
    dx = 2.0 * Lx / (global_shape[-1] - 1)
    rdtype = real_dtype_of(dtype)
    g = realwave_g(kind)
    filter_func = "mod_cosine" if kind == "sine_gordon" else "id_sqrt"

    if use_c:
        aniso = _sharded_aniso(global_shape, dx, axis_names, variant)
    else:
        lap = _sharded_lap(global_shape, dx, axis_names, variant, rdtype)
    neumann = (_sharded_neumann(global_shape, axis_names) if apply_bc
               else (lambda u: u))

    def local_single(u, u_past, mloc, cloc=None):
        op = (lambda v: aniso(v, cloc)) if use_c else lap
        if integrator == "gautschi":
            omega2 = lambda w: -op(w)
            u_new, u_past_new = rw.gautschi_step(
                u, u_past, omega2, mloc, g, dt, m=krylov_m,
                filter_func=filter_func, reorth=reorth,
                axis_names=axis_names)
        else:
            u_new, u_past_new = rw.sv_step(u, u_past, op, mloc, g, dt)
        return neumann(u_new), u_past_new

    def local_step(u, u_past, mloc, cloc=None):
        if batch_axis is None:
            return local_single(u, u_past, mloc, cloc)
        if use_c:
            return jax.vmap(local_single)(u, u_past, mloc, cloc)
        return jax.vmap(local_single)(u, u_past, mloc)

    spec = _spec(axis_names, batch_axis)
    in_specs = (spec, spec, spec) + ((spec,) if use_c else ())
    if use_c:
        fn = local_step
    else:
        fn = lambda u, u_past, mloc: local_step(u, u_past, mloc)
    sharded = jax.shard_map(fn, mesh=mesh,
                            in_specs=in_specs,
                            out_specs=(spec, spec), check_vma=False)
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# Grid-sharded trajectory engines: the datagen path for single trajectories
# too large for one device (1024^2-256^3 configs — SURVEY.md section 5's
# "long-context" axis, new capability over the reference's one-grid-one-GPU
# model). Same contract as pipeline/engine.make_*_trajectory_fn, but the
# WHOLE evolution scan runs inside shard_map: halos ppermute between devices,
# Lanczos reductions psum, snapshots stack shard-locally and come back as
# one global array.
# ---------------------------------------------------------------------------

def _guard_helpers(axis_names):
    """Cross-shard guard plumbing: the finiteness verdict must be GLOBAL
    (a shard-local verdict would give shards different while_loop trip
    counts and deadlock the halo ppermutes inside the step) — the sharded
    analogue of the reference's on-device NaN-check kernel
    (device/sg_solver_dev.hpp:36-44)."""

    def all_finite(ok):
        bad = lax.psum((~ok).astype(jnp.int32), axis_names)
        return bad == 0

    return all_finite


def sharded_gradient(u, dx, axis, axis_name, gc, N):
    """np.gradient semantics (central diffs, first-order one-sided at the
    GLOBAL edges) along one sharded axis, halos via ppermute. Used by the
    sharded energy series so it matches the unsharded engine's
    jnp.gradient-based energy bit-for-bit in the interior."""
    n = u.shape[axis]
    first = lax.slice_in_dim(u, 0, 1, axis=axis)
    last = lax.slice_in_dim(u, n - 1, n, axis=axis)
    nxt = jnp.concatenate([lax.slice_in_dim(u, 1, n, axis=axis),
                           _recv_from_next(first, axis_name)], axis=axis)
    prv = jnp.concatenate([_recv_from_prev(last, axis_name),
                           lax.slice_in_dim(u, 0, n - 1, axis=axis)],
                          axis=axis)
    g = (nxt - prv) / (2.0 * dx)
    g = jnp.where(gc == 0, (nxt - u) / dx, g)
    g = jnp.where(gc == N - 1, (u - prv) / dx, g)
    return g


def make_sharded_nlse_trajectory_fn(kind, global_shape, Lx, dt, mesh,
                                    axis_names=("gy", "gx"),
                                    batch_axis=None, integrator="ss2",
                                    sigma1=1.0, sigma2=-0.1, kappa=1.0,
                                    krylov_m=10, dtype=jnp.complex64,
                                    variant="reference", apply_bc=True,
                                    reorth=True, use_c=True, guard=False,
                                    record_energy=False):
    """Builds traj(u0_packed, m, c, num_snapshots, snapshot_freq) on a
    spatially sharded grid.

    u0_packed: (B, 2, *global_shape) real — stacked (real, imag).
    m, c:      (B, *global_shape) real coefficient fields.
    Returns    (B, S, 2, *global_shape) — same contract as
    pipeline/engine.make_nlse_trajectory_fn, so pipeline/datagen.py can use
    either engine interchangeably (guard appends bad_at (B,) int32,
    record_energy a {"mass": (B, S)} series — both all-reduced over the
    spatial mesh axes). The batch axis is unsharded (replicated blocks per
    device) unless `batch_axis` names a mesh axis.
    """
    from nlsolvers_tpu.models.evolve import evolve, evolve_guarded

    nx = global_shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    rdtype = real_dtype_of(dtype)
    two_state = integrator in ("sewi", "sewi_fused", "gautschi")
    dV = dx ** len(global_shape)
    spatial_axes = tuple(range(1, len(global_shape) + 1))
    all_finite = _guard_helpers(axis_names)

    if use_c:
        aniso = _sharded_aniso(global_shape, dx, axis_names, variant)
    else:
        lap = _sharded_lap(global_shape, dx, axis_names, variant, rdtype)
    neumann = (_sharded_neumann(global_shape, axis_names) if apply_bc
               else (lambda u: u))

    def op_of(cloc):
        return (lambda v: aniso(v, cloc)) if use_c else lap

    def mass_of(state):
        u = state[0] if two_state else state
        local = jnp.sum(jnp.abs(u) ** 2, axis=spatial_axes) * dV
        return lax.psum(local, axis_names)

    def single_step(state, i, mloc, cloc):
        op = op_of(cloc)
        rho = nlse_density(kind, mloc, sigma1=sigma1, sigma2=sigma2,
                           kappa=kappa)
        if integrator == "ss2":
            u = nlse_mod.ss2_step(state, op, rho, dt, m=krylov_m,
                                  reorth=reorth, axis_names=axis_names)
            return neumann(u)
        if integrator == "sewi":
            two_step = nlse_mod.sewi_step
        elif integrator == "sewi_fused":
            two_step = partial(nlse_mod.sewi_step, fuse_exp_sinc=True)
        else:
            two_step = nlse_mod.gautschi_step
        u, u_prev = state

        def boot(_):
            return nlse_mod.sewi_first_step(u, op, rho, dt, m=krylov_m,
                                            reorth=reorth,
                                            axis_names=axis_names)

        def normal(_):
            return two_step(u, u_prev, op, rho, dt, m=krylov_m,
                            reorth=reorth, axis_names=axis_names)

        u_new, u_prev_new = lax.cond(i == 1, boot, normal, None)
        return neumann(u_new), u_prev_new

    vstep = jax.vmap(single_step, in_axes=(0, None, 0, 0))
    # batch dim is always present (sharded over batch_axis or replicated)
    u_spec = P(batch_axis, None, *axis_names)
    f_spec = P(batch_axis, *axis_names)
    out_spec = P(batch_axis, None, None, *axis_names)

    @partial(jax.jit, static_argnums=(3, 4))
    def traj(u0_packed, m, c, num_snapshots, snapshot_freq):
        def local(u0p, mloc, cloc):
            u0 = lax.complex(u0p[:, 0].astype(rdtype),
                             u0p[:, 1].astype(rdtype))
            state0 = (u0, u0) if two_state else u0
            observe = (lambda s: s[0]) if two_state else (lambda s: s)
            step = lambda st, i: vstep(st, i, mloc, cloc)

            def pack(snaps):
                snaps = jnp.moveaxis(snaps, 0, 1)          # (B, S, *local)
                return jnp.stack([jnp.real(snaps), jnp.imag(snaps)],
                                 axis=2)

            if not guard:
                snaps = evolve(step, state0, num_snapshots, snapshot_freq,
                               observe=observe)            # (S, B, *local)
                return pack(snaps)
            scalars = {"mass": mass_of} if record_energy else None
            snaps, bad_at, series = evolve_guarded(
                step, state0, num_snapshots, snapshot_freq,
                observe=observe, batched=True, scalars=scalars,
                finite_reduce=all_finite)
            series = {k: jnp.moveaxis(v, 0, 1) for k, v in series.items()}
            return ((pack(snaps), bad_at)
                    + ((series,) if record_energy else ()))

        out_specs = out_spec
        if guard:
            # bad_at and the series are all-reduced over the spatial axes;
            # only the batch axis (if meshed) stays sharded
            out_specs = (out_spec, P(batch_axis))
            if record_energy:
                out_specs += ({"mass": P(batch_axis, None)},)
        return jax.shard_map(local, mesh=mesh,
                             in_specs=(u_spec, f_spec, f_spec),
                             out_specs=out_specs, check_vma=False)(
            u0_packed, m, c)

    return traj


def make_sharded_realwave_trajectory_fn(kind, global_shape, Lx, dt, mesh,
                                        axis_names=("gy", "gx"),
                                        batch_axis=None,
                                        integrator="gautschi", krylov_m=10,
                                        dtype=jnp.float32,
                                        variant="reference", apply_bc=True,
                                        reorth=True, use_c=True,
                                        guard=False, record_energy=False):
    """Builds traj(u0, v0, m, c, num_snapshots, snapshot_freq) on a
    spatially sharded grid; same contract as
    pipeline/engine.make_realwave_trajectory_fn: (B, *shape) inputs,
    (u_traj, v_traj) outputs each (B, S, *shape) with v = (u - u_past)/dt
    (kg_driver.cpp:112); guard appends bad_at (B,) int32, record_energy an
    {"energy": (B, S)} series — both all-reduced over the spatial mesh
    axes. Gautschi and SV integrators; stochastic phi-4 is not
    grid-shardable (per-point noise would need globally consistent
    per-shard streams) — use the batch engine for it.
    """
    from nlsolvers_tpu.models.evolve import evolve, evolve_guarded
    from nlsolvers_tpu.models.nonlinearities import realwave_potential

    if kind == "stochastic_phi4":
        raise ValueError("stochastic_phi4 is not supported on sharded "
                         "grids; use pipeline/engine (batch sharding)")
    nx = global_shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    rdtype = real_dtype_of(dtype)
    g = realwave_g(kind)
    filter_func = "mod_cosine" if kind == "sine_gordon" else "id_sqrt"
    dV = dx ** len(global_shape)
    spatial_axes = tuple(range(1, len(global_shape) + 1))
    all_finite = _guard_helpers(axis_names)
    potential_density = realwave_potential(kind)

    def energy_of(state):
        """Per-lane total energy, psum'd over the spatial mesh; the gradient
        terms use halo-aware central differences so the value matches the
        unsharded engine's jnp.gradient-based energy."""
        u, u_past = state
        v = (u - u_past) / dt

        def coords(a):
            ln = u.shape[a]
            N = global_shape[a - 1]           # a counts the batch axis
            name = axis_names[a - 1]
            gc = (lax.axis_index(name) * ln
                  + lax.broadcasted_iota(jnp.int32, u.shape, a))
            return name, gc, N

        grad2 = 0.0
        for a in spatial_axes:
            name, gc, N = coords(a)
            grad2 = grad2 + sharded_gradient(u, dx, a, name, gc, N) ** 2
        dens = 0.5 * v ** 2 + 0.5 * grad2 + potential_density(u)
        return lax.psum(jnp.sum(dens, axis=spatial_axes) * dV, axis_names)

    if use_c:
        aniso = _sharded_aniso(global_shape, dx, axis_names, variant)
    else:
        lap = _sharded_lap(global_shape, dx, axis_names, variant, rdtype)
    neumann = (_sharded_neumann(global_shape, axis_names) if apply_bc
               else (lambda u: u))

    def single_step(state, i, mloc, cloc):
        op = (lambda v: aniso(v, cloc)) if use_c else lap
        u, u_past = state
        if integrator == "gautschi":
            omega2 = lambda w: -op(w)
            u_new, u_past_new = rw.gautschi_step(
                u, u_past, omega2, mloc, g, dt, m=krylov_m,
                filter_func=filter_func, reorth=reorth,
                axis_names=axis_names)
        else:
            u_new, u_past_new = rw.sv_step(u, u_past, op, mloc, g, dt)
        return neumann(u_new), u_past_new

    vstep = jax.vmap(single_step, in_axes=(0, None, 0, 0))
    # batch dim is always present (sharded over batch_axis or replicated)
    f_spec = P(batch_axis, *axis_names)
    out_spec = P(batch_axis, None, *axis_names)

    @partial(jax.jit, static_argnums=(4, 5))
    def traj(u0, v0, m, c, num_snapshots, snapshot_freq):
        def local(u0, v0, mloc, cloc):
            u0 = jnp.asarray(u0, rdtype)
            v0 = jnp.asarray(v0, rdtype)
            state0 = (u0, u0 - dt * v0)    # u_past = u0 - dt v0
            step = lambda st, i: vstep(st, i, mloc, cloc)

            def observe(st):
                u, u_past = st
                return u, (u - u_past) / dt

            if not guard:
                u_s, v_s = evolve(step, state0, num_snapshots,
                                  snapshot_freq, observe=observe)
                return jnp.moveaxis(u_s, 0, 1), jnp.moveaxis(v_s, 0, 1)
            scalars = {"energy": energy_of} if record_energy else None
            (u_s, v_s), bad_at, series = evolve_guarded(
                step, state0, num_snapshots, snapshot_freq,
                observe=observe, batched=True, scalars=scalars,
                finite_reduce=all_finite)
            series = {k: jnp.moveaxis(v, 0, 1) for k, v in series.items()}
            out = (jnp.moveaxis(u_s, 0, 1), jnp.moveaxis(v_s, 0, 1),
                   bad_at)
            return out + ((series,) if record_energy else ())

        out_specs = (out_spec, out_spec)
        if guard:
            out_specs += (P(batch_axis),)
            if record_energy:
                out_specs += ({"energy": P(batch_axis, None)},)
        return jax.shard_map(local, mesh=mesh,
                             in_specs=(f_spec, f_spec, f_spec, f_spec),
                             out_specs=out_specs,
                             check_vma=False)(u0, v0, m, c)

    return traj
