"""Multi-device tests on the 8-virtual-CPU-device mesh: spatial domain
decomposition must be bit-compatible with the single-device path, and batch
sharding must reproduce per-trajectory runs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlsolvers_tpu.models import problems
from nlsolvers_tpu.parallel import batch as pbatch
from nlsolvers_tpu.parallel import mesh as pmesh
from nlsolvers_tpu.parallel import spatial

RNG = np.random.default_rng(11)
N = 32
LX = 4.0
DT = 2e-3


def need_devices(k):
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} devices")


def test_factor_devices():
    assert pmesh.factor_devices(8, 3) == (2, 2, 2)
    assert pmesh.factor_devices(4, 3) == (2, 2, 1)
    assert pmesh.factor_devices(1, 3) == (1, 1, 1)
    assert np.prod(pmesh.factor_devices(6, 3)) == 6


def test_sharded_nlse_step_matches_single_device():
    need_devices(4)
    mesh = pmesh.make_mesh(("gy", "gx"), shape=(2, 2),
                           devices=jax.devices()[:4])
    m = RNG.uniform(0.5, 1.5, (N, N))
    env = np.exp(-(np.linspace(-1, 1, N)[:, None] ** 2
                   + np.linspace(-1, 1, N)[None, :] ** 2))
    u0 = (env * np.exp(1j * env)).astype(np.complex128)

    prob = problems.nlse_problem("cubic", (N, N), LX, DT, m_field=m,
                                 krylov_m=8, dtype=jnp.complex128)
    ref_state = prob.init(u0)
    for i in range(3):
        ref_state = prob.step(ref_state, i + 1)

    step = spatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, mesh, axis_names=("gy", "gx"),
        krylov_m=8, dtype=jnp.complex128)
    up = jnp.stack([jnp.real(jnp.asarray(u0)), jnp.imag(jnp.asarray(u0))])
    mj = jnp.asarray(m)
    for _ in range(3):
        up = step(up, mj)
    got = np.asarray(up[0]) + 1j * np.asarray(up[1])
    np.testing.assert_allclose(got, np.asarray(ref_state), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("integrator", ["gautschi", "sv"])
def test_sharded_realwave_step_matches_single_device(integrator):
    need_devices(4)
    mesh = pmesh.make_mesh(("gy", "gx"), shape=(2, 2),
                           devices=jax.devices()[:4])
    m = RNG.uniform(0.5, 1.5, (N, N))
    u0 = 0.4 * RNG.standard_normal((N, N))
    v0 = 0.1 * RNG.standard_normal((N, N))

    prob = problems.realwave_problem("sine_gordon", (N, N), LX, DT,
                                     m_field=m, integrator=integrator,
                                     krylov_m=8, dtype=jnp.float64)
    ref_state = prob.init(u0, v0)
    for i in range(3):
        ref_state = prob.step(ref_state, i + 1)

    step = spatial.make_sharded_realwave_step(
        "sine_gordon", (N, N), LX, DT, mesh, axis_names=("gy", "gx"),
        integrator=integrator, krylov_m=8, dtype=jnp.float64)
    u = jnp.asarray(u0)
    u_past = jnp.asarray(u0 - DT * v0)
    mj = jnp.asarray(m)
    for _ in range(3):
        u, u_past = step(u, u_past, mj)
    np.testing.assert_allclose(np.asarray(u), np.asarray(ref_state[0]),
                               rtol=1e-10, atol=1e-12)


def test_sharded_with_batch_axis():
    need_devices(8)
    mesh = pmesh.make_mesh(("batch", "gy", "gx"), shape=(2, 2, 2))
    B = 4
    m = RNG.uniform(0.5, 1.5, (B, N, N))
    u0 = (RNG.standard_normal((B, N, N))
          + 1j * RNG.standard_normal((B, N, N))) * 0.1

    step = spatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, mesh, axis_names=("gy", "gx"),
        batch_axis="batch", krylov_m=6, dtype=jnp.complex128)
    up = jnp.stack([jnp.asarray(u0.real), jnp.asarray(u0.imag)])
    up = step(up, jnp.asarray(m))

    # per-sample single-device reference
    for b in range(B):
        prob = problems.nlse_problem("cubic", (N, N), LX, DT, m_field=m[b],
                                     krylov_m=6, dtype=jnp.complex128)
        want = prob.step(prob.init(u0[b]), 1)
        got = np.asarray(up[0, b]) + 1j * np.asarray(up[1, b])
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                   atol=1e-12)


def test_batched_evolve_matches_sequential():
    need_devices(2)
    mesh = pmesh.make_mesh(("batch",), shape=(2,),
                           devices=jax.devices()[:2])
    B = 4
    m = np.ones((N, N))
    u0 = (RNG.standard_normal((B, N, N))
          + 1j * RNG.standard_normal((B, N, N))) * 0.1
    prob = problems.nlse_problem("cubic", (N, N), LX, DT, m_field=m,
                                 krylov_m=6, dtype=jnp.complex128)
    states0 = jax.vmap(prob.init)(jnp.asarray(u0))
    snaps = pbatch.batched_evolve(prob, states0, num_snapshots=3,
                                  snapshot_freq=2, mesh=mesh)
    assert snaps.shape == (B, 3, N, N)
    for b in range(2):
        st = prob.init(u0[b])
        for i in range(4):
            st = prob.step(st, i + 1)
        np.testing.assert_allclose(np.asarray(snaps[b, 2]), np.asarray(st),
                                   rtol=1e-9, atol=1e-12)


def _gauss3d(n):
    x = np.linspace(-1, 1, n)
    env = np.exp(-(x[:, None, None] ** 2 + x[None, :, None] ** 2
                   + x[None, None, :] ** 2))
    return env


@pytest.mark.parametrize("mesh_shape,variant", [
    ((2, 2, 2), "clean"),
    ((1, 1, 8), "reference"),     # reference seam variant: gx-only sharding
])
def test_sharded_laplacian_3d_matches_single_device(mesh_shape, variant):
    need_devices(int(np.prod(mesh_shape)))
    from nlsolvers_tpu.ops import operators as ops
    from jax.sharding import PartitionSpec as P

    n = 16
    mesh = pmesh.make_mesh(("gz", "gy", "gx"), shape=mesh_shape,
                           devices=jax.devices()[: int(np.prod(mesh_shape))])
    u = RNG.standard_normal((n, n, n))
    dx = 2 * LX / (n - 1)

    ref = ops.laplacian_3d((n, n, n), dx, variant=variant,
                           dtype=jnp.float64)(jnp.asarray(u))

    lap = spatial.sharded_laplacian_3d((n, n, n), dx, ("gz", "gy", "gx"),
                                       variant=variant, dtype=jnp.float64)
    sharded = jax.jit(jax.shard_map(
        lap, mesh=mesh, in_specs=P("gz", "gy", "gx"),
        out_specs=P("gz", "gy", "gx")))
    got = sharded(jnp.asarray(u))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_sharded_laplacian_3d_reference_rejects_split_y():
    need_devices(4)
    mesh = pmesh.make_mesh(("gz", "gy", "gx"), shape=(1, 2, 2),
                           devices=jax.devices()[:4])
    from jax.sharding import PartitionSpec as P
    n = 16
    lap = spatial.sharded_laplacian_3d((n, n, n), 0.1, ("gz", "gy", "gx"),
                                       variant="reference")
    f = jax.shard_map(lap, mesh=mesh, in_specs=P("gz", "gy", "gx"),
                      out_specs=P("gz", "gy", "gx"))
    with pytest.raises(ValueError, match="reference"):
        f(jnp.zeros((n, n, n)))


def test_sharded_neumann_3d_matches_single_device():
    need_devices(8)
    from nlsolvers_tpu.ops import boundaries as bc
    from jax.sharding import PartitionSpec as P

    n = 16
    mesh = pmesh.make_mesh(("gz", "gy", "gx"), shape=(2, 2, 2),
                           devices=jax.devices()[:8])
    u = RNG.standard_normal((n, n, n))
    ref = bc.neumann_no_velocity_3d(jnp.asarray(u))
    fn = spatial.sharded_neumann_3d((n, n, n), ("gz", "gy", "gx"))
    sharded = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("gz", "gy", "gx"),
        out_specs=P("gz", "gy", "gx")))
    np.testing.assert_array_equal(np.asarray(sharded(jnp.asarray(u))),
                                  np.asarray(ref))


def test_sharded_nlse_step_3d_matches_single_device():
    need_devices(8)
    n = 16
    mesh = pmesh.make_mesh(("gz", "gy", "gx"), shape=(2, 2, 2),
                           devices=jax.devices()[:8])
    m = RNG.uniform(0.5, 1.5, (n, n, n))
    u0 = (_gauss3d(n) * np.exp(1j * _gauss3d(n))).astype(np.complex128)

    prob = problems.nlse_problem("cubic", (n, n, n), LX, DT, m_field=m,
                                 krylov_m=6, dtype=jnp.complex128,
                                 variant="clean")
    ref_state = prob.init(u0)
    for i in range(2):
        ref_state = prob.step(ref_state, i + 1)

    step = spatial.make_sharded_nlse_step(
        "cubic", (n, n, n), LX, DT, mesh, axis_names=("gz", "gy", "gx"),
        krylov_m=6, dtype=jnp.complex128, variant="clean")
    up = jnp.stack([jnp.real(jnp.asarray(u0)), jnp.imag(jnp.asarray(u0))])
    mj = jnp.asarray(m)
    for _ in range(2):
        up = step(up, mj)
    got = np.asarray(up[0]) + 1j * np.asarray(up[1])
    np.testing.assert_allclose(got, np.asarray(ref_state), rtol=1e-10,
                               atol=1e-12)


def test_sharded_realwave_step_3d_matches_single_device():
    need_devices(8)
    n = 16
    mesh = pmesh.make_mesh(("gz", "gy", "gx"), shape=(2, 2, 2),
                           devices=jax.devices()[:8])
    m = RNG.uniform(0.5, 1.5, (n, n, n))
    u0 = _gauss3d(n)
    v0 = 0.1 * _gauss3d(n)

    prob = problems.realwave_problem(
        "klein_gordon", (n, n, n), LX, DT, m_field=m, integrator="sv",
        krylov_m=6, dtype=jnp.float64, variant="clean")
    ref_state = prob.init(u0, v0)
    for i in range(2):
        ref_state = prob.step(ref_state, i + 1)

    step = spatial.make_sharded_realwave_step(
        "klein_gordon", (n, n, n), LX, DT, mesh,
        axis_names=("gz", "gy", "gx"), integrator="sv", krylov_m=6,
        dtype=jnp.float64, variant="clean")
    u, up = jnp.asarray(u0), jnp.asarray(u0) - DT * jnp.asarray(v0)
    mj = jnp.asarray(m)
    for _ in range(2):
        u, up = step(u, up, mj)
    np.testing.assert_allclose(np.asarray(u), np.asarray(ref_state[0]),
                               rtol=1e-10, atol=1e-12)


def test_sharded_anisotropic_matches_global():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from nlsolvers_tpu.ops import operators
    from nlsolvers_tpu.parallel import spatial

    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 virtual devices")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("gy", "gx"))
    N = 32
    dx = 0.17
    rng = np.random.default_rng(5)
    c = (1.0 + 0.5 * rng.random((N, N))).astype(np.float64)
    u = (rng.standard_normal((N, N))
         + 1j * rng.standard_normal((N, N))).astype(np.complex128)
    ref = np.asarray(operators.anisotropic_laplacian_2d(c, dx, dx)(
        jnp.asarray(u)))

    local = spatial.sharded_anisotropic_laplacian_2d((N, N), dx, dx,
                                                     ("gy", "gx"))
    from jax.sharding import PartitionSpec as P
    f = jax.jit(jax.shard_map(local, mesh=mesh,
                              in_specs=(P("gy", "gx"), P("gy", "gx")),
                              out_specs=P("gy", "gx"), check_vma=False))
    got = np.asarray(f(jnp.asarray(u), jnp.asarray(c)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_sharded_nlse_step_with_c():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from nlsolvers_tpu.parallel import spatial
    from nlsolvers_tpu.models import problems

    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 virtual devices")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("gy", "gx"))
    N = 32
    rng = np.random.default_rng(6)
    c = (1.0 + 0.4 * rng.random((N, N))).astype(np.float32)
    mf = np.ones((N, N), np.float32)
    u0 = 0.1 * rng.standard_normal((2, N, N)).astype(np.float32)

    step = spatial.make_sharded_nlse_step(
        "cubic", (N, N), 5.0, 1e-3, mesh, axis_names=("gy", "gx"),
        krylov_m=6, dtype=jnp.complex64, use_c=True)
    got = np.asarray(step(jnp.asarray(u0), jnp.asarray(mf), jnp.asarray(c)))

    # single-device reference problem with the same c field
    prob = problems.nlse_problem("cubic", (N, N), 5.0, 1e-3, m_field=mf,
                                 c_field=c, krylov_m=6, dtype=jnp.complex64)
    u0c = jnp.asarray(u0[0] + 1j * u0[1], jnp.complex64)
    ref_c = np.asarray(jax.jit(prob.step)(u0c, 1))
    ref = np.stack([ref_c.real, ref_c.imag])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mesh_shape,variant", [
    ((2, 2, 2), "clean"),
    ((1, 1, 8), "clean"),
    ((1, 1, 8), "reference"),     # merged-row seam variant: gx-only sharding
])
def test_sharded_anisotropic_3d_matches_global(mesh_shape, variant):
    need_devices(int(np.prod(mesh_shape)))
    from nlsolvers_tpu.ops import operators as ops
    from jax.sharding import PartitionSpec as P

    n = 16
    mesh = pmesh.make_mesh(("gz", "gy", "gx"), shape=mesh_shape,
                           devices=jax.devices()[: int(np.prod(mesh_shape))])
    rng = np.random.default_rng(9)
    c = 1.0 + 0.5 * rng.random((n, n, n))
    u = rng.standard_normal((n, n, n))
    dx = 2 * LX / (n - 1)

    ref = np.asarray(ops.anisotropic_laplacian_3d(c, dx, variant=variant)(
        jnp.asarray(u)))

    local = spatial.sharded_anisotropic_laplacian_3d(
        (n, n, n), dx, ("gz", "gy", "gx"), variant=variant)
    f = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("gz", "gy", "gx"), P("gz", "gy", "gx")),
        out_specs=P("gz", "gy", "gx"), check_vma=False))
    got = np.asarray(f(jnp.asarray(u), jnp.asarray(c)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_sharded_anisotropic_3d_reference_rejects_split_y():
    need_devices(4)
    from jax.sharding import PartitionSpec as P
    mesh = pmesh.make_mesh(("gz", "gy", "gx"), shape=(1, 2, 2),
                           devices=jax.devices()[:4])
    n = 16
    local = spatial.sharded_anisotropic_laplacian_3d(
        (n, n, n), 0.1, ("gz", "gy", "gx"), variant="reference")
    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P("gz", "gy", "gx"), P("gz", "gy", "gx")),
                      out_specs=P("gz", "gy", "gx"), check_vma=False)
    with pytest.raises(ValueError, match="reference"):
        f(jnp.zeros((n, n, n)), jnp.ones((n, n, n)))


def test_sharded_nlse_step_3d_with_c():
    need_devices(8)
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("gz", "gy", "gx"))
    N = 16
    rng = np.random.default_rng(12)
    c = (1.0 + 0.4 * rng.random((N, N, N))).astype(np.float32)
    mf = np.ones((N, N, N), np.float32)
    u0 = 0.1 * rng.standard_normal((2, N, N, N)).astype(np.float32)

    step = spatial.make_sharded_nlse_step(
        "cubic", (N, N, N), 5.0, 1e-3, mesh,
        axis_names=("gz", "gy", "gx"), krylov_m=6, dtype=jnp.complex64,
        use_c=True, variant="clean")
    got = np.asarray(step(jnp.asarray(u0), jnp.asarray(mf), jnp.asarray(c)))

    prob = problems.nlse_problem("cubic", (N, N, N), 5.0, 1e-3, m_field=mf,
                                 c_field=c, krylov_m=6, dtype=jnp.complex64,
                                 variant="clean")
    u0c = jnp.asarray(u0[0] + 1j * u0[1], jnp.complex64)
    ref_c = np.asarray(jax.jit(prob.step)(u0c, 1))
    ref = np.stack([ref_c.real, ref_c.imag])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_sharded_nlse_trajectory_matches_engine():
    need_devices(8)
    from jax.sharding import Mesh
    from nlsolvers_tpu.pipeline.engine import make_nlse_trajectory_fn

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("gy", "gx"))
    N, B, S, freq = 32, 2, 4, 3
    rng = np.random.default_rng(21)
    u0 = 0.1 * rng.standard_normal((B, 2, N, N)).astype(np.float32)
    m = (1.0 + 0.1 * rng.random((B, N, N))).astype(np.float32)
    c = (1.0 + 0.3 * rng.random((B, N, N))).astype(np.float32)

    ref_fn = make_nlse_trajectory_fn("cubic", (N, N), LX, 1e-3,
                                     integrator="ss2", krylov_m=6,
                                     dtype=jnp.complex64)
    ref = np.asarray(ref_fn(u0, m, c, S, freq))

    traj_fn = spatial.make_sharded_nlse_trajectory_fn(
        "cubic", (N, N), LX, 1e-3, mesh, axis_names=("gy", "gx"),
        integrator="ss2", krylov_m=6, dtype=jnp.complex64)
    got = np.asarray(traj_fn(u0, m, c, S, freq))
    assert got.shape == (B, S, 2, N, N)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_sharded_realwave_trajectory_matches_engine():
    need_devices(8)
    from jax.sharding import Mesh
    from nlsolvers_tpu.pipeline.engine import make_realwave_trajectory_fn

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("gy", "gx"))
    N, B, S, freq = 32, 2, 4, 2
    rng = np.random.default_rng(22)
    u0 = 0.2 * rng.standard_normal((B, N, N)).astype(np.float32)
    v0 = 0.05 * rng.standard_normal((B, N, N)).astype(np.float32)
    m = (1.0 + 0.1 * rng.random((B, N, N))).astype(np.float32)
    c = (1.0 + 0.3 * rng.random((B, N, N))).astype(np.float32)

    ref_fn = make_realwave_trajectory_fn("sine_gordon", (N, N), LX, 1e-3,
                                         integrator="gautschi", krylov_m=6,
                                         dtype=jnp.float32)
    ref_u, ref_v = ref_fn(u0, v0, m, c, S, freq)

    traj_fn = spatial.make_sharded_realwave_trajectory_fn(
        "sine_gordon", (N, N), LX, 1e-3, mesh, axis_names=("gy", "gx"),
        integrator="gautschi", krylov_m=6, dtype=jnp.float32)
    got_u, got_v = traj_fn(u0, v0, m, c, S, freq)
    assert np.asarray(got_u).shape == (B, S, N, N)
    np.testing.assert_allclose(np.asarray(got_u), np.asarray(ref_u),
                               rtol=2e-4, atol=2e-5)
    # v = (u - u_past)/dt amplifies f32 roundoff by 1/dt = 1e3, so the
    # velocity tolerance is the u tolerance scaled accordingly
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(ref_v),
                               rtol=2e-3, atol=5e-3)


# (mesh shape, variant, anisotropic) per sharded 3D family; the reference
# variant's y-seam couples planes, so it shards over gx only
SHARDED_NLSE_CASES = {
    "2d-aniso-2x4": ((2, 4), "reference", True),
    "3d-iso-clean-2x2x2": ((2, 2, 2), "clean", False),
    "3d-iso-clean-1x1x8": ((1, 1, 8), "clean", False),
    "3d-iso-reference-x-only": ((1, 1, 8), "reference", False),
    "3d-aniso-clean-2x2x2": ((2, 2, 2), "clean", True),
    "3d-aniso-clean-1x1x8": ((1, 1, 8), "clean", True),
    "3d-aniso-reference-x-only": ((1, 1, 8), "reference", True),
}


@pytest.mark.parametrize("case", sorted(SHARDED_NLSE_CASES))
def test_sharded_nlse_step_matches_problem(case):
    """The sharded SS2 step (halo ppermutes, psum'd Lanczos) against the
    unsharded problem step at f64, for every sharded operator family."""
    mesh_shape, variant, aniso = SHARDED_NLSE_CASES[case]
    need_devices(int(np.prod(mesh_shape)))
    dim = len(mesh_shape)
    n = 32 if dim == 2 else 16
    shape = (n,) * dim
    axes = ("gy", "gx") if dim == 2 else ("gz", "gy", "gx")
    mesh = pmesh.make_mesh(axes, shape=mesh_shape,
                           devices=jax.devices()[: int(np.prod(mesh_shape))])
    rng = np.random.default_rng(31)
    m = rng.uniform(0.5, 1.5, shape)
    c = 1.0 + 0.4 * rng.random(shape) if aniso else None
    env = _gauss3d(n) if dim == 3 else _gauss3d(n)[n // 2]
    u0 = env * np.exp(1j * env)

    prob = problems.nlse_problem("cubic", shape, LX, DT, m_field=m,
                                 c_field=c, krylov_m=6, variant=variant,
                                 dtype=jnp.complex128)
    want = prob.step(prob.step(prob.init(u0), 1), 2)

    step = spatial.make_sharded_nlse_step(
        "cubic", shape, LX, DT, mesh, axis_names=axes, krylov_m=6,
        dtype=jnp.complex128, variant=variant, use_c=aniso)
    up = jnp.stack([jnp.asarray(u0.real), jnp.asarray(u0.imag)])
    fields = (jnp.asarray(m),) + ((jnp.asarray(c),) if aniso else ())
    for _ in range(2):
        up = step(up, *fields)
    got = np.asarray(up[0]) + 1j * np.asarray(up[1])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mesh_shape,variant,aniso", [
    ((2, 2, 2), "clean", False),
    ((1, 1, 8), "reference", True),
], ids=["iso-clean-2x2x2", "aniso-reference-x-only"])
def test_sharded_realwave_gautschi_3d_matches_problem(mesh_shape, variant,
                                                      aniso):
    """Sharded real-wave Gautschi (shared-Lanczos cos/filter pair through
    matfunc_apply_multi) against the unsharded problem step, 3D, f64."""
    need_devices(int(np.prod(mesh_shape)))
    n = 16
    shape = (n,) * 3
    axes = ("gz", "gy", "gx")
    mesh = pmesh.make_mesh(axes, shape=mesh_shape,
                           devices=jax.devices()[: int(np.prod(mesh_shape))])
    rng = np.random.default_rng(32)
    m = rng.uniform(0.5, 1.5, shape)
    c = 1.0 + 0.4 * rng.random(shape) if aniso else None
    u0, v0 = _gauss3d(n), 0.1 * _gauss3d(n)

    prob = problems.realwave_problem(
        "sine_gordon", shape, LX, DT, m_field=m, c_field=c,
        integrator="gautschi", krylov_m=6, dtype=jnp.float64,
        variant=variant)
    want = prob.init(u0, v0)
    for i in range(2):
        want = prob.step(want, i + 1)

    step = spatial.make_sharded_realwave_step(
        "sine_gordon", shape, LX, DT, mesh, axis_names=axes,
        integrator="gautschi", krylov_m=6, dtype=jnp.float64,
        variant=variant, use_c=aniso)
    u, up = jnp.asarray(u0), jnp.asarray(u0 - DT * v0)
    fields = (jnp.asarray(m),) + ((jnp.asarray(c),) if aniso else ())
    for _ in range(2):
        u, up = step(u, up, *fields)
    np.testing.assert_allclose(np.asarray(u), np.asarray(want[0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(up), np.asarray(want[1]),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("integrator", ["sewi", "sewi_fused", "gautschi"])
def test_sharded_two_step_trajectory_matches_engine(integrator):
    """Grid-sharded two-step NLSE trajectories (SS2 bootstrap at step 1,
    then the two-step scheme) against the batch engine, f64."""
    need_devices(8)
    from jax.sharding import Mesh
    from nlsolvers_tpu.pipeline.engine import make_nlse_trajectory_fn

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("gy", "gx"))
    n, B, S, freq = 32, 2, 3, 2
    rng = np.random.default_rng(33)
    u0 = 0.3 * rng.standard_normal((B, 2, n, n))
    m = 1.0 + 0.1 * rng.random((B, n, n))
    c = 1.0 + 0.3 * rng.random((B, n, n))

    ref_fn = make_nlse_trajectory_fn("cubic", (n, n), LX, DT,
                                     integrator=integrator, krylov_m=6,
                                     dtype=jnp.complex128)
    want = np.asarray(ref_fn(u0, m, c, S, freq))
    traj_fn = spatial.make_sharded_nlse_trajectory_fn(
        "cubic", (n, n), LX, DT, mesh, axis_names=("gy", "gx"),
        integrator=integrator, krylov_m=6, dtype=jnp.complex128)
    got = np.asarray(traj_fn(u0, m, c, S, freq))
    assert got.shape == (B, S, 2, n, n)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
