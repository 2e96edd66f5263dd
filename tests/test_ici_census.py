"""Census of the collectives the sharded SS2 step issues.

The sharded Lanczos (ops/krylov.py with axis_names) runs one psum for the
start vector's norm and, in each of its m - 1 iterations, one psum for the
reorthogonalisation projection and one for the new column's norm. Each
stencil application exchanges one-deep halos with two ppermutes (from the
successor and from the predecessor) per sharded grid axis; the anisotropic
operator exchanges edge slabs of both u and c, so four per axis. SS2 applies
the operator only inside its one Lanczos run, so for Krylov dimension m:

    psum      = 1 + 2 (m - 1)
    ppermute  = (m - 1) * 2 * dims      (isotropic)
              = (m - 1) * 4 * dims      (anisotropic)

These tests trace the actual sharded step on the virtual CPU mesh, count
the `ppermute`/`psum` equations in its jaxpr, and assert equality with the
counts above, so a change to parallel/spatial.py or ops/krylov.py that adds
a collective per iteration fails here instead of slipping by.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
from jax._src import core as jcore
from jax.sharding import Mesh

from nlsolvers_tpu.parallel import spatial

M = 4  # small Krylov m keeps the trace fast; counts scale with m - 1


def expected_step_collectives(dims, m, aniso=False):
    per_axis = 4 if aniso else 2
    return {"ppermute": (m - 1) * per_axis * dims, "psum": 1 + 2 * (m - 1)}


def count_collectives(closed_jaxpr):
    """Recursively count every primitive in a (closed) jaxpr, descending
    into pjit/shard_map/scan/cond sub-jaxprs carried in eqn params."""

    def walk(jaxpr, c):
        for eqn in jaxpr.eqns:
            c[eqn.primitive.name] += 1
            for v in eqn.params.values():
                vs = v if isinstance(v, (list, tuple)) else [v]
                for x in vs:
                    if isinstance(x, jcore.ClosedJaxpr):
                        walk(x.jaxpr, c)
                    elif isinstance(x, jcore.Jaxpr):
                        walk(x, c)
        return c

    return walk(closed_jaxpr.jaxpr, Counter())


def _census(step, *args):
    jaxpr = jax.make_jaxpr(lambda *a: step(*a))(*args)
    counts = count_collectives(jaxpr)
    return {k: counts.get(k, 0) for k in ("ppermute", "psum")}


def test_census_2d_iso():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("gy", "gx"))
    step = spatial.make_sharded_nlse_step(
        "cubic", (32, 64), 10.0, 1e-3, mesh, axis_names=("gy", "gx"),
        krylov_m=M, dtype=jnp.complex64, variant="clean")
    u0 = np.zeros((2, 32, 64), np.float32)
    mf = np.ones((32, 64), np.float32)
    assert _census(step, u0, mf) == {"ppermute": 12, "psum": 7}
    assert _census(step, u0, mf) == expected_step_collectives(2, M)


def test_census_2d_aniso():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("gy", "gx"))
    step = spatial.make_sharded_nlse_step(
        "cubic", (32, 64), 10.0, 1e-3, mesh, axis_names=("gy", "gx"),
        krylov_m=M, dtype=jnp.complex64, variant="clean", use_c=True)
    u0 = np.zeros((2, 32, 64), np.float32)
    mf = np.ones((32, 64), np.float32)
    cf = np.ones((32, 64), np.float32)
    assert _census(step, u0, mf, cf) == {"ppermute": 24, "psum": 7}
    assert _census(step, u0, mf, cf) == expected_step_collectives(
        2, M, aniso=True)


def test_census_3d_iso():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("gz", "gy", "gx"))
    step = spatial.make_sharded_nlse_step(
        "cubic", (8, 8, 16), 10.0, 1e-3, mesh,
        axis_names=("gz", "gy", "gx"), krylov_m=M, dtype=jnp.complex64,
        variant="clean")
    u0 = np.zeros((2, 8, 8, 16), np.float32)
    mf = np.ones((8, 8, 16), np.float32)
    assert _census(step, u0, mf) == {"ppermute": 18, "psum": 7}
    assert _census(step, u0, mf) == expected_step_collectives(3, M)


def test_census_3d_aniso():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("gz", "gy", "gx"))
    step = spatial.make_sharded_nlse_step(
        "cubic", (8, 8, 16), 10.0, 1e-3, mesh,
        axis_names=("gz", "gy", "gx"), krylov_m=M, dtype=jnp.complex64,
        variant="clean", use_c=True)
    u0 = np.zeros((2, 8, 8, 16), np.float32)
    mf = np.ones((8, 8, 16), np.float32)
    cf = np.ones((8, 8, 16), np.float32)
    assert _census(step, u0, mf, cf) == {"ppermute": 36, "psum": 7}
    assert _census(step, u0, mf, cf) == expected_step_collectives(
        3, M, aniso=True)
