"""Per-phase timings of one SS2 step at 1024^2, m=10: full step, Lanczos
with and without reorthogonalisation, the stencil and the pointwise kick.

Run from the repo root: python benchmarks/prof_lanczos.py
"""
import os
import sys
import time
import numpy as np
import jax, jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, M, DT = 1024, 10, 1e-3
rng = np.random.default_rng(0)
up = jnp.asarray(np.stack([rng.standard_normal((N, N)),
                           rng.standard_normal((N, N))]).astype(np.float32))

from nlsolvers_tpu.ops import operators as ops, krylov
from nlsolvers_tpu.models import nlse as nlse_mod
from nlsolvers_tpu.models.nonlinearities import nlse_density

dx = 2 * 10.0 / (N - 1)
lap = ops.laplacian_2d((N, N), dx, dx, dtype=jnp.float32)
rho = nlse_density("cubic", np.ones((N, N), np.float32))

def timeit(name, fn, iters=20):
    t0 = time.time(); out = fn(up); jax.block_until_ready(out)
    print(f"{name:26s} compile {time.time()-t0:6.1f}s", end=" ", flush=True)
    t0 = time.time()
    for _ in range(iters):
        out = fn(up)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / iters
    print(f" run {dt*1e3:8.3f} ms", flush=True)
    return dt

@jax.jit
def full_step(up):
    u = jax.lax.complex(up[0], up[1])
    u = nlse_mod.ss2_step(u, lap, rho, DT, m=M, reorth=True)
    return jnp.stack([jnp.real(u), jnp.imag(u)])

@jax.jit
def lanczos_reorth(up):
    u = jax.lax.complex(up[0], up[1])
    V, a, b, b0 = krylov.lanczos(lap, u, M, reorth=True)
    return jnp.stack([jnp.real(V[-1]), jnp.imag(V[-1])]), a, b

@jax.jit
def lanczos_noreorth(up):
    u = jax.lax.complex(up[0], up[1])
    V, a, b, b0 = krylov.lanczos(lap, u, M, reorth=False)
    return jnp.stack([jnp.real(V[-1]), jnp.imag(V[-1])]), a, b

@jax.jit
def stencil_x9(up):
    u = jax.lax.complex(up[0], up[1])
    for _ in range(9):
        u = lap(u)
    return jnp.stack([jnp.real(u), jnp.imag(u)])

@jax.jit
def pointwise(up):
    u = jax.lax.complex(up[0], up[1])
    u = u * jnp.exp(0.5j * DT * rho(u))
    return jnp.stack([jnp.real(u), jnp.imag(u)])

t_full = timeit("full ss2 step", full_step)
timeit("lanczos m=10 reorth", lanczos_reorth)
timeit("lanczos m=10 NO reorth", lanczos_noreorth)
timeit("stencil x9", stencil_x9)
timeit("pointwise x1", pointwise)
print(f"steps/s full: {1/t_full:.1f}")
