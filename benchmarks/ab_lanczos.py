#!/usr/bin/env python
"""Interleaved A/B of Lanczos formulations at the headline operating point.

Two processes may land on cards with other clocks and power limits, so
candidates are timed interleaved in ONE process, several rounds,
min-of-rounds per variant.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

N = 1024
M = 10
LX = 10.0
DT = 1e-4
CHUNK = 100
ROUNDS = 4


def lanczos_list_stack(matvec, u, m):
    """Old formulation: python list + jnp.stack per iteration (re-copies V)."""
    n = u.size
    beta0 = jnp.sqrt(jnp.sum(jnp.abs(u) ** 2))
    vs = [(u / beta0).astype(u.dtype)]
    alphas, betas = [], []
    for j in range(m - 1):
        vj = vs[j]
        w = matvec(vj)
        if j > 0:
            w = w - betas[j - 1] * vs[j - 1]
        a = jnp.real(jnp.vdot(vj.reshape(-1), w.reshape(-1)))
        w = w - a * vj
        Vm = jnp.stack([v.reshape(n) for v in vs])
        proj = jnp.conj(Vm) @ w.reshape(n)
        w = w - (proj @ Vm).reshape(u.shape)
        b = jnp.sqrt(jnp.sum(jnp.abs(w) ** 2))
        vs.append((w / b).astype(u.dtype))
        alphas.append(a)
        betas.append(b)
    return jnp.stack(vs), jnp.stack(alphas), jnp.stack(betas), beta0


def lanczos_cols(matvec, u, m):
    """Column-list CGS: no V buffer, projection via per-column vdots that XLA
    fuses; reconstruction as one fused multi-column saxpy chain."""
    beta0 = jnp.sqrt(jnp.sum(jnp.abs(u) ** 2))
    vs = [(u / beta0).astype(u.dtype)]
    alphas, betas = [], []
    for j in range(m - 1):
        w = matvec(vs[j])
        if j > 0:
            w = w - betas[j - 1] * vs[j - 1]
        wf = w.reshape(-1)
        proj = [jnp.vdot(v.reshape(-1), wf) for v in vs]
        a = jnp.real(proj[j])
        corr = proj[0] * vs[0]
        for i in range(1, j + 1):
            corr = corr + proj[i] * vs[i]
        w = w - corr
        b = jnp.sqrt(jnp.sum(jnp.abs(w) ** 2))
        vs.append((w / b).astype(u.dtype))
        alphas.append(a)
        betas.append(b)
    return jnp.stack(vs), jnp.stack(alphas), jnp.stack(betas), beta0


def main():
    from nlsolvers_tpu.ops import operators
    from nlsolvers_tpu.ops.krylov import lanczos as lanczos_buf
    from nlsolvers_tpu.utils.complexio import pack_complex, unpack_complex

    x = np.linspace(-LX, LX, N, dtype=np.float32)
    X, Y = np.meshgrid(x, x, indexing="ij")
    env = np.exp(-(X**2 + Y**2) / 4).astype(np.float32)
    u0p = jnp.asarray(np.stack([env * np.cos(0.5 * X),
                                env * np.sin(0.5 * X)]))
    dx = 2 * LX / (N - 1)
    lap = operators.laplacian_2d((N, N), dx, dx, dtype=jnp.float32)

    def wrap(lcz):
        def one(u):
            V, a, b, b0 = lcz(lap, u, M)
            # consume everything so nothing is dead-code eliminated
            return (V[-1] * (b0 + a.sum() + b.sum())).astype(u.dtype)

        def fn(up):
            u = unpack_complex(up)
            u = jax.lax.fori_loop(0, CHUNK, lambda i, s: one(s), u)
            return pack_complex(u)

        return jax.jit(fn)

    cands = {
        "buf_at_set": wrap(lanczos_buf),
        "list_stack": wrap(lanczos_list_stack),
        "cols_vdots": wrap(lanczos_cols),
    }
    for f in cands.values():
        jax.block_until_ready(f(u0p))   # compile + warm

    best = {k: float("inf") for k in cands}
    for r in range(ROUNDS):
        for k, f in cands.items():
            t0 = time.perf_counter()
            jax.block_until_ready(f(u0p))
            best[k] = min(best[k], (time.perf_counter() - t0) / CHUNK)
    for k, v in best.items():
        print(f"{k:12s} {v*1e3:8.3f} ms/step  {1/v:8.1f} steps/s")


if __name__ == "__main__":
    main()
