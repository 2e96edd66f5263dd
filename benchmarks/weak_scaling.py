#!/usr/bin/env python
"""Weak-scaling harness: trajectory-parallel datagen throughput vs devices.

The reference's parallelism model is embarrassingly parallel over
trajectories (one SLURM array task / MPI rank per GPU, SURVEY.md section
3.4); the equivalent here is a batch axis sharded over the device
mesh (parallel/batch.py). This harness keeps per-device load fixed
(WEAK scaling: B = devices) and reports steps/s and efficiency vs 1 device.

Run on the 8-virtual-CPU mesh (functional scaling check):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/weak_scaling.py
On a host with several GPUs it measures the cards' weak scaling.

CAVEAT: on virtual CPU devices the "efficiency" is bounded by PHYSICAL
host cores, not the devices — with 2 cores and 8 virtual devices the
ceiling is 0.25, so the printed number is a host-contention artifact
there. The >= 0.85 BASELINE.md target applies to runs on real cards, where the
batch axis needs zero collectives in the numerics (SURVEY.md section 3.4:
the reference model is embarrassingly parallel over trajectories).

Prints one JSON line per device count plus a summary line with the
efficiency at max devices.
"""

import json
import sys
import time

import numpy as np


def main(n_grid=128, chunk=25, krylov_m=10):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from nlsolvers_tpu.models import problems
    from nlsolvers_tpu.utils.complexio import pack_complex, unpack_complex

    devs = jax.devices()
    counts = [n for n in (1, 2, 4, 8) if n <= len(devs)]
    base = None
    results = []
    for n in counts:
        mesh = Mesh(np.array(devs[:n]), ("batch",))
        prob = problems.nlse_problem(
            "cubic", (n_grid, n_grid), 10.0, 1e-4,
            m_field=np.ones((n_grid, n_grid), np.float32),
            krylov_m=krylov_m, dtype=jnp.complex64)
        step = jax.vmap(lambda u: prob.step(u, 1))

        def chunk_fn(up):
            u = unpack_complex(up)
            u = jax.lax.fori_loop(0, chunk, lambda i, s: step(s), u)
            return pack_complex(u)

        B = n                                       # weak: 1 traj/device
        rng = np.random.default_rng(0)
        u0 = 0.1 * rng.standard_normal((2, n, n_grid, n_grid)).astype(
            np.float32)
        sharding = NamedSharding(mesh, P(None, "batch"))
        x = jax.device_put(jnp.asarray(u0), sharding)
        f = jax.jit(chunk_fn, out_shardings=sharding)
        jax.block_until_ready(f(x))                 # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x))
            best = min(best, time.perf_counter() - t0)
        traj_steps_per_sec = B * chunk / best
        if base is None:
            base = traj_steps_per_sec
        eff = traj_steps_per_sec / (n * base)
        rec = {"devices": n, "traj_steps_per_sec": round(traj_steps_per_sec, 2),
               "weak_efficiency": round(eff, 3)}
        results.append(rec)
        print(json.dumps(rec))
    n_last = counts[-1]
    eff = results[-1]["weak_efficiency"]
    dev = devs[0]
    print(json.dumps({
        "metric": f"weak_scaling_eff_{n_last}dev_nlse2d_{n_grid}",
        "value": eff,
        "unit": "efficiency",
        "vs_baseline": round(eff / 0.85, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)},
    }))
    return results


if __name__ == "__main__":
    sys.path.insert(0, ".")
    main()
