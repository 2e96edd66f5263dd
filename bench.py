#!/usr/bin/env python
"""Headline benchmark: 2D cubic NLSE time-steps/sec/chip at 1024^2, Lanczos m=10.

Prints the card's `name, power.limit` (nvidia-smi) first, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...}.

The reference publishes no benchmark numbers (BASELINE.md). `vs_baseline` is
therefore measured against the reference's implied production operating point:
its 2D sweep budget is 30 runs of (200^2 grid, nt=2000 steps) per 15-minute
SLURM task on one GPU (finalized_scripts/nlse_2d_launch.sh:5,47-50,66), i.e.
~66.7 steps/s at 200^2; scaled by grid area to 1024^2 that is ~2.54 steps/s.

`vs_reference_host_measured` is a MEASURED anchor: the reference's own Eigen
host driver (nlse_cubic_driver.cpp, the only reference path that runs without
an NVIDIA GPU), compiled with the reference's release flags and timed at this
exact operating point by benchmarks/reference_cpu_bench.py —
1.113 steps/s (complex128, 1 CPU). Regenerate with
`python benchmarks/reference_cpu_bench.py`.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

N = 1024
KRYLOV_M = 10
LX = 10.0
DT = 1e-4
CHUNK = 2000         # steps per timed jit call
# >= 5 repeats, report the MEDIAN + spread
REPEATS = 5

BASELINE_STEPS_PER_SEC = 30 * 2000 / (15 * 60) * (200 / N) ** 2
# measured by benchmarks/reference_cpu_bench.py (see module docstring):
# the reference's f64 host driver on one CPU core; the reference has no f32
# CPU path
REFERENCE_HOST_MEASURED_STEPS_PER_SEC = 1.113


def main():
    from nlsolvers_tpu.models import problems
    from nlsolvers_tpu.utils.runtime import card_lines, enable_compile_cache

    for line in card_lines():
        print(line)
    enable_compile_cache()
    dev = jax.devices()[0]
    x = np.linspace(-LX, LX, N, dtype=np.float32)
    X, Y = np.meshgrid(x, x, indexing="ij")
    env = np.exp(-(X**2 + Y**2) / 4).astype(np.float32)
    u0 = (env * np.exp(0.5j * X)).astype(np.complex64)
    m_field = np.ones((N, N), np.float32)

    prob = problems.nlse_problem(
        "cubic", (N, N), LX, DT, m_field=m_field, krylov_m=KRYLOV_M,
        dtype=jnp.complex64)

    def chunk(u):
        return jax.lax.fori_loop(0, CHUNK, lambda i, s: prob.step(s, i + 1),
                                 u)

    chunk_j = jax.jit(chunk)
    u = jax.device_put(prob.init(u0), dev)

    t0 = time.time()
    u = jax.block_until_ready(chunk_j(u))     # compile + first chunk
    compile_and_first = time.time() - t0

    times = []
    for _ in range(REPEATS):
        t0 = time.time()
        u = jax.block_until_ready(chunk_j(u))
        times.append(time.time() - t0)

    rates = sorted(CHUNK / t for t in times)
    steps_per_sec = float(np.median(rates))
    assert np.all(np.isfinite(np.asarray(u))), "non-finite state"

    print(json.dumps({
        "metric": f"nlse2d_cubic_{N}x{N}_m{KRYLOV_M}_steps_per_sec_per_chip",
        "value": round(steps_per_sec, 3),
        "unit": "time-steps/s/chip",
        "min": round(rates[0], 3),
        "max": round(rates[-1], 3),
        "spread_pct": round(100.0 * (rates[-1] - rates[0])
                            / steps_per_sec, 2),
        "repeats": REPEATS,
        "compile_and_first_s": round(compile_and_first, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": round(steps_per_sec / BASELINE_STEPS_PER_SEC, 3),
        "vs_reference_host_measured": round(
            steps_per_sec / REFERENCE_HOST_MEASURED_STEPS_PER_SEC, 1),
    }))


if __name__ == "__main__":
    main()
