"""Subprocess worker: one host of a local multi-process CPU cluster.

Launched by tests/test_multihost.py and benchmarks/multihost_scaling.py —
each process simulates one host of a cluster (N virtual CPU devices, gloo
collectives over localhost) and runs the SAME multi-host datagen code path
that a real cluster runs (parallel/distributed.py): join the process group,
build the global batch mesh, generate per-host runs, archive per-host HDF5
shards.

Reference analogue being replaced: one mpi4py rank of the trajectory farm
(/root/reference/device/submit_nlse.py:80-137).

Standalone script — must NOT import tests/conftest (fresh interpreter; the
platform/device-count setup happens here before the backend initializes).
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--devices-per-host", type=int, default=2)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--mode", default="datagen", choices=["datagen", "dryrun"])
    ap.add_argument("--family", default="nlse")
    ap.add_argument("--system", default="cubic")
    ap.add_argument("--phenomenon", default="multi_soliton")
    ap.add_argument("--num-runs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nt", type=int, default=10)
    ap.add_argument("--T", type=float, default=0.02)
    ap.add_argument("--snapshots", type=int, default=4)
    ap.add_argument("--krylov-m", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--shard-grid", default="",
                    help="e.g. '1,2': grid-shard each trajectory over the "
                         "host's local devices (batch axis spans hosts)")
    ap.add_argument("--record-energy", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices_per_host}"
    ).strip()

    from nlsolvers_tpu.parallel import distributed as dist

    dist.initialize(f"localhost:{args.port}", args.nproc, args.pid,
                    platform="cpu")

    import jax

    assert jax.process_count() == args.nproc, jax.process_count()
    assert len(jax.local_devices()) == args.devices_per_host

    if args.mode == "dryrun":
        # full sharded-step compile+execute over the multi-host mesh
        sys.path.insert(0, os.getcwd())
        import __graft_entry__ as graft

        t0 = time.time()
        graft.dryrun_multichip(args.nproc * args.devices_per_host)
        print(json.dumps(dict(pid=args.pid, written=[],
                              elapsed=time.time() - t0)), flush=True)
        return 0

    shard_grid = (tuple(int(x) for x in args.shard_grid.split(","))
                  if args.shard_grid else None)
    # grid-sharded runs build their own (batch, gy, gx) global mesh inside
    # Datagen (pipeline/datagen._build_grid_sharded_traj_fn)
    mesh = None if shard_grid else dist.global_mesh(("batch",))

    from nlsolvers_tpu.pipeline.datagen import Datagen, DatagenConfig

    cfg = DatagenConfig(
        family=args.family, phenomenon=args.phenomenon, system=args.system,
        nx=args.nx, T=args.T, nt=args.nt, snapshots=args.snapshots,
        num_runs=args.num_runs, batch_size=args.batch_size,
        krylov_m=args.krylov_m, seed=args.seed, output_dir=args.outdir,
        mesh=mesh, shard_grid=shard_grid,
        record_energy=args.record_energy, resume=args.resume)
    t0 = time.time()
    dg = Datagen(cfg)
    written = dg.run()
    elapsed = time.time() - t0
    # one JSON line for the launcher (walltime gather, submit_nlse.py:129-134)
    # with the per-phase decomposition (sample/evolve/archive) and the
    # rank-0 sweep summary line for tests to assert on
    print(json.dumps(dict(pid=args.pid, written=[str(p) for p in written],
                          elapsed=elapsed,
                          stats=getattr(dg, "last_stats", None),
                          summary=getattr(dg, "summary_line", None))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
