"""Datagen CLI: `python -m nlsolvers_tpu.pipeline <family> [options]`.

Mirrors the reference launcher argparse surfaces
(complex_launcher_2d.py:276-354, real_launcher_2d.py parse_args) with one
unified entry point for all four (family x dim) combinations. Options the
reference encoded in the executable path (--exe build/bin/nlse_2d_dev) are
explicit flags here (--system, --integrator, --dim); subprocess/SLURM
plumbing is gone — batching happens in-process on the mesh.

Examples:
  python -m nlsolvers_tpu.pipeline nlse --phenomenon multi_soliton \
      --system cubic --nx 128 --T 1.5 --nt 500 --snapshots 100 \
      --num-runs 4 --output-dir out
  python -m nlsolvers_tpu.pipeline realwave --phenomenon kink_field \
      --system sine_gordon --integrator gautschi --dim 2 --nx 128 \
      --num-runs 2 --output-dir out
"""

import argparse
import sys

from nlsolvers_tpu.pipeline.datagen import Datagen, DatagenConfig
from nlsolvers_tpu.utils.runtime import enable_compile_cache

NLSE_SYSTEMS = ["cubic", "cubic_quintic", "saturable"]
REALWAVE_SYSTEMS = ["sine_gordon", "double_sine_gordon",
                    "hyperbolic_sine_gordon", "klein_gordon", "phi4",
                    "stochastic_phi4"]
C_TYPES = ["constant", "periodic_structure", "piecewise_constant",
           "sign_changing_mass", "layered", "waveguide", "quasiperiodic",
           "turbulent"]
M_TYPES = ["constant", "piecewise", "gradient", "phase", "topological",
           "defects", "quasiperiodic", "multiscale"]


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m nlsolvers_tpu.pipeline",
        description="Nonlinear-wave trajectory datagen")
    sub = p.add_subparsers(dest="family", required=True)

    def common(sp, systems, default_system, integrators, default_integrator):
        sp.add_argument("--phenomenon", type=str, required=True)
        sp.add_argument("--system", type=str, default=default_system,
                        choices=systems)
        sp.add_argument("--integrator", type=str,
                        default=default_integrator, choices=integrators)
        sp.add_argument("--dim", type=int, default=2, choices=[2, 3])
        sp.add_argument("--nx", type=int, default=128)
        sp.add_argument("--Lx", type=float, default=10.0)
        sp.add_argument("--T", type=float, default=1.5)
        sp.add_argument("--nt", type=int, default=500)
        sp.add_argument("--snapshots", type=int, default=100)
        sp.add_argument("--num-runs", type=int, default=1)
        sp.add_argument("--batch-size", type=int, default=0,
                        help="trajectories per compiled batch "
                             "(0 = all runs in one batch)")
        sp.add_argument("--anisotropy-type", type=str, default="constant",
                        choices=C_TYPES)
        sp.add_argument("--m_type", "--m-type", dest="m_type", type=str,
                        default="constant", choices=M_TYPES)
        sp.add_argument("--m0", type=float, default=1.0)
        sp.add_argument("--krylov-m", type=int, default=0,
                        help="Lanczos subspace size (0 = reference default)")
        sp.add_argument("--dtype", type=str, default="")
        sp.add_argument("--variant", type=str, default="reference",
                        choices=["reference", "clean"])
        sp.add_argument("--dr-target", type=int, default=0,
                        help="downsampled grid points per axis (0 = keep)")
        sp.add_argument("--dr-strategy", type=str, default="interpolation",
                        choices=["FFT", "fft", "interpolation", "none"])
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--output-dir", type=str, required=True)
        sp.add_argument("--format", dest="archive_format", type=str,
                        default="hdf5", choices=["hdf5", "npy"],
                        help="archive format: reference-schema HDF5 or the "
                             "device drivers' .npy trajectory files "
                             "(streamed via the native async writer)")
        sp.add_argument("--async-archive", action="store_true",
                        help="archive on background Python threads "
                             "(measured slower for hdf5 — h5py GIL "
                             "contention with D2H; the npy format is "
                             "natively async either way)")
        sp.add_argument("--no-guard", action="store_true",
                        help="disable the in-loop stability guard "
                             "(on-device per-snapshot finiteness check with "
                             "early exit once every run in a batch "
                             "diverged)")
        sp.add_argument("--resume", action="store_true",
                        help="resumable sweep: derive the run id from "
                             "--seed and skip batches whose runs are all "
                             "already archived (same seed => identical "
                             "remaining runs); launch with --resume from "
                             "the start to make a sweep resumable")
        sp.add_argument("--record-energy", action="store_true",
                        help="record mass (NLSE) / discrete energy "
                             "(realwave) per snapshot ON DEVICE during "
                             "generation; archived under energy/")
        sp.add_argument("--shard-batch", type=int, default=0,
                        help="shard the trajectory batch over this many "
                             "devices (-1 = all local devices, 0 = off); "
                             "the replacement for SLURM-array farming")
        sp.add_argument("--shard-grid", type=str, default="",
                        help="comma-separated mesh extents per grid axis "
                             "(2D: 'gy,gx' e.g. 2,4; 3D: 'gz,gy,gx'): shard "
                             "EACH trajectory's grid spatially over devices "
                             "— for single runs too large for one device. "
                             "Combine with --shard-batch N for a "
                             "(batch, *grid) mesh")

    nlse = sub.add_parser("nlse", help="complex NLSE family")
    common(nlse, NLSE_SYSTEMS, "cubic",
           ["ss2", "sewi", "sewi_fused", "gautschi"], "ss2")
    nlse.add_argument("--sigma1", type=float, default=1.0)
    nlse.add_argument("--sigma2", type=float, default=-0.1)
    nlse.add_argument("--kappa", type=float, default=1.0)
    nlse.add_argument("--no-normalize-ic", action="store_true")
    nlse.add_argument("--bc", type=str, default="noflux",
                      choices=["noflux", "radiating", "none"],
                      help="boundary condition; 'radiating' is the "
                           "experimental radiating envelope "
                           "(boundaries.hpp:59-121, 2D only)")

    rw = sub.add_parser("realwave", help="real wave family (SG/KG/phi4)")
    common(rw, REALWAVE_SYSTEMS, "sine_gordon", ["gautschi", "sv"],
           "gautschi")
    rw.add_argument("--noise-strength", type=float, default=0.1)
    return p


def _build_mesh(shard_batch, shard_grid, dim):
    """Mesh from the CLI sharding flags: batch-only, grid-only (left to
    Datagen), or a combined (batch, *grid) mesh."""
    if not shard_batch and not shard_grid:
        return None
    if shard_grid and not shard_batch:
        return None     # Datagen builds the grid-only mesh itself
    import jax

    from nlsolvers_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    n = shard_batch
    if not shard_grid:
        if n < 0 or n > len(devices):
            n = len(devices)
        return make_mesh(("batch",), shape=(n,), devices=devices[:n])
    import numpy as np

    grid_n = int(np.prod(shard_grid))
    if n < 0:
        n = max(1, len(devices) // grid_n)
    axes = (("batch", "gy", "gx") if dim == 2
            else ("batch", "gz", "gy", "gx"))
    total = n * grid_n
    return make_mesh(axes, shape=(n,) + tuple(shard_grid),
                     devices=devices[:total])


def config_from_args(args):
    shard_grid = (tuple(int(x) for x in args.shard_grid.split(","))
                  if args.shard_grid else ())
    kwargs = dict(
        family=args.family, phenomenon=args.phenomenon, system=args.system,
        dim=args.dim, nx=args.nx, Lx=args.Lx, T=args.T, nt=args.nt,
        snapshots=args.snapshots, num_runs=args.num_runs,
        batch_size=args.batch_size, integrator=args.integrator,
        anisotropy_type=args.anisotropy_type, m_type=args.m_type,
        m0=args.m0, krylov_m=args.krylov_m, dtype=args.dtype,
        variant=args.variant, dr_target=args.dr_target,
        dr_strategy=args.dr_strategy, seed=args.seed,
        output_dir=args.output_dir, shard_grid=shard_grid,
        guard=not args.no_guard, record_energy=args.record_energy,
        archive_format=args.archive_format,
        archive_async=args.async_archive, resume=args.resume,
        mesh=_build_mesh(args.shard_batch, shard_grid, args.dim))
    if args.family == "nlse":
        kwargs.update(sigma1=args.sigma1, sigma2=args.sigma2,
                      kappa=args.kappa,
                      normalize_ic=not args.no_normalize_ic,
                      boundary=args.bc)
    else:
        kwargs.update(noise_strength=args.noise_strength)
    return DatagenConfig(**kwargs)


def main(argv=None):
    # Multi-host: if NLS_COORDINATOR/NLS_NUM_PROCESSES/NLS_PROCESS_ID are set
    # (or a pod resource manager initialized jax.distributed already), every
    # host runs this same CLI and the batch axis spans the global device
    # mesh; num-runs is per host, archives are per-host shards.
    from nlsolvers_tpu.parallel import distributed as dist

    joined = dist.initialize_from_env()
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if joined:
        cfg.mesh = dist.global_mesh(("batch",))
    written = Datagen(cfg).run()
    print(f"wrote {len(written)} archives under "
          f"{cfg.output_dir}/{cfg.archive_format}")
    return 0


if __name__ == "__main__":
    enable_compile_cache()
    sys.exit(main())
