"""nlsolvers_tpu — a JAX nonlinear wave-equation solver suite.

A from-scratch JAX/XLA framework with the capabilities of the reference
C++/CUDA suite `konradha/nonlinear-solvers` (see SURVEY.md): 2D/3D NLSE (cubic,
cubic-quintic, saturable), sine-Gordon (single/double/hyperbolic), Klein-Gordon,
phi-4 (deterministic + stochastic) and Boussinesq, evolved with Krylov/Lanczos
matrix-function integrators (SS2 Strang splitting, sEWI, Gautschi-type) and
Stormer-Verlet, on no-flux grids with spatially varying c(x) and m(x) fields.

Design stance:
  * operators are matrix-free stencils (shifted adds XLA fuses), not CSR
    SpMV (reference: nlsolvers/common/include/laplacians.hpp);
  * a whole trajectory is ONE jitted `lax.scan` — no per-step host round trips
    (reference: subprocess-per-run drivers, e.g. host/drivers/nlse_cubic_driver.cpp);
  * batches of trajectories are `vmap`-ed and sharded over a device mesh
    (reference: SLURM job arrays / mpi4py farms);
  * large grids are spatially sharded with `shard_map` + halo exchange
    (new capability; the reference never decomposes a grid).
"""

from nlsolvers_tpu import ops, models, parallel, pipeline, analysis, utils

__version__ = "0.1.0"
