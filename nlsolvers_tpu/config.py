"""Global numerical configuration.

The reference suite runs everything in float64/complex128 (Eigen + CUDA double).
The production path here defaults to f32/c64 state with drift-validated
tolerances: the Lanczos hot loop is memory-bound, so half-width state moves
half the bytes per step, and the conservation receipts (mass/Hamiltonian
drift) show the f32 roundoff stays far below the discretisation error at the
reference's operating points. Every public API takes an explicit dtype, so
complex128/float64 runs (the reference's own precision) use the same code;
tests and oracles run f64 on CPU with `jax_enable_x64` (see tests/conftest.py).
"""

import jax.numpy as jnp

# Default real/complex dtypes for solver state (see module docstring).
default_real_dtype = jnp.float32
default_complex_dtype = jnp.complex64

# Default Krylov subspace dimension. Reference: m=10 host default
# (host/include/eigen_krylov_real.hpp:60), m=20 for NLSE 2D device
# (device/drivers/nlse_cubic_driver_2d.cpp:105), m=15 cubic-quintic.
default_krylov_m = 10


def real_dtype_of(dtype):
    """Real dtype matching a possibly-complex dtype (pure numpy: usable at
    trace time without creating device values)."""
    import numpy as np
    return np.empty((), dtype).real.dtype
