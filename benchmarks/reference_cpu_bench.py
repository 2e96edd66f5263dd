#!/usr/bin/env python
"""Measured reference anchor: the ACTUAL reference implementation's
steps/sec at the headline benchmark's operating point (2D cubic NLSE,
1024^2, Krylov m=10 — expm_multiply's default, eigen_krylov_complex.hpp:58).

Builds /root/reference/nlsolvers/host/drivers/nlse_cubic_driver.cpp with the
reference's own release flags (CMakeLists.txt:51-52: -O2 -march=native
-ftree-vectorize -ffast-math -fprefetch-loop-arrays -fopenmp-simd) and times
two run lengths; the steps/sec comes from the delta, which cancels process
startup, .npy IO and the operator build.

Caveats recorded with the number: the host path is complex double (f64) —
the reference has no f32 CPU path — while bench.py runs complex64 on the GPU;
and this measures the HOST (Eigen) implementation, the only reference path
that runs without an NVIDIA GPU (BASELINE.md).

Prints one JSON line {metric, value, unit}.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
REF = Path("/root/reference/nlsolvers")
TF_INC = Path(sys.prefix) / "lib/python3.12/site-packages/tensorflow/include"

N = 1024
LX = 10.0
DT = 1e-4
NT_SHORT, NT_LONG = 4, 24


def build():
    exe = HERE / "golden/bin/nlse_cubic_driver_bench"
    if exe.exists():
        return exe
    exe.parent.mkdir(parents=True, exist_ok=True)
    # -mno-avx512fp16: the TF-bundled Eigen's AVX512-FP16 kernels don't
    # compile under this g++; fp16 paths are unused by the f64 solver anyway
    cmd = ["g++", "-O2", "-march=native", "-mno-avx512fp16",
           "-ftree-vectorize", "-ffast-math",
           "-fprefetch-loop-arrays", "-fopenmp-simd", "-std=c++17",
           f"-I{TF_INC}", f"-I{HERE}/golden/include",
           f"-I{REF}/common/include", f"-I{REF}/host/include",
           str(REF / "host/drivers/nlse_cubic_driver.cpp"), "-o", str(exe)]
    subprocess.run(cmd, check=True)
    return exe


def run(exe, tmp, nt):
    x = np.linspace(-LX, LX, N)
    X, Y = np.meshgrid(x, x, indexing="ij")
    u0 = (np.exp(-(X**2 + Y**2) / 4) * np.exp(0.5j * X)).astype(complex)
    m = np.ones((N, N))
    u0_f, m_f = tmp / "u0.npy", tmp / "m.npy"
    np.save(u0_f, u0)
    np.save(m_f, m)
    out = tmp / f"traj_{nt}.npy"
    t0 = time.perf_counter()
    subprocess.run([str(exe), str(N), str(N), str(LX), str(LX), str(u0_f),
                    str(out), str(nt * DT), str(nt), "1", str(m_f)],
                   check=True, capture_output=True)
    return time.perf_counter() - t0


def main():
    exe = build()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        t_short = run(exe, tmp, NT_SHORT)
        t_long = run(exe, tmp, NT_LONG)
    steps_per_sec = (NT_LONG - NT_SHORT) / (t_long - t_short)
    print(json.dumps({
        "metric": f"reference_host_nlse2d_cubic_{N}sq_m10_steps_per_sec",
        "value": round(steps_per_sec, 3),
        "unit": "time-steps/s (Eigen host, complex128, 1 CPU)",
        "t_short_s": round(t_short, 2), "t_long_s": round(t_long, 2),
    }))


if __name__ == "__main__":
    main()
