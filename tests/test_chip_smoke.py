"""The CPU-checkable parts of chip_smoke.py and of the runtime it relies on:
the refusal to run without a GPU, the choice of phases by card count, the
compile-cache placement, every phase's control flow at a tiny size on the
virtual CPU devices, and the main path without the optional h5py package.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, cwd=ROOT, env=None, code=None):
    """A fresh interpreter on the CPU backend (`python -c code` or a
    script), so process-level JAX settings cannot leak between tests."""
    full_env = dict(os.environ, JAX_PLATFORMS="cpu",
                    PYTHONPATH=str(ROOT))
    full_env.pop("JAX_COMPILATION_CACHE_DIR", None)
    full_env.update(env or {})
    cmd = [sys.executable] + (["-c", code] if code else []) + list(args)
    return subprocess.run(cmd, cwd=cwd, env=full_env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("where,args", [
    ("repo", []), ("repo", ["--chips", "4"]), ("alone", [])])
def test_exits_nonzero_without_gpu(where, args, tmp_path):
    """No GPU: a non-zero exit and no result line, also in a directory that
    holds chip_smoke.py and nothing else of the repo."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run(["chip_smoke.py"] + args, cwd=cwd,
                env={"PYTHONPATH": ""} if where == "alone" else None)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr


def test_chip_count_selects_phases():
    cs = _chip_smoke()
    one = [name for name, _ in cs.phases_for(1)]
    four = [name for name, _ in cs.phases_for(4)]
    assert one == ["golden", "headline", "nlse3d", "realwave", "datagen"]
    assert four == ["sweep_sharded", "grid_2d", "grid_3d",
                    "dryrun_multichip"]
    assert not set(one) & set(four)


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache is the fixed <repo>/.jax_cache."""
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import json, jax\n"
            "from nlsolvers_tpu.utils.runtime import enable_compile_cache\n"
            "got = enable_compile_cache()\n"
            "print(json.dumps([got, jax.config.jax_compilation_cache_dir]))")
    proc = _run([], env=env, code=code)
    assert proc.returncode == 0, proc.stderr
    got, config_dir = json.loads(proc.stdout.strip().splitlines()[-1])
    want = (str(tmp_path / env_dir) if env_dir
            else str(ROOT / ".jax_cache"))
    assert got == want
    assert config_dir == want


# each phase at a tiny size on the CPU devices: control flow, comparisons
# and the phase line, not speed
TINY = {
    "headline": dict(n=48, drift_steps=200, matfuncs=3),
    "nlse3d": dict(n=16, steps=20),
    "realwave": dict(n=48, steps=40),
    "datagen": dict(nx=24, nt=40, snapshots=4, krylov_m=8, runs=8),
    "sweep_sharded": dict(nx=24, nt=40, snapshots=4, krylov_m=8, runs=8),
    "grid_2d": dict(n=32),
    "grid_3d": dict(n=16),
    "dryrun_multichip": dict(),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_runs_at_tiny_size(name):
    cs = _chip_smoke()
    phases = dict(cs.phases_for(1) + cs.phases_for(4))
    line = phases[name](**TINY[name])
    assert isinstance(line, str) and line


def test_golden_phase_on_cpu():
    """The golden phase gates every case's f64-final check, and its one
    exemption names a case that runs."""
    cs = _chip_smoke()
    line = cs.phase_golden()
    assert line.startswith("23 cases")
    for case, key in cs.GOLDEN_F64_EXEMPT:
        assert f"{case} {key} " in line


def test_import_without_h5py():
    code = ("import sys\n"
            "sys.modules['h5py'] = None\n"
            "import nlsolvers_tpu\n"
            "from nlsolvers_tpu.models import problems\n"
            "from nlsolvers_tpu.pipeline import datagen, io_hdf5\n"
            "from nlsolvers_tpu.analysis import ensemble\n"
            "print('imported')")
    proc = _run([], code=code)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_npy_sweep_without_h5py(tmp_path):
    code = ("import sys\n"
            "sys.modules['h5py'] = None\n"
            "from nlsolvers_tpu.pipeline.__main__ import main\n"
            "sys.exit(main(sys.argv[1:]))")
    proc = _run(["nlse", "--phenomenon", "multi_soliton", "--nx", "16",
                 "--T", "0.01", "--nt", "4", "--snapshots", "2",
                 "--krylov-m", "4", "--num-runs", "2", "--format", "npy",
                 "--output-dir", str(tmp_path)], code=code)
    assert proc.returncode == 0, proc.stderr
    assert len(list((tmp_path / "npy").glob("run_*_u.npy"))) == 2


def test_hdf5_format_without_h5py_names_it(tmp_path, monkeypatch):
    from nlsolvers_tpu.pipeline.datagen import DatagenConfig

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        DatagenConfig(family="nlse", phenomenon="multi_soliton",
                      system="cubic", nx=16, num_runs=1,
                      output_dir=str(tmp_path), archive_format="hdf5")
