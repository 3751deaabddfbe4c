"""Package boundary and kernel-wrapper contracts of gpmpc_tpu_torch."""

import os
import subprocess
import sys

import pytest
import torch

from gpmpc_tpu_torch import Model
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.systems import four_tank_ode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    """The port imports torch and never jax or gpmpc_tpu (whose __init__
    imports jax), the batched study's package included."""
    code = (
        "import sys, pkgutil, importlib, gpmpc_tpu_torch\n"
        "import gpmpc_tpu_torch.parallel\n"
        "from gpmpc_tpu_torch.parallel import BatchedStudy, online_gp\n"
        "assert 'gpmpc_tpu_torch.parallel.batched' in sys.modules\n"
        "for m in pkgutil.walk_packages(gpmpc_tpu_torch.__path__, "
        "'gpmpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gpmpc_tpu' or m.startswith('gpmpc_tpu.')]\n"
        "print(len(bad), bad[:5])\n"
        "import torch\n"
        "print(torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0] == "0 []", out.stdout
    assert lines[1] == "False False", out.stdout


def test_fused_integrator_without_kernel_ode_raises_on_cuda():
    """On a CUDA device the fused integrator needs an ODE compiled into the
    RK4 kernel; a wrapped or foreign ODE is refused at construction (before
    any tensor is placed, so this runs without a card)."""
    kw = dict(Nx=4, Nu=2, dt=3.0, fused_integrator=True, device="cuda")
    with pytest.raises(ValueError, match="ROADMAP"):
        Model(ode=lambda x, u: four_tank_ode(x, u), **kw)
    assert ck.kernel_ode_id(four_tank_ode) == (0, 4, 2)
    assert ck.kernel_ode_id(lambda x, u: x) is None
    # on the CPU any ODE is fine: the wrapper runs the plain loop there
    Model(ode=lambda x, u: four_tank_ode(x, u), Nx=4, Nu=2, dt=3.0,
          fused_integrator=True, device="cpu")


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on CUDA gets an error, never
    the plain version."""
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.rk4_substeps(four_tank_ode, x, torch.empty(2, device="meta"),
                        0.3, 10)
    args = [torch.empty(s, device="meta") for s in
            ((3, 4, 4), (3, 4, 2), (3, 4), (3, 4, 4), (3, 2, 2), (3, 4, 2),
             (3, 4), (3, 2), (4, 4), (4,), (4,), ())]
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.riccati_sweep(*args)


def test_argument_checks():
    shapes = dict(x=(4,), u=(2,))
    good = (torch.zeros(4), torch.zeros(2))
    ck._check_cuda("k", good, shapes)
    with pytest.raises(TypeError, match="float32"):
        ck._check_cuda("k", (torch.zeros(4, dtype=torch.float64),
                             torch.zeros(2)), shapes)
    with pytest.raises(ValueError, match="shape"):
        ck._check_cuda("k", (torch.zeros(5), torch.zeros(2)), shapes)
    with pytest.raises(ValueError, match="contiguous"):
        ck._check_cuda("k", (torch.zeros(4, 2)[:, 0], torch.zeros(2)),
                       shapes)
    with pytest.raises(ValueError, match="tensor on"):
        ck._check_cuda("k", (torch.zeros(4), 1.0), shapes)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ck.build_library()
    assert not (tmp_path / "build").exists()


def test_reset_launches():
    ck.LAUNCHES["rk4_substeps"] += 3
    ck.reset_launches()
    assert ck.LAUNCHES == {"riccati_sweep": 0, "rk4_substeps": 0,
                           "se_ard_gram": 0, "cholesky": 0,
                           "gp_predict_batch": 0}
