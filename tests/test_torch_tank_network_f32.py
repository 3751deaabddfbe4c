"""The four-tank network of ``tests/test_torch_tank_network.py`` in f32
with ``fused_kkt=True`` and the fused plant on both sides, one
output-feedback step at two units, the MPC's horizon cut to 5 steps (the
Pallas interpreter unrolls the stages: 20 take ~10 s more to compile on
one CPU core): the port's K1 at (8, 4) (the MPC) and (8, 8) (the MHE) and its K2
run their plain versions on the CPU, the JAX package runs its Pallas
kernels in interpret mode.  A file of its own so that another worker
takes its JAX compiles (~45 s on one CPU core)."""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_tank_network import run_loop


def test_network_step_f32_fused_matches_jax_pallas():
    """States, estimates and inputs within rtol 1e-3: f32 sums differ in
    order across jacfwd, line search and sweep (the f32 bound of
    ``tests/test_torch_mpc_step.py``)."""
    got = run_loop(2, "torch", torch.float32, True, 1, nt=5)
    ref = run_loop(2, "jax", jnp.float32, True, 1, nt=5)
    for g, r, name in zip(got, ref, ("x_true", "x_hat", "u")):
        assert g.dtype == np.float32 and np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, r, rtol=1e-3, err_msg=name)
