"""Port parity: the fixture GP of gpmpc_tpu_torch against gpmpc_tpu's on the
same numpy arrays (f64, rtol 1e-8): posterior factors, prediction, TA/ME
propagation, linearization, and loading the JAX package's saved model."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpmpc_tpu import GP as JGP
from gpmpc_tpu.models.gp_core import GPHypers as JHypers
from gpmpc_tpu.models import gp_core as jcore
from gpmpc_tpu.models import propagate as jprop
from gpmpc_tpu_torch import GP
from gpmpc_tpu_torch.models import gp_core, propagate
from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_fixture, \
    gp_from_numpy

RTOL = 1e-8
OPTS = dict(jitter=1e-5, min_noise=1e-4)


def _close(got, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def pair():
    f = np.load(FIXTURE)
    f64 = jnp.float64            # the fixture stores f32; both sides widen
    hyper = JHypers(log_ell=jnp.asarray(f["tank_log_ell"], f64),
                    log_sf2=jnp.asarray(f["tank_log_sf2"], f64),
                    log_sn2=jnp.asarray(f["tank_log_sn2"], f64),
                    mean_w=jnp.zeros((4, 0), f64))
    jgp = JGP(jnp.asarray(f["tank_X"], f64), jnp.asarray(f["tank_Y"], f64),
              mean_func="zero", hyper=hyper, gp_method="TA",
              optimizer_opts=OPTS)
    tgp = gp_from_fixture(dtype=torch.float64, gp_method="TA",
                          optimizer_opts=OPTS, device="cpu")
    return jgp, tgp


def _queries(n=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform([6, 6, 1, 1], [16, 16, 4, 4], (n, 4))
    u = rng.uniform(0, 6, (n, 2))
    return np.concatenate([x, u], axis=1)


def test_posterior_matches(pair):
    jgp, tgp = pair
    assert (tgp.N, tgp.D, tgp.Ny) == (100, 6, 4)
    for name in ("z_mean", "z_std", "y_mean", "y_std"):
        _close(getattr(tgp.norm, name), getattr(jgp.norm, name))
    _close(tgp.post.chol, jgp.post.chol, atol=1e-12)
    scale_a = float(np.abs(np.asarray(jgp.post.alpha)).max())
    _close(tgp.post.alpha, jgp.post.alpha, atol=RTOL * scale_a)
    scale_k = float(np.abs(np.asarray(jgp.post.inv_k)).max())
    _close(tgp.post.inv_k, jgp.post.inv_k, atol=RTOL * scale_k)


def _var_atol(gp, raw=False):
    """The variance sf2 - k*'K^-1 k* cancels two terms of size sf2, so its
    error is held against that size: rtol 1e-8 of sf2 (times y_std^2 in raw
    units)."""
    scale = np.exp(np.asarray(gp.hyper.log_sf2))
    if raw:
        scale = scale * np.asarray(gp.norm.y_std) ** 2
    return RTOL * float(scale.max())


def test_predict_and_propagate_match(pair):
    jgp, tgp = pair
    rng = np.random.default_rng(3)
    for z in _queries():
        zn = (z - np.asarray(jgp.norm.z_mean)) / np.asarray(jgp.norm.z_std)
        mu_j, var_j = jcore.predict(jgp.post, jnp.asarray(zn), jgp.cfg)
        mu_t, var_t = gp_core.predict(tgp.post, torch.as_tensor(zn), tgp.cfg)
        _close(mu_t, mu_j, atol=1e-12)
        _close(var_t, var_j, atol=_var_atol(jgp))
        m = 0.1 * rng.standard_normal((6, 6))
        cov = m @ m.T
        for jf, tf in ((jprop.propagate_ta, propagate.propagate_ta),
                       (jprop.propagate_me, propagate.propagate_me)):
            outs_j = jf(jgp.post, jgp.norm, jgp.cfg, jnp.asarray(z),
                        jnp.asarray(cov))
            outs_t = tf(tgp.post, tgp.norm, tgp.cfg, torch.as_tensor(z),
                        torch.as_tensor(cov))
            for got, ref in zip(outs_t, outs_j):
                _close(got, ref, atol=_var_atol(jgp, raw=True))


def test_wrapper_surface_matches(pair):
    jgp, tgp = pair
    z = _queries(1, seed=7)[0]
    _close(tgp.linearize(z), jgp.linearize(jnp.asarray(z)), atol=1e-10)
    _close(tgp.noise_cov(), jgp.noise_cov())
    mu_t, var_t = tgp.predict(z[:4], z[4:])
    mu_j, var_j = jgp.predict(jnp.asarray(z[:4]), jnp.asarray(z[4:]))
    _close(mu_t, mu_j, atol=1e-10)
    _close(var_t, var_j, atol=_var_atol(jgp, raw=True))
    cov = 0.01 * np.eye(6)
    mu_t, sig_t = tgp.predict(z[:4], z[4:], cov=cov)
    mu_j, sig_j = jgp.predict(jnp.asarray(z[:4]), jnp.asarray(z[4:]),
                              cov=jnp.asarray(cov))
    _close(sig_t, sig_j, atol=_var_atol(jgp, raw=True))


def test_load_model_reads_jax_npz(tmp_path):
    """A model saved by the JAX package's GP.save_model loads into the port
    and predicts the same (non-zero mean function included)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (25, 3))
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], x[:, 2] ** 2], axis=1)
    hyper = JHypers(log_ell=jnp.asarray(0.2 * rng.standard_normal((2, 3))),
                    log_sf2=jnp.asarray([0.1, -0.2]),
                    log_sn2=jnp.asarray([-5.0, -4.0]),
                    mean_w=jnp.asarray(rng.standard_normal((2, 4))))
    jgp = JGP(jnp.asarray(x), jnp.asarray(y), mean_func="linear",
              hyper=hyper, gp_method="ME")
    path = str(tmp_path / "gp.npz")
    jgp.save_model(path)
    tgp = GP.load_model(path, dtype=torch.float64, device="cpu")
    assert tgp.gp_method == "ME" and tgp.cfg.mean_func == "linear"
    for z in rng.uniform(-1, 1, (4, 3)):
        mu_t, var_t = tgp.predict(z)
        mu_j, var_j = jgp.predict(jnp.asarray(z))
        _close(mu_t, mu_j, atol=1e-10)
        _close(var_t, var_j, atol=_var_atol(jgp, raw=True))


def test_gp_from_numpy_f32_and_guards():
    f = np.load(FIXTURE)
    gp = gp_from_numpy(f["tank_X"][:20], f["tank_Y"][:20], f["tank_log_ell"],
                       f["tank_log_sf2"], f["tank_log_sn2"],
                       optimizer_opts=OPTS, device="cpu")
    assert gp.post.chol.dtype == torch.float32
    assert bool(torch.all(torch.isfinite(gp.post.chol)))
    # sparse GPs are ported (ROADMAP §1 item 6.7; tests/test_torch_
    # sparse.py holds them against JAX): the JAX package's guards
    sp = GP(f["tank_X"][:20], f["tank_Y"][:20], inducing=10, train=False,
            device="cpu")
    assert sp.Zn.shape == (10, 6) and sp.post is None
    with pytest.raises(ValueError, match=r"inducing=20 must be in \[1, N=20\)"):
        GP(f["tank_X"][:20], f["tank_Y"][:20], inducing=20, device="cpu")
    with pytest.raises(ValueError, match="requires inducing"):
        GP(f["tank_X"][:20], f["tank_Y"][:20], optimize_inducing=True,
           device="cpu")
    # the mesh is ported (ROADMAP §1 item 6.9; tests/test_torch_
    # distributed.py holds it against JAX): anything but a DeviceMesh is
    # refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        GP(f["tank_X"], f["tank_Y"], mesh=object(), device="cpu")
    gp.set_method("EM")         # ported with the car (slice B)
    gp.set_method("UT")         # ported with slice F (part 1)
