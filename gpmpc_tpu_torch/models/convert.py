"""Carrying GP weights between the JAX package and the port.

Both packages build their GP from the same numpy arrays: the training set
and the log hyperparameters.  ``gp_from_numpy`` builds the port's GP from
them, ``hypers_to_numpy`` gives them back from a port-trained GP (the JAX
``GPHypers(**{k: jnp.asarray(v) ...})`` takes them), and
``gp_from_fixture`` reads the pinned bench fixture
(``benchmarks/bench_fixture.npz``) the way ``bench.py`` does.  Like the
``GP`` they make, both functions place it on the card unless ``device``
says otherwise.  ``online_posterior_from_numpy`` carries a conditioned
online posterior (``OnlinePosterior`` of either package) over by its
leaves.
"""

from __future__ import annotations

import os

import numpy as np

import torch

from gpmpc_tpu_torch.models.gp import GP
from gpmpc_tpu_torch.models.gp_core import GPHypers
from gpmpc_tpu_torch.models.propagate import Normalization
from gpmpc_tpu_torch.parallel.online_gp import OnlinePosterior
from gpmpc_tpu_torch.utils.device import resolve_device

#: the pinned bench model shared with the JAX package
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "benchmarks", "bench_fixture.npz")


def gp_from_numpy(X, Y, log_ell, log_sf2, log_sn2, mean_w=None, *,
                  device=None, dtype=None, **gp_kwargs) -> GP:
    """A :class:`GP` from numpy arrays: X (N, D), Y (N, Ny), log_ell
    (Ny, D), log_sf2 (Ny,), log_sn2 (Ny,), mean_w (Ny, F) (zeros (Ny, 0)
    when None, i.e. the zero mean).  ``gp_kwargs`` go to :class:`GP`:
    ``kernel=`` carries a JAX GP's kernel family (a Matérn GP's hypers
    mean nothing under another kernel), ``gh_order=``/``gh_grid=`` its GH
    quadrature, ``gp_method=``, ``mean_func=``, ``optimizer_opts=``."""
    ny = np.shape(log_sf2)[0]
    if mean_w is None:
        mean_w = np.zeros((ny, 0))
    hyper = GPHypers(log_ell=np.asarray(log_ell), log_sf2=np.asarray(log_sf2),
                     log_sn2=np.asarray(log_sn2), mean_w=np.asarray(mean_w))
    if dtype is not None:
        gp_kwargs["dtype"] = dtype
    return GP(np.asarray(X), np.asarray(Y), hyper=hyper, device=device,
              **gp_kwargs)


def hypers_to_numpy(hyper: GPHypers) -> dict:
    """The log hyperparameters as numpy arrays keyed by ``GPHypers``'
    field names: log_ell (Ny, D), log_sf2 (Ny,), log_sn2 (Ny,), mean_w
    (Ny, F)."""
    return {k: v.detach().cpu().numpy() for k, v in hyper._asdict().items()}


def gp_from_fixture(path: str = FIXTURE, prefix: str = "tank", n=None, *,
                    device=None, dtype=None, **gp_kwargs) -> GP:
    """The pinned fixture GP ``{prefix}_*`` (zero mean), optionally cut to
    its first ``n`` training points."""
    f = np.load(path)
    sl = slice(None) if n is None else slice(0, int(n))
    return gp_from_numpy(f[f"{prefix}_X"][sl], f[f"{prefix}_Y"][sl],
                         f[f"{prefix}_log_ell"], f[f"{prefix}_log_sf2"],
                         f[f"{prefix}_log_sn2"], mean_func="zero",
                         device=device, dtype=dtype, **gp_kwargs)


def online_posterior_from_numpy(leaves, norm, *, device=None, dtype=None):
    """The port's ``(OnlinePosterior, Normalization)`` from an online
    posterior's leaves as numpy arrays in the field order both packages
    share (x, y, inv_k, alpha, count, log_ell, log_sf2, sn2, mean_w; a
    leading batch dim allowed) and the normalization's four arrays
    (z_mean, z_std, y_mean, y_std).  ``count`` stays int32; the rest take
    ``dtype`` (default: their own).  On the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    leaves = list(leaves)
    if len(leaves) != len(OnlinePosterior._fields):
        raise ValueError(f"expected {len(OnlinePosterior._fields)} leaves "
                         f"{OnlinePosterior._fields}; got {len(leaves)}")

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    count = OnlinePosterior._fields.index("count")
    post = OnlinePosterior(*(t(a, torch.int32) if i == count else t(a)
                             for i, a in enumerate(leaves)))
    return post, Normalization(*(t(a) for a in norm))
