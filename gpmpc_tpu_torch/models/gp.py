"""Stateful GP model wrapper.

Counterpart of ``gpmpc_tpu/models/gp.py::GP`` for a GP whose
hyperparameters are given (``hyper=`` or :meth:`GP.load_model`): stores the
training data, z-score normalizes inputs/outputs, precomputes per-dim
factorizations, selects the propagation scheme and predicts.  Training,
validation and saving are ROADMAP slice C; sparse GPs slice F.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd

from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.models.propagate import Normalization, get_propagator
from gpmpc_tpu_torch.ops.kernels import KERNELS
from gpmpc_tpu_torch.utils.config import GPConfig


def mean_fn_functional(post: gp_core.GPPosterior, norm: Normalization,
                       cfg: GPConfig, z: torch.Tensor) -> torch.Tensor:
    """Raw-space predictive mean with the posterior as an explicit argument."""
    zn = (z - norm.z_mean) / norm.z_std
    return norm.y_mean + norm.y_std * gp_core.predict_mean(post, zn, cfg)


class GP:
    """Multi-output GP regressor: one independent SE-ARD GP per output dim.

    ``device`` and ``dtype`` place every tensor the GP holds; the training
    data and hyperparameters may come in as numpy arrays or tensors."""

    def __init__(self,
                 X,
                 Y,
                 mean_func: str = "zero",
                 gp_method: str = "TA",
                 hyper: Optional[gp_core.GPHypers] = None,
                 normalize: bool = True,
                 optimizer_opts: Optional[dict] = None,
                 kernel: str = "se",
                 device=None,
                 dtype=torch.float32):
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.dtype = dtype
        X = self._t(X)
        Y = self._t(Y)
        if X.ndim != 2 or Y.ndim != 2 or X.shape[0] != Y.shape[0]:
            raise ValueError("X must be (N, D) and Y (N, Ny) with equal N")
        if kernel not in KERNELS:
            raise NotImplementedError(
                f"kernel {kernel!r} is not ported yet (ROADMAP slice F item "
                f"2); supported: {KERNELS}")
        if hyper is None:
            raise NotImplementedError(
                "GP training is not ported yet (ROADMAP slice C): pass "
                "hyper= or use GP.load_model / models.convert.gp_from_numpy")
        self.X_raw = X
        self.Y_raw = Y
        self.N, self.D = X.shape
        self.Ny = Y.shape[1]
        self.cfg = GPConfig(mean_func=mean_func, normalize=normalize,
                            kernel=kernel, **dict(optimizer_opts or {}))

        if normalize:
            z_std = torch.std(X, dim=0, correction=0)
            y_std = torch.std(Y, dim=0, correction=0)
            self.norm = Normalization(
                z_mean=torch.mean(X, dim=0),
                z_std=torch.where(z_std > 1e-12, z_std, 1.0),
                y_mean=torch.mean(Y, dim=0),
                y_std=torch.where(y_std > 1e-12, y_std, 1.0))
        else:
            self.norm = Normalization.identity(self.D, self.Ny, dtype,
                                               self.device)
        self.Xn = (X - self.norm.z_mean) / self.norm.z_std
        self.Yn = (Y - self.norm.y_mean) / self.norm.y_std

        self.hyper = gp_core.GPHypers(*(self._t(h) for h in hyper))
        self.post = gp_core.posterior(self.Xn, self.Yn, self.hyper, self.cfg)
        self.set_method(gp_method)

    def _t(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    # ------------------------------------------------------------ predict

    def set_method(self, gp_method: str):
        """Select the propagation scheme and build the one-step moment map
        ``(mu_z, Sigma_z) -> (mu_y, Sigma_y, C)``."""
        self.gp_method = gp_method.upper()
        prop = get_propagator(self.gp_method)
        cfg = self.cfg

        def moment_map(mu_z, cov_z):
            return prop(self.post, self.norm, cfg, mu_z, cov_z)

        self._moment_map = moment_map
        return moment_map

    def predict(self, x, u=None, cov=None, gp_method: Optional[str] = None):
        """One-step prediction.  With ``cov`` given, propagates input
        uncertainty by the selected scheme and returns ``(mean (Ny,), cov
        (Ny,Ny))``; without, returns ``(mean (Ny,), var (Ny,))``."""
        z = self._t(x)
        if u is not None:
            z = torch.cat([z, self._t(u)])
        if gp_method is not None and gp_method.upper() != self.gp_method:
            self.set_method(gp_method)
        if cov is None:
            d = z.shape[0]
            mu, sig, _ = self._moment_map(z, z.new_zeros((d, d)))
            return mu, torch.diagonal(sig)
        mu, sig, _ = self._moment_map(z, self._t(cov))
        return mu, sig

    def mean_fn(self):
        """Raw-space predictive mean ``z -> (Ny,)``."""
        post, norm, cfg = self.post, self.norm, self.cfg

        def f(z):
            return mean_fn_functional(post, norm, cfg, z)

        return f

    def linearize(self, z) -> torch.Tensor:
        """Jacobian of the predictive mean at z, (Ny, D)."""
        return jacfwd(self.mean_fn())(self._t(z))

    def noise_cov(self) -> torch.Tensor:
        """Learned process-noise covariance diag(sn2) in raw output units."""
        sn2 = torch.exp(self.hyper.log_sn2) + self.cfg.min_noise
        return torch.diag(sn2 * self.norm.y_std ** 2)

    # ------------------------------------------------------------ persist

    @classmethod
    def load_model(cls, path: str, device=None,
                   dtype=torch.float32, **gp_kwargs) -> "GP":
        """Rebuild a trained GP from the ``.npz`` that the JAX package's
        ``GP.save_model`` writes."""
        z = np.load(path)
        if "inducing" in z and int(z["inducing"]):
            raise NotImplementedError(
                "sparse (inducing-point) GPs are not ported yet "
                "(ROADMAP slice F item 8)")
        hyper = gp_core.GPHypers(log_ell=z["log_ell"], log_sf2=z["log_sf2"],
                                 log_sn2=z["log_sn2"], mean_w=z["mean_w"])
        return cls(z["X"], z["Y"], mean_func=str(z["mean_func"]),
                   gp_method=str(z["gp_method"]), hyper=hyper,
                   normalize=bool(z["normalize"]),
                   kernel=str(z["kernel"]) if "kernel" in z else "se",
                   device=device, dtype=dtype, **gp_kwargs)
