"""Stateful GP model wrapper.

Counterpart of ``gpmpc_tpu/models/gp.py::GP``: stores the training data,
z-score normalizes inputs/outputs, trains the hyperparameters (multistart
batched L-BFGS on the Cholesky NLL, :func:`gp_core.fit`) unless they are
given (``hyper=`` or :meth:`GP.load_model`), precomputes the per-dim
factorizations, selects the propagation scheme, predicts, validates on
held-out data and saves to the JAX package's ``.npz`` format.  Sparse
(inducing-point) GPs are ROADMAP slice F item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.models.propagate import Normalization, get_propagator
from gpmpc_tpu_torch.ops.kernels import KERNELS
from gpmpc_tpu_torch.utils.config import GPConfig
from gpmpc_tpu_torch.utils.device import resolve_device


def mean_fn_functional(post: gp_core.GPPosterior, norm: Normalization,
                       cfg: GPConfig, z: torch.Tensor) -> torch.Tensor:
    """Raw-space predictive mean with the posterior as an explicit argument."""
    zn = (z - norm.z_mean) / norm.z_std
    return norm.y_mean + norm.y_std * gp_core.predict_mean(post, zn, cfg)


class GP:
    """Multi-output GP regressor: one independent SE-ARD GP per output dim.

    ``device`` (default: the CUDA card; pass ``device="cpu"`` for the CPU)
    and ``dtype`` place every tensor the GP holds; the training data and
    hyperparameters may come in as numpy arrays or tensors.  Without
    ``hyper`` the GP trains at construction (``train=True``): ``multistart``
    starts per output dim, at most ``max_iters`` L-BFGS iterations each,
    the perturbed starts drawn from ``generator`` (default: a
    ``torch.Generator`` on the GP's device seeded with ``seed``)."""

    def __init__(self,
                 X,
                 Y,
                 mean_func: str = "zero",
                 gp_method: str = "TA",
                 hyper: Optional[gp_core.GPHypers] = None,
                 normalize: bool = True,
                 multistart: int = 2,
                 max_iters: int = 250,
                 optimizer_opts: Optional[dict] = None,
                 train: bool = True,
                 seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 inducing: Optional[int] = None,
                 mesh=None,
                 kernel: str = "se",
                 device=None,
                 dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        X = self._t(X)
        Y = self._t(Y)
        if X.ndim != 2 or Y.ndim != 2 or X.shape[0] != Y.shape[0]:
            raise ValueError("X must be (N, D) and Y (N, Ny) with equal N")
        if kernel not in KERNELS:
            raise NotImplementedError(
                f"kernel {kernel!r} is not ported yet (ROADMAP slice F item "
                f"2); supported: {KERNELS}")
        if inducing is not None:
            raise NotImplementedError(
                "sparse (inducing-point) GPs are not ported yet (ROADMAP "
                "slice F item 8)")
        if mesh is not None:
            raise NotImplementedError(
                "GP(mesh=): sharding the training grid over devices is not "
                "ported yet (ROADMAP slice F item 10, torch.distributed)")
        self.X_raw = X
        self.Y_raw = Y
        self.N, self.D = X.shape
        self.Ny = Y.shape[1]
        self.cfg = GPConfig(mean_func=mean_func, multistart=multistart,
                            max_iters=max_iters, normalize=normalize,
                            kernel=kernel, **dict(optimizer_opts or {}))
        self._generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(seed)

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

        self.hyper: Optional[gp_core.GPHypers] = None
        self.nll: Optional[torch.Tensor] = None
        #: batched NLL evaluations of the last training
        self.n_evals = 0
        self.post: Optional[gp_core.GPPosterior] = None
        if hyper is not None:
            self.hyper = gp_core.GPHypers(*(self._t(h) for h in hyper))
            self._build_posterior()
        elif train:
            self.train()
        self.set_method(gp_method)

    # ------------------------------------------------------------ training

    def train(self, generator: Optional[torch.Generator] = None) -> None:
        """Multistart L-BFGS hyperparameter training of every output dim at
        once (:func:`gp_core.fit`), then the posterior.  The perturbed
        starts come from ``generator`` (default: the GP's own)."""
        self.hyper, self.nll, self.n_evals = gp_core.fit(
            self.Xn, self.Yn, self.cfg,
            generator if generator is not None else self._generator)
        self._build_posterior()

    def _build_posterior(self) -> None:
        self.post = gp_core.posterior(self.Xn, self.Yn, self.hyper, self.cfg)

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

    # ------------------------------------------------------------ validate

    def validate(self, X_test, Y_test, verbose: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Held-out metrics per output dim: SMSE, MNLP and RMSE (numpy), as
        the JAX package's ``validate``; the predictions are one batched
        :func:`gp_core.predict_batch` (one K3 launch on the card)."""
        z = self._t(X_test)
        y = np.asarray(Y_test.cpu() if torch.is_tensor(Y_test) else Y_test,
                       dtype=np.float64)
        cfg = dataclasses.replace(self.cfg, predict_includes_noise=True)
        norm = self.norm
        mu_n, var_n = gp_core.predict_batch(
            self.post, (z - norm.z_mean) / norm.z_std, cfg)
        mu = (norm.y_mean + norm.y_std * mu_n).cpu().double().numpy()
        var = torch.clamp(norm.y_std ** 2 * var_n, min=1e-12)
        var = var.cpu().double().numpy()
        err2 = (mu - y) ** 2
        rmse = np.sqrt(err2.mean(axis=0))
        smse = err2.mean(axis=0) / y.var(axis=0)
        mnlp = 0.5 * (err2 / var + np.log(2 * np.pi * var)).mean(axis=0)
        if verbose:
            for d in range(self.Ny):
                print(f"dim {d}: RMSE={rmse[d]:.4g}  SMSE={smse[d]:.4g}  "
                      f"MNLP={mnlp[d]:.4g}")
        return smse, mnlp, rmse

    # ------------------------------------------------------------ persist

    def save_model(self, path: str) -> None:
        """Persist X, Y and the hypers to ``.npz`` in the JAX package's
        format, so either package can load the model."""
        np.savez(path, X=self.X_raw.cpu().numpy(), Y=self.Y_raw.cpu().numpy(),
                 **{k: v.detach().cpu().numpy()
                    for k, v in self.hyper._asdict().items()},
                 mean_func=self.cfg.mean_func, gp_method=self.gp_method,
                 normalize=self.cfg.normalize, kernel=self.cfg.kernel,
                 inducing=0, Zn=np.zeros((0, 0)))

    @classmethod
    def load_model(cls, path: str, device=None,
                   dtype=torch.float32, **gp_kwargs) -> "GP":
        """Rebuild a trained GP from the ``.npz`` that either package's
        ``GP.save_model`` writes (on the card unless ``device`` says
        otherwise)."""
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

    # ------------------------------------------------------------ misc

    def get_size(self) -> Tuple[int, int, int]:
        """(N, D, Ny) — training-set size, input dim, output dim."""
        return self.N, self.D, self.Ny

    def print_hyper_parameters(self) -> None:
        """Pretty-print the hypers (and the trained NLL per dim)."""
        h = self.hyper
        for d in range(self.Ny):
            ell = ", ".join(f"{v:.4g}"
                            for v in torch.exp(h.log_ell[d]).tolist())
            print(f"GP dim {d}: ell=[{ell}]  "
                  f"sf2={float(torch.exp(h.log_sf2[d])):.4g}  "
                  f"sn2={float(torch.exp(h.log_sn2[d])):.4g}"
                  + (f"  NLL={float(self.nll[d]):.4g}"
                     if self.nll is not None else ""))
