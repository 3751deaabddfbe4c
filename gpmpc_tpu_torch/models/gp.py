"""Stateful GP model wrapper.

Counterpart of ``gpmpc_tpu/models/gp.py::GP``: stores the training data,
z-score normalizes inputs/outputs, trains the hyperparameters (multistart
batched L-BFGS on the Cholesky NLL, :func:`gp_core.fit`) unless they are
given (``hyper=`` or :meth:`GP.load_model`), precomputes the per-dim
factorizations, selects the propagation scheme, predicts, validates on
held-out data and saves to the JAX package's ``.npz`` format.  With
``inducing=M`` it is the sparse variational GP of
:mod:`gpmpc_tpu_torch.models.sparse`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from gpmpc_tpu_torch.models import gp_core, sparse
from gpmpc_tpu_torch.models.propagate import Normalization, get_propagator
from gpmpc_tpu_torch.ops.kernels import KERNELS
from gpmpc_tpu_torch.parallel import distributed
from gpmpc_tpu_torch.utils.config import GPConfig
from gpmpc_tpu_torch.utils.device import resolve_device


def mean_fn_functional(post: gp_core.GPPosterior, norm: Normalization,
                       cfg: GPConfig, z: torch.Tensor) -> torch.Tensor:
    """Raw-space predictive mean with the posterior as an explicit argument."""
    zn = (z - norm.z_mean) / norm.z_std
    return norm.y_mean + norm.y_std * gp_core.predict_mean(post, zn, cfg)


class GP:
    """Multi-output GP regressor: one independent GP per output dim, of
    the kernel family ``kernel`` (``"se"``, ``"matern52"`` or
    ``"matern32"``).

    ``device`` (default: the CUDA card; pass ``device="cpu"`` for the CPU)
    and ``dtype`` place every tensor the GP holds; the training data and
    hyperparameters may come in as numpy arrays or tensors.  Without
    ``hyper`` the GP trains at construction (``train=True``): ``multistart``
    starts per output dim, at most ``max_iters`` L-BFGS iterations each,
    the perturbed starts drawn from ``generator`` (default: a
    ``torch.Generator`` on the GP's device seeded with ``seed``).
    ``gh_order`` and ``gh_grid`` are the Gauss-Hermite quadrature's knobs,
    read only with ``gp_method='GH'`` (``models/propagate.py::
    propagate_gh``).

    ``inducing=M`` (1 <= M < N) makes it the sparse variational GP
    (:mod:`~gpmpc_tpu_torch.models.sparse`): M k-center inducing points,
    training on the Titsias free-energy bound, a posterior every consumer
    takes as it takes the exact one.  ``optimize_inducing=True`` also
    refines the inducing locations on the summed bound (fit, Z-step,
    warm refit).

    ``mesh`` (a ``DeviceMesh`` of the GP's device type, from
    :func:`~gpmpc_tpu_torch.parallel.distributed.make_study_mesh`) shards
    the training grid over its ranks (:func:`gp_core.fit`; both fits of
    the sparse GP); every rank passes the same data and seed and holds
    the same result.  The Z-step and the refit stay on each rank, as in
    the JAX package."""

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
                 optimize_inducing: bool = False,
                 mesh=None,
                 kernel: str = "se",
                 gh_order: int = 3,
                 gh_grid: str = "auto",
                 device=None,
                 dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        X = self._t(X)
        Y = self._t(Y)
        if X.ndim != 2 or Y.ndim != 2 or X.shape[0] != Y.shape[0]:
            raise ValueError("X must be (N, D) and Y (N, Ny) with equal N")
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; "
                             f"supported: {KERNELS}")
        if inducing is not None and not 1 <= int(inducing) < X.shape[0]:
            raise ValueError(
                f"inducing={inducing} must be in [1, N={X.shape[0]}) — "
                "at M >= N the exact GP is both cheaper and tighter")
        self.inducing = int(inducing) if inducing is not None else None
        if optimize_inducing and inducing is None:
            raise ValueError("optimize_inducing=True requires inducing=M")
        self.optimize_inducing = bool(optimize_inducing)
        if mesh is not None:
            distributed.check_mesh(mesh, self.device)
        self.mesh = mesh
        if gh_grid not in ("auto", "tensor", "cubature5"):
            raise ValueError(f"gh_grid must be 'auto'|'tensor'|'cubature5';"
                             f" got {gh_grid!r}")
        self.gh_order = int(gh_order)
        self.gh_grid = gh_grid
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
        if self.inducing is not None:
            self.z_idx = sparse.select_inducing(self.Xn, self.inducing)
            self.Zn = self.Xn[self.z_idx.long()]     # (M, D) inducing inputs
        else:
            self.z_idx = None
            self.Zn = None

        self.hyper: Optional[gp_core.GPHypers] = None
        self.nll: Optional[torch.Tensor] = None
        #: batched objective evaluations of the last training, and (sparse)
        #: of each of its legs: the exact subset fit, the VFE fit, the
        #: Z-step and the refit
        self.n_evals = 0
        self.fit_evals = {}
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
        once (:func:`gp_core.fit`; with ``inducing`` on the VFE bound,
        :func:`sparse.fit_sparse`), then the posterior.  The perturbed
        starts come from ``generator`` (default: the GP's own)."""
        g = generator if generator is not None else self._generator
        if self.inducing is None:
            self.hyper, self.nll, self.n_evals = gp_core.fit(
                self.Xn, self.Yn, self.cfg, g, mesh=self.mesh)
            self.fit_evals = {"exact": self.n_evals}
        else:
            self.hyper, self.nll, evals = sparse.fit_sparse(
                self.Xn, self.Yn, self.Zn, self.cfg, g, mesh=self.mesh)
            if self.optimize_inducing:
                # coordinate descent: a Z-step on the summed bound with the
                # hypers fixed, then a warm single-start refit on the
                # moved set
                self.Zn, _, evals["inducing"] = sparse.optimize_inducing(
                    self.Xn, self.Yn, self.Zn, self.hyper, self.cfg)
                self.hyper, self.nll, evals["refit"] = sparse.refit_sparse(
                    self.Xn, self.Yn, self.Zn, self.hyper, self.cfg)
            self.fit_evals = evals
            self.n_evals = sum(evals.values())
        self._build_posterior()

    def _build_posterior(self) -> None:
        if self.inducing is not None:
            self.post = sparse.sparse_posterior(self.Xn, self.Yn, self.Zn,
                                                self.hyper, self.cfg)
        else:
            self.post = gp_core.posterior(self.Xn, self.Yn, self.hyper,
                                          self.cfg)

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
        if self.gp_method == "EM" and self.cfg.mean_func != "zero":
            raise ValueError(
                "exact moment matching (EM) requires mean_func='zero' "
                "(PILCO closed forms assume a zero prior mean)")
        if self.gp_method == "EM" and self.cfg.kernel != "se":
            raise ValueError(
                "exact moment matching (EM) requires kernel='se' — the "
                "PILCO closed forms are SE-specific; use ME/TA/UT/GH with "
                f"kernel={self.cfg.kernel!r}")
        prop = get_propagator(self.gp_method)
        if self.gp_method == "GH":
            prop = functools.partial(prop, order=self.gh_order,
                                     grid=self.gh_grid)
        cfg = self.cfg

        def moment_map(mu_z, cov_z):
            return prop(self.post, self.norm, cfg, mu_z, cov_z)

        self._moment_map = moment_map
        return moment_map

    def moment_map(self):
        """The one-step moment map ``(mu_z, Sigma_z) -> (mu_y, Sigma_y, C)``
        of the selected scheme: what the MPC embeds in its rollout."""
        return self._moment_map

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
        the JAX package's ``validate``; the predictions are one
        :func:`gp_core.predict_points` (one K3 launch on the card for an
        SE GP)."""
        z = self._t(X_test)
        y = np.asarray(Y_test.cpu() if torch.is_tensor(Y_test) else Y_test,
                       dtype=np.float64)
        cfg = dataclasses.replace(self.cfg, predict_includes_noise=True)
        norm = self.norm
        mu_n, var_n = gp_core.predict_points(
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
                 inducing=self.inducing or 0,
                 # the (possibly moved) inducing set in normalized
                 # coordinates, so a loaded model rebuilds this posterior
                 Zn=(self.Zn.detach().cpu().numpy() if self.Zn is not None
                     else np.zeros((0, 0))))

    @classmethod
    def load_model(cls, path: str, device=None,
                   dtype=torch.float32, **gp_kwargs) -> "GP":
        """Rebuild a trained GP from the ``.npz`` that either package's
        ``GP.save_model`` writes (on the card unless ``device`` says
        otherwise)."""
        z = np.load(path)
        hyper = gp_core.GPHypers(log_ell=z["log_ell"], log_sf2=z["log_sf2"],
                                 log_sn2=z["log_sn2"], mean_w=z["mean_w"])
        inducing = int(z["inducing"]) if "inducing" in z else 0
        gp = cls(z["X"], z["Y"], mean_func=str(z["mean_func"]),
                 gp_method=str(z["gp_method"]), hyper=hyper,
                 normalize=bool(z["normalize"]), inducing=inducing or None,
                 kernel=str(z["kernel"]) if "kernel" in z else "se",
                 device=device, dtype=dtype, **gp_kwargs)
        if inducing and "Zn" in z and z["Zn"].size:
            zn = gp._t(z["Zn"])
            if not torch.equal(gp.Zn, zn):
                gp.Zn = zn                       # optimized, not k-center
                gp._build_posterior()
                gp.set_method(gp.gp_method)
        return gp

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
