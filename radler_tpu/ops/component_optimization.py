"""Component-amplitude optimization (post-automask).

TPU-native equivalent of ``cpp/math/component_optimization.{h,cc}``:

* ``linear_component_solve`` — exact least-squares solve of the component
  amplitudes so the residual is zero at component positions
  (``component_optimization.cc:181-263``).  The reference builds a wrap-around
  PSF matrix and calls GSL; here the (K x K) system is built with one PSF
  gather and solved with ``jnp.linalg.solve`` on the device.
* ``gradient_descent`` — line-search gradient descent where gradient and
  residual are computed with FFT convolutions
  (``component_optimization.cc:265-321``); independent of the number of
  components.
* ``lm_nonlinear_fit`` — regularized Levenberg–Marquardt amplitude fit, the
  TPU-native equivalent of ``LsDeconvolution::nonLinearFit``
  (``cpp/algorithms/ls_deconvolution.cc:243-316``).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..settings import OptimizationAlgorithm
from .convolution import padded_convolve


def linear_component_solve(
    model: jnp.ndarray, residual: jnp.ndarray, psf: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve amplitudes at the model's non-zero positions exactly.

    Mirrors ``LinearComponentSolve``: unknowns are amplitudes at the existing
    model component positions; equations demand the dirty image equals the
    model convolved with the PSF at those positions (wrap-around indexing,
    like the reference's ``(x + width + psf_x - x_i) % width``).  The residual
    is zeroed at component positions afterwards.
    """
    h, w = model.shape
    host_model = np.asarray(model)
    ys, xs = np.nonzero(host_model)
    k = len(xs)
    if k == 0:
        return model, residual
    xs_j = jnp.asarray(xs)
    ys_j = jnp.asarray(ys)
    # A[i, j] = psf value at position i for a component at position j
    # (wrap-around, matching component_optimization.cc:200-230).
    dyy = (ys_j[:, None] - ys_j[None, :] + h + h // 2) % h
    dxx = (xs_j[:, None] - xs_j[None, :] + w + w // 2) % w
    a = psf[dyy, dxx]
    # b: dirty value = residual + model ⊛ psf at the positions.
    dirty = residual + padded_convolve(model, psf)
    b = dirty[ys_j, xs_j]
    amplitudes, *_ = jnp.linalg.lstsq(a, b)
    new_model = jnp.zeros_like(model).at[ys_j, xs_j].set(amplitudes)
    new_residual = dirty - padded_convolve(new_model, psf)
    new_residual = new_residual.at[ys_j, xs_j].set(0.0)
    return new_model, new_residual


@partial(jax.jit, static_argnames=("n_iterations", "padded_h", "padded_w"))
def _gd_iterations(
    model, dirty, psf, mask, n_iterations, padded_h, padded_w
):
    def conv(x):
        return padded_convolve(x, psf, padded_shape=(padded_h, padded_w))

    def body(_, state):
        model, _ = state
        residual = dirty - conv(model)
        gradient = conv(residual) * mask
        conv_grad = conv(gradient)
        denom = jnp.sum(conv_grad * conv_grad)
        step = jnp.where(
            denom > 0.0, jnp.sum(residual * conv_grad) / denom, 0.0
        )
        model = model + step * gradient
        return model, residual

    model, _ = jax.lax.fori_loop(0, n_iterations, body, (model, dirty))
    residual = dirty - conv(model)
    return model, residual


def gradient_descent(
    model: jnp.ndarray,
    residual: jnp.ndarray,
    psf: jnp.ndarray,
    n_iterations: int = 4,
    support_mask: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Line-search GD over component amplitudes
    (``component_optimization.cc:265-321``): only positions in the support
    are adjusted (by default the model acts as its own support mask)."""
    h, w = model.shape
    if support_mask is None:
        mask = (model != 0.0).astype(model.dtype)
    else:
        mask = support_mask.astype(model.dtype)
    dirty = residual + padded_convolve(model, psf)
    ph, pw = 2 * h, 2 * w
    return _gd_iterations(model, dirty, psf, mask, n_iterations, ph, pw)


def gradient_descent_with_variable_psf(
    supports: "list[jnp.ndarray]",
    image: jnp.ndarray,
    psfs: "list[jnp.ndarray]",
    n_iterations: int = 10,
    padded_shape=None,
) -> "list[jnp.ndarray]":
    """Joint line-search GD over components with per-group PSFs.

    Mirrors ``GradientDescentWithVariablePsf``
    (``component_optimization.cc:323-400``): one delta image per PSF group
    (used by multiscale to jointly refine components of every scale, each
    convolved with its own scale-convolved PSF).  ``supports[g]`` is a 0/1
    image marking group ``g``'s component positions.
    """
    h, w = image.shape
    if padded_shape is None:
        padded_shape = (2 * h, 2 * w)

    def conv(x, psf):
        return padded_convolve(x, psf, padded_shape=padded_shape)

    models = [jnp.zeros((h, w), jnp.float32) for _ in psfs]
    for _ in range(n_iterations):
        residual = image
        for model, psf in zip(models, psfs):
            residual = residual - conv(model, psf)
        # Gradient per group: residual correlated with the PSF at component
        # positions; direction image = gradients re-convolved.
        gradients = [
            conv(residual, psf) * support
            for psf, support in zip(psfs, supports)
        ]
        direction = jnp.zeros((h, w), jnp.float32)
        for gradient, psf in zip(gradients, psfs):
            direction = direction + conv(gradient, psf)
        denom = jnp.sum(direction * direction)
        step = jnp.where(denom > 0.0, jnp.sum(residual * direction) / denom, 0.0)
        models = [
            model + step * gradient
            for model, gradient in zip(models, gradients)
        ]
    return models


@partial(jax.jit, static_argnames=("max_iterations",))
def _lm_iterations(
    gram: jnp.ndarray,  # [K, K] PSF Gram matrix (A^T A over all pixels)
    b: jnp.ndarray,  # [K] correlation of the dirty with the PSF at positions
    dirty_sq: jnp.ndarray,  # scalar ||dirty||^2
    mu: jnp.ndarray,  # regularization strength
    max_iterations: int,
):
    """Device LM loop over amplitudes ``x``: minimize
    ``||dirty - A x||^2 + (mu * sum|x|)^2``.

    Because the model is linear in ``x``, the data term reduces to K-space:
    ``||dirty||^2 - 2 x.b + x.G.x`` — no image-size work inside the loop.
    The penalty Jacobian row is ``mu * |x_p|`` — the reference's (inexact)
    derivative, reproduced deliberately (``ls_deconvolution.cc:107-125``).
    Stopping matches ``gsl_multifit_test_delta(dx, x, 1e-4, 1e-4)``.
    """
    k = b.shape[0]
    eye = jnp.eye(k, dtype=gram.dtype)

    def cost_of(x):
        data = dirty_sq - 2.0 * jnp.dot(x, b) + jnp.dot(x, gram @ x)
        pen = mu * jnp.sum(jnp.abs(x))
        return data + pen * pen

    def cond(state):
        it, x, lam, cost, done = state
        return (~done) & (it < max_iterations)

    def body(state):
        it, x, lam, cost, _ = state
        ax = jnp.abs(x)
        pen_sum = mu * jnp.sum(ax)
        # J^T r: data part -(b - G x); penalty row (mu |x_p|) * (mu sum|x|).
        g = -(b - gram @ x) + (mu * ax) * pen_sum
        # J^T J = G + mu^2 |x||x|^T; Marquardt damping on the diagonal.
        h = gram + (mu * mu) * jnp.outer(ax, ax)
        damped = h + lam * (jnp.diag(jnp.diag(h)) + 1e-12 * eye)
        delta = jnp.linalg.solve(damped, -g)
        new_x = x + delta
        new_cost = cost_of(new_x)
        accept = new_cost < cost
        x = jnp.where(accept, new_x, x)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, lam * 0.1, lam * 10.0)
        converged = accept & jnp.all(
            jnp.abs(delta) < 1e-4 + 1e-4 * jnp.abs(x)
        )
        stuck = lam > 1e12
        return it + 1, x, lam, cost, converged | stuck

    init = (
        jnp.int32(0),
        jnp.zeros_like(b),
        jnp.asarray(1e-3, gram.dtype),
        cost_of(jnp.zeros_like(b)),
        jnp.asarray(False),
    )
    _, x, _, _, _ = jax.lax.while_loop(cond, body, init)
    return x


def lm_nonlinear_fit(
    mask: np.ndarray,  # [H, W] bool component support
    residual: jnp.ndarray,
    psf: jnp.ndarray,
    regularization: float = 0.1,
    max_iterations: int = 100,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Regularized nonlinear amplitude fit over the mask positions
    (``LsDeconvolution::nonLinearFit``, ``ls_deconvolution.cc:243-316``).

    The reference iterates GSL's ``lmsder`` over residuals
    ``[dirty - A x; mu * sum|x|]`` with wrap-around PSF indexing and
    ``mu = 0.1``.  The model is linear in ``x``, so ``A^T A`` is the circular
    autocorrelation of the PSF gathered at pairwise position offsets — the
    whole LM solve then runs on-device in K-space (one [K, K] system per LM
    step) with two FFT correlations of image-size work total.

    Returns ``(model, residual)`` like the reference: the fitted amplitudes
    placed at their positions, and ``dirty - model ⊛ psf`` everywhere (the
    nonlinear path does not zero the residual at the positions).
    """
    h, w = residual.shape
    ys, xs = np.nonzero(np.asarray(mask))
    k = len(xs)
    if k == 0:
        return jnp.zeros_like(residual), residual
    ys_j = jnp.asarray(ys)
    xs_j = jnp.asarray(xs)
    # Circular autocorrelation R(d) = sum_j psf_c(j) psf_c(j+d); the Gram
    # matrix is R at pairwise offsets (wrap-around indexing as in the
    # reference's ``(x + midX - pX) % width``).
    psf_f = jnp.fft.rfft2(jnp.fft.ifftshift(psf))
    autocorr = jnp.fft.irfft2(psf_f * jnp.conj(psf_f), s=(h, w))
    dyy = (ys_j[:, None] - ys_j[None, :]) % h
    dxx = (xs_j[:, None] - xs_j[None, :]) % w
    gram = autocorr[dyy, dxx]
    # b_p = (dirty ⋆ psf)(p): correlate, then gather at the positions.
    corr = jnp.fft.irfft2(jnp.fft.rfft2(residual) * jnp.conj(psf_f), s=(h, w))
    b = corr[ys_j, xs_j]
    dirty_sq = jnp.sum(residual * residual)

    amplitudes = _lm_iterations(
        gram.astype(jnp.float32),
        b.astype(jnp.float32),
        dirty_sq,
        jnp.float32(regularization),
        max_iterations,
    )
    model = jnp.zeros_like(residual).at[ys_j, xs_j].set(amplitudes)
    model_f = jnp.fft.rfft2(model)
    fitted = jnp.fft.irfft2(model_f * psf_f, s=(h, w))
    return model, residual - fitted


def run_component_optimization(
    dirty_set, model_set, psfs: jnp.ndarray, algorithm: OptimizationAlgorithm
) -> None:
    """Dispatch per image (``generic_clean.cc:26-49``).

    Only the model is updated; the reference's solvers take the residual as
    const and leave the stored residual images untouched."""
    meta = dirty_set.meta
    new_mod = []
    for i in range(dirty_set.n_images):
        res = dirty_set.data[i]
        mod = model_set.data[i]
        psf = psfs[meta.psf_index(i)]
        if algorithm == OptimizationAlgorithm.LINEAR_EQUATION_SOLVER:
            mod, _ = linear_component_solve(mod, res, psf)
        elif algorithm == OptimizationAlgorithm.GRADIENT_DESCENT:
            mod, _ = gradient_descent(mod, res, psf)
        else:
            raise RuntimeError(
                f"Unsupported optimization algorithm {algorithm} for generic "
                "clean"
            )
        new_mod.append(mod)
    model_set.data = jnp.stack(new_mod)
