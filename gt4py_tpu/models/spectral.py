"""Spectral transforms: FFT-based filters and elliptic solves.

Per-level 2D real FFTs over the horizontal plane (XLA's FFT),
vectorized over the K-leading axis.  (Workload named by BASELINE.json;
absent from the reference repository.)
"""

import numpy as np


def _wavenumbers(ni, nj, dx, dy, xp):
    kx = xp.fft.fftfreq(ni, d=dx) * 2.0 * np.pi
    ky = xp.fft.rfftfreq(nj, d=dy) * 2.0 * np.pi
    return kx.reshape(1, ni, 1), ky.reshape(1, 1, -1)


def spectral_filter(q, cutoff: float, dx: float = 1.0, dy: float = 1.0):
    """Low-pass filter: zero all modes with |k| above ``cutoff`` (physical
    K-leading (K, NI, NJ) arrays, periodic)."""
    import jax.numpy as jnp

    nk, ni, nj = q.shape
    kx, ky = _wavenumbers(ni, nj, dx, dy, jnp)
    spec = jnp.fft.rfft2(q, axes=(1, 2))
    k2 = kx**2 + ky**2
    mask = (k2 <= cutoff**2).astype(spec.dtype)
    return jnp.fft.irfft2(spec * mask, s=(ni, nj), axes=(1, 2)).astype(q.dtype)


def poisson_solve(rhs, dx: float = 1.0, dy: float = 1.0):
    """Solve lap(p) = rhs on a doubly-periodic domain (zero-mean gauge)."""
    import jax.numpy as jnp

    nk, ni, nj = rhs.shape
    kx, ky = _wavenumbers(ni, nj, dx, dy, jnp)
    k2 = kx**2 + ky**2
    spec = jnp.fft.rfft2(rhs, axes=(1, 2))
    inv = jnp.where(k2 > 0, -1.0 / jnp.where(k2 > 0, k2, 1.0), 0.0)
    return jnp.fft.irfft2(spec * inv, s=(ni, nj), axes=(1, 2)).astype(rhs.dtype)


def spectral_filter_numpy(q, cutoff: float, dx: float = 1.0, dy: float = 1.0):
    nk, ni, nj = q.shape
    kx, ky = _wavenumbers(ni, nj, dx, dy, np)
    spec = np.fft.rfft2(q, axes=(1, 2))
    mask = ((kx**2 + ky**2) <= cutoff**2).astype(spec.dtype)
    return np.fft.irfft2(spec * mask, s=(ni, nj), axes=(1, 2)).astype(q.dtype)


def poisson_solve_numpy(rhs, dx: float = 1.0, dy: float = 1.0):
    nk, ni, nj = rhs.shape
    kx, ky = _wavenumbers(ni, nj, dx, dy, np)
    k2 = kx**2 + ky**2
    spec = np.fft.rfft2(rhs, axes=(1, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(k2 > 0, -1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    return np.fft.irfft2(spec * inv, s=(ni, nj), axes=(1, 2)).astype(rhs.dtype)
