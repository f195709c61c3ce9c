"""Real-arithmetic DFT helpers (matmul form).

The small DFTs the model needs are expressed as real matrix products at
full float32 precision, so no complex intermediate appears. Every size
involved is tiny (direction counts <= 32, spectral grids <= domain size).
`jnp.fft` could replace them (ROADMAP).

Used by the ensemble spectral-noise generator (inverse rfft2 of a
half-plane spectrum) and the WIM isotropic-scattering mode (forward/inverse
DFT over the wave-direction axis).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# small DFT matmuls need full f32 precision (a float32 matmul may
# otherwise run in reduced precision, e.g. TF32)
_PREC = jax.lax.Precision.HIGHEST

def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def _basis(n: int, m: int, dtype):
    """cos/sin DFT basis matrices B[j, k] = trig(2*pi*j*k/n), shape (m, n)."""
    j = np.arange(m)[:, None]
    k = np.arange(n)[None, :]
    ang = 2.0 * np.pi * j * k / n
    return jnp.asarray(np.cos(ang), dtype), jnp.asarray(np.sin(ang), dtype)


def irfft2(a, b, shape):
    """Real inverse 2-D FFT of a half-plane spectrum a + i*b with shape
    (ny, nx//2+1), matching ``jnp.fft.irfft2(a + 1j*b, s=shape)``.

    Computed as ifft along axis 0 then irfft along axis 1, each as real
    matmuls: ifft_N gives Re/Im via the (N,N) cos/sin bases; irfft_M
    doubles the interior columns (Hermitian redundancy weights)."""
    ny, nx = shape
    lh = nx // 2 + 1
    assert a.shape[-2:] == (ny, lh) and b.shape == a.shape
    dt = a.dtype
    cy, sy = _basis(ny, ny, dt)  # (ny_out, ny_k)
    cx, sx = _basis(nx, nx, dt)
    cx, sx = cx[:, :lh], sx[:, :lh]  # (nx_out, l)
    w = np.full(lh, 2.0)
    w[0] = 1.0
    if nx % 2 == 0:
        w[-1] = 1.0
    w = jnp.asarray(w, dt)
    re_t = (_mm(cy, a) - _mm(sy, b)) / ny  # (ny, lh)
    im_t = (_mm(sy, a) + _mm(cy, b)) / ny
    out = _mm(re_t * w, cx.T) - _mm(im_t * w, sx.T)
    return out / nx


def dft_leading(s):
    """Forward DFT over axis 0 of a real array: returns (re, im) of
    ``jnp.fft.fft(s, axis=0)``."""
    n = s.shape[0]
    c, sn = _basis(n, n, s.dtype)
    flat = s.reshape(n, -1)
    re = _mm(c, flat).reshape(s.shape)
    im = (-_mm(sn, flat)).reshape(s.shape)
    return re, im


def idft_real_leading(re, im):
    """Real part of the inverse DFT over axis 0, matching
    ``jnp.real(jnp.fft.ifft(re + 1j*im, axis=0))``."""
    n = re.shape[0]
    c, sn = _basis(n, n, re.dtype)
    rf = re.reshape(n, -1)
    if_ = im.reshape(n, -1)
    out = (_mm(c.T, rf) - _mm(sn.T, if_)) / n
    return out.reshape(re.shape)
