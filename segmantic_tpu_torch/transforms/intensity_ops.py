"""Intensity-augmentation math on device tensors.

Port of ``segmantic_tpu/transforms/intensity_ops.py``. The JAX functions take
one channel-first sample and are ``vmap``-ped over the batch; here the batch
axis is written out: every op but :func:`flip` takes ``(S, C, *spatial)`` with
one parameter set per sample (leading axis ``S``) and applies sample ``i``'s
parameters to sample ``i``; :func:`zscore` takes one channel-first sample, as
the JAX function does. All take explicit parameters (no random numbers
inside), compute in f32 (f64 for f64 input) and return the input's dtype.
Statistics "of the sample" (min, max, the k-space maximum) run over all
channels and voxels of one sample, as in the JAX code.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..ops.fused_conv import at_least_f32

__all__ = [
    "flip", "adjust_contrast", "histogram_shift", "random_control_points",
    "polynomial_bias_field", "num_bias_coeff", "bias_field", "gibbs_noise",
    "kspace_spike", "zscore",
]


def flip(x: torch.Tensor, do_flip: Sequence[bool]) -> torch.Tensor:
    """Flip spatial axis ``a`` of a channel-first (C, *spatial) tensor where
    ``do_flip[a]`` is true."""
    dims = [a + 1 for a in range(x.ndim - 1) if bool(do_flip[a])]
    return x.flip(dims) if dims else x


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _per_sample(v, x: torch.Tensor) -> torch.Tensor:
    """Parameter ``v`` (S,) or (S, K) as a tensor of x's compute dtype on x's
    device, with singleton axes appended so that ``v`` or ``v[:, i]``
    broadcasts over (S, C, *spatial)."""
    v = torch.as_tensor(v, device=x.device).to(_compute_dtype(x))
    return v.reshape(v.shape + (1,) * (x.ndim - 1))


def _sample_min_max(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dims = tuple(range(1, x.ndim))
    return x.amin(dims, keepdim=True), x.amax(dims, keepdim=True)


def adjust_contrast(x: torch.Tensor, gamma) -> torch.Tensor:
    """Gamma contrast: normalize each sample to [0, 1], apply ``** gamma``
    (per sample, (S,)), map back."""
    xf = at_least_f32(x)
    mn, mx = _sample_min_max(xf)
    eps = 1e-7
    rng = (mx - mn).clamp_min(eps)
    xn = ((xf - mn) / rng).clamp_min(eps)
    return (torch.pow(xn, _per_sample(gamma, x)) * rng + mn).to(x.dtype)


def random_control_points(noise, mn: torch.Tensor, mx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Histogram-shift control points from ``noise`` (S, K), drawn by the
    caller uniformly in +-0.45 of the spacing ``1 / (K - 1)``: evenly spaced
    sources, destinations jittered within their neighbours' bounds, ends
    pinned; both scaled to each sample's range ``mn`` .. ``mx`` ((S,))."""
    noise = torch.as_tensor(noise, dtype=mn.dtype, device=mn.device).clone()
    noise[:, 0] = 0.0
    noise[:, -1] = 0.0
    src = torch.linspace(0.0, 1.0, noise.shape[1], dtype=mn.dtype, device=mn.device)
    dst = torch.sort(src[None] + noise, dim=1).values
    scale = (mx - mn)[:, None]
    return src[None] * scale + mn[:, None], dst * scale + mn[:, None]


def histogram_shift(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear intensity remap through control points ``src`` ->
    ``dst`` (each (S, K), monotone, in the sample's range), as a sum of
    clamped linear segments; the result keeps the sample's range."""
    xf = at_least_f32(x)
    mn, mx = _sample_min_max(xf)
    src, dst = _per_sample(src, x), _per_sample(dst, x)  # (S, K, 1, ...)
    deltas = (src[:, 1:] - src[:, :-1]).clamp_min(1e-12)
    slopes = (dst[:, 1:] - dst[:, :-1]) / deltas
    out = dst[:, 0].expand_as(xf).clone()
    for i in range(src.shape[1] - 1):
        out += slopes[:, i] * torch.minimum((xf - src[:, i]).clamp_min(0.0), deltas[:, i])
    return torch.minimum(torch.maximum(out, mn), mx).to(x.dtype)


def _bias_exponents(nd: int, degree: int):
    if nd == 3:
        return [(i, j, k) for i in range(degree + 1) for j in range(degree + 1 - i)
                for k in range(degree + 1 - i - j)]
    return [(i, j) for i in range(degree + 1) for j in range(degree + 1 - i)]


def num_bias_coeff(nd: int, degree: int = 3) -> int:
    return len(_bias_exponents(nd, degree))


def polynomial_bias_field(shape: Sequence[int], coeff: torch.Tensor,
                          degree: int = 3) -> torch.Tensor:
    """exp(polynomial) multiplicative bias fields (S, *shape) over normalized
    coordinates [-1, 1]; ``coeff`` (S, n), f32 or f64, has one entry per monomial of total
    degree <= ``degree``, in the JAX package's order. The polynomial is
    evaluated separably (powers per axis, one small contraction), not through
    a stacked basis of n full volumes."""
    nd = len(shape)
    exps = _bias_exponents(nd, degree)
    if coeff.shape[1:] != (len(exps),):
        raise ValueError(f"need {len(exps)} bias coefficients per sample, got "
                         f"{tuple(coeff.shape)}")
    cube = coeff.new_zeros((coeff.shape[0],) + (degree + 1,) * nd)
    for t, e in enumerate(exps):
        cube[(slice(None),) + e] = coeff[:, t]
    powers = [
        torch.linspace(-1.0, 1.0, s, dtype=coeff.dtype, device=coeff.device)[None, :]
        ** torch.arange(degree + 1, dtype=coeff.dtype, device=coeff.device)[:, None]
        for s in shape
    ]  # (degree + 1, s) per axis
    spec = "sijk,ia,jb,kc->sabc" if nd == 3 else "sij,ia,jb->sab"
    return torch.exp(torch.einsum(spec, cube, *powers))


def bias_field(x: torch.Tensor, coeff, degree: int = 3) -> torch.Tensor:
    coeff = torch.as_tensor(coeff, device=x.device).to(_compute_dtype(x))
    field = polynomial_bias_field(x.shape[2:], coeff, degree)
    return x * field[:, None].to(x.dtype)


def gibbs_noise(x: torch.Tensor, alpha) -> torch.Tensor:
    """Gibbs ringing: hard low-pass in k-space, keeping a centered box of
    half-width ``1 - alpha`` (normalized, per sample (S,)); ``alpha = 0`` is
    the identity.

    The JAX package applies the same projection as per-axis circulant
    matrices (its matrix unit's fast path); here it is an FFT round trip with
    the same per-axis box mask in unshifted-frequency order, whose real part
    is taken (the box about (s - 1) / 2 is asymmetric on even axes)."""
    xf = at_least_f32(x)
    dims = tuple(range(2, x.ndim))
    spec = torch.fft.fftn(xf, dim=dims)
    radius = (1.0 - torch.as_tensor(alpha, dtype=xf.dtype, device=x.device)).clamp_min(1e-3)
    for a, s in enumerate(x.shape[2:]):
        c = (s - 1) / 2.0
        coord = (torch.arange(s, dtype=xf.dtype, device=x.device) - c).abs() / max(c, 1.0)
        coord = torch.fft.ifftshift(coord)
        mask = (coord[None, :] <= radius[:, None]).to(xf.dtype)  # (S, s)
        spec = spec * mask.reshape((mask.shape[0], 1) + (1,) * a + (s,)
                                   + (1,) * (len(dims) - a - 1))
    return torch.fft.ifftn(spec, dim=dims).real.to(x.dtype)


def kspace_spike(x: torch.Tensor, loc_frac, intensity_factor) -> torch.Tensor:
    """Herringbone artifact: set one k-space sample (``loc_frac`` (S, nd) in
    [0, 1), away from DC) to ``exp(intensity_factor * log max|K|)``
    (``intensity_factor`` (S,)).

    By linearity, setting one k-sample to v and inverting equals adding
    ``(v - K[idx])`` times that sample's complex exponential in image space,
    so only the forward half-spectrum is needed, for the log-max."""
    nd = x.ndim - 2
    dims = tuple(range(2, x.ndim))
    xf = at_least_f32(x)
    k_half = torch.fft.rfftn(xf, dim=dims)
    log_max = torch.log(k_half.abs().amax(tuple(range(1, x.ndim)), keepdim=True) + 1e-12)
    spike_val = torch.exp(log_max * _per_sample(intensity_factor, x))

    loc = torch.as_tensor(loc_frac, dtype=torch.float32, device=x.device)
    phase = xf.new_zeros((x.shape[0], 1) + (1,) * nd)
    for a in range(nd):
        n = x.shape[2 + a]
        idx = ((loc[:, a] * n).to(torch.int64).clamp(0, n - 1) - n // 2) % n  # (S,)
        # idx * r mod n in integers before the float multiply: angles stay in [0, 2 pi)
        k = (idx[:, None] * torch.arange(n, device=x.device)[None, :]) % n
        v = (2.0 * math.pi / n) * k.to(xf.dtype)
        phase = phase + v.reshape((x.shape[0], 1) + (1,) * a + (n,) + (1,) * (nd - a - 1))
    cosp, sinp = torch.cos(phase), torch.sin(phase)
    # the per-channel forward DFT sample K[idx] = sum_r x e^{-i phase}
    k_re = (xf * cosp).sum(dims, keepdim=True)
    k_im = -(xf * sinp).sum(dims, keepdim=True)
    d_re, d_im = spike_val - k_re, -k_im
    nprod = float(math.prod(x.shape[2:]))
    return (xf + (d_re * cosp - d_im * sinp) / nprod).to(x.dtype)


def zscore(x: torch.Tensor, channel_wise: bool = True, nonzero: bool = False) -> torch.Tensor:
    """Z-score of one channel-first sample (C, *spatial): per channel or over
    the whole sample, over all voxels or the nonzero ones only (the zeros then
    stay zero). Population variance; the deviation is clamped at 1e-7."""
    dims = tuple(range(1, x.ndim)) if channel_wise else tuple(range(x.ndim))
    if nonzero:
        mask = (x != 0).to(x.dtype)
        count = mask.sum(dims, keepdim=True).clamp_min(1.0)
        mean = (x * mask).sum(dims, keepdim=True) / count
        var = (((x - mean) * mask) ** 2).sum(dims, keepdim=True) / count
        return torch.where(mask > 0, (x - mean) / var.sqrt().clamp_min(1e-7), x)
    mean = x.mean(dims, keepdim=True)
    std = x.std(dims, correction=0, keepdim=True)
    return (x - mean) / std.clamp_min(1e-7)
