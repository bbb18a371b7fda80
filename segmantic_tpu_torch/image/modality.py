"""MRI/CT modality preparation: N4-style bias-field correction, CT scaling.

Port of ``segmantic_tpu/image/modality.py``, a numpy / scipy copy (host-side
prep tooling, not the training hot path; reference:
src/segmantic/image/modality.py:4-49): Otsu thresholding, median filtering
and an N4-style iterative bias-field estimator (log-domain histogram
sharpening + smooth field fit, multi-resolution). The B-spline basis cache
``_BSPLINE_BASIS_CACHE`` is this module's own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage

from ..core.volume import Volume
from ..ops.resample import resample_affine_np

__all__ = ["otsu_threshold", "otsu_mask", "fit_bspline_field", "bias_correct",
           "median_filter", "scale_clamp_ct", "unscale_ct"]


def otsu_threshold(data: np.ndarray, bins: int = 200) -> float:
    """Otsu's threshold over the intensity histogram."""
    hist, edges = np.histogram(data.ravel(), bins=bins)
    centers = (edges[:-1] + edges[1:]) / 2
    w = hist.astype(np.float64)
    total = w.sum()
    best_t, best_var = centers[0], -1.0
    cum_w = np.cumsum(w)
    cum_mean = np.cumsum(w * centers)
    mean_total = cum_mean[-1] / total
    for i in range(1, bins):
        w0 = cum_w[i - 1]
        w1 = total - w0
        if w0 == 0 or w1 == 0:
            continue
        m0 = cum_mean[i - 1] / w0
        m1 = (cum_mean[-1] - cum_mean[i - 1]) / w1
        var_between = w0 * w1 * (m0 - m1) ** 2
        if var_between > best_var:
            best_var = var_between
            best_t = centers[i]
    return float(best_t)


def otsu_mask(image: Volume, bins: int = 200) -> Volume:
    """Foreground mask via Otsu thresholding (foreground = above threshold)."""
    data = image.numpy().astype(np.float32)
    t = otsu_threshold(data, bins)
    return image.with_data((data > t).astype(np.uint8))


def _shrink(data: np.ndarray, factor: int) -> np.ndarray:
    """Subsample a channel-first array by an integer factor."""
    sl = (slice(None),) + (slice(None, None, factor),) * (data.ndim - 1)
    return np.ascontiguousarray(data[sl])


def _sharpen_histogram(
    log_data: np.ndarray,
    mask: np.ndarray,
    num_bins: int = 200,
    fwhm: float = 0.15,
    wiener_noise: float = 0.01,
) -> np.ndarray:
    """N4 core step: Wiener-deconvolve the log-intensity histogram with a
    Gaussian of given FWHM and return the expected 'sharpened' value per voxel.
    """
    vals = log_data[mask]
    lo, hi = float(vals.min()), float(vals.max())
    if hi <= lo:
        return log_data.copy()
    scale = (num_bins - 1) / (hi - lo)
    # linear-binned histogram with fractional assignment
    pos = (vals - lo) * scale
    idx = np.floor(pos).astype(np.int64)
    frac = pos - idx
    hist = np.bincount(idx, weights=1 - frac, minlength=num_bins + 1)
    hist += np.bincount(
        np.minimum(idx + 1, num_bins), weights=frac, minlength=num_bins + 1
    )
    hist = hist[:num_bins]

    # Gaussian kernel in histogram space
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0))) * scale
    n_fft = 2 * num_bins
    f_hist = np.fft.rfft(hist, n_fft)
    x = np.arange(n_fft)
    x = np.minimum(x, n_fft - x)
    g = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    g /= g.sum()
    f_g = np.fft.rfft(g, n_fft)
    # Wiener deconvolution
    f_u = f_hist * np.conj(f_g) / (np.abs(f_g) ** 2 + wiener_noise)
    u = np.maximum(np.fft.irfft(f_u, n_fft)[:num_bins], 0.0)

    # E[u | v]: smooth the sharpened distribution back and take expectation
    centers = lo + np.arange(num_bins) / scale
    num = np.fft.irfft(np.fft.rfft(u * centers, n_fft) * f_g, n_fft)[:num_bins]
    den = np.fft.irfft(np.fft.rfft(u, n_fft) * f_g, n_fft)[:num_bins]
    expected = np.where(den > 1e-12, num / np.maximum(den, 1e-12), centers)

    # map each voxel's value to expected sharpened value
    out = log_data.copy()
    pos_all = np.clip((log_data[mask] - lo) * scale, 0, num_bins - 1 - 1e-6)
    i0 = np.floor(pos_all).astype(np.int64)
    w = pos_all - i0
    out[mask] = expected[i0] * (1 - w) + expected[np.minimum(i0 + 1, num_bins - 1)] * w
    return out


def _bspline_weights(t: np.ndarray) -> np.ndarray:
    """Uniform cubic B-spline basis values for local parameter t ∈ [0,1):
    returns (4, len(t)) weights for controls i-1..i+2."""
    t2, t3 = t * t, t * t * t
    return np.stack(
        [
            (1 - 3 * t + 3 * t2 - t3) / 6.0,
            (4 - 6 * t2 + 3 * t3) / 6.0,
            (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0,
            t3 / 6.0,
        ]
    )


def _bspline_coords(n: int, g: int) -> "tuple[np.ndarray, np.ndarray]":
    """Map voxel index 0..n-1 into the control lattice of g cells
    (g+3 controls): returns (cell index, (4,n) weights)."""
    u = np.linspace(0, g - 1e-6, n)
    cell = np.floor(u).astype(np.int64)
    w = _bspline_weights(u - cell)
    return cell, w


_BSPLINE_BASIS_CACHE: dict = {}


def _bspline_basis(shape, cells: int):
    """(idx_list, w_list, n_ctrl): flattened full-grid control indices and
    weights for each of the 4^nd tensor-product basis offsets (cached)."""
    key = (tuple(shape), cells)
    if key in _BSPLINE_BASIS_CACHE:
        return _BSPLINE_BASIS_CACHE[key]
    import itertools as _it

    nd = len(shape)
    axes = [_bspline_coords(n, cells) for n in shape]
    n_ctrl_axis = [cells + 3] * nd
    n_ctrl = int(np.prod(n_ctrl_axis))

    idx_list, w_list = [], []
    for offsets in _it.product(range(4), repeat=nd):
        idx = np.zeros(shape, np.int64)
        w = np.ones(shape, np.float64)
        for a in range(nd):
            cell, wts = axes[a]
            expand = (1,) * a + (shape[a],) + (1,) * (nd - a - 1)
            idx = idx * n_ctrl_axis[a] + np.broadcast_to(
                (cell + offsets[a]).reshape(expand), shape
            )
            w = w * wts[offsets[a]].reshape(expand)
        idx_list.append(idx.reshape(-1))
        w_list.append(w.reshape(-1))
    _BSPLINE_BASIS_CACHE[key] = (idx_list, w_list, n_ctrl)
    return _BSPLINE_BASIS_CACHE[key]


def fit_bspline_field(
    residual: np.ndarray,  # (*spatial) values to fit
    mask: np.ndarray,  # (*spatial) bool
    cells: int = 4,
    reg: float = 1e-5,
) -> np.ndarray:
    """Regularized least-squares cubic B-spline fit of ``residual`` over the
    masked voxels, evaluated on the full grid (N4's field model — the
    reference delegates this to itk::N4BiasFieldCorrectionImageFilter's
    B-spline fitter; reference: src/segmantic/image/modality.py:27-31)."""
    shape = residual.shape
    idx_full, w_full, n_ctrl = _bspline_basis(shape, cells)

    flat_mask = mask.reshape(-1)
    r = residual.reshape(-1)[flat_mask]
    idx_list = [i[flat_mask] for i in idx_full]
    w_list = [w[flat_mask] for w in w_full]

    # normal equations AtWA c = AtW r via scattered adds (the matrix is
    # small — (cells+3)^nd controls — but banded-dense)
    ata = np.zeros((n_ctrl, n_ctrl), np.float64)
    atb = np.zeros(n_ctrl, np.float64)
    k = len(idx_list)
    for a in range(k):
        atb += np.bincount(idx_list[a], weights=w_list[a] * r, minlength=n_ctrl)
        np.add.at(ata, (idx_list[a], idx_list[a]), w_list[a] * w_list[a])
        for b in range(a + 1, k):
            w_ab = w_list[a] * w_list[b]
            np.add.at(ata, (idx_list[a], idx_list[b]), w_ab)
            np.add.at(ata, (idx_list[b], idx_list[a]), w_ab)

    ata[np.diag_indices_from(ata)] += reg * max(ata.max(), 1e-12)
    # lstsq tolerates the singular rows of never-touched boundary controls
    coeff = np.linalg.lstsq(ata, atb, rcond=None)[0]

    field = np.zeros(int(np.prod(shape)), np.float64)
    for idx, w in zip(idx_full, w_full):
        field += coeff[idx] * w
    return field.reshape(shape)


def bias_correct(
    input: Volume,
    mask: Optional[Volume] = None,
    shrink_factor: int = 4,
    num_fitting_levels: int = 4,
    num_iterations: int = 50,
    convergence_threshold: float = 1e-4,
    field_fit: str = "bspline",
) -> Volume:
    """N4-style MRI bias-field correction.

    Estimates a smooth multiplicative bias field on a shrunk copy
    (log-domain, iterative histogram sharpening + Gaussian-smoothed residual
    field over ``num_fitting_levels`` scales), then divides the full-
    resolution image by the upsampled field — mirroring the reference's
    shrink + GetLogBiasFieldAsImage + divide flow
    (reference: src/segmantic/image/modality.py:17-31).
    """
    full = input.numpy().astype(np.float32)
    if mask is None:
        mask_arr = (full > otsu_threshold(full)).astype(np.uint8)
    else:
        mask_arr = (mask.numpy() > 0).astype(np.uint8)

    small = _shrink(full, shrink_factor)
    small_mask = _shrink(mask_arr, shrink_factor).astype(bool)

    eps = 1e-6
    positive = small > eps
    log_small = np.where(positive, np.log(np.maximum(small, eps)), 0.0)
    m = small_mask & positive

    log_bias = np.zeros_like(log_small)
    current = log_small.copy()
    nd = small.ndim - 1
    base_sigma = max(max(small.shape[1:]) / 8.0, 2.0)

    for level in range(num_fitting_levels):
        sigma = base_sigma / (2**level)
        cells = 2 ** (level + 1)  # N4-style: control resolution doubles/level
        # ITK N4 runs num_iterations PER fitting level
        for _ in range(max(num_iterations, 1)):
            sharpened = _sharpen_histogram(current, m)
            residual = np.where(m, current - sharpened, 0.0)
            smooth_r = np.empty_like(residual)
            for c in range(residual.shape[0]):
                if field_fit == "bspline":
                    smooth_r[c] = fit_bspline_field(
                        residual[c].astype(np.float64), m[c], cells=cells
                    )
                else:  # normalized Gaussian smoothing within the mask
                    weight = m[c].astype(np.float32)
                    num_s = ndimage.gaussian_filter(residual[c] * weight, sigma)
                    den_s = ndimage.gaussian_filter(weight, sigma)
                    smooth_r[c] = np.where(
                        den_s > 1e-6, num_s / np.maximum(den_s, 1e-6), 0
                    )
            log_bias = log_bias + smooth_r
            new = log_small - log_bias
            change = float(np.abs(new - current)[m].std()) if m.any() else 0.0
            current = new
            if change < convergence_threshold:
                break

    # upsample log bias field to full resolution via the shared resampler
    scale = np.eye(nd, nd + 1)
    for a in range(nd):
        scale[a, a] = (small.shape[1 + a] - 1) / max(full.shape[1 + a] - 1, 1)
    log_bias_full = resample_affine_np(log_bias, scale, full.shape[1:], order=1)

    corrected = full / np.exp(log_bias_full).astype(np.float32)
    return input.with_data(corrected)


def median_filter(image: Volume, radius: int = 1) -> Volume:
    data = image.numpy()
    size = (1,) + (2 * radius + 1,) * (data.ndim - 1)
    return image.with_data(ndimage.median_filter(data, size=size))


def scale_clamp_ct(img: Volume) -> Volume:
    """Prepare CT: median filter → clamp [-1100, 3100] → scale to [0, 255]."""
    out = median_filter(img, radius=1)
    data = np.clip(out.numpy().astype(np.float32), -1100.0, 3100.0)
    data = (data + 1100.0) * (255.0 / (1100.0 + 3100.0))
    return out.with_data(data)


def unscale_ct(img: Volume) -> Volume:
    """Invert :func:`scale_clamp_ct` (except the clamping)."""
    data = img.numpy().astype(np.float32) * ((1100.0 + 3100.0) / 255.0) - 1100.0
    return img.with_data(data)
