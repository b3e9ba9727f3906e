"""ECC image alignment (camera-motion compensation) on the card (port of
``busca_tpu.ops.ecc``).

The reference calls OpenCV's ``findTransformECC`` on full-resolution
grayscale frame pairs every frame with 100 Gauss-Newton iterations
(byte_tracker.py:626-650), a serial host cost in the frame loop.  busca_tpu
adds a device form: the ECC maximization of Evangelidis & Psarakis (2008)
for Euclidean motion as a loop of bilinear warps (gathers), image
gradients and 3x3 solves.  Here it is plain torch on the tensors' device
(:func:`estimate_cmc` puts host frames on the card unless asked for the
CPU): no iteration reads a value back to the host, the 3x3 systems are
solved in closed form (float64 adjugate; ``torch.linalg.solve`` checks its
``info`` and synchronizes), and the loop runs a fixed ``num_iterations``
(50 by default) with no early exit, as busca_tpu's ``fori_loop``.  Its
zero padding outside the image, ``jnp.gradient``'s edge rule and the 1e-6
ridge are busca_tpu's.

``busca_tpu_torch.trackers.cmc`` keeps cv2 as the default backend; this is
its ``backend="device"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rgb_to_gray(frame: torch.Tensor, bgr: bool = True) -> torch.Tensor:
    """ITU-R BT.601 luma (what cv2.cvtColor uses), float32 ``[H, W]``."""
    f = frame.to(torch.float32)
    if bgr:
        b, g, r = f[..., 0], f[..., 1], f[..., 2]
    else:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _gradient(img: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along ``dim`` at unit spacing: central differences
    inside, one-sided ones at the two edges."""
    n = img.shape[dim]
    inner = (img.narrow(dim, 2, n - 2) - img.narrow(dim, 0, n - 2)) * 0.5
    first = img.narrow(dim, 1, 1) - img.narrow(dim, 0, 1)
    last = img.narrow(dim, n - 1, 1) - img.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return xs.to(torch.float32), ys.to(torch.float32)


def _warp_bilinear(imgs: torch.Tensor, warp: torch.Tensor, xs: torch.Tensor,
                   ys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample every image of ``imgs`` ``[K, H, W]`` at ``warp @ (x, y, 1)``
    for each output pixel (``xs``/``ys`` its coordinates), zero outside.
    Returns (warped ``[K, H, W]``, the mask where all four taps lie
    inside)."""
    k, h, w = imgs.shape
    sx = warp[0, 0] * xs + warp[0, 1] * ys + warp[0, 2]
    sy = warp[1, 0] * xs + warp[1, 1] * ys + warp[1, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = imgs.reshape(k, h * w)
    out = None
    valid = None
    for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0i + dy, x0i + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)
        v = flat[:, idx].reshape(k, h, w)
        v = torch.where(inside, v, torch.zeros((), device=v.device))
        term = v * wt
        out = term if out is None else out + term
        valid = inside if valid is None else valid & inside
    return out, valid


def _solve3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 b`` for a 3x3 ``a`` by its adjugate, in float64 on the
    device: no pivoting (``a`` is a Gram matrix plus a ridge), no host
    sync."""
    a = a.to(torch.float64)
    c00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
    c01 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
    c02 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
    c10 = a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]
    c11 = a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]
    c12 = a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]
    c20 = a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]
    c21 = a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]
    c22 = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    adj = torch.stack([torch.stack([c00, c10, c20]),
                       torch.stack([c01, c11, c21]),
                       torch.stack([c02, c12, c22])])
    det = a[0, 0] * c00 + a[0, 1] * c01 + a[0, 2] * c02
    return ((adj @ b.to(torch.float64)) / det).to(torch.float32)


def _params_to_warp(p: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(p[0]), torch.sin(p[0])
    return torch.stack([torch.stack([c, -s, p[1]]),
                        torch.stack([s, c, p[2]])])


def ecc_euclidean(template: torch.Tensor, image: torch.Tensor,
                  num_iterations: int = 50
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate the Euclidean warp aligning ``image`` to ``template``
    (``[H, W]`` grayscale, on one device), busca_tpu's ``ecc_euclidean``.
    Returns (the correlation coefficient, the warp ``[2, 3]``), device
    tensors: sampling ``image`` at ``warp @ (x, y, 1)`` matches the
    template, cv2.findTransformECC's convention."""
    template = template.to(torch.float32)
    image = image.to(torch.float32)
    dev = image.device
    h, w = template.shape
    # the image and its gradients warp together: one gather per tap
    stack = torch.stack([image, _gradient(image, 1), _gradient(image, 0)])
    xs, ys = _grid(h, w, dev)
    xf, yf = xs.reshape(-1), ys.reshape(-1)
    tf = template.reshape(-1)
    ridge = 1e-6 * torch.eye(3, device=dev)
    p = torch.zeros(3, device=dev)
    rho = torch.zeros((), device=dev)
    for _ in range(int(num_iterations)):
        warp = _params_to_warp(p)
        warped, valid = _warp_bilinear(stack, warp, xs, ys)
        iwf, gx, gy = warped.reshape(3, -1)
        vm = valid.reshape(-1).to(torch.float32)
        n_valid = torch.clamp(vm.sum(), min=1.0)
        # zero-mean over the valid region
        t0 = (tf - (tf * vm).sum() / n_valid) * vm
        i0 = (iwf - (iwf * vm).sum() / n_valid) * vm
        # the warp's Jacobian in (theta, tx, ty)
        c, s = torch.cos(p[0]), torch.sin(p[0])
        dsx_dt = -s * xf - c * yf
        dsy_dt = c * xf - s * yf
        g = torch.stack([(gx * dsx_dt + gy * dsy_dt) * vm, gx * vm,
                         gy * vm], dim=1)  # [N, 3]
        hmat = g.t() @ g + ridge
        g_i = g.t() @ i0
        g_t = g.t() @ t0
        hinv_gi = _solve3(hmat, g_i)
        norm_i2 = i0 @ i0
        tc = t0 @ i0
        num = norm_i2 - g_i @ hinv_gi
        den = tc - g_t @ hinv_gi
        lam = num / torch.where(den.abs() > 1e-12, den,
                                torch.full((), 1e-12, device=dev))
        err = lam * t0 - i0
        p = p + _solve3(hmat, g.t() @ err)
        norm_t = torch.sqrt(t0 @ t0) + 1e-12
        norm_i = torch.sqrt(norm_i2) + 1e-12
        rho = tc / (norm_t * norm_i)
    return rho, _params_to_warp(p)


def _gray(frame, bgr: bool, device: torch.device) -> torch.Tensor:
    t = frame if torch.is_tensor(frame) else torch.from_numpy(
        np.ascontiguousarray(frame))
    return rgb_to_gray(t.to(device), bgr)


def estimate_cmc(prev_frame, cur_frame, num_iterations: int = 50,
                 bgr: bool = True, device="cuda"):
    """Frame-to-frame CMC warp on ``device`` (the card unless the caller
    asks for ``"cpu"``; raises without CUDA), in
    ``trackers.cmc.ecc_align``'s calling convention: host or device frames
    in, ``(cc, 2x3 numpy warp)`` out; reading them is the one sync."""
    from busca_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rho, warp = ecc_euclidean(_gray(prev_frame, bgr, dev),
                              _gray(cur_frame, bgr, dev), num_iterations)
    return float(rho), warp.cpu().numpy().astype(np.float32)
