"""Digest quantile kernel (kernel K2) and its plain PyTorch version.

`quantiles_rows(mean, weight, mn, mx, qs)` computes, for every digest
row, the quantiles qs by midpoint interpolation: live cells sorted by
mean, inclusive prefix sum of the weights, interpolation between
centroid-mass midpoints with min/max endpoints. It replaces the Pallas
kernel veneur_tpu/ops/pallas_digest.py quantiles_rows; the CUDA source is
csrc/digest_quantiles.cu.

The kernel gives each row one warp that sorts only the row's live cells
(the design is in the note atop the CUDA source). Rows of up to
`SMEM_CELLS` cells stage in shared memory; wider rows go to a second
kernel that stages each warp's row in a slab of global scratch the
wrapper allocates. For a CPU tensor the wrapper runs
`quantiles_rows_plain`; for a CUDA tensor it launches one of the two
kernels, once a call, or raises. `launches` counts launches of the
shared-memory kernel, `wide_launches` those of the wide-row kernel, and
nothing else.
"""

from __future__ import annotations

import math

import torch

launches = 0
wide_launches = 0

SMEM_CELLS = 2048    # widest row a warp stages in shared memory (24 KB)
MAX_CELLS = 1 << 30  # the kernels' key slots and cell ranks are 32-bit


def quantiles_rows_plain(mean, weight, mn, mx, qs) -> torch.Tensor:
    """The kernel's function in plain torch: mean/weight f32[R, C],
    mn/mx f32[R], qs f32[Q] -> f32[R, Q]."""
    live = weight > 0
    skey, order = torch.sort(torch.where(live, mean, math.inf), dim=-1,
                             stable=True)
    sw = torch.where(live, weight, 0.0).gather(-1, order)
    cum = torch.cumsum(sw, dim=-1)
    tot = cum[..., -1:]
    occ = sw > 0
    xs = torch.where(occ, cum - 0.5 * sw, tot)
    ys = torch.where(occ, skey, mx[:, None])
    t = qs[None, :] * tot                                   # [R, Q]
    c = xs.shape[-1]
    k = torch.searchsorted(xs.contiguous(), t.contiguous(), right=True)
    kc = torch.clamp(k, 1, c)
    x0 = torch.where(k == 0, 0.0, xs.gather(-1, kc - 1))
    y0 = torch.where(k == 0, mn[:, None], ys.gather(-1, kc - 1))
    x1 = torch.where(k == c, tot, xs.gather(-1, torch.clamp(k, max=c - 1)))
    y1 = torch.where(k == c, mx[:, None],
                     ys.gather(-1, torch.clamp(k, max=c - 1)))
    slope = (y1 - y0) / torch.clamp(x1 - x0, min=1e-30)
    v = y0 + (t - x0) * slope
    v = torch.where(t < tot, v, mx[:, None])
    return torch.where(tot > 0, v, math.nan)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype}{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


def quantiles_rows(mean, weight, mn, mx, qs) -> torch.Tensor:
    """f32[R, C] means/weights, f32[R] min/max, f32[Q] qs -> f32[R, Q]."""
    global launches, wide_launches
    if mean.device.type == "cpu":
        return quantiles_rows_plain(mean, weight, mn, mx, qs)
    if mean.device.type != "cuda":
        raise ValueError(f"no digest kernel for device {mean.device}")
    r, c = mean.shape
    q = qs.shape[0]
    f32, dev = torch.float32, mean.device
    for name, t, shape in (("mean", mean, (r, c)), ("weight", weight, (r, c)),
                           ("mn", mn, (r,)), ("mx", mx, (r,)),
                           ("qs", qs, (q,))):
        _check(name, t, f32, shape, dev)
    if not 0 < c <= MAX_CELLS:
        raise ValueError(f"digest rows of {c} cells: the kernels index "
                         f"cells with 32-bit ints and take 1...{MAX_CELLS}")
    out = torch.empty((r, q), dtype=f32, device=dev)
    if r == 0 or q == 0:
        return out
    from veneur_tpu_torch.ops import _build
    lib = _build.load()
    scratch = None
    if c > SMEM_CELLS:
        scratch = torch.empty(lib.vt_digest_quantiles_scratch(r, c),
                              dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.vt_digest_quantiles(
        mean.data_ptr(), weight.data_ptr(), mn.data_ptr(), mx.data_ptr(),
        qs.data_ptr(), out.data_ptr(), r, c, q,
        None if scratch is None else scratch.data_ptr(), stream)
    _build.check(rc, "digest_quantiles launch")
    if scratch is None:
        launches += 1
    else:
        wide_launches += 1
    return out
