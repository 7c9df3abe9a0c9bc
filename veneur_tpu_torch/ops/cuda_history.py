"""Masked HLL window-merge kernel (kernel K3) and its plain PyTorch version.

`merge_windows_packed(rows, sel, precision=p, idx=None)` takes rows
i32[R, W, nw] of 6-bit packed HLL rows (one per ring row and ring
column) and selection masks sel f32[S, W], and returns i32[N, S, nw]:
per picked row and step, the packed register max over the columns with
sel > 0. A step that selects nothing gives zero words. With `idx`
(int32[N]) row n of the result merges rows[idx[n]], the index clamped
into [0, R) as the range program's `_take` clamps, so the ring is read
in place; without it N = R. It replaces the Pallas kernel
veneur_tpu/ops/pallas_history.py merge_windows_packed; the CUDA source is
csrc/merge_windows.cu.

For a CPU tensor the wrapper runs `merge_windows_packed_plain`; for a
CUDA tensor it launches the kernel or raises. `launches` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.ops import hll as hll_ops

launches = 0


def merge_windows_packed_plain(rows, sel, *, precision: int,
                               idx=None) -> torch.Tensor:
    """The kernel's function in plain torch: the clamped row gather, then
    the loop over the column axis of the JAX package's XLA chain
    (history/merge.py _merge_windows_xla) with an int32 register
    accumulator [N, S, R]. Each column updates only the steps that
    select it, and a column no step selects is not read; the register max
    makes both identical to visiting every column under the mask."""
    if idx is not None:
        rows = rows[torch.clamp(idx.long(), 0, rows.shape[0] - 1)]
    n, w, _nw = rows.shape
    s = sel.shape[0]
    acc = torch.zeros((n, s, hll_ops.num_registers(precision)),
                      dtype=torch.int32, device=rows.device)
    picked = (sel > 0.0).cpu().numpy()
    for i in range(w):
        steps = np.nonzero(picked[:, i])[0]
        if steps.size == 0:
            continue
        regs = hll_ops.unpack_registers(rows[:, i], precision=precision)
        at = torch.from_numpy(steps).to(rows.device)
        acc[:, at] = torch.maximum(acc[:, at],
                                   regs.to(torch.int32)[:, None, :])
    return hll_ops.pack_registers(acc.to(torch.uint8), precision=precision)


def merge_windows_packed(rows, sel, *, precision: int,
                         idx=None) -> torch.Tensor:
    """i32[R, W, nw] packed rows, f32[S, W] masks, optional i32[N] row
    index -> i32[N, S, nw] (N = R without an index)."""
    global launches
    if rows.device.type == "cpu":
        return merge_windows_packed_plain(rows, sel, precision=precision,
                                          idx=idx)
    if rows.device.type != "cuda":
        raise ValueError(f"no window-merge kernel for device {rows.device}")
    if rows.dim() != 3 or sel.dim() != 2:
        raise ValueError(f"want rows [R, W, nw] and sel [S, W], got "
                         f"{list(rows.shape)} and {list(sel.shape)}")
    r, w, nw = rows.shape
    s = sel.shape[0]
    if rows.dtype != torch.int32 or sel.dtype != torch.float32:
        raise ValueError(f"want int32 rows and float32 sel, got "
                         f"{rows.dtype} and {sel.dtype}")
    if sel.shape[1] != w or nw != hll_ops.packed_words(precision):
        raise ValueError(f"sel {list(sel.shape)} / rows {list(rows.shape)} "
                         f"do not match W={w}, p={precision}")
    tensors = [("rows", rows), ("sel", sel)]
    n = r
    if idx is not None:
        if idx.dim() != 1 or idx.dtype != torch.int32:
            raise ValueError(f"idx: want int32[N], got "
                             f"{idx.dtype}{list(idx.shape)}")
        if r == 0 and idx.numel():
            raise ValueError("idx picks rows of an empty ring")
        tensors.append(("idx", idx))
        n = idx.shape[0]
    for name, t in tensors:
        if t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {rows.device}")
    out = torch.empty((n, s, nw), dtype=torch.int32, device=rows.device)
    if n == 0 or s == 0:
        return out
    from veneur_tpu_torch.ops import _build
    lib = _build.load()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = lib.vt_merge_windows(rows.data_ptr(),
                              None if idx is None else idx.data_ptr(),
                              sel.data_ptr(), out.data_ptr(), r, n, w, nw,
                              s, precision, stream)
    _build.check(rc, "merge_windows launch")
    launches += 1
    return out
