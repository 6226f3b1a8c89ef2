"""Whole-trace kernel K3: CUDA wrapper and its plain PyTorch version
(counterpart of nefii_tpu/ops/pallas/fused_trace.py).

`build_fused_sphere_trace(network, tracer)` returns
fn(cam [N,3], dirs [N,3], mask_intersect [N], near [N], far [N]) ->
(acc_start, acc_end, unfinished_start, min_dis, max_dis, n_evals): the
contract of RayTracer._sphere_trace. For a CUDA tensor it launches
`sphere_trace_kernel` (`csrc/fused_trace.cu`), one launch for the whole
trace; for a CPU tensor it runs `fused_sphere_trace_plain`.

Both cut the rays into tiles of `tile` rays (the kernel: RAYS_PER_BLOCK)
and give a tile the kernel's semantics: a tile runs another trace iteration
only while one of its rays is unfinished, and another line-search step only
while one of its rays has a negative sdf; every evaluation of a tile counts
its 2 * tile start and end points in `n_evals`. Per-ray results do not
depend on the tiling (converged rays are frozen by their masks), the count
does. fp32 only, as the TPU kernel. Each wrapper launch adds one to
`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from nefii_tpu_torch.ops.kernels.fused_mlp import (
    KERNEL_WIDTH, FusedWeights, embed_padded, fused_hidden_plain, network_weights,
)

# launches of the CUDA kernel; the wrapper adds one where it launches, nowhere else
LAUNCHES: Dict[str, int] = {"fused_sphere_trace": 0}

RAYS_PER_BLOCK = 16   # rays per block tile of the CUDA kernel (TR in csrc/fused_trace.cu)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sdf_plain(pts: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    h = fused_hidden_plain(embed_padded(pts, fw), fw)
    return h @ fw.wlast_col.to(h.device) + fw.b_last[0].to(h.device)


def fused_sphere_trace_plain(cam, dirs, mask_intersect, near, far, fw: FusedWeights, tracer,
                             tile: int = RAYS_PER_BLOCK):
    """K3 in plain PyTorch: -> (acc_start, acc_end, unfinished_start, n_evals).

    Dense over the rays, with the SDF evaluated only on the tiles that the
    kernel would evaluate, and counted as the kernel counts."""
    N = cam.shape[0]
    T = tile
    n_pad = -(-max(N, T) // T) * T
    n_tiles = n_pad // T

    def pad(x, value=0):
        return torch.cat([x, x.new_full((n_pad - N,) + x.shape[1:], value)])

    cam, dirs, near, far = pad(cam.float()), pad(dirs.float()), pad(near.float()), pad(far.float())
    m = pad(mask_intersect.bool(), False)
    zero = torch.zeros_like(near)
    thresh = tracer.sdf_threshold

    def tiles_of(mask):
        return mask.view(n_tiles, T).any(1)

    def sdf_at(acc_s, acc_e, m_s, m_e, tiles):
        """Masked sdf at the start and end points of the rays of `tiles`."""
        idx = (tiles.nonzero()[:, 0, None] * T
               + torch.arange(T, device=cam.device)).reshape(-1)
        pts = torch.cat([cam[idx] + acc_s[idx, None] * dirs[idx],
                         cam[idx] + acc_e[idx, None] * dirs[idx]])
        sd = _sdf_plain(pts, fw) if idx.numel() else pts[:, 0]
        sd_s, sd_e = zero.clone(), zero.clone()
        sd_s[idx] = sd[:idx.numel()]
        sd_e[idx] = sd[idx.numel():]
        return (torch.where(m_s, sd_s, zero), torch.where(m_e, sd_e, zero),
                2 * T * int(tiles.sum()))

    def head(unf_s, unf_e, next_s, next_e):
        curr_s = torch.where(unf_s, next_s, zero)
        curr_s = torch.where(curr_s <= thresh, zero, curr_s)
        curr_e = torch.where(unf_e, next_e, zero)
        curr_e = torch.where(curr_e <= thresh, zero, curr_e)
        return curr_s, curr_e, unf_s & (curr_s > thresh), unf_e & (curr_e > thresh)

    acc_s = torch.where(m, near, zero)
    acc_e = torch.where(m, far, zero)
    all_tiles = torch.ones(n_tiles, dtype=torch.bool, device=cam.device)
    next_s, next_e, n_ev = sdf_at(acc_s, acc_e, m, m, all_tiles)
    curr_s, curr_e, unf_s, unf_e = head(m, m, next_s, next_e)
    for _ in range(tracer.sphere_tracing_iters):
        live = tiles_of(unf_s | unf_e)
        if not bool(live.any()):
            break
        acc_s = acc_s + curr_s
        acc_e = acc_e - curr_e
        next_s, next_e, k = sdf_at(acc_s, acc_e, unf_s, unf_e, live)
        n_ev += k
        for j in range(tracer.line_step_iters):
            np_s, np_e = next_s < 0, next_e < 0
            neg = tiles_of(np_s | np_e)
            if not bool(neg.any()):
                break
            factor = (1.0 - tracer.line_search_step) * 2.0 ** (-j)
            acc_s = torch.where(np_s, acc_s - factor * curr_s, acc_s)
            acc_e = torch.where(np_e, acc_e + factor * curr_e, acc_e)
            sd_s, sd_e, k = sdf_at(acc_s, acc_e, np_s, np_e, neg)
            n_ev += k
            next_s = torch.where(np_s, sd_s, next_s)
            next_e = torch.where(np_e, sd_e, next_e)
        not_crossed = acc_s < acc_e
        curr_s, curr_e, unf_s, unf_e = head(unf_s & not_crossed, unf_e & not_crossed,
                                            next_s, next_e)
    return acc_s[:N], acc_e[:N], unf_s[:N], n_ev


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    from nefii_tpu_torch.ops.kernels import build

    lib = build.load("fused_trace")
    if not getattr(lib, "_nefii_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nefii_sphere_trace.argtypes = [
            vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong), i, i, vp, f, f, f,
            i, i, i, vp, vp, vp, vp, ctypes.c_longlong, vp]
        lib.nefii_sphere_trace.restype = i
        lib.nefii_trace_error_string.argtypes = [i]
        lib.nefii_trace_error_string.restype = ctypes.c_char_p
        lib.nefii_fused_trace_config.argtypes = [ctypes.POINTER(i)] * 3
        width, rays, threads = i(), i(), i()
        lib.nefii_fused_trace_config(ctypes.byref(width), ctypes.byref(rays), ctypes.byref(threads))
        if (width.value, rays.value) != (KERNEL_WIDTH, RAYS_PER_BLOCK):
            raise RuntimeError(f"fused_trace library takes width {width.value}, {rays.value} rays "
                               f"a block; the wrapper expects {KERNEL_WIDTH}, {RAYS_PER_BLOCK}")
        lib._nefii_typed = True
    return lib


def fused_sphere_trace(cam, dirs, mask_intersect, near, far, fw: FusedWeights, tracer):
    """K3: -> (acc_start, acc_end, unfinished_start, n_evals). CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if cam.device.type == "cpu":
        return fused_sphere_trace_plain(cam, dirs, mask_intersect, near, far, fw, tracer)
    if cam.device.type != "cuda":
        raise ValueError(f"fused_sphere_trace: tensors on {cam.device} are not supported")
    if fw.dtype != torch.float32:
        raise ValueError("fused_sphere_trace: the whole-trace kernel is fp32 only")
    if fw.width != KERNEL_WIDTH:
        raise ValueError(f"fused_sphere_trace: the CUDA kernel takes hidden width {KERNEL_WIDTH}, "
                         f"this network has {fw.width}")
    if fw.buf.device != cam.device:
        raise ValueError(f"fused_sphere_trace: weights on {fw.buf.device}, rays on {cam.device}")
    n = cam.shape[0]
    if cam.shape != (n, 3) or dirs.shape != (n, 3) or any(
            t.shape != (n,) for t in (mask_intersect, near, far)):
        raise ValueError("fused_sphere_trace: cam, dirs must be [N,3] and mask, near, far [N]")
    for name, t in (("cam", cam), ("dirs", dirs), ("near", near), ("far", far)):
        if t.dtype != torch.float32 or t.device != cam.device:
            raise ValueError(f"fused_sphere_trace: {name} must be float32 on {cam.device}")
    if mask_intersect.dtype != torch.bool or mask_intersect.device != cam.device:
        raise ValueError("fused_sphere_trace: mask_intersect must be bool on the same device")
    cam, dirs, mask_intersect, near, far = (t.contiguous() for t in
                                            (cam, dirs, mask_intersect, near, far))
    acc_s = torch.empty(n, dtype=torch.float32, device=cam.device)
    acc_e = torch.empty_like(acc_s)
    unf = torch.empty(n, dtype=torch.bool, device=cam.device)
    if n == 0:
        return acc_s, acc_e, unf, 0
    counter = torch.zeros(1, dtype=torch.int64, device=cam.device)
    wlast = fw.wlast_col.to(cam.device).contiguous()
    lib = _lib()
    desc = (ctypes.c_longlong * len(fw.desc))(*fw.desc)
    err = lib.nefii_sphere_trace(
        cam.data_ptr(), dirs.data_ptr(), mask_intersect.data_ptr(), near.data_ptr(),
        far.data_ptr(), fw.buf.data_ptr(), desc, len(fw.layers), fw.x_cols, wlast.data_ptr(),
        fw.b_sdf, float(tracer.sdf_threshold), 1.0 - float(tracer.line_search_step),
        int(tracer.line_step_iters), int(tracer.sphere_tracing_iters), int(fw.multires),
        acc_s.data_ptr(), acc_e.data_ptr(), unf.data_ptr(), counter.data_ptr(), n,
        torch.cuda.current_stream(cam.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sphere_trace: CUDA error {err} "
                           f"({lib.nefii_trace_error_string(err).decode()})")
    LAUNCHES["fused_sphere_trace"] += 1
    return acc_s, acc_e, unf, int(counter.item())


def build_fused_sphere_trace(network, tracer):
    """fn(cam, dirs, mask_intersect, near, far) -> (acc_start, acc_end,
    unfinished_start, min_dis, max_dis, n_evals), through K3."""
    fw = network_weights(network, torch.float32)

    def fn(cam, dirs, mask_intersect, near, far):
        acc_s, acc_e, unf, n_evals = fused_sphere_trace(
            cam, dirs, mask_intersect, near, far, fw, tracer)
        zero = torch.zeros_like(near)
        return (acc_s, acc_e, unf, torch.where(mask_intersect, near, zero),
                torch.where(mask_intersect, far, zero), n_evals)

    return fn
