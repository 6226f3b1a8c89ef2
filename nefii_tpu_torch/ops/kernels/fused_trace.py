"""Whole-trace kernel K3: CUDA wrapper and its plain PyTorch version
(counterpart of nefii_tpu/ops/pallas/fused_trace.py).

`build_fused_sphere_trace(network, tracer)` returns
fn(cam [N,3], dirs [N,3], mask_intersect [N], near [N], far [N]) ->
(acc_start, acc_end, unfinished_start, min_dis, max_dis, n_evals): the
contract of RayTracer._sphere_trace. For a CUDA tensor it launches
`sphere_trace_split_kernel` (`csrc/fused_trace.cu`), one launch for the
whole trace; for a CPU tensor it runs `fused_sphere_trace_plain`.

The kernel is compiled for the FMA K1's widths, FMA_WIDTHS = (256, 512),
since its near rays are traced again through K1 fp32 on K3's own packing:
on the card the network is packed at the smallest that holds it
(`packing_width`), so NeuS's 8x256 net runs at 256 in both.

The kernel runs the SDF chain on the tensor cores in split fp16 over a pool
of live rays. Split fp16 is K2's split-bf16 scheme (hi.hi + lo.hi + hi.lo)
with fp16's 11 significand bits: ~22 bits kept where split bf16 keeps ~16.
Each layer's weights are scaled by a power of two 2^s_l so that their lo
parts stay normal (`trace_weights` packs them once). A 64-row tile holds
the point queries that the rays' state machines ask for (a start point
while unf_s, an end point while unf_e, a back-stepped point while its sdf
is negative), and a ray leaves the pool when it is finished. So `n_evals`
counts the point queries evaluated, the count of the gathered tracer
(`RayTracer._sphere_trace`); the kernel's tiles and their empty rows are
reported beside it (`stats`). Per-ray results do not depend on which rays
share a tile.

Split fp16 holds the sdf close to fp32's but not to the bit, and a stop test
(sdf <= sdf_threshold), a line-search sign test (sdf < 0) or the crossing
test (acc_start < acc_end) on values that close to their threshold can go
the other way: the ray then ends a sub-threshold step from the fp32 trace. The
kernel flags a ray whose decision took values within NEAR_DELTA of their
threshold and counts the flagged rays in the counters the wrapper reads
anyway; the wrapper traces those rays again with `tracer`'s gathered fp32
trace on K1 fp32 (`csrc/fused_mlp.cu`) and keeps that trace for them.

The plain version has two modes: `tile=None` (the default) evaluates and
counts the live queries, as the kernel does; `tile=T` gives a tile of T rays
the Pallas kernel's semantics (another iteration while one of its rays is
unfinished, every evaluation counting the tile's 2 T points), for the count
parity with the Pallas kernel. `split=True` runs its chain in the kernel's
arithmetic and, as the wrapper does, its near rays' re-trace in fp32, so
that the card can tell the scheme's error from the kernel's (`agreement`
compares two traces). `_trace_kernel` and `_trace_plain` are the traces
without the re-trace, for measurement. fp32 only, as the TPU kernel.
Each kernel launch adds one to `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional

import torch

from nefii_tpu_torch.ops.kernels.fused_mlp import (
    FMA_WIDTHS, SPLIT_K, SPLIT_NX, SPLIT_REC, TC_BLOCK_ROWS, FusedWeights, _grid,
    _softplus100, _split_mm, embed_padded, fused_hidden_plain, network_weights, pack_split,
    sdf_closure, split_group,
)
from nefii_tpu_torch.utils.telemetry import host_sync

# launches of the CUDA kernel, and at each width ("fused_sphere_trace@256");
# the wrapper adds one where it launches, nowhere else
LAUNCHES: Dict[str, int] = {"fused_sphere_trace": 0,
                            **{f"fused_sphere_trace@{w}": 0 for w in FMA_WIDTHS}}

POOL_SLOTS = 32   # rays in a block's pool (TR_SLOTS in csrc/fused_trace.cu)
# A stop test (sdf <= sdf_threshold), line-search sign test (sdf < 0) or
# crossing test (acc_start < acc_end) of the split-fp16 trace whose values lie
# within NEAR_DELTA of its threshold (of each other) is near: the ray is
# traced again in fp32. NEAR_DELTA is 5 times the worst |split-fp16 sdf -
# fp32 sdf| measured on an H100 (8.345e-7) over 262,144 camera, random and
# secondary-conf rays of one 512x512 view of the flagship net's seeded init,
# at their points near, far, the fp32 trace's ends and their midpoint,
# rounded up. The card test test_k3_on_a_view_matches_plain
# (tests/test_torch_port_cuda.py, through kernel_gates.check_k3_near) fails
# unless NEAR_DELTA covers that error twice over, there and on NeuS's 8x256
# net at its 256 packing (1.073e-6), or where a ray's flags differ from the
# K1-fp32 trace's; chip_smoke.py's phases 4 and 13 hold the same.
# It is a constant: a geometry with larger activations is not measured.
NEAR_DELTA = 4.2e-6


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def forward_records(fw: FusedWeights) -> int:
    """Records that K3 streams a tile: the forward chain's, in K2's forward
    record layout, a K-deep block 2 ceil(k / 16 / g) records at g =
    split_group(fw.width) slices a record, one at 512 and two at 256
    (forward_records in csrc/fused_trace.cu)."""
    g = split_group(fw.width)
    return sum(2 * -(-(k // SPLIT_K) // g) for L in fw.layers for k in (L.k_h, L.k_x))


def _layer_shifts(fw: FusedWeights) -> List[int]:
    """s_l for each layer: its weights (both parts of a skip layer) times
    2^s_l have their largest magnitude in [2^13, 2^14), well inside fp16's
    range, and their lo parts stay normal."""
    shifts = []
    for L in fw.layers:
        m = max(float(w.abs().max()) for w in (L.w, L.wx) if w is not None)
        shifts.append(14 - math.frexp(m)[1] if m > 0 else 0)
    return shifts


@torch.no_grad()
def trace_weights(fw: FusedWeights):
    """K3's records (packed once, kept in fw.trace): per layer the forward
    B = (2^s_l W)^T in pack_split's layout, split_group(fw.width) k16 slices
    a record (a block's odd last slice padded with zeros at 256), split in
    fp16; and the s_l."""
    if fw.trace is None:
        shifts = _layer_shifts(fw)
        g = split_group(fw.width)
        rec = torch.cat([pack_split(w.t() * 2.0 ** s, fw.width, g, torch.float16)
                         for L, s in zip(fw.layers, shifts) for w in (L.w, L.wx)
                         if w is not None])
        fw.trace = (rec.contiguous(), shifts)
    return fw.trace


def _f16_hidden_plain(x: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """K3's chain in plain PyTorch: layer l's products in split fp16 against
    2^s_l W, the sum times 2^-s_l, then the bias and softplus in fp32."""
    xf = x.float()
    h = xf
    for L, s in zip(fw.layers, trace_weights(fw)[1]):
        z = _split_mm(h[:, :L.k_h], L.w.float() * 2.0 ** s, torch.float16)
        if L.wx is not None:
            z = z + _split_mm(xf, L.wx.float() * 2.0 ** s, torch.float16)
        h = _softplus100(z * 2.0 ** -s + L.b.float())
    return h


def _sdf_plain(pts: torch.Tensor, fw: FusedWeights, split: bool = False) -> torch.Tensor:
    x = embed_padded(pts, fw)
    h = _f16_hidden_plain(x, fw) if split else fused_hidden_plain(x, fw)
    return h @ fw.wlast_col.to(h.device) + fw.b_last[0].to(h.device)


def _trace_plain(cam, dirs, mask_intersect, near, far, fw: FusedWeights, tracer,
                 tile: Optional[int] = None, split: bool = False):
    """The trace of fused_sphere_trace_plain without the re-trace of its near
    rays: -> (acc_start, acc_end, unfinished_start, n_evals, near [N] bool)."""
    N = cam.shape[0]
    T = max(N, 1) if tile is None else tile
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
        """Masked sdf at the start points of the m_s rays and the end points
        of the m_e rays (tile=None), or at both points of every ray of
        `tiles`; and the count of points evaluated."""
        if tile is None:
            i_s, i_e = m_s.nonzero()[:, 0], m_e.nonzero()[:, 0]
        else:
            i_s = i_e = (tiles.nonzero()[:, 0, None] * T
                         + torch.arange(T, device=cam.device)).reshape(-1)
        pts = torch.cat([cam[i_s] + acc_s[i_s, None] * dirs[i_s],
                         cam[i_e] + acc_e[i_e, None] * dirs[i_e]])
        sd = _sdf_plain(pts, fw, split) if pts.shape[0] else pts[:, 0]
        sd_s, sd_e = zero.clone(), zero.clone()
        sd_s[i_s] = sd[:i_s.numel()]
        sd_e[i_e] = sd[i_s.numel():]
        return (torch.where(m_s, sd_s, zero), torch.where(m_e, sd_e, zero), pts.shape[0])

    near_ray = torch.zeros_like(m)

    def mark(live, value, target):
        """A decision on `value` against `target` at the `live` ends is near."""
        near_ray.logical_or_(live & ((value - target).abs() <= NEAR_DELTA))

    def head(unf_s, unf_e, next_s, next_e):
        mark(unf_s, next_s, thresh)
        mark(unf_e, next_e, thresh)
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
        ev_s, ev_e = unf_s, unf_e  # the ends just evaluated
        for j in range(tracer.line_step_iters):
            mark(ev_s, next_s, 0.0)
            mark(ev_e, next_e, 0.0)
            np_s, np_e = next_s < 0, next_e < 0
            ev_s, ev_e = np_s, np_e
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
        mark(unf_s | unf_e, acc_e, acc_s)
        not_crossed = acc_s < acc_e
        curr_s, curr_e, unf_s, unf_e = head(unf_s & not_crossed, unf_e & not_crossed,
                                            next_s, next_e)
    return acc_s[:N], acc_e[:N], unf_s[:N], n_ev, near_ray[:N]


def fused_sphere_trace_plain(cam, dirs, mask_intersect, near, far, fw: FusedWeights, tracer,
                             tile: Optional[int] = None, split: bool = False,
                             stats: Optional[dict] = None):
    """K3 in plain PyTorch: -> (acc_start, acc_end, unfinished_start, n_evals).

    Dense over the rays. With tile=None the SDF is evaluated at the live
    queries only and n_evals counts them (the kernel's count); with tile=T
    at every start and end point of the tiles of T rays that the Pallas
    kernel would evaluate, counted as it counts. split=True runs the SDF
    chain in the kernel's split fp16 and, as the wrapper does, re-traces the
    near rays (NEAR_DELTA) in fp32 and adds that trace's evaluations
    (`_trace_plain` keeps the split trace of every ray). `stats`, if given,
    receives the near flags of the trace (`near` [N] bool) and their count
    (`n_near`), before the re-trace."""
    acc_s, acc_e, unf_s, n_ev, near_ray = _trace_plain(cam, dirs, mask_intersect, near, far,
                                                       fw, tracer, tile, split)
    n_near = int(near_ray.sum())
    if stats is not None:
        stats.update(near=near_ray, n_near=n_near)
    if split and n_near:
        idx = near_ray.nonzero()[:, 0]
        r_s, r_e, r_unf, k = fused_sphere_trace_plain(
            cam[idx], dirs[idx], mask_intersect[idx], near[idx], far[idx], fw, tracer)
        acc_s[idx], acc_e[idx], unf_s[idx] = r_s, r_e, r_unf
        n_ev += k
    return acc_s, acc_e, unf_s, n_ev


def agreement(a, b):
    """Two traces' (acc_start, acc_end, unfinished) -> (rays whose unfinished
    flag differs, rays whose hit (acc_start < acc_end) differs, the largest
    distance error on the rays that agree on both)."""
    unf = a[2] == b[2]
    hit = (a[0] < a[1]) == (b[0] < b[1])
    same = unf & hit
    err = max((a[0] - b[0])[same].abs().max().item(),
              (a[1] - b[1])[same].abs().max().item()) if bool(same.any()) else 0.0
    return int((~unf).sum()), int((~hit).sum()), err


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_SLOT_BYTES = 0  # bytes of one pool slot, read from the library


def _lib() -> ctypes.CDLL:
    global _SLOT_BYTES
    from nefii_tpu_torch.ops.kernels import build

    lib = build.load("fused_trace")
    if not getattr(lib, "_nefii_typed", False):
        vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.nefii_sphere_trace.argtypes = [
            vp, vp, vp, vp, vp, vp, i, ctypes.POINTER(i), vp, ctypes.POINTER(ll), i, i, i, vp, f,
            f, f, f, i, i, i,
            vp, vp, vp, vp, vp, vp, ll, i, vp]
        lib.nefii_sphere_trace.restype = i
        lib.nefii_trace_error_string.argtypes = [i]
        lib.nefii_trace_error_string.restype = ctypes.c_char_p
        lib.nefii_fused_trace_config.argtypes = [ctypes.POINTER(i)] * 4
        widths, slots, rows, slot_bytes = (i * 2)(), i(), i(), i()
        lib.nefii_fused_trace_config(widths, ctypes.byref(slots), ctypes.byref(rows),
                                     ctypes.byref(slot_bytes))
        _SLOT_BYTES = slot_bytes.value
        got = (tuple(widths), slots.value, rows.value)
        if got != (FMA_WIDTHS, POOL_SLOTS, TC_BLOCK_ROWS):
            raise RuntimeError(f"fused_trace library takes widths {got[0]}, {got[1]} rays a "
                               f"pool, {got[2]}-row tiles; the wrapper expects {FMA_WIDTHS}, "
                               f"{POOL_SLOTS}, {TC_BLOCK_ROWS}")
        lib._nefii_typed = True
    return lib


def _trace_records(fw: FusedWeights, device: torch.device):
    """K3's records (trace_weights, packed at its first launch), their count
    and the layer shifts. Raises unless the packing is whole, on `device`,
    contiguous and 16-byte aligned (the bulk copies')."""
    if fw.x_cols > SPLIT_NX:
        raise ValueError(f"fused_sphere_trace: the kernel takes at most {SPLIT_NX} embedding "
                         f"columns, this network has {fw.x_cols}")
    rec, shifts = trace_weights(fw)
    n_rec = forward_records(fw)
    if rec.device != device or rec.dtype != torch.float16 or rec.numel() != n_rec * SPLIT_REC \
            or len(shifts) != len(fw.layers):
        raise ValueError("fused_sphere_trace: the packed split weights do not match the network")
    if not rec.is_contiguous() or rec.data_ptr() % 16:
        raise ValueError("fused_sphere_trace: the packed weights must be contiguous and "
                         "16-byte aligned")
    return rec, n_rec, shifts


def _trace_kernel(cam, dirs, mask_intersect, near, far, fw: FusedWeights, tracer,
                  stats: Optional[dict] = None):
    """One launch of K3 on CUDA tensors, without the re-trace of its near
    rays: -> (acc_start, acc_end, unfinished_start, n_evals, near [N] bool,
    n_near). Raises unless the inputs are what the kernel takes. `stats`, if
    given, receives the kernel's evaluations, tiles and their empty rows."""
    if cam.device.type != "cuda":
        raise ValueError(f"fused_sphere_trace: tensors on {cam.device} are not supported")
    if fw.dtype != torch.float32:
        raise ValueError("fused_sphere_trace: the whole-trace kernel is fp32 only")
    if fw.width not in FMA_WIDTHS:
        raise ValueError(f"fused_sphere_trace: the CUDA kernel takes hidden widths {FMA_WIDTHS}, "
                         f"this packing has {fw.width}")
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
    if n >= 2 ** 31:
        raise ValueError("fused_sphere_trace: at most 2^31 - 1 rays a launch")
    rec, n_rec, shifts = _trace_records(fw, cam.device)
    cam, dirs, mask_intersect, near, far = (t.contiguous() for t in
                                            (cam, dirs, mask_intersect, near, far))
    acc_s = torch.empty(n, dtype=torch.float32, device=cam.device)
    acc_e = torch.empty_like(acc_s)
    unf = torch.empty(n, dtype=torch.bool, device=cam.device)
    near_ray = torch.empty(n, dtype=torch.bool, device=cam.device)
    if n == 0:
        return acc_s, acc_e, unf, 0, near_ray, 0
    lib = _lib()
    grid = _grid(n, cam.device, POOL_SLOTS, 1)
    # the next ray to take, the evaluations executed, the empty rows, the near rays
    counters = torch.zeros(4, dtype=torch.int64, device=cam.device)
    pool = torch.empty(grid * POOL_SLOTS * _SLOT_BYTES, dtype=torch.uint8, device=cam.device)
    wlast = fw.wlast_col.to(cam.device).contiguous()
    desc = (ctypes.c_longlong * len(fw.desc))(*fw.desc)
    err = lib.nefii_sphere_trace(
        cam.data_ptr(), dirs.data_ptr(), mask_intersect.data_ptr(), near.data_ptr(),
        far.data_ptr(), rec.data_ptr(), n_rec, (ctypes.c_int * len(shifts))(*shifts),
        fw.buf.data_ptr(), desc, len(fw.layers),
        fw.x_cols, fw.width, wlast.data_ptr(), fw.b_sdf, float(tracer.sdf_threshold), NEAR_DELTA,
        1.0 - float(tracer.line_search_step), int(tracer.line_step_iters),
        int(tracer.sphere_tracing_iters), int(fw.multires), acc_s.data_ptr(), acc_e.data_ptr(),
        unf.data_ptr(), near_ray.data_ptr(), pool.data_ptr(), counters.data_ptr(), n, grid,
        torch.cuda.current_stream(cam.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sphere_trace: CUDA error {err} "
                           f"({lib.nefii_trace_error_string(err).decode()})")
    LAUNCHES["fused_sphere_trace"] += 1
    LAUNCHES[f"fused_sphere_trace@{fw.width}"] += 1
    with host_sync("k3.counters"):
        _, n_evals, empty, n_near = counters.tolist()
    if stats is not None:
        stats.update(evals=n_evals, empty_rows=empty, tiles=(n_evals + empty) // TC_BLOCK_ROWS)
    return acc_s, acc_e, unf, n_evals, near_ray, n_near


def fused_sphere_trace(cam, dirs, mask_intersect, near, far, fw: FusedWeights, tracer,
                       stats: Optional[dict] = None):
    """K3: -> (acc_start, acc_end, unfinished_start, n_evals). CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise. The rays the
    kernel flags near are traced again in fp32 by `tracer`'s gathered trace
    on K1 fp32. `stats`, if given, receives the kernel's evaluations, tiles
    and their empty rows, its near flags (`near`) and their count
    (`n_near`), and the re-trace's evaluations (`retrace_evals`, included in
    n_evals)."""
    if cam.device.type == "cpu":
        return fused_sphere_trace_plain(cam, dirs, mask_intersect, near, far, fw, tracer,
                                        stats=stats)
    acc_s, acc_e, unf, n_evals, near_ray, n_near = _trace_kernel(
        cam, dirs, mask_intersect, near, far, fw, tracer, stats)
    if stats is not None:
        stats.update(near=near_ray, n_near=n_near, retrace_evals=0)
    if n_near:
        # the near rays, in index order, without a second host sync
        idx = torch.argsort(near_ray.to(torch.uint8), descending=True, stable=True)[:n_near]
        r_s, r_e, r_unf, k = tracer._sphere_trace(sdf_closure(fw), cam[idx], dirs[idx],
                                                  mask_intersect[idx], near[idx], far[idx])
        acc_s[idx], acc_e[idx], unf[idx] = r_s, r_e, r_unf
        n_evals += k
        if stats is not None:
            stats["retrace_evals"] = k
    return acc_s, acc_e, unf, n_evals


def build_fused_sphere_trace(network, tracer):
    """fn(cam, dirs, mask_intersect, near, far) -> (acc_start, acc_end,
    unfinished_start, min_dis, max_dis, n_evals), through K3 on the
    network's fp32 packing at the smallest of K3's widths that holds it
    (256 for NeuS's 8x256 net, 512 for the flagship's 8x512), which its near
    rays' re-trace through the FMA K1 shares."""
    fw = network_weights(network, torch.float32, FMA_WIDTHS)

    def fn(cam, dirs, mask_intersect, near, far):
        acc_s, acc_e, unf, n_evals = fused_sphere_trace(
            cam, dirs, mask_intersect, near, far, fw, tracer)
        zero = torch.zeros_like(near)
        return (acc_s, acc_e, unf, torch.where(mask_intersect, near, zero),
                torch.where(mask_intersect, far, zero), n_evals)

    return fn
