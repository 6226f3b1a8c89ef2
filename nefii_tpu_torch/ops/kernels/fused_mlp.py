"""Fused SDF-MLP kernels: CUDA wrappers and their plain PyTorch versions
(counterpart of nefii_tpu/ops/pallas/fused_mlp.py).

The kernels are in `csrc/fused_mlp.cu` (built by `build.py`, bound with
ctypes):

  * K1 replaces the Pallas `_kernel`: the value-only hidden chain of the SDF
    MLP, which answers every SDF query of the tracers (`build_fused_sdf`).
    It has two entries in each dtype: `fused_hidden` takes the embedded
    points and returns h; `fused_sdf_value` takes the points [N, 3], computes
    their positional encoding in the kernel, in the prologue that fills its x
    tile (bit for bit `embed_padded`), reduces h against the sdf column of
    the final linear and returns sdf [N]: one launch a query of the tracers
    (`build_fused_sdf`), with no embedding in memory. In fp32
    it runs on the FMA pipe (`csrc/sdf_mlp_fma.cuh`: both operands from
    shared memory, the weights through a bulk-copy ring), its sdf column
    summed in `sdf_column`'s order, so that a row's sdf is `sdf_column` of
    the kernel's h bit for bit. In bf16 (bf16 operands, fp32 accumulation, h
    rounded to bf16 after every layer) it runs on the tensor cores
    (`csrc/sdf_mlp_tc.cuh`).
  * `fused_fwd_bwd` (K2) replaces the Pallas `_kernel_fwd_bwd`: the forward
    plus the input-space backward of the sdf column, fp32. It gives sdf,
    feature and normal at every shading point and secondary hit
    (`build_fused_sdf_feature_grad`). It runs on the tensor cores in split
    bf16 (`csrc/sdf_mlp_split.cuh`): every operand v is split into
    hi = bf16(v) and lo = bf16(v - hi), and every product is
    hi.hi + lo.hi + hi.lo in fp32, which keeps the fp32 chain's accuracy
    (`fused_fwd_bwd_split_plain` is that arithmetic in plain PyTorch).

Widths. Every kernel is compiled for hidden widths 256 and 512: the FMA K1
(and K3, fused_trace.py) for FMA_WIDTHS, the tensor-core K1 and K2 for
TC_WIDTHS. A packing for a kernel on the card has the smallest of its widths
that holds the network (`packing_width`): NeuS's 8x256 net runs at 256 in
K1 (fp32 and bf16), K2 and K3; on the CPU every packing keeps the network's
own width. A width no kernel takes (above 512) is refused on the card.

`prepare_weights` resolves weight norm, pads and folds the skip layer's
1/sqrt(2) into split weights once per call, into one packed buffer that the
kernels and the plain versions share (K1 fp32 streams its layers as they
lie there); in bf16 it also packs K1's tensor-core chunks (`pack_tc`). K2
packs its split hi/lo records of both passes (`split_weights`) at its first
launch and keeps them on the FusedWeights.
`network_weights` keeps one FusedWeights a network, dtype and width while
the parameters do not change, so the closures, built at every forward, pack
a frozen geometry once. The final linear (outside `fused_sdf_value`'s sdf
column), K2's positional encoding and the encoding's backward stay outside
the kernels, as in the JAX package.

A wrapper given a CUDA tensor launches its kernel or raises; the plain
version (`*_plain`) runs only for tensors on the CPU, and it is what the
kernels are compared against. Each wrapper counts its launches in
`LAUNCHES`, and by width ("fused_sdf_value@256").
Nothing here imports triton or needs nvcc at import time.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nefii_tpu_torch.utils.telemetry import host_sync

FMA_WIDTHS = (256, 512)   # widths the FMA K1 and K3 are compiled for (FmaCfg in csrc)
TC_WIDTHS = (256, 512)    # widths the tensor-core K1 and K2 are compiled for
# K1 fp32's two entries (the hidden state, the sdf), then the tensor-core kernels'
FMA_KERNELS = ("fused_sdf_hidden", "fused_sdf_value_fp32")
TC_KERNELS = ("fused_sdf_hidden_tc", "fused_sdf_value", "fused_sdf_fwd_bwd")
# launches of each CUDA kernel, and of each kernel at each width
# ("<kernel>@<width>"); a wrapper adds one where it launches, nowhere else
LAUNCHES: Dict[str, int] = {**{k: 0 for k in FMA_KERNELS + TC_KERNELS},
                            **{f"{k}@{w}": 0 for k in FMA_KERNELS for w in FMA_WIDTHS},
                            **{f"{k}@{w}": 0 for k in TC_KERNELS for w in TC_WIDTHS}}

# resident blocks per SM of each design, threads a block of the FMA K1 (256
# consumers and a producer warpgroup), the embedding columns its x tile
# holds, and the tensor-core kernels' rows a tile; the grids are persistent
# (csrc: sdf_mlp_fma.cuh's FMA_THREADS and FMA_MAX_XC, TC_THREADS' launch
# bounds, TC_BM)
FMA_BLOCKS_PER_SM, FMA_THREADS, FMA_MAX_XC = 1, 384, 64
TC_BLOCK_ROWS, TC_BLOCKS_PER_SM = 64, 1
TC_K = 64             # input rows of one tensor-core weight chunk (TC_BK)
# K2's weight records (csrc/sdf_mlp_split.cuh): a record is SPLIT_REC bf16
# values, the hi or the lo half of k16 slices of a K-major [N][16] block in
# the 32-byte swizzle; SPLIT_REC // (N * 16) slices a record (split_group):
# one at N = 512, two at 256, 8 at the backward's x_cols-wide outputs,
# padded to N = SPLIT_NX
SPLIT_K, SPLIT_REC, SPLIT_NX = 16, 8192, 64


def split_group(n: int) -> int:
    """k16 slices a K2 record holds at N = n (SPLIT_REC values, hi or lo)."""
    return SPLIT_REC // (n * SPLIT_K)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def network_width(network) -> int:
    """The network's own packed width: its widest fused layer's output,
    rounded up to a multiple of 16."""
    return _round_up(max(layer.d_out for layer in network.layers[:-1]), 16)


def fit_width(width: int, widths) -> int:
    """The smallest of a kernel's compiled `widths` that holds a network of
    packed width `width`; `width` itself where none does (the kernel's
    wrapper then refuses the packing)."""
    return min((w for w in widths if w >= width), default=width)


def packing_width(network, widths) -> int:
    """The width network_weights packs `network` at for a kernel compiled
    for `widths`: on the card fit_width, elsewhere the network's own (the
    plain versions give the same values at any padding)."""
    own = network_width(network)
    return fit_width(own, widths) if next(network.parameters()).is_cuda else own


@dataclass
class FusedLayer:
    """Views into FusedWeights.buf for one fused layer."""
    w: torch.Tensor             # [k_h, width]   h part (layer 0: the embedded input)
    wx: Optional[torch.Tensor]  # [k_x, width]   skip layers' x part
    b: torch.Tensor             # [width]
    k_h: int
    k_x: int


@dataclass
class FusedWeights:
    buf: torch.Tensor        # packed weights and biases, working dtype
    desc: List[int]          # per layer: w, wx, b offsets (elements), k_h, k_x
    layers: List[FusedLayer]
    width: int               # padded width of every fused layer's output
    x_cols: int              # padded embedding width
    emb_dim: int             # real embedding width
    real_width: int          # real width of the last hidden layer
    w_last: torch.Tensor     # [real_width, d_out (+F)] fp32, the final linear
    b_last: torch.Tensor
    wlast_col: torch.Tensor  # [width] fp32: sdf column of w_last, zero padded
    b_sdf: float             # b_last[0], read once
    multires: int
    d_in: int
    embed_fn: object
    tc: Optional[torch.Tensor] = None     # bf16 only: K1's tensor-core chunks (pack_tc)
    # fp32 only: K2's split records of both passes in the order it reads
    # them, packed by split_weights at K2's first launch
    split: Optional[torch.Tensor] = None
    # fp32 only: K3's split-fp16 records of the forward chain and each
    # layer's weight scale exponent, packed by fused_trace.trace_weights
    trace: Optional[tuple] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.buf.dtype


@torch.no_grad()
def prepare_weights(network, dtype: torch.dtype = torch.float32,
                    width: Optional[int] = None) -> FusedWeights:
    """Resolve weight norm + padding + skip folding into the packed buffer.

    Every fused layer (all but the final linear) is padded to one output
    width; input widths are padded to multiples of 16 and the embedding to
    x_cols. Padded weight rows/columns and biases are zero, so padded
    features never reach a real output (forward) or gradient (backward).
    `width` pads the outputs further, to the width of the kernel the packing
    is for (packing_width); by default a packing keeps the network's own.
    """
    dims, embed_fn = network._layer_dims()
    n = len(dims)
    d_emb = dims[0]
    x_cols = _round_up(d_emb, 16)
    ws = [network.layers[l].effective_weight().t() for l in range(n - 2)]  # [in, out]
    width = max(width or 0, network_width(network))

    blocks: List[torch.Tensor] = []
    offset = 0

    def put(t: torch.Tensor) -> int:
        nonlocal offset
        start = offset
        blocks.append(t.reshape(-1))
        offset += t.numel()
        return start

    desc: List[int] = []
    shapes = []
    tc_parts: List[torch.Tensor] = []
    for l, w in enumerate(ws):
        in_dim, out_dim = w.shape
        w = F.pad(w, (0, width - out_dim))
        b = F.pad(network.layers[l].b, (0, width - out_dim))
        if l in network.skip_in:
            h_dim = in_dim - d_emb
            k_h, k_x = _round_up(h_dim, 16), x_cols
            scale = 1.0 / np.sqrt(2.0)
            wa = F.pad(w[:h_dim] * scale, (0, 0, 0, k_h - h_dim))
            wb = F.pad(w[h_dim:] * scale, (0, 0, 0, x_cols - d_emb))
        else:
            k_h, k_x = (x_cols if l == 0 else _round_up(in_dim, 16)), 0
            wa = F.pad(w, (0, 0, 0, k_h - in_dim))
            wb = None
        o_w = put(wa)
        o_wx = put(wb) if wb is not None else -1
        o_b = put(b)
        desc += [o_w, o_wx, o_b, k_h, k_x]
        shapes.append((o_w, o_wx, o_b, k_h, k_x))
        if dtype == torch.bfloat16:
            tc_parts += [pack_tc(w) for w in ([wa] + ([wb] if wb is not None else []))]
    buf = torch.cat(blocks).to(dtype).contiguous()

    layers = []
    for o_w, o_wx, o_b, k_h, k_x in shapes:
        layers.append(FusedLayer(
            w=buf[o_w:o_w + k_h * width].view(k_h, width),
            wx=buf[o_wx:o_wx + k_x * width].view(k_x, width) if k_x else None,
            b=buf[o_b:o_b + width], k_h=k_h, k_x=k_x,
        ))

    last = network.layers[n - 2]
    w_last = last.effective_weight().t().float().contiguous()
    real_width = dims[-2]
    wlast_col = F.pad(w_last[:, 0], (0, width - real_width)).contiguous()
    b_last = last.b.detach().float()
    with host_sync("kernels.pack"):
        b_sdf = float(b_last[0])
    return FusedWeights(
        buf=buf, desc=desc, layers=layers, width=width, x_cols=x_cols, emb_dim=d_emb,
        real_width=real_width, w_last=w_last, b_last=b_last, wlast_col=wlast_col,
        b_sdf=b_sdf, multires=network.multires, d_in=network.d_in,
        embed_fn=embed_fn,
        tc=torch.cat(tc_parts).to(torch.bfloat16).contiguous() if tc_parts else None,
    )


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """[..., rows, 64] -> the same values in the 128-byte swizzled layout of
    Hopper's TMA and wgmma: in row r, the 8-element group g is stored at
    group g ^ (r % 8)."""
    r = torch.arange(t.shape[-2], device=t.device)[:, None]
    col = torch.arange(TC_K, device=t.device)[None, :]
    return torch.gather(t, -1, (((col // 8) ^ (r % 8)) * 8 + col % 8).expand(t.shape))


def pack_tc(w: torch.Tensor) -> torch.Tensor:
    """One weight block [k, width] (input x output) -> the tensor-core
    kernel's chunks, flat: the input dimension zero padded to a multiple of
    TC_K and cut into chunks of TC_K, each chunk [width][TC_K] K-major (the
    transposed block) and 128-byte swizzled, so one contiguous bulk copy
    lands it in shared memory as the wgmma B descriptor reads it."""
    k, width = w.shape
    n = -(-k // TC_K)
    wt = F.pad(w, (0, 0, 0, n * TC_K - k)).t().reshape(width, n, TC_K).permute(1, 0, 2)
    return _swizzle128(wt.contiguous()).reshape(-1)


def _swizzle32(t: torch.Tensor) -> torch.Tensor:
    """[..., rows, 16] -> the same values in the 32-byte swizzled layout of
    wgmma: in row r, the 8-element half h is stored at half h ^ ((r // 4) % 2)."""
    r = torch.arange(t.shape[-2], device=t.device)[:, None]
    col = torch.arange(SPLIT_K, device=t.device)[None, :]
    return torch.gather(t, -1, (((col // 8) ^ ((r // 4) % 2)) * 8 + col % 8).expand(t.shape))


def split_pair(t: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """fp32 t -> (hi, lo) in `dtype` with hi = dtype(t), lo = dtype(t - hi),
    both rounded to nearest even, as the split kernels round their operands
    (K2 in bf16, K3 in fp16)."""
    hi = t.to(dtype)
    return hi, (t - hi.float()).to(dtype)


def pack_split(b: torch.Tensor, n_pad: int, group: int,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One K-major operand block b [n, k] (row i holds the k inputs of the
    product's output column i) -> K2's records, flat in `dtype`: n zero padded to n_pad and k to a
    multiple of 16 * group (the padding is zero slices), cut into k16 slices
    [n_pad][16] in the 32-byte swizzle, split into hi and lo; every `group`
    slices give a hi record and then a lo record, so one bulk copy lands a
    record as the wgmma B descriptor reads it."""
    n, k = b.shape
    kp = _round_up(k, SPLIT_K * group)
    slices = F.pad(b.float(), (0, kp - k, 0, n_pad - n)).reshape(n_pad, kp // SPLIT_K, SPLIT_K)
    slices = slices.permute(1, 0, 2).contiguous()
    hi, lo = (_swizzle32(t).reshape(-1, group * n_pad * SPLIT_K)
              for t in split_pair(slices, dtype))
    return torch.stack([hi, lo], 1).reshape(-1)


@torch.no_grad()
def split_weights(fw: FusedWeights) -> torch.Tensor:
    """K2's records (pack_split) of fp32 weights, packed once and kept in
    fw.split: per layer the forward's B = W^T ([width out][k in]), then from
    the top layer the backward's B = W itself ([k in][width out]; N = k
    padded to width, or to SPLIT_NX for the x_cols-wide outputs of layer 0
    and the skip layer's x part)."""
    if fw.split is None:
        wide, narrow = split_group(fw.width), split_group(SPLIT_NX)
        parts = [pack_split(w.t(), fw.width, wide) for L in fw.layers for w in (L.w, L.wx)
                 if w is not None]
        for l in reversed(range(len(fw.layers))):
            L = fw.layers[l]
            parts.append(pack_split(L.w, fw.width, wide) if l
                         else pack_split(L.w, SPLIT_NX, narrow))
            if L.wx is not None:
                parts.append(pack_split(L.wx, SPLIT_NX, narrow))
        fw.split = torch.cat(parts).contiguous()
    return fw.split


def split_records(fw: FusedWeights) -> int:
    """Records of pack_split that K2 streams a tile, in the kernel's count
    (split_records in csrc/sdf_mlp_split.cuh): a K-deep block at g slices a
    record is 2 ceil(k / 16 / g) records; forward, g = split_group(width);
    backward, K = width, at N = width or at N = SPLIT_NX (layer 0 and the
    skip layer's x part)."""
    def recs(k: int, g: int) -> int:
        return 2 * -(-(k // SPLIT_K) // g)

    wide, narrow = split_group(fw.width), split_group(SPLIT_NX)
    return sum(recs(L.k_h, wide) + recs(L.k_x, wide)
               + recs(fw.width, wide if l else narrow) + (recs(fw.width, narrow) if L.k_x else 0)
               for l, L in enumerate(fw.layers))


def embed_padded(pts: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """[N, 3] points -> kernel-ready [N, x_cols] embedding in the working dtype."""
    x = fw.embed_fn(pts) if fw.multires > 0 else pts
    x = F.pad(x.float(), (0, fw.x_cols - x.shape[-1]))
    return x.to(fw.dtype).contiguous()


def _softplus100(z: torch.Tensor) -> torch.Tensor:
    t = z * 100.0
    return (F.relu(t) + torch.log1p(torch.exp(-t.abs()))) * 0.01


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def fused_hidden_plain(x: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """K1 in plain PyTorch: operands in the working dtype, fp32 accumulation,
    h rounded to the working dtype after every layer."""
    xf = x.float()
    h = xf
    for L in fw.layers:
        z = h[:, :L.k_h] @ L.w.float()
        if L.wx is not None:
            z = z + xf @ L.wx.float()
        h = _softplus100(z + L.b.float())
        if fw.dtype != torch.float32:
            h = h.to(fw.dtype).float()
    return h.to(fw.dtype)


def fused_sdf_value_plain(x: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """K1 with the sdf column of the final linear, in plain PyTorch: the
    hidden chain, then h[:, :real_width] . w_last[:, 0] + b_last[0] in fp32;
    for an fp32 packing summed in sdf_column's fixed order (the FMA
    kernel's)."""
    h = fused_hidden_plain(x, fw)[:, :fw.real_width].float()
    if fw.dtype == torch.float32:
        return sdf_column(h, fw.w_last[:, 0], fw.b_last[0])
    return (h @ fw.w_last[:, :1])[:, 0] + fw.b_last[0]


def _fwd_bwd(x: torch.Tensor, fw: FusedWeights, mm):
    """K2's chain with the matrix product `mm`: (last hidden [N, width],
    d sdf/d x [N, x_cols])."""
    xf = x.float()
    h = xf
    zs = []
    for L in fw.layers:
        z = mm(h[:, :L.k_h], L.w.float())
        if L.wx is not None:
            z = z + mm(xf, L.wx.float())
        z = z + L.b.float()
        zs.append(z)
        h = _softplus100(z)
    g = fw.wlast_col.expand(x.shape[0], fw.width)
    gx = torch.zeros_like(xf)
    for L, z in zip(reversed(fw.layers), reversed(zs)):
        gz = g * torch.sigmoid(z * 100.0)
        if L.wx is not None:
            gx = gx + mm(gz, L.wx.float().t())
        g = F.pad(mm(gz, L.w.float().t()), (0, fw.width - L.k_h))
    return h, gx + g[:, :fw.x_cols]


def fused_fwd_bwd_plain(x: torch.Tensor, fw: FusedWeights):
    """K2 in plain PyTorch (fp32): (last hidden [N, width], d sdf/d x [N, x_cols])."""
    return _fwd_bwd(x, fw, torch.matmul)


def _split_mm(a: torch.Tensor, w: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    ah, al = (t.float() for t in split_pair(a, dtype))
    wh, wl = (t.float() for t in split_pair(w, dtype))
    return ah @ wh + al @ wh + ah @ wl


def fused_fwd_bwd_split_plain(x: torch.Tensor, fw: FusedWeights):
    """K2 in the kernel's split-bf16 arithmetic, in plain PyTorch: every
    product a.w is a_hi.w_hi + a_lo.w_hi + a_hi.w_lo in fp32 (exact bf16
    products, fp32 sums). On no path: it tells the scheme's error (against
    fused_fwd_bwd_plain) from the kernel's (against this)."""
    return _fwd_bwd(x, fw, _split_mm)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_SM_COUNT: Dict[int, int] = {}


def fma_block_rows(width: int) -> int:
    """Rows a block tile of the FMA K1 holds at `width`: its 256 consumer
    threads own 8x16 outputs each, so 64 rows at 512 and 128 at 256 (FmaCfg
    in csrc/sdf_mlp_fma.cuh)."""
    return 256 * 8 * 16 // width


def _lib() -> ctypes.CDLL:
    from nefii_tpu_torch.ops.kernels import build

    lib = build.load("fused_mlp")
    if not getattr(lib, "_nefii_typed", False):
        vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        pll = ctypes.POINTER(ctypes.c_longlong)
        lib.nefii_sdf_hidden.argtypes = [vp, vp, pll, i, i, i, vp, ll, i, vp]
        lib.nefii_sdf_value_fp32.argtypes = [vp, vp, pll, i, i, i, i, vp, f, i, vp, ll, i, vp]
        lib.nefii_sdf_hidden_tc.argtypes = [vp, vp, vp, pll, i, i, i, vp, ll, i, vp]
        lib.nefii_sdf_value.argtypes = [vp, vp, vp, pll, i, i, i, i, vp, f, vp, ll, i, vp]
        lib.nefii_sdf_fwd_bwd.argtypes = [vp, vp, vp, pll, i, i, i, vp, vp, vp, vp, i, ll, i,
                                          vp]
        for fn in (lib.nefii_sdf_hidden, lib.nefii_sdf_value_fp32, lib.nefii_sdf_hidden_tc,
                   lib.nefii_sdf_value, lib.nefii_sdf_fwd_bwd):
            fn.restype = i
        lib.nefii_error_string.argtypes = [i]
        lib.nefii_error_string.restype = ctypes.c_char_p
        lib.nefii_fused_mlp_config.argtypes = [ctypes.POINTER(i)] * 6
        widths, rows, tc_widths = (i * 2)(), (i * 2)(), (i * 2)()
        threads, tc_rows, tc_threads = i(), i(), i()
        lib.nefii_fused_mlp_config(widths, rows, ctypes.byref(threads), ctypes.byref(tc_rows),
                                   ctypes.byref(tc_threads), tc_widths)
        got = (tuple(widths), tuple(rows), threads.value, tc_rows.value, tuple(tc_widths))
        want = (FMA_WIDTHS, tuple(fma_block_rows(w) for w in FMA_WIDTHS), FMA_THREADS,
                TC_BLOCK_ROWS, TC_WIDTHS)
        if got != want:
            raise RuntimeError(f"fused_mlp library takes widths {got[0]} at rows {got[1]} and "
                               f"{got[2]} threads (FMA), rows {got[3]} and widths {got[4]} "
                               f"(tensor cores); the wrapper expects {want}")
        lib._nefii_typed = True
    return lib


def _grid(n_rows: int, device: torch.device, rows: int, per_sm: int) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return max(1, min(-(-n_rows // rows), _SM_COUNT[idx] * per_sm))


def tc_block_rows(width: int) -> int:
    """Rows a block step of the tensor-core K1 holds: one 64-row tile at 512,
    two (one a consumer warpgroup, in ping-pong) at 256 (csrc/sdf_mlp_tc.cuh)."""
    return TC_BLOCK_ROWS * 512 // width


def _check_points(x: torch.Tensor, fw: FusedWeights, name: str) -> None:
    """What an sdf entry takes on every device: points [N, d_in] fp32."""
    if x.dim() != 2 or x.shape[1] != fw.d_in or x.dtype != torch.float32:
        raise ValueError(f"{name}: input must be points [N, {fw.d_in}] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _check_cuda(x: torch.Tensor, fw: FusedWeights, name: str,
                widths=FMA_WIDTHS, points: bool = False) -> None:
    """What every kernel takes: the input on the weights' card, a compiled
    width, both contiguous and aligned; the input the embedded points [N,
    x_cols] in the weights' dtype, 16-byte aligned, or with `points` (the sdf
    entries, _check_points) the points of three coordinates (the kernels
    encode three), 4-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} are not supported")
    if fw.buf.device != x.device:
        raise ValueError(f"{name}: weights on {fw.buf.device}, input on {x.device}")
    if fw.width not in widths:
        raise ValueError(f"{name}: the CUDA kernel takes hidden widths {widths}, "
                         f"this packing has {fw.width}")
    if not points and (x.dim() != 2 or x.shape[1] != fw.x_cols):
        raise ValueError(f"{name}: input must be [N, {fw.x_cols}], got {tuple(x.shape)}")
    if not points and x.dtype != fw.dtype:
        raise ValueError(f"{name}: input is {x.dtype}, weights are {fw.dtype}")
    if points and fw.d_in != 3:
        raise ValueError(f"{name}: the kernels encode 3 coordinates, this network takes "
                         f"{fw.d_in}")
    if not x.is_contiguous() or not fw.buf.is_contiguous():
        raise ValueError(f"{name}: input and weights must be contiguous")
    if x.data_ptr() % (4 if points else 16) or fw.buf.data_ptr() % 16:
        raise ValueError(f"{name}: input and weights must be aligned")


def _check_fma(x: torch.Tensor, fw: FusedWeights, name: str, points: bool = False) -> None:
    """What the FMA K1 takes beyond _check_cuda: fp32 and an embedding of at
    most FMA_MAX_XC columns (its x tile)."""
    _check_cuda(x, fw, name, points=points)
    if fw.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {fw.dtype} is not supported")
    if fw.x_cols > FMA_MAX_XC:
        raise ValueError(f"{name}: the FMA kernel takes at most {FMA_MAX_XC} embedding "
                         f"columns, this network has {fw.x_cols}")


def _check_tc(x: torch.Tensor, fw: FusedWeights, name: str, points: bool = False) -> None:
    """What the tensor-core kernel takes beyond _check_cuda: bf16 weights, an
    embedding of at most one chunk, and its packed chunks on the device,
    whole, contiguous and 16-byte aligned (the bulk copies' alignment)."""
    _check_cuda(x, fw, name, TC_WIDTHS, points)
    if fw.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the tensor-core kernel is bf16 only, weights are {fw.dtype}")
    if fw.x_cols > TC_K:
        raise ValueError(f"{name}: the tensor-core kernel takes at most {TC_K} embedding "
                         f"columns, this network has {fw.x_cols}")
    n_chunks = sum(-(-L.k_h // TC_K) + -(-L.k_x // TC_K) for L in fw.layers)
    tc = fw.tc
    if tc is None or tc.device != x.device or tc.numel() != n_chunks * fw.width * TC_K:
        raise ValueError(f"{name}: the packed tensor-core weights are missing or do not match")
    if not tc.is_contiguous() or tc.data_ptr() % 16:
        raise ValueError(f"{name}: the packed weights must be contiguous and 16-byte aligned")


def _raise_on(err: int, name: str, lib: ctypes.CDLL) -> None:
    if err != 0:
        msg = lib.nefii_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _count(name: str, width: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}@{width}"] += 1


def fused_hidden(x: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """K1: embedded points [N, x_cols] -> last hidden state [N, width], both in
    the working dtype: fp32 on the FMA pipe (FMA_WIDTHS), bf16 on the tensor
    cores (TC_WIDTHS)."""
    if x.device.type == "cpu":
        return fused_hidden_plain(x, fw)
    if fw.dtype == torch.bfloat16:
        _check_tc(x, fw, "fused_hidden")
    else:
        _check_fma(x, fw, "fused_hidden")
    n = x.shape[0]
    out = torch.empty(n, fw.width, dtype=fw.dtype, device=x.device)
    if n == 0:
        return out
    lib = _lib()
    desc = (ctypes.c_longlong * len(fw.desc))(*fw.desc)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if fw.dtype == torch.bfloat16:
        err = lib.nefii_sdf_hidden_tc(
            x.data_ptr(), fw.tc.data_ptr(), fw.buf.data_ptr(), desc, len(fw.layers), fw.x_cols,
            fw.width, out.data_ptr(), n,
            _grid(n, x.device, tc_block_rows(fw.width), TC_BLOCKS_PER_SM), stream)
        _raise_on(err, "fused_hidden", lib)
        _count("fused_sdf_hidden_tc", fw.width)
    else:
        err = lib.nefii_sdf_hidden(
            x.data_ptr(), fw.buf.data_ptr(), desc, len(fw.layers), fw.x_cols, fw.width,
            out.data_ptr(), n, _grid(n, x.device, fma_block_rows(fw.width), FMA_BLOCKS_PER_SM),
            stream)
        _raise_on(err, "fused_hidden", lib)
        _count("fused_sdf_hidden", fw.width)
    return out


def fused_sdf_value(x: torch.Tensor, fw: FusedWeights) -> torch.Tensor:
    """K1 with the positional encoding in its prologue and the sdf column of
    the final linear in its epilogue: points [N, 3] fp32, contiguous -> sdf
    [N] fp32, the sdf of embed_padded(x, fw); in bf16 on the tensor cores
    (TC_WIDTHS), in fp32 on the FMA pipe (FMA_WIDTHS), summed as sdf_column
    sums (`fused_sdf_value_fp32` in LAUNCHES)."""
    _check_points(x, fw, "fused_sdf_value")
    if x.device.type == "cpu":
        return fused_sdf_value_plain(embed_padded(x, fw), fw)
    if fw.dtype == torch.bfloat16:
        _check_tc(x, fw, "fused_sdf_value", points=True)
    else:
        _check_fma(x, fw, "fused_sdf_value", points=True)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    wlast = fw.wlast_col.to(x.device).contiguous()
    lib = _lib()
    desc = (ctypes.c_longlong * len(fw.desc))(*fw.desc)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if fw.dtype == torch.bfloat16:
        err = lib.nefii_sdf_value(
            x.data_ptr(), fw.tc.data_ptr(), fw.buf.data_ptr(), desc, len(fw.layers), fw.x_cols,
            fw.width, fw.multires, wlast.data_ptr(), fw.b_sdf, out.data_ptr(), n,
            _grid(n, x.device, tc_block_rows(fw.width), TC_BLOCKS_PER_SM), stream)
        name = "fused_sdf_value"
    else:
        err = lib.nefii_sdf_value_fp32(
            x.data_ptr(), fw.buf.data_ptr(), desc, len(fw.layers), fw.x_cols, fw.width,
            fw.multires, wlast.data_ptr(), fw.b_sdf, sdf_cols(fw.real_width), out.data_ptr(), n,
            _grid(n, x.device, fma_block_rows(fw.width), FMA_BLOCKS_PER_SM), stream)
        name = "fused_sdf_value_fp32"
    _raise_on(err, "fused_sdf_value", lib)
    _count(name, fw.width)
    return out


def _check_split(x: torch.Tensor, fw: FusedWeights, name: str) -> torch.Tensor:
    """What K2's tensor-core kernel takes beyond _check_cuda: fp32, an
    embedding of at most SPLIT_NX columns, and its split records (packed
    here at the first launch) on the device, whole, contiguous and 16-byte
    aligned (the bulk copies'). -> the records."""
    _check_cuda(x, fw, name, TC_WIDTHS)
    if fw.dtype != torch.float32:
        raise ValueError(f"{name}: the forward+backward kernel is fp32 only")
    if fw.x_cols > SPLIT_NX:
        raise ValueError(f"{name}: the kernel takes at most {SPLIT_NX} embedding columns, "
                         f"this network has {fw.x_cols}")
    rec = split_weights(fw)
    if rec.device != x.device or rec.dtype != torch.bfloat16 \
            or rec.numel() != split_records(fw) * SPLIT_REC:
        raise ValueError(f"{name}: the packed split weights do not match the network")
    if not rec.is_contiguous() or rec.data_ptr() % 16:
        raise ValueError(f"{name}: the packed weights must be contiguous and 16-byte aligned")
    return rec


def fused_fwd_bwd(x: torch.Tensor, fw: FusedWeights):
    """K2: embedded points [N, x_cols] fp32 -> (last hidden [N, width],
    d sdf / d x [N, x_cols]), fp32, on the tensor cores in split bf16
    (TC_WIDTHS)."""
    if x.device.type == "cpu":
        return fused_fwd_bwd_plain(x, fw)
    rec = _check_split(x, fw, "fused_fwd_bwd")
    n = x.shape[0]
    h = torch.empty(n, fw.width, dtype=torch.float32, device=x.device)
    dx = torch.empty(n, fw.x_cols, dtype=torch.float32, device=x.device)
    if n == 0:
        return h, dx
    lib = _lib()
    grid = _grid(n, x.device, TC_BLOCK_ROWS, TC_BLOCKS_PER_SM)
    # s = sigmoid(100 z) of every layer but the last: one slot per resident
    # block, not per row
    sbuf = torch.empty(grid * (len(fw.layers) - 1) * TC_BLOCK_ROWS * fw.width,
                       dtype=torch.float32, device=x.device)
    wlast = fw.wlast_col.to(x.device).contiguous()
    desc = (ctypes.c_longlong * len(fw.desc))(*fw.desc)
    err = lib.nefii_sdf_fwd_bwd(
        x.data_ptr(), rec.data_ptr(), fw.buf.data_ptr(), desc, len(fw.layers), fw.x_cols,
        fw.width, wlast.data_ptr(), h.data_ptr(), dx.data_ptr(), sbuf.data_ptr(),
        rec.numel() // SPLIT_REC, n, grid, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "fused_fwd_bwd", lib)
    _count("fused_sdf_fwd_bwd", fw.width)
    return h, dx


# ---------------------------------------------------------------------------
# network-level closures (counterparts of build_fused_sdf / _feature_grad)
# ---------------------------------------------------------------------------

def network_weights(network, dtype: torch.dtype, widths) -> FusedWeights:
    """prepare_weights(network, dtype) at packing_width(network, widths), the
    width of the kernel compiled for `widths`; kept on the network by (dtype,
    width) and reused while its parameters are the same tensors with no
    in-place write since (their version counters). The model builds its
    closures at every forward; on a frozen geometry they so share one
    packing a dtype and width, K2's and K3's records included."""
    width = packing_width(network, widths)
    key = tuple((p.device, p.data_ptr(), p._version) for p in network.parameters())
    cache = network.__dict__.setdefault("_fused_weights", {})
    if (dtype, width) not in cache or cache[dtype, width][0] != key:
        cache[dtype, width] = (key, prepare_weights(network, dtype, width))
    return cache[dtype, width][1]


def pe_backward(dx_emb: torch.Tensor, pts: torch.Tensor, multires: int) -> torch.Tensor:
    """VJP of the positional encoding: [N, d(1+2m)] cotangent -> [N, d]."""
    d = pts.shape[-1]
    dp = dx_emb[:, :d]
    for k in range(multires):
        f = float(2.0 ** k)
        s = d + 2 * k * d
        c = d + (2 * k + 1) * d
        dp = dp + f * (torch.cos(pts * f) * dx_emb[:, s:s + d]
                       - torch.sin(pts * f) * dx_emb[:, c:c + d])
    return dp


def sdf_cols(k: int) -> int:
    """The columns sdf_column sums k products over: k zero padded to a power
    of two."""
    return 1 << (k - 1).bit_length() if k > 1 else 1


def sdf_column(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h [N,K] . w [K] + b, each row summed in one fixed order (pairwise
    halves of the zero-padded products). A matrix product's kernel, and with
    it its order of summation, may follow the rows' count; here a row's sdf
    does not depend on the other rows of its batch. The FMA K1's sdf entry
    sums in this order."""
    s = h * w
    k = s.shape[1]
    p = sdf_cols(k)
    if p != k:
        s = F.pad(s, (0, p - k))
    while p > 1:
        p //= 2
        s = s[:, :p] + s[:, p:2 * p]
    return s[:, 0] + b


def sdf_closure(fw: FusedWeights):
    """fn(pts [N,3]) -> sdf [N]: one launch of K1 on `fw`, the encoding in
    its prologue and the sdf column in its epilogue (fused_sdf_value, looked
    up at each call). In fp32 the column is summed in sdf_column's fixed
    order, so that a ray's trace does not depend on the rays traced beside it
    (K3's near rays are traced again alone)."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        return fused_sdf_value(pts.float().contiguous(), fw)

    return fn


def build_fused_sdf(network, dtype: torch.dtype = torch.float32):
    """fn(pts [N,3]) -> sdf [N] through K1 (sdf_closure) on the network's
    packed weights: in bf16 at the tensor-core kernel's width, in fp32 at
    the FMA kernel's."""
    widths = TC_WIDTHS if dtype == torch.bfloat16 else FMA_WIDTHS
    return sdf_closure(network_weights(network, dtype, widths))


def build_fused_sdf_feature_grad(network):
    """fn(pts [N,3]) -> (sdf [N], feature [N,F], grad [N,3]), value-only (K2)."""
    assert network.d_out == 1, "the gradient kernel assumes a single sdf output"
    fw = network_weights(network, torch.float32, TC_WIDTHS)

    def fn(pts: torch.Tensor):
        pts = pts.detach()
        h, dx = fused_fwd_bwd(embed_padded(pts, fw), fw)
        h = h[:, :fw.real_width]
        dx = dx[:, :fw.emb_dim]
        fin = h @ fw.w_last + fw.b_last
        feature = h if network.use_last_as_f else fin[:, 1:]
        grad = pe_backward(dx, pts, fw.multires) if fw.multires > 0 else dx[:, :fw.d_in]
        return fin[:, 0], feature, grad

    return fn
