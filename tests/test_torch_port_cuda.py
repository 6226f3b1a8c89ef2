"""The port's CUDA kernels on the card (marked `cuda`; they skip where
torch.cuda.is_available() is False). This file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

Tolerances, kernel against its plain PyTorch version on the same CUDA
tensors: fp32 within 1e-4 absolute (FMA chain vs cuBLAS summation order over
8 layers of 512-long dot products; K2's split bf16 stays within ~1e-5 of the
fp32 chain); bf16 (the tensor-core K1 and its sdf entry) within 1e-2 of the
largest value (one bf16 rounding of h flipped by the order propagates); the
input gradient within 1e-3 of its largest value.

Every kernel (the FMA K1, the tensor-core K1 bf16 and K2, K3) is compiled
for widths 256 and 512 and launches at the packing's width. The FMA K1's sdf
entry sums its own h in fused_mlp.sdf_column's order: it equals sdf_column
of the hidden entry's h bit for bit.
"""

import dataclasses

import pytest
import torch

from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.ops.kernels import fused_mlp as fm

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _flagship():
    _card()
    net = ImplicitNetwork(feature_vector_size=512, dims=(512,) * 8, skip_in=(4,), multires=6,
                          use_last_as_f=True, bias=0.6, device="cuda")
    net.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    pts = torch.randn(5000, 3, generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda") * 0.5
    return net, pts


def _neus():
    """NeuS's 8x256 SDF net (confs/conf_neus.conf) on the card, seeded, and
    5000 points around its init sphere."""
    _card()
    net = ImplicitNetwork(feature_vector_size=256, dims=(256,) * 8, skip_in=(4,), multires=6,
                          bias=0.5, device="cuda")
    net.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    pts = torch.randn(5000, 3, generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda") * 0.5
    return net, pts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@torch.no_grad()
def test_k1_kernel_matches_plain(dtype):
    net, pts = _flagship()
    fw = fm.prepare_weights(net, dtype)
    x = fm.embed_padded(pts, fw)
    fm.reset_launch_counts()
    h = fm.fused_hidden(x, fw).float()
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_hidden" if dtype == torch.float32 else "fused_sdf_hidden_tc"] == 1
    assert sum(v for k, v in fm.LAUNCHES.items() if "@" not in k) == 1
    ref = fm.fused_hidden_plain(x, fw).float()
    bound = 1e-4 if dtype == torch.float32 else 1e-2 * ref.abs().max().item()
    assert (h - ref).abs().max().item() <= bound


@pytest.mark.parametrize("n", [1, 63, 64, 65, 5000, 262_144])
@torch.no_grad()
def test_k2_kernel_matches_plain(n):
    """K2 on the tensor cores in split bf16, at ragged sizes around its
    64-row tile and at 262,144 points, against the fp32 plain version."""
    net, _ = _flagship()
    fw = fm.prepare_weights(net)
    pts = torch.randn(n, 3, generator=torch.Generator(device="cuda").manual_seed(n),
                      device="cuda") * 0.5
    x = fm.embed_padded(pts, fw)
    fm.reset_launch_counts()
    h, dx = fm.fused_fwd_bwd(x, fw)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_fwd_bwd"] == fm.LAUNCHES["fused_sdf_fwd_bwd@512"] == 1
    assert sum(v for k, v in fm.LAUNCHES.items() if "@" not in k) == 1
    h_r, dx_r = fm.fused_fwd_bwd_plain(x, fw)
    assert h.shape == (n, 512) and dx.shape == (n, fw.x_cols)
    assert (h - h_r).abs().max().item() <= 1e-4
    assert (dx - dx_r).abs().max().item() <= 1e-3 * dx_r.abs().max().item()


@torch.no_grad()
def test_wrappers_refuse_what_the_kernels_do_not_take():
    net, pts = _flagship()
    fw = fm.prepare_weights(net)
    x = fm.embed_padded(pts, fw)
    fm.reset_launch_counts()
    assert fm.fused_hidden(x[:0], fw).shape == (0, fw.width)  # N = 0: no launch
    with pytest.raises(ValueError):
        fm.fused_hidden(x[:, :-1], fw)  # wrong width
    with pytest.raises(ValueError):
        fm.fused_hidden(x.to(torch.bfloat16), fw)  # dtype differs from the weights
    with pytest.raises(ValueError):
        fm.fused_hidden(x.t().contiguous().t(), fw)  # not contiguous
    with pytest.raises(ValueError):
        fm.fused_fwd_bwd(fm.embed_padded(pts, fm.prepare_weights(net, torch.bfloat16)),
                         fm.prepare_weights(net, torch.bfloat16))  # K2 is fp32 only
    with pytest.raises(ValueError):
        fm.fused_fwd_bwd(x, dataclasses.replace(fw, split=fm.split_weights(fw)[:-8]))  # cut
    assert fm.fused_sdf_value(x[:0], fw).shape == (0,)  # K1 fp32's sdf entry, N = 0
    with pytest.raises(ValueError):
        fm.fused_sdf_value(x.to(torch.bfloat16), fw)  # dtype differs from the weights
    with pytest.raises(ValueError):
        fm.fused_sdf_value(x[:, :-1], fw)  # wrong width
    assert all(n == 0 for n in fm.LAUNCHES.values())


@pytest.mark.parametrize("n", [1, 63, 64, 65, 5000, 100_000])
@torch.no_grad()
def test_tensor_core_k1_and_sdf_value_match_plain(n):
    """The bf16 tensor-core kernel, both entries, at ragged sizes around its
    64-row tile and at 100,000 points: within 1e-2 of the largest value."""
    net, _ = _flagship()
    fw = fm.prepare_weights(net, torch.bfloat16)
    pts = torch.randn(n, 3, generator=torch.Generator(device="cuda").manual_seed(n),
                      device="cuda") * 0.5
    x = fm.embed_padded(pts, fw)
    fm.reset_launch_counts()
    h = fm.fused_hidden(x, fw).float()
    sdf = fm.fused_sdf_value(x, fw)
    sdf_built = fm.build_fused_sdf(net, torch.bfloat16)(pts)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_hidden_tc"] == 1 and fm.LAUNCHES["fused_sdf_value"] == 2
    assert fm.LAUNCHES["fused_sdf_hidden"] == 0
    ref = fm.fused_hidden_plain(x, fw).float()
    sdf_ref = fm.fused_sdf_value_plain(x, fw)
    assert h.shape == (n, 512) and sdf.shape == (n,) and sdf.dtype == torch.float32
    assert (h - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    for s in (sdf, sdf_built):
        assert (s - sdf_ref).abs().max().item() <= 1e-2 * sdf_ref.abs().max().item()


@torch.no_grad()
def test_tensor_core_wrappers_refuse_what_the_kernel_does_not_take():
    """The tensor-core kernels take widths 256 and 512: a 256-wide packing
    launches their width-256 instantiation, a wider one than 512 (or one
    between) is refused, as are the misaligned, the strided and the fp32
    input; the FMA K1, K2 and K3 take a 256 packing and refuse one of 384."""
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    net, pts = _flagship()
    fw = fm.prepare_weights(net, torch.bfloat16)
    x = fm.embed_padded(pts, fw)

    def net_of(width):
        n = ImplicitNetwork(feature_vector_size=width, dims=(width,) * 4, skip_in=(2,),
                            multires=6, use_last_as_f=True, bias=0.6, device="cuda")
        n.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
        return n

    narrow, wide = net_of(256), net_of(640)
    fw_narrow = fm.prepare_weights(narrow, torch.bfloat16, width=256)
    fw_wide = fm.prepare_weights(wide, torch.bfloat16, fm.packing_width(wide, fm.TC_WIDTHS))
    fw_between = fm.prepare_weights(narrow, torch.bfloat16, width=384)
    assert (fw_narrow.width, fw_wide.width, fw_between.width) == (256, 640, 384)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    misaligned = flat[1:].view(x.shape)  # 2 bytes past a 16-byte boundary
    misaligned.copy_(x)
    fm.reset_launch_counts()
    for fn in (fm.fused_hidden, fm.fused_sdf_value):
        assert fn(x[:0], fw).shape[0] == 0  # N = 0: no launch
        for bad in (fw_wide, fw_between):
            with pytest.raises(ValueError):
                fn(fm.embed_padded(pts, bad), bad)  # no instantiation takes it
        with pytest.raises(ValueError):
            fn(misaligned, fw)
        with pytest.raises(ValueError):
            fn(x.t().contiguous().t(), fw)  # not contiguous
        with pytest.raises(ValueError):
            fn(x.float(), fw)  # an fp32 input to the bf16 kernel
    assert all(n == 0 for n in fm.LAUNCHES.values())
    for fn in (fm.fused_hidden, fm.fused_sdf_value):
        assert fn(fm.embed_padded(pts, fw_narrow), fw_narrow).shape[0] == pts.shape[0]
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_hidden_tc@256"] == fm.LAUNCHES["fused_sdf_value@256"] == 1
    f32_narrow = fm.prepare_weights(narrow, torch.float32, width=256)
    f32_between = fm.prepare_weights(narrow, torch.float32, width=384)
    x32 = fm.embed_padded(pts, f32_narrow)
    rays = _k3_rays(100)
    ft.reset_launch_counts()
    with pytest.raises(ValueError):
        fm.fused_hidden(fm.embed_padded(pts, f32_between), f32_between)  # no FMA K1 at 384
    with pytest.raises(ValueError):
        ft.fused_sphere_trace(*rays, f32_between, RayTracer())  # no K3 at 384
    assert fm.LAUNCHES["fused_sdf_hidden"] == 0 and ft.LAUNCHES["fused_sphere_trace"] == 0
    fm.fused_fwd_bwd(x32, f32_narrow)  # K2 takes it
    fm.fused_hidden(x32, f32_narrow)  # the FMA K1 takes it
    ft._trace_kernel(*rays, f32_narrow, RayTracer())  # K3 takes it
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_fwd_bwd@256"] == fm.LAUNCHES["fused_sdf_hidden@256"] == 1
    assert fm.LAUNCHES["fused_sdf_hidden"] == ft.LAUNCHES["fused_sphere_trace@256"] == 1
    assert ft.LAUNCHES["fused_sphere_trace"] == 1


# the primary tracer's conf and the secondary tracer's (confs/conf.conf:121-127)
@torch.no_grad()
def test_fp32_sdf_closure_rows_do_not_depend_on_the_batch():
    """K1 fp32's sdf entry and its fixed-order sdf column: the sdf of a point
    is the same bit for bit in any batch (of 1, 7, 500 or 777 rows in any
    order), so that K3's near rays, traced again alone, are traced as in the
    whole batch."""
    net, pts = _flagship()
    fn = fm.build_fused_sdf(net, torch.float32)
    full = fn(pts)
    idx = torch.randperm(pts.shape[0], generator=torch.Generator().manual_seed(0))[:777].cuda()
    assert torch.equal(full[idx], fn(pts[idx]))
    for rows in (slice(3, 4), slice(100, 107), slice(4000, 4500)):
        assert torch.equal(full[rows], fn(pts[rows].contiguous()))


FMA_SIZES = (1, 63, 64, 65, 127, 128, 129, 5000, 12_500)


@pytest.mark.parametrize("width", [512, 256])
@pytest.mark.parametrize("n", FMA_SIZES)
@torch.no_grad()
def test_fma_k1_entries_match_plain_and_sdf_column(n, width):
    """K1 fp32's two entries at both widths (the flagship's 8x512, NeuS's
    8x256), at ragged sizes around its 64- and 128-row tiles and at 12,500
    rows (the near re-trace's size): the hidden entry within 1e-4 of the
    plain version, the sdf entry within 1e-4 of its plain version and equal
    bit for bit to sdf_column of the hidden entry's h; each launches once, at
    the packing's width."""
    net, _ = _flagship() if width == 512 else _neus()
    fw = fm.network_weights(net, torch.float32, fm.FMA_WIDTHS)
    assert fw.width == width
    pts = torch.randn(n, 3, generator=torch.Generator(device="cuda").manual_seed(n),
                      device="cuda") * 0.5
    x = fm.embed_padded(pts, fw)
    fm.reset_launch_counts()
    h = fm.fused_hidden(x, fw)
    sdf = fm.fused_sdf_value(x, fw)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_hidden"] == fm.LAUNCHES[f"fused_sdf_hidden@{width}"] == 1
    assert fm.LAUNCHES["fused_sdf_value_fp32"] == fm.LAUNCHES[f"fused_sdf_value_fp32@{width}"] == 1
    assert sum(v for k, v in fm.LAUNCHES.items() if "@" not in k) == 2
    assert h.shape == (n, width) and sdf.shape == (n,) and sdf.dtype == torch.float32
    assert bool(torch.isfinite(h).all() and torch.isfinite(sdf).all())
    assert (h - fm.fused_hidden_plain(x, fw)).abs().max().item() <= 1e-4
    assert (sdf - fm.fused_sdf_value_plain(x, fw)).abs().max().item() <= 1e-4
    assert torch.equal(sdf, fm.sdf_column(h[:, :fw.real_width], fw.w_last[:, 0], fw.b_last[0]))


K3_CONFS = {"primary": dict(line_step_iters=3, sphere_tracing_iters=10),
            "secondary": dict(line_step_iters=0, sphere_tracing_iters=5)}


def _k3_rays(n):
    """n camera rays from (0, 0, -2) in random directions around +z, about
    half of them hitting the flagship init sphere."""
    from nefii_tpu_torch.utils.camera import get_sphere_intersection

    g = torch.Generator(device="cuda").manual_seed(2)
    cam_loc = torch.tensor([[0.0, 0.0, -2.0]], device="cuda")
    dirs = torch.randn(1, n, 3, generator=g, device="cuda") * 0.3
    dirs[..., 2] = 1.0
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    si, mi = get_sphere_intersection(cam_loc, dirs)
    return (cam_loc.expand(n, 3).contiguous(), dirs[0].contiguous(), mi[0],
            si[0, :, 0].contiguous(), si[0, :, 1].contiguous())


@pytest.mark.parametrize("width", [512, 256])
@pytest.mark.parametrize("conf", sorted(K3_CONFS))
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 5000])
@torch.no_grad()
def test_k3_kernel_matches_plain(n, conf, width):
    """K3 (split fp16 on the tensor cores, a pool of 32 live rays a block, its
    near rays traced again in fp32) at ragged sizes around its pool and its
    64-row tile, under both tracer confs, at both widths (the flagship's
    8x512 net; NeuS's 8x256 at 256, one m64n128k16 partial a slice, two
    slices a record): no ray's flags differ from the K1-fp32 trace on the
    same packing, whose arithmetic the re-trace shares; the same per-ray
    results as its fp32 plain version (summation order aside, which the
    5e-5 stop threshold can turn into a flipped convergence), near flags as
    the split-fp16 plain version's (up to 5% of them, at the edge of
    NEAR_DELTA, where the kernel's and the plain version's sums may fall
    either side), and the kernel's evaluation count within 1% of the plain
    version's live queries, the re-trace's added. It launches at the
    packing's width, its re-trace K1 fp32 too."""
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    net, _ = _flagship() if width == 512 else _neus()
    tracer = RayTracer(**K3_CONFS[conf])
    rays = _k3_rays(n)
    fw = fm.network_weights(net, torch.float32, fm.FMA_WIDTHS)
    assert fw.width == width
    fm.reset_launch_counts()
    ft.reset_launch_counts()
    stats = {}
    out = ft.fused_sphere_trace(*rays, fw, tracer, stats=stats)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["fused_sphere_trace"] == ft.LAUNCHES[f"fused_sphere_trace@{width}"] == 1
    retraced = fm.LAUNCHES["fused_sdf_value_fp32"]
    assert retraced == fm.LAUNCHES[f"fused_sdf_value_fp32@{width}"]
    assert (retraced > 0) == (stats["n_near"] > 0) and fm.LAUNCHES["fused_sdf_hidden"] == 0
    k1_unf, k1_hit, k1_err = ft.agreement(out, tracer._sphere_trace(fm.sdf_closure(fw), *rays))
    assert k1_unf == k1_hit == 0 and k1_err <= 1e-4
    ref = ft.fused_sphere_trace_plain(*rays, fw, tracer)
    split_stats = {}
    ft.fused_sphere_trace_plain(*rays, fw, tracer, split=True, stats=split_stats)
    assert stats["n_near"] == int(stats["near"].sum())
    differ = int((stats["near"] != split_stats["near"]).sum())
    assert differ <= 2 + 0.05 * split_stats["n_near"], (differ, split_stats["n_near"])
    agree = out[2] == ref[2]
    assert agree.float().mean().item() >= 0.999
    hit, hit_ref = out[0] < out[1], ref[0] < ref[1]
    if n == 5000:
        assert 0 < int(hit.sum()) < n
    same = agree & (hit == hit_ref)
    assert (out[0] - ref[0])[same].abs().max().item() <= 1e-4
    assert (out[1] - ref[1])[same].abs().max().item() <= 1e-4
    assert abs(stats["evals"] - ref[3]) <= 0.01 * ref[3]
    assert stats["evals"] + stats["retrace_evals"] == out[3]
    assert stats["tiles"] * 64 == stats["evals"] + stats["empty_rows"]


@torch.no_grad()
def test_k3_wrapper_refuses_what_the_kernel_does_not_take():
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    net, _ = _flagship()
    rays = _k3_rays(100)
    tracer = RayTracer()
    fw = fm.prepare_weights(net)
    ft.reset_launch_counts()
    with pytest.raises(ValueError):  # fp32 only
        ft.fused_sphere_trace(*rays, fm.prepare_weights(net, torch.bfloat16), tracer)
    rec, shifts = ft.trace_weights(fw)
    with pytest.raises(ValueError):  # cut split records
        ft.fused_sphere_trace(*rays, dataclasses.replace(fw, trace=(rec[:-8], shifts)), tracer)
    with pytest.raises(ValueError):  # near in fp64
        ft.fused_sphere_trace(*rays[:3], rays[3].double(), rays[4], fw, tracer)
    assert ft.LAUNCHES["fused_sphere_trace"] == 0


@torch.no_grad()
def test_kernels_take_a_256_wide_network():
    """NeuS's 8x256 SDF net (confs/conf_neus.conf) on the card: the closures
    pack it at 256 for every kernel, the FMA K1 and K3 sharing K2's fp32
    packing, and each kernel on it agrees with its plain version as on the
    flagship; nothing launches at 512."""
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    net, pts = _neus()
    fm.reset_launch_counts()
    ft.reset_launch_counts()
    fw = fm.network_weights(net, torch.float32, fm.FMA_WIDTHS)
    assert (fw.width, fw.real_width) == (256, 256)
    x = fm.embed_padded(pts, fw)
    assert (fm.fused_hidden(x, fw) - fm.fused_hidden_plain(x, fw)).abs().max().item() <= 1e-4
    fw2 = fm.network_weights(net, torch.float32, fm.TC_WIDTHS)
    assert fw2 is fw
    x2 = fm.embed_padded(pts, fw2)
    h, dx = fm.fused_fwd_bwd(x2, fw2)
    h_r, dx_r = fm.fused_fwd_bwd_plain(x2, fw2)
    assert h.shape == (5000, 256)
    assert (h - h_r).abs().max().item() <= 1e-4
    assert (dx - dx_r).abs().max().item() <= 1e-3 * dx_r.abs().max().item()
    fw16 = fm.network_weights(net, torch.bfloat16, fm.TC_WIDTHS)
    assert fw16.width == 256
    x16 = fm.embed_padded(pts, fw16)
    for got, ref in ((fm.fused_hidden(x16, fw16), fm.fused_hidden_plain(x16, fw16)),
                     (fm.fused_sdf_value(x16, fw16), fm.fused_sdf_value_plain(x16, fw16))):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max()
    tracer = RayTracer(**K3_CONFS["primary"])
    rays = _k3_rays(5000)
    k1_fp32 = fm.LAUNCHES["fused_sdf_hidden"]
    stats = {}
    out = ft.fused_sphere_trace(*rays, fw, tracer, stats=stats)
    # K3's near rays are traced again through K1 fp32's sdf entry, a launch
    # an iteration
    retraced = fm.LAUNCHES["fused_sdf_value_fp32"]
    assert (retraced > 0) == (stats["n_near"] > 0)
    ref = ft.fused_sphere_trace_plain(*rays, fw, tracer)
    agree = out[2] == ref[2]
    same = agree & ((out[0] < out[1]) == (ref[0] < ref[1]))
    assert agree.float().mean().item() >= 0.999 and 0 < int((ref[0] < ref[1]).sum()) < 5000
    assert (out[0] - ref[0])[same].abs().max().item() <= 1e-4
    assert (out[1] - ref[1])[same].abs().max().item() <= 1e-4
    torch.cuda.synchronize()
    assert k1_fp32 == fm.LAUNCHES["fused_sdf_fwd_bwd@256"] == fm.LAUNCHES["fused_sdf_fwd_bwd"] == 1
    assert fm.LAUNCHES["fused_sdf_hidden_tc@256"] == fm.LAUNCHES["fused_sdf_value@256"] == 1
    assert fm.LAUNCHES["fused_sdf_hidden_tc"] == fm.LAUNCHES["fused_sdf_value"] == 1
    assert fm.LAUNCHES["fused_sdf_hidden@256"] == fm.LAUNCHES["fused_sdf_hidden"] == 1
    assert fm.LAUNCHES["fused_sdf_value_fp32@256"] == fm.LAUNCHES["fused_sdf_value_fp32"]
    assert ft.LAUNCHES["fused_sphere_trace"] == ft.LAUNCHES["fused_sphere_trace@256"] == 1
    assert sum(v for k, v in {**fm.LAUNCHES, **ft.LAUNCHES}.items() if k.endswith("@512")) == 0


@pytest.mark.parametrize("n", [1, 63, 64, 65, 5000, 262_144])
@torch.no_grad()
def test_fma_k1_at_width_256_matches_plain(n):
    """The FMA K1 on NeuS's net at width 256 (128-row block tiles), at ragged
    sizes around its tile and at 262,144 points, against the fp32 plain
    version within 1e-4; it launches its width-256 instantiation, and the
    sdf closure the tracers use on the same packing (its sdf entry) agrees
    too."""
    net, _ = _neus()
    fw = fm.network_weights(net, torch.float32, fm.FMA_WIDTHS)
    assert fw.width == 256 and fm.fma_block_rows(256) == 128
    pts = torch.randn(n, 3, generator=torch.Generator(device="cuda").manual_seed(n),
                      device="cuda") * 0.5
    x = fm.embed_padded(pts, fw)
    fm.reset_launch_counts()
    h = fm.fused_hidden(x, fw)
    sdf = fm.sdf_closure(fw)(pts)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_hidden@256"] == fm.LAUNCHES["fused_sdf_hidden"] == 1
    assert fm.LAUNCHES["fused_sdf_value_fp32@256"] == fm.LAUNCHES["fused_sdf_value_fp32"] == 1
    assert fm.LAUNCHES["fused_sdf_hidden@512"] == fm.LAUNCHES["fused_sdf_value_fp32@512"] == 0
    ref = fm.fused_hidden_plain(x, fw)
    assert h.shape == (n, 256) and bool(torch.isfinite(h).all())
    assert (h - ref).abs().max().item() <= 1e-4
    sdf_ref = (ref @ fw.wlast_col + fw.b_last[0])
    assert (sdf - sdf_ref).abs().max().item() <= 1e-4


def test_two_gloo_ranks_on_one_card_step_as_one_process(tmp_path):
    """A frozen training step (a small net on the kernels: K1 fp32, K2, K3)
    on 2 gloo ranks that share cuda:0, CUDA tensors in every collective,
    against the one-process step on the card: the loss within rel 1e-5,
    every gradient within a relative L2 of 1e-4 (the ranks' sums in another
    order), the gathered secondary hits' masks equal, their points and
    directions and the distilled batch within 1e-6: the bracket of the
    gathered tracer's bisection, which runs as long as the slowest ray of a
    rank's batch. The witness that the batch's size is the cause: rank 0's
    hits equal bit for bit those of one process stepping on rank 0's half
    of the batch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import test_torch_port_dist_ranks as ranks
    from nefii_tpu_torch.config import parse_string
    from nefii_tpu_torch.models.idr import IDRNetwork
    from nefii_tpu_torch.parallel import spmd
    from nefii_tpu_torch.scripts import dryrun_multichip as dm

    conf = dm.SMALL_CONF.replace("use_fused_sdf = False", "use_fused_sdf = True\n"
                                 "    use_fused_trace = True")
    state = IDRNetwork.from_conf(parse_string(conf).get_config("model"), seed=0).state_dict()
    batch, gt = ranks.training_batch()
    steps01 = np.random.default_rng(3).random(16).astype(np.float32)
    job = dict(model_conf=conf, loss_conf=dm.LOSS, state=state, tables=ranks.dir_tables(),
               device="cuda:0", cases={"step": dict(
                   kind="step", batch=batch, gt=gt, freeze_geo=True, steps01=steps01,
                   secondary_limit=3 * 32, k_max=7, num_rays=2)})
    one = ranks.run_cases(job)["step"]
    step = job["cases"]["step"]
    half = ranks.run_cases(dict(job, cases={"half": dict(
        step, batch=spmd.shard_batch(batch, 0, 2), gt=spmd.shard_batch(gt, 0, 2))}))["half"]
    two = ranks.finish_job(ranks.start_job(job, 2, str(tmp_path)))
    pool = two[0]["step"]["pool"]
    n, strategies = pool["secondary_mask"].shape[1] // 2, pool["secondary_mask"].shape[0]
    for k, v in pool.items():
        np.testing.assert_array_equal(v[:, :n], half["pool"][k][:strategies])
    for res in two:
        got = res["step"]
        assert abs(got["terms"]["loss"] - one["terms"]["loss"]) <= 1e-5 * abs(one["terms"]["loss"])
        for k, g in one["grads"].items():
            if np.any(g):
                assert np.linalg.norm(got["grads"][k] - g) <= 1e-4 * np.linalg.norm(g), k
        hit = one["pool"]["secondary_mask"][..., 0]
        np.testing.assert_array_equal(got["pool"]["secondary_mask"], one["pool"]["secondary_mask"])
        np.testing.assert_allclose(got["pool"]["secondary_points"][hit],
                                   one["pool"]["secondary_points"][hit], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["pool"]["secondary_dir"], one["pool"]["secondary_dir"],
                                   rtol=0, atol=1e-6)
        assert got["distilled"]["K"] == one["distilled"]["K"] > 0
        for k in ("points", "ray_dirs"):
            np.testing.assert_allclose(got["distilled"][k], one["distilled"][k], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# host syncs: every sync of the port's hot path lies in a telemetry.host_sync site
# ---------------------------------------------------------------------------

def _host_sync_blocks():
    """{source file: [(first line, last line, site)]} of every `with
    host_sync("<site>")` block in nefii_tpu_torch."""
    import ast
    import os

    import nefii_tpu_torch

    def site(expr):
        f = getattr(expr, "func", None)
        if (isinstance(f, ast.Name) and f.id == "host_sync") or (
                isinstance(f, ast.Attribute) and f.attr == "host_sync"):
            return expr.args[0].value
        return None

    blocks = {}
    root = os.path.dirname(os.path.abspath(nefii_tpu_torch.__file__))
    for d, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(d, name)
                with open(path) as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.With):
                        for item in node.items:
                            if site(item.context_expr):
                                blocks.setdefault(path, []).append(
                                    (node.lineno, node.end_lineno, site(item.context_expr)))
    return root, blocks


def _sync_warnings(fn):
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") -> the Python
    stack of each synchronising call it made."""
    import traceback
    import warnings

    stacks = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stacks.append(traceback.extract_stack()[:-1])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return stacks


def _check_sync_sites(fn, label):
    """Every sync warning raised through nefii_tpu_torch comes from inside a
    host_sync block, and each site raises as many as its counter adds. The
    explicit synchronisations (`step_end`, `view_end`) may raise none:
    whether torch.cuda.synchronize warns depends on the PyTorch version."""
    import os

    from nefii_tpu_torch.utils import telemetry

    root, blocks = _host_sync_blocks()
    before = telemetry.sync_counts()
    stacks = _sync_warnings(fn)
    after = telemetry.sync_counts()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    warned, outside = {}, {}
    for st in stacks:
        frames = [f for f in st if os.path.abspath(f.filename).startswith(root + os.sep)]
        if not frames:
            continue
        inner = [(b - a, site) for f in frames
                 for a, b, site in blocks.get(os.path.abspath(f.filename), ()) if a <= f.lineno <= b]
        if inner:
            site = min(inner)[1]
            warned[site] = warned.get(site, 0) + 1
        else:
            key = f"{os.path.relpath(frames[-1].filename, root)}:{frames[-1].lineno}"
            outside[key] = outside.get(key, 0) + 1
    print(f"[host syncs] {label}: {sum(warned.values()) + sum(outside.values())} sync warnings "
          f"through the port, counters {sum(delta.values())}: {dict(sorted(delta.items()))}; "
          f"warnings by site {dict(sorted(warned.items()))}; outside a site: {outside}",
          flush=True)
    assert not outside, f"{label}: syncs outside a host_sync site: {outside}"
    explicit = ("step_end", "view_end")
    for site in set(delta) | set(warned):
        n = warned.get(site, 0)
        assert n == delta.get(site, 0) or (site in explicit and n == 0), (label, site, n, delta)


@pytest.mark.parametrize("cell", ["nefii", "neus", "neus_k3"])
def test_every_sync_of_a_training_iteration_and_a_render_chunk_is_a_site(cell, tmp_path):
    """One distillation iteration of each training cell's conf at its size
    (2048 px x 64 rays, 1024 hits distilled), after one that warms up, the
    NeuS one also through K3 (`use_fused_trace`), and for the flagship one
    1024-px render chunk at 256 rays a pixel."""
    import os

    import numpy as np

    from nefii_tpu_torch.config import ConfigFactory
    from nefii_tpu_torch.datasets.scene_dataset import SceneDataset
    from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
    from nefii_tpu_torch.parallel import spmd
    from nefii_tpu_torch.scripts.render import OUTPUT_KEYS
    from nefii_tpu_torch.training.trainer import IDRTrainRunner
    from nefii_tpu_torch.utils import general as utils

    _card()
    name, level, gamma, wo_mask = {"nefii": ("conf.conf", 18, 1.0, False),
                                   "neus": ("conf_neus.conf", 15, 2.2, True),
                                   "neus_k3": ("conf_neus.conf", 15, 2.2, True)}[cell]
    conf = ConfigFactory.parse_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "confs", name))
    conf.put("model.use_fused_trace", cell.endswith("_k3"))
    scene = write_sphere_scene(str(tmp_path / "scene"), 2, 512)
    runner = IDRTrainRunner(conf=conf, data_split_dir=scene, freeze_geometry=True,
                            exps_folder_name=str(tmp_path / "exps"), roughness_warmup=5000,
                            secondary_train_interval=10, secondary_batch_size=1024,
                            memory_capacity_level=level, gamma=gamma, wo_mask=wo_mask,
                            device="cuda")
    runner.cur_iter = 5000
    runner._sample_pixels(0)
    distilled = []

    def iteration():
        _, model_input, ground_truth = runner.train_dataset.collate([runner.train_dataset[0]])
        batch = runner._device_inputs(model_input)
        gt = {"rgb": runner._upload(ground_truth["rgb"], np.float32)}
        _, out, finite = runner.train_step(batch, gt, False, False, runner._alpha(), True)
        assert finite
        runner._sync()
        distilled.append(runner._train_with_secondary(out, False, False))
        runner._sync()

    iteration()
    _check_sync_sites(iteration, f"{cell}.train")
    print(f"[host syncs] {cell}.train: {distilled} hits distilled", flush=True)
    if cell != "nefii":
        return
    ds = SceneDataset(1.0, scene, False)
    ds.change_sampling_rays(256, np.random.default_rng(0))
    idx, mi, gt = ds[0]
    _, mi, _ = ds.collate([(idx, mi, gt)])
    chunks = utils.split_input(mi, ds.total_pixels, 1024)
    chunk = dict(chunks[len(chunks) // 2])  # the middle rows: the sphere fills them
    chunk.pop("__valid__")
    batch = {k: torch.as_tensor(np.asarray(v), device="cuda") for k, v in chunk.items()}
    batch["uv"] = batch["uv"].float()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = runner.model.eval()
    with torch.no_grad():
        spmd.eval_forward(model, batch, gen, OUTPUT_KEYS)
        _check_sync_sites(lambda: spmd.eval_forward(model, batch, gen, OUTPUT_KEYS),
                          "nefii.render256 chunk")
