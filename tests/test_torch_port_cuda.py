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
"""

import dataclasses

import pytest
import torch

from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.ops.kernels import fused_mlp as fm

pytestmark = pytest.mark.cuda


def _flagship():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    net = ImplicitNetwork(feature_vector_size=512, dims=(512,) * 8, skip_in=(4,), multires=6,
                          use_last_as_f=True, bias=0.6, device="cuda")
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
    assert sum(fm.LAUNCHES.values()) == 1
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
    assert fm.LAUNCHES["fused_sdf_fwd_bwd"] == 1 and sum(fm.LAUNCHES.values()) == 1
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
    with pytest.raises(ValueError):
        fm.fused_sdf_value(x, fw)  # the sdf entry is the bf16 tensor-core kernel
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
    net, pts = _flagship()
    fw = fm.prepare_weights(net, torch.bfloat16)
    x = fm.embed_padded(pts, fw)
    narrow = ImplicitNetwork(feature_vector_size=256, dims=(256,) * 4, skip_in=(2,), multires=6,
                             use_last_as_f=True, bias=0.6, device="cuda")
    narrow.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    # a packing at the net's own width (the default on the card pads it to 512)
    fw_narrow = fm.prepare_weights(narrow, torch.bfloat16, width=256)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    misaligned = flat[1:].view(x.shape)  # 2 bytes past a 16-byte boundary
    misaligned.copy_(x)
    fm.reset_launch_counts()
    for fn in (fm.fused_hidden, fm.fused_sdf_value):
        assert fn(x[:0], fw).shape[0] == 0  # N = 0: no launch
        with pytest.raises(ValueError):
            fn(fm.embed_padded(pts, fw_narrow), fw_narrow)  # width 256, not 512
        with pytest.raises(ValueError):
            fn(misaligned, fw)
        with pytest.raises(ValueError):
            fn(x.t().contiguous().t(), fw)  # not contiguous
        with pytest.raises(ValueError):
            fn(x.float(), fw)  # an fp32 input to the bf16 kernel
    assert all(n == 0 for n in fm.LAUNCHES.values())


# the primary tracer's conf and the secondary tracer's (confs/conf.conf:121-127)
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


@pytest.mark.parametrize("conf", sorted(K3_CONFS))
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 5000])
@torch.no_grad()
def test_k3_kernel_matches_plain(n, conf):
    """K3 (split fp16 on the tensor cores, a pool of 32 live rays a block) at
    ragged sizes around its pool and its 64-row tile, under both tracer
    confs: the same per-ray results as its fp32 plain version (summation
    order aside, which the 5e-5 stop threshold can turn into a flipped
    convergence) and an evaluation count within 1% of the plain version's
    live queries."""
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    net, _ = _flagship()
    tracer = RayTracer(**K3_CONFS[conf])
    rays = _k3_rays(n)
    fw = fm.prepare_weights(net)
    ft.reset_launch_counts()
    stats = {}
    out = ft.fused_sphere_trace(*rays, fw, tracer, stats=stats)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["fused_sphere_trace"] == 1
    ref = ft.fused_sphere_trace_plain(*rays, fw, tracer)
    agree = out[2] == ref[2]
    assert agree.float().mean().item() >= 0.999
    hit, hit_ref = out[0] < out[1], ref[0] < ref[1]
    if n == 5000:
        assert 0 < int(hit.sum()) < n
    same = agree & (hit == hit_ref)
    assert (out[0] - ref[0])[same].abs().max().item() <= 1e-4
    assert (out[1] - ref[1])[same].abs().max().item() <= 1e-4
    assert abs(out[3] - ref[3]) <= 0.01 * ref[3]
    assert stats["evals"] == out[3] and stats["tiles"] * 64 == out[3] + stats["empty_rows"]


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
    """NeuS's 8x256 SDF net (confs/conf_neus.conf) on the card: prepare_weights
    pads it to the kernels' one width, and K1 (fp32, bf16 and its sdf entry),
    K2 and K3 on that packing agree with their plain versions as on the
    flagship."""
    from nefii_tpu_torch.ops.kernels import fused_trace as ft
    from nefii_tpu_torch.ops.ray_tracing import RayTracer

    _flagship()  # skips without a card
    net = ImplicitNetwork(feature_vector_size=256, dims=(256,) * 8, skip_in=(4,), multires=6,
                          bias=0.5, device="cuda")
    net.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    pts = torch.randn(5000, 3, generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda") * 0.5
    fm.reset_launch_counts()
    ft.reset_launch_counts()
    fw = fm.prepare_weights(net)
    assert (fw.width, fw.real_width) == (fm.KERNEL_WIDTH, 256)
    x = fm.embed_padded(pts, fw)
    assert (fm.fused_hidden(x, fw) - fm.fused_hidden_plain(x, fw)).abs().max().item() <= 1e-4
    h, dx = fm.fused_fwd_bwd(x, fw)
    h_r, dx_r = fm.fused_fwd_bwd_plain(x, fw)
    assert (h - h_r).abs().max().item() <= 1e-4
    assert (dx - dx_r).abs().max().item() <= 1e-3 * dx_r.abs().max().item()
    fw16 = fm.prepare_weights(net, torch.bfloat16)
    x16 = fm.embed_padded(pts, fw16)
    for got, ref in ((fm.fused_hidden(x16, fw16), fm.fused_hidden_plain(x16, fw16)),
                     (fm.fused_sdf_value(x16, fw16), fm.fused_sdf_value_plain(x16, fw16))):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max()
    tracer = RayTracer(**K3_CONFS["primary"])
    rays = _k3_rays(5000)
    out = ft.fused_sphere_trace(*rays, fw, tracer)
    ref = ft.fused_sphere_trace_plain(*rays, fw, tracer)
    agree = out[2] == ref[2]
    same = agree & ((out[0] < out[1]) == (ref[0] < ref[1]))
    assert agree.float().mean().item() >= 0.999 and 0 < int((ref[0] < ref[1]).sum()) < 5000
    assert (out[0] - ref[0])[same].abs().max().item() <= 1e-4
    assert (out[1] - ref[1])[same].abs().max().item() <= 1e-4
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_sdf_hidden"] == fm.LAUNCHES["fused_sdf_fwd_bwd"] == 1
    assert fm.LAUNCHES["fused_sdf_hidden_tc"] == fm.LAUNCHES["fused_sdf_value"] == 1
    assert ft.LAUNCHES["fused_sphere_trace"] == 1
