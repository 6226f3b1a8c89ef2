"""The fused SDF-MLP kernels of the PyTorch port: their plain PyTorch
versions (the CPU path, and the reference the CUDA kernels are held against
on the card) against the JAX package's Pallas kernels run in interpret mode,
on the same weights and points.

Tolerances:
  * fp32 sdf and hidden state within 2e-5, sdf-feature within 2e-5, spatial
    gradient within 1e-4: both sides are fp32 and differ in summation order
    (the fp32 network gates of the parity suite);
  * bf16 within 1e-2 relative to the largest value: h is rounded to bf16
    after every layer on both sides, and one rounding flipped by a different
    summation order propagates (the JAX package's bf16 bound,
    fused_mlp.py:177-179).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.models.implicit import ImplicitNetwork as JImplicit
from nefii_tpu.ops.pallas import fused_mlp as jfm
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.utils.checkpoints import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_REL = 1e-2

NETS = {
    "small-4x64": dict(feature_vector_size=64, dims=(64,) * 4, skip_in=(2,), multires=4,
                       use_last_as_f=True, bias=0.6),
    "flagship-8x512": dict(feature_vector_size=512, dims=(512,) * 8, skip_in=(4,), multires=6,
                           use_last_as_f=True, bias=0.6),
    "narrow-no-lastf": dict(feature_vector_size=256, dims=(256,) * 4, skip_in=(2,), multires=4,
                            use_last_as_f=False, bias=0.5),
    "tiny-no-pe": dict(feature_vector_size=64, dims=(64,) * 3, skip_in=(1,), multires=0,
                       use_last_as_f=True, bias=0.5),
}


def _nets(name, seed=0):
    cfg = dict(d_in=3, d_out=1, geometric_init=True, weight_norm=True, **NETS[name])
    jnet = JImplicit(**cfg)
    params = jnet.init_params(jax.random.PRNGKey(seed))
    return jnet, params, params_from_jax(ImplicitNetwork(**cfg), flatten_tree(params))


def _pts(n, seed=1):
    return (np.random.RandomState(seed).randn(n, 3) * 0.5).astype(np.float32)


@pytest.mark.parametrize("name", ["small-4x64", "flagship-8x512"])
def test_k1_plain_matches_pallas_fp32(name):
    jnet, params, net = _nets(name)
    pts = _pts(300)
    width = jnet.dims[-1]
    sdf_j = np.asarray(jfm.build_fused_sdf(jnet, params, tile=128, interpret=True)(pts))
    h_j = np.asarray(jfm.build_fused_hidden(jnet, params, tile=128, interpret=True)(pts))
    np.testing.assert_allclose(sdf_j, np.asarray(jnet.sdf(params, pts)), atol=FP32_TOL)

    fm.reset_launch_counts()
    with torch.no_grad():
        pt = torch.from_numpy(pts)
        sdf_t = fm.build_fused_sdf(net)(pt).numpy()
        fw = fm.prepare_weights(net)
        h_t = fm.fused_hidden(fm.embed_padded(pt, fw), fw).numpy()
    assert all(n == 0 for n in fm.LAUNCHES.values())
    np.testing.assert_allclose(sdf_t, sdf_j, atol=FP32_TOL)
    np.testing.assert_allclose(h_t[:, :width], h_j[:, :width], atol=FP32_TOL)


def test_k1_plain_matches_pallas_bf16():
    jnet, params, net = _nets("flagship-8x512")
    pts = _pts(256)
    sdf_j = np.asarray(jfm.build_fused_sdf(jnet, params, tile=128, interpret=True,
                                           dtype=jnp.bfloat16)(pts))
    h_j = np.asarray(jfm.build_fused_hidden(jnet, params, tile=128, interpret=True,
                                            dtype=jnp.bfloat16)(pts)).astype(np.float32)
    with torch.no_grad():
        pt = torch.from_numpy(pts)
        sdf_t = fm.build_fused_sdf(net, torch.bfloat16)(pt).numpy()
        fw = fm.prepare_weights(net, torch.bfloat16)
        h_t = fm.fused_hidden(fm.embed_padded(pt, fw), fw).float().numpy()
    assert h_t.dtype == np.float32 and fw.buf.dtype == torch.bfloat16
    np.testing.assert_allclose(sdf_t, sdf_j, atol=BF16_REL * np.abs(sdf_j).max())
    np.testing.assert_allclose(h_t[:, :512], h_j[:, :512], atol=BF16_REL * np.abs(h_j).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdf_value_plain_matches_pallas(dtype):
    """The plain sdf path of build_fused_sdf (fused_sdf_value's plain version
    in bf16, the hidden chain and the sdf column in fp32) against the Pallas
    build_fused_sdf in interpret mode: 2e-5 in fp32, 1e-2 of the largest
    value in bf16."""
    jnet, params, net = _nets("flagship-8x512")
    pts = _pts(320, seed=3)
    sdf_j = np.asarray(jfm.build_fused_sdf(jnet, params, tile=128, interpret=True,
                                           dtype=getattr(jnp, dtype))(pts))
    tdtype = getattr(torch, dtype)
    fm.reset_launch_counts()
    with torch.no_grad():
        pt = torch.from_numpy(pts)
        sdf_t = fm.build_fused_sdf(net, tdtype)(pt).numpy()
        fw = fm.prepare_weights(net, tdtype)
        value = fm.fused_sdf_value(fm.embed_padded(pt, fw), fw).numpy()
    assert all(n == 0 for n in fm.LAUNCHES.values())
    assert sdf_t.dtype == value.dtype == np.float32
    tol = FP32_TOL if dtype == "float32" else BF16_REL * np.abs(sdf_j).max()
    np.testing.assert_allclose(sdf_t, sdf_j, atol=tol)
    np.testing.assert_allclose(value, sdf_j, atol=tol)


def test_tensor_core_chunks_pack_every_layer():
    """prepare_weights' bf16 chunks for the tensor-core kernel: the 58
    [512][64] chunks of the flagship net, in layer order (h part, then x
    part), each the transposed, zero-padded, 128-byte swizzled slice of the
    layer's weights; unpacking gives the bf16 weights of the packed buffer
    back exactly."""
    _, _, net = _nets("flagship-8x512")
    fw = fm.prepare_weights(net, torch.bfloat16)
    # fp32 packs no chunks: K2 packs its split records at its first launch
    # (split_weights, test_split_records_pack_both_passes)
    fw32 = fm.prepare_weights(net)
    assert fw32.tc is None and fw32.split is None and fw.split is None
    off = 0
    for L in fw.layers:
        for w, k in ((L.w, L.k_h), (L.wx, L.k_x)):
            if w is None:
                continue
            n = -(-k // fm.TC_K)
            chunks = fw.tc[off:off + n * fw.width * fm.TC_K].view(n, fw.width, fm.TC_K)
            # row r of a chunk holds its 8-element group g at group g ^ (r % 8)
            r = 11
            logical = torch.nn.functional.pad(w.t(), (0, n * fm.TC_K - k))[r, :fm.TC_K]
            for g in range(8):
                assert torch.equal(chunks[0, r, 8 * (g ^ (r % 8)):8 * (g ^ (r % 8)) + 8],
                                   logical[8 * g:8 * g + 8])
            # swizzling twice undoes it: every chunk back to [k, width]
            whole = fm._swizzle128(chunks).permute(1, 0, 2).reshape(fw.width, n * fm.TC_K)
            assert torch.equal(whole[:, :k].t(), w)
            off += n * fw.width * fm.TC_K
    assert off == fw.tc.numel() == 58 * 512 * 64


@pytest.mark.parametrize("name", ["flagship-8x512", "narrow-no-lastf", "tiny-no-pe"])
def test_k2_plain_matches_pallas(name):
    jnet, params, net = _nets(name)
    pts = _pts(300)
    sdf_j, feat_j, grad_j = (np.asarray(a) for a in jfm.build_fused_sdf_feature_grad(
        jnet, params, tile=128, interpret=True)(pts))
    fm.reset_launch_counts()
    with torch.no_grad():
        sdf_t, feat_t, grad_t = (a.numpy() for a in
                                 fm.build_fused_sdf_feature_grad(net)(torch.from_numpy(pts)))
    assert fm.LAUNCHES["fused_sdf_fwd_bwd"] == 0
    np.testing.assert_allclose(sdf_t, sdf_j, atol=FP32_TOL)
    np.testing.assert_allclose(feat_t, feat_j, atol=FP32_TOL)
    np.testing.assert_allclose(grad_t, grad_j, atol=GRAD_TOL)


def _unpack_split(rec, n_pad, group):
    """K2's records of one block -> (hi, lo), each [n_pad, k] bf16 (row i
    holds the K-major data of B row i); the swizzle undoes itself."""
    r = fm._swizzle32(rec.view(-1, 2, group, n_pad, fm.SPLIT_K))

    def whole(t):
        return t.reshape(-1, n_pad, fm.SPLIT_K).permute(1, 0, 2).reshape(n_pad, -1)

    return whole(r[:, 0]), whole(r[:, 1])


def test_split_records_pack_both_passes():
    """split_weights' fp32 records for K2's tensor-core kernel, in the order
    it streams them: per layer the forward B = W^T ([512 out][k in]), then
    from the top layer the backward B = W itself ([k in][512 out], N padded
    to 512, or to 64 with 8 slices a record at layer 0 and the skip layer's x
    part). hi is bf16(w), hi + lo gives w back within 2^-16 relative, the
    padding is zero, the rows are 32-byte swizzled, and the flagship net has
    920 records of 16 KB."""
    _, _, net = _nets("flagship-8x512")
    fw = fm.prepare_weights(net)
    rec = fm.SPLIT_REC
    records = fm.split_weights(fw)
    assert fw.split is records and fm.split_weights(fw) is records  # packed once, kept
    assert records.dtype == torch.bfloat16
    assert records.numel() == fm.split_records(fw) * rec == 920 * rec
    assert fm.prepare_weights(net, torch.bfloat16).tc.numel() == 58 * 512 * 64  # K1's chunks

    # row r of a slice holds its 8-element half h at half h ^ ((r // 4) % 2)
    raw = records[:rec].view(512, 16)  # layer 0's first forward slice, hi
    logical = fw.layers[0].w.t()[:, :16].to(torch.bfloat16)
    for r in (3, 5, 12):
        for h in (0, 1):
            hs = h ^ ((r // 4) % 2)
            assert torch.equal(raw[r, 8 * hs:8 * hs + 8], logical[r, 8 * h:8 * h + 8])

    off = 0

    def check(n_pad, group, ref):
        nonlocal off
        n, k = ref.shape
        n_rec = 2 * (-(-k // 16)) // group
        hi, lo = _unpack_split(records[off:off + n_rec * rec], n_pad, group)
        off += n_rec * rec
        assert hi.shape == (n_pad, -(-k // 16) * 16)
        assert torch.equal(hi[:n, :k], ref.to(torch.bfloat16))
        err = (hi[:n, :k].float() + lo[:n, :k].float() - ref).abs()
        assert bool((err <= 2.0 ** -16 * ref.abs()).all())
        assert not hi[n:].any() and not hi[:, k:].any() and not lo[n:].any()

    for L in fw.layers:
        for w in (L.w, L.wx):
            if w is not None:
                check(512, 1, w.t())
    for l in reversed(range(len(fw.layers))):
        L = fw.layers[l]
        check(512, 1, L.w) if l else check(64, 8, L.w)  # W_l itself, not its transpose
        if L.wx is not None:
            check(64, 8, L.wx)
    assert off == records.numel()


@pytest.mark.parametrize("name", ["flagship-8x512", "narrow-no-lastf", "tiny-no-pe"])
def test_k2_split_arithmetic_matches_pallas(name, monkeypatch):
    """The tensor-core K2's split-bf16 arithmetic (fused_fwd_bwd_split_plain:
    every product a_hi.w_hi + a_lo.w_hi + a_hi.w_lo in fp32) through
    build_fused_sdf_feature_grad against the Pallas K2 in interpret mode,
    under test_k2_plain_matches_pallas's fp32 gates."""
    jnet, params, net = _nets(name)
    pts = _pts(300)
    sdf_j, feat_j, grad_j = (np.asarray(a) for a in jfm.build_fused_sdf_feature_grad(
        jnet, params, tile=128, interpret=True)(pts))
    monkeypatch.setattr(fm, "fused_fwd_bwd", fm.fused_fwd_bwd_split_plain)
    fm.reset_launch_counts()
    with torch.no_grad():
        sdf_t, feat_t, grad_t = (a.numpy() for a in
                                 fm.build_fused_sdf_feature_grad(net)(torch.from_numpy(pts)))
    assert all(n == 0 for n in fm.LAUNCHES.values())
    np.testing.assert_allclose(sdf_t, sdf_j, atol=FP32_TOL)
    np.testing.assert_allclose(feat_t, feat_j, atol=FP32_TOL)
    np.testing.assert_allclose(grad_t, grad_j, atol=GRAD_TOL)


def test_network_weights_pack_once_until_the_parameters_change():
    """The closures' weights (network_weights): one FusedWeights a network and
    dtype, reused while the parameters are unchanged, so K2's records are
    packed once on a frozen geometry; an in-place write to a parameter (a
    checkpoint load, an optimizer step) packs them anew."""
    _, _, net = _nets("small-4x64")
    fw = fm.network_weights(net)
    assert fm.network_weights(net) is fw
    assert fm.network_weights(net, torch.bfloat16) is not fw
    assert fm.network_weights(net, torch.bfloat16) is fm.network_weights(net, torch.bfloat16)
    fm.split_weights(fw)
    assert fm.network_weights(net).split is fw.split
    pts = torch.from_numpy(_pts(50))
    before = fm.build_fused_sdf_feature_grad(net)(pts)[0]
    with torch.no_grad():
        net.layers[0].b.add_(0.25)
    fresh = fm.network_weights(net)
    assert fresh is not fw and fresh.split is None
    assert torch.allclose(fresh.layers[0].b, fw.layers[0].b + 0.25)
    after = fm.build_fused_sdf_feature_grad(net)(pts)[0]
    assert not torch.allclose(after, before)


@pytest.mark.parametrize("name", ["small-4x64", "narrow-no-lastf"])
def test_padding_to_the_kernel_width_changes_no_value(name):
    """A network narrower than the CUDA kernels' one width (NeuS's 8x256)
    runs in them padded to KERNEL_WIDTH, prepare_weights' default on the
    card: the plain versions of K1 (fp32 and bf16), its sdf entry and K2 (fp32
    and split bf16) give on that packing the unpadded packing's values, and
    K2's records are as many as the kernel counts for it."""
    _, _, net = _nets(name)
    pts = torch.from_numpy(_pts(200))
    for dtype in (torch.float32, torch.bfloat16):
        fw = fm.prepare_weights(net, dtype)
        fp = fm.prepare_weights(net, dtype, width=fm.KERNEL_WIDTH)
        assert fp.width == fm.KERNEL_WIDTH > fw.width and fp.real_width == fw.real_width
        x = fm.embed_padded(pts, fw)
        h = fm.fused_hidden_plain(x, fp)
        # the padding units: softplus(0) / 100, which meet zero weights only
        assert torch.equal(h[:, fw.width:], fm._softplus100(torch.zeros(1)).to(dtype).expand(
            h.shape[0], fm.KERNEL_WIDTH - fw.width))
        torch.testing.assert_close(h[:, :fw.width], fm.fused_hidden_plain(x, fw),
                                   atol=1e-6, rtol=0)
        torch.testing.assert_close(fm.fused_sdf_value_plain(x, fp),
                                   fm.fused_sdf_value_plain(x, fw), atol=1e-6, rtol=0)
    fw, fp = fm.prepare_weights(net), fm.prepare_weights(net, width=fm.KERNEL_WIDTH)
    for fn in (fm.fused_fwd_bwd_plain, fm.fused_fwd_bwd_split_plain):
        (h, dx), (hp, dxp) = fn(x.float(), fw), fn(x.float(), fp)
        torch.testing.assert_close(hp[:, :fw.width], h, atol=1e-6, rtol=0)
        torch.testing.assert_close(dxp, dx, atol=1e-6, rtol=0)
    assert fm.split_weights(fp).numel() == fm.split_records(fp) * fm.SPLIT_REC


def test_wrappers_cpu_plain_empty_and_other_devices_raise():
    """CPU tensors take the plain path (no launch, N=0 allowed); a tensor on
    any device other than the CPU must launch the CUDA kernel or raise."""
    _, _, net = _nets("small-4x64")
    fm.reset_launch_counts()
    fw = fm.prepare_weights(net)
    assert fw.x_cols % 16 == 0 and fw.width % 16 == 0
    h = fm.fused_hidden(torch.zeros(0, fw.x_cols), fw)
    h2, dx = fm.fused_fwd_bwd(torch.zeros(0, fw.x_cols), fw)
    assert h.shape == (0, fw.width) and h2.shape == (0, fw.width) and dx.shape == (0, fw.x_cols)
    fw16 = fm.prepare_weights(net, torch.bfloat16)
    assert fm.fused_sdf_value(torch.zeros(0, fw16.x_cols, dtype=torch.bfloat16), fw16).shape == (0,)
    meta = torch.empty(4, fw.x_cols, device="meta")
    with pytest.raises(ValueError):
        fm.fused_hidden(meta, fw)
    with pytest.raises(ValueError):
        fm.fused_fwd_bwd(meta, fw)
    with pytest.raises(ValueError):
        fm.fused_sdf_value(meta.to(torch.bfloat16), fw16)
    assert all(n == 0 for n in fm.LAUNCHES.values())


def test_import_needs_no_nvcc_or_triton():
    """The kernel module imports (and its plain path runs) with no nvcc on
    PATH and no triton package; nothing is built at import time."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from nefii_tpu_torch.ops.kernels import build, fused_mlp as fm\n"
        "from nefii_tpu_torch.models.implicit import ImplicitNetwork\n"
        "net = ImplicitNetwork(feature_vector_size=32, dims=(32, 32), multires=2,"
        " use_last_as_f=True)\n"
        "net.reset_parameters(torch.Generator().manual_seed(0))\n"
        "assert fm.build_fused_sdf(net)(torch.zeros(5, 3)).shape == (5,)\n"
        "assert not build._LIBS and not build.BUILD_LOG\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
