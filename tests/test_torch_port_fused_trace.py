"""K3, the whole-trace kernel: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and the JAX dense tracer, and the
port's RayTracer with and without the K3 hook, on a small geometric-init
SDF net with the same weights and rays.

Gates, those of tests/test_fused_trace.py: distances within 1e-5, unfinished
masks equal, min/max distances exact, and the same executed-evaluation count
as the Pallas kernel at the same tile size (the plain version's tile mode);
the live-query mode (the kernel's count) counts what the port's gathered
tracer counts. The dense tracer sums the MLP in
another order than the fused chain (unpadded weights, one skip matmul); a
ray whose step lands within rounding of the stop threshold can then differ
by a few 1e-5, so the seeded rays keep clear of that boundary, as
tests/test_torch_port_tracer.py's do."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nefii_tpu.models.implicit import ImplicitNetwork as JImplicit
from nefii_tpu.ops.pallas.fused_trace import build_fused_sphere_trace as jbuild
from nefii_tpu.ops.ray_tracing import RayTracer as JRayTracer
from nefii_tpu.utils.camera import get_sphere_intersection
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.models.implicit import ImplicitNetwork
from nefii_tpu_torch.ops.kernels import fused_mlp as fm
from nefii_tpu_torch.ops.kernels import fused_trace as ft
from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.utils.checkpoints import params_from_jax
from test_torch_port_fused_mlp import _unpack_split

ATOL = 1e-5
IMPLICIT = dict(feature_vector_size=8, d_in=3, d_out=1, dims=(32,) * 4, geometric_init=True,
                bias=0.6, skip_in=(2,), weight_norm=True, multires=2)
TRACER = dict(sdf_threshold=5e-5, line_search_step=0.5, line_step_iters=3,
              sphere_tracing_iters=10)


@pytest.fixture(scope="module")
def nets():
    jnet = JImplicit(**IMPLICIT)
    params = jnet.init_params(jax.random.PRNGKey(0))
    return jnet, params, params_from_jax(ImplicitNetwork(**IMPLICIT), flatten_tree(params))


def _rays(n=200, seed=1):
    rs = np.random.RandomState(seed)
    cam_loc = np.array([[0.0, 0.0, 2.5]], np.float32)
    targets = (rs.randn(1, n, 3) * 0.6).astype(np.float32)
    dirs = targets - cam_loc[:, None, :]
    return cam_loc, (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


def _flat(cam_loc, dirs, r=1.0):
    N = dirs.shape[1]
    si, mi = get_sphere_intersection(jnp.asarray(cam_loc), jnp.asarray(dirs), r=r)
    cam = np.broadcast_to(cam_loc[:, None, :], dirs.shape).reshape(N, 3).copy()
    return (cam, dirs.reshape(N, 3), np.asarray(mi).reshape(N),
            np.asarray(si[..., 0]).reshape(N), np.asarray(si[..., 1]).reshape(N))


def _plain(net, args, tile):
    fw = fm.prepare_weights(net)
    with torch.no_grad():
        return ft.fused_sphere_trace_plain(*(torch.from_numpy(np.array(a)) for a in args), fw,
                                           RayTracer(**TRACER), tile=tile)


@pytest.mark.parametrize("tile", [16, 64])
def test_plain_matches_the_pallas_kernel(nets, tile):
    jnet, params, net = nets
    args = _flat(*_rays())
    assert 0 < args[2].sum() < args[2].size  # hits and misses of the bounding sphere
    ref = jbuild(jnet, params, JRayTracer(**TRACER), tile=tile, interpret=True)(
        *(jnp.asarray(a) for a in args))
    acc_s, acc_e, unf, n_evals = _plain(net, args, tile)
    np.testing.assert_allclose(acc_s.numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(acc_e.numpy(), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_array_equal(unf.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(acc_s.numpy() < acc_e.numpy(),
                                  np.asarray(ref[0]) < np.asarray(ref[1]))
    assert n_evals == int(ref[5]) > 0


def test_plain_matches_the_dense_tracer_and_k3_closure(nets):
    """The JAX dense trace, and build_fused_sphere_trace's six outputs."""
    jnet, params, net = nets
    args = _flat(*_rays())
    jt = JRayTracer(**TRACER)
    ref = jt._sphere_trace(lambda x: jnet.sdf(params, x), *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        out = ft.build_fused_sphere_trace(net, RayTracer(**TRACER))(
            *(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    # the live queries: what the port's gathered tracer evaluates on the same rays
    gathered = RayTracer(**TRACER)._sphere_trace(
        net.sdf, *(torch.from_numpy(np.array(a)) for a in args))
    assert out[5] == gathered[3] > 0
    assert ft.LAUNCHES["fused_sphere_trace"] == 0  # CPU tensors: the plain version ran


def test_results_do_not_depend_on_the_tile(nets):
    _, _, net = nets
    args = _flat(*_rays(n=150, seed=3))
    a = _plain(net, args, 16)
    b = _plain(net, args, 150)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    # every executed evaluation of a tile counts its 2 * tile points
    assert a[3] % 32 == 0 and b[3] % 300 == 0 and a[3] > 0


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_ray_tracer_with_and_without_the_k3_hook(nets, training):
    """RayTracer(sphere_trace_fn=K3) against RayTracer alone and against the
    JAX tracer with its own K3 hook, the min-SDF vector injected (steps01 is
    what the JAX tracer draws from its key)."""
    jnet, params, net = nets
    cam_loc, dirs = _rays(n=120, seed=4)
    n = dirs.shape[1]
    obj = np.random.RandomState(5).rand(n) < 0.7  # object-mask conflicts on purpose
    jt = JRayTracer(**TRACER, n_steps=32)
    key = jax.random.PRNGKey(7)
    steps01 = torch.from_numpy(np.asarray(jax.random.uniform(key, (jt.n_steps,))))
    jsdf = lambda x: jnet.sdf(params, x)
    jref = jt(jsdf, jnp.asarray(cam_loc), jnp.asarray(obj), jnp.asarray(dirs), key=key,
              training=training,
              sphere_trace_fn=jbuild(jnet, params, jt, tile=64, interpret=True))
    tracer = RayTracer(**TRACER, n_steps=32)
    inputs = (torch.from_numpy(cam_loc), torch.from_numpy(obj), torch.from_numpy(dirs))
    with torch.no_grad():
        plain = tracer(net.sdf, *inputs, training=training, steps01=steps01)
        hooked = tracer(net.sdf, *inputs, training=training, steps01=steps01,
                        sphere_trace_fn=ft.build_fused_sphere_trace(net, tracer))
    j_mask = np.asarray(jref.object_mask)
    assert 0 < j_mask.sum() < j_mask.size
    for res in (plain, hooked):
        np.testing.assert_array_equal(res.object_mask.numpy(), j_mask)
        np.testing.assert_allclose(res.dists.numpy(), np.asarray(jref.dists), atol=ATOL)
        np.testing.assert_allclose(res.points.numpy(), np.asarray(jref.points), atol=ATOL)
    assert hooked.n_evals > 0 and plain.n_evals > 0


@pytest.mark.parametrize("tile", [16, 64])
def test_live_queries_match_the_tile_mode(nets, tile):
    """The live-query mode (the kernel's) and the Pallas kernel's tile mode give
    the same per-ray results, bit for bit; the live mode evaluates fewer points,
    as many as the port's gathered tracer through the same chain."""
    _, _, net = nets
    args = _flat(*_rays(n=150, seed=3))
    live = _plain(net, args, None)
    tiled = _plain(net, args, tile)
    for x, y in zip(live[:3], tiled[:3]):
        assert torch.equal(x, y)
    fw = fm.prepare_weights(net)
    with torch.no_grad():
        gathered = RayTracer(**TRACER)._sphere_trace(
            lambda p: ft._sdf_plain(p, fw), *(torch.from_numpy(np.array(a)) for a in args))
    assert live[3] == gathered[3] < tiled[3]
    for x, y in zip(live[:3], gathered[:3]):
        assert torch.equal(x, y)


# The kernel's split-fp16 chain (hi.hi + lo.hi + hi.lo, ~22 significand bits
# kept) is as close to the fp32 chain as fp32 sums in another order, so it
# is held to the fp32 gate. The control, K2's split bf16 (~16 bits kept),
# moves the tiny net's trace by a few 1e-5: past the fp32 gate, which is what
# ruled it out for the trace, and within 1e-4
SPLIT_ATOL = {"fp16": ATOL, "bf16": 1e-4}


def _split_bf16_hidden(x, fw):
    """The control's chain: K2's split bf16 against the unscaled weights."""
    xf = x.float()
    h = xf
    for L in fw.layers:
        z = fm._split_mm(h[:, :L.k_h], L.w.float())
        if L.wx is not None:
            z = z + fm._split_mm(xf, L.wx.float())
        h = fm._softplus100(z + L.b.float())
    return h


@pytest.mark.parametrize("split", ["fp16", "bf16"])
def test_split_trace_matches_the_pallas_kernel(nets, split, monkeypatch):
    """The kernel's arithmetic (split=True) against the JAX Pallas kernel in
    interpret mode: the same unfinished masks and hits, distances within
    SPLIT_ATOL; and the split-bf16 control, which the fp32 gate rejects."""
    jnet, params, net = nets
    args = _flat(*_rays())
    ref = jbuild(jnet, params, JRayTracer(**TRACER), tile=64, interpret=True)(
        *(jnp.asarray(a) for a in args))
    if split == "bf16":
        monkeypatch.setattr(ft, "_f16_hidden_plain", _split_bf16_hidden)
    fw = fm.prepare_weights(net)
    with torch.no_grad():
        acc_s, acc_e, unf, n_evals = ft.fused_sphere_trace_plain(
            *(torch.from_numpy(np.array(a)) for a in args), fw, RayTracer(**TRACER), split=True)
    np.testing.assert_array_equal(unf.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(acc_s.numpy() < acc_e.numpy(),
                                  np.asarray(ref[0]) < np.asarray(ref[1]))
    np.testing.assert_allclose(acc_s.numpy(), np.asarray(ref[0]), atol=SPLIT_ATOL[split])
    np.testing.assert_allclose(acc_e.numpy(), np.asarray(ref[1]), atol=SPLIT_ATOL[split])
    err = max(np.abs(acc_s.numpy() - np.asarray(ref[0])).max(),
              np.abs(acc_e.numpy() - np.asarray(ref[1])).max())
    print(f"split {split}: max distance error {err:.3e} against the Pallas kernel")
    if split == "bf16":
        assert err > ATOL
    assert 0 < n_evals < int(ref[5])


@pytest.mark.parametrize("split", [False, True], ids=["fp32", "split_fp16"])
def test_padding_to_the_kernel_width_changes_no_trace(nets, split):
    """K3 on a network narrower than its one width runs on the packing padded
    to KERNEL_WIDTH (prepare_weights' default on the card): the plain
    version, in fp32 and in the kernel's split fp16, traces on it as on the
    unpadded packing, and the records are as many as the kernel counts."""
    _, _, net = nets
    args = [torch.from_numpy(np.array(a)) for a in _flat(*_rays())]
    fw, fp = fm.prepare_weights(net), fm.prepare_weights(net, width=fm.KERNEL_WIDTH)
    assert fp.width == fm.KERNEL_WIDTH > fw.width
    with torch.no_grad():
        ref = ft.fused_sphere_trace_plain(*args, fw, RayTracer(**TRACER), split=split)
        got = ft.fused_sphere_trace_plain(*args, fp, RayTracer(**TRACER), split=split)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), atol=1e-6)
    assert torch.equal(got[2], ref[2]) and got[3] == ref[3]
    rec, n_rec, _ = ft._trace_records(fp, torch.device("cpu"))
    assert n_rec == ft.forward_records(fp) and rec.numel() == n_rec * fm.SPLIT_REC


def test_k3_streams_the_forward_records_in_split_fp16():
    """K3 is told the forward chain's record count, and its records are K2's
    forward records (per layer W^T's k16 slices, hi then lo) of the weights
    scaled by 2^s_l, split in fp16: hi + lo holds 2^s_l W to ~2^-22, and the
    largest scaled weight of a layer lies in [2^13, 2^14)."""
    net = ImplicitNetwork(feature_vector_size=512, dims=(512,) * 8, skip_in=(4,), multires=6,
                          use_last_as_f=True, bias=0.6)
    net.reset_parameters(torch.Generator().manual_seed(0))
    fw = fm.prepare_weights(net)
    rec, n_rec, shifts = ft._trace_records(fw, torch.device("cpu"))
    assert n_rec == ft.forward_records(fw) == 456  # 7.47 MB, K2 streams 920 records
    assert rec.dtype == torch.float16 and rec.numel() == n_rec * fm.SPLIT_REC
    parts = [(w, s) for L, s in zip(fw.layers, shifts) for w in (L.w, L.wx) if w is not None]
    forward = torch.cat([fm.pack_split(w.t() * 2.0 ** s, fw.width, 1, torch.float16)
                         for w, s in parts])
    assert torch.equal(rec, forward)
    off = 0
    for w, s in parts:
        scaled = w.t().float() * 2.0 ** s
        assert 2 ** 13 <= scaled.abs().max() < 2 ** 14
        n = fw.width * w.shape[0]  # hi and lo of every slice of this block
        hi, lo = _unpack_split(rec[off:off + 2 * n], fw.width, 1)
        off += 2 * n
        k = w.shape[0]
        assert (hi.float() + lo.float() - F.pad(scaled, (0, hi.shape[1] - k))).abs().max() \
            <= 2.0 ** -22 * scaled.abs().max()
    assert off == rec.numel()
    with pytest.raises(ValueError):  # a cut packing is refused
        ft._trace_records(dataclasses.replace(fw, trace=(rec[:-8], shifts)),
                          torch.device("cpu"))

