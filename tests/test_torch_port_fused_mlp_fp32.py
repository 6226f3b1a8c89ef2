"""K1 fp32's sdf entry (fused_sdf_value on an fp32 packing): its plain
version, the CPU path of the fp32 sdf closure, against the JAX package's
build_fused_sdf in interpret mode, and the properties the FMA kernel's sdf
epilogue keeps on the card: sdf_column of the hidden chain, summed in one
fixed order, so a row's sdf does not depend on its batch.

Tolerance against JAX: 1e-5 absolute, the fp32 reordering of a 512-term sum
(Pallas dots and the final matmul against the plain chain's and the pairwise
sum). Everything else is bit for bit.
"""

import functools
import os
import re

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

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "nefii_tpu_torch", "ops", "kernels", "csrc")
JAX_TOL = 1e-5
N_POINTS = 300

NETS = {
    # confs/conf.conf's implicit net at a small width: 8 layers, skip at 4,
    # multires 6 (x_cols 48)
    "flagship-shaped-8x64": dict(feature_vector_size=64, dims=(64,) * 8, skip_in=(4,),
                                 multires=6, use_last_as_f=True, bias=0.6),
    # confs/conf_neus.conf's implicit net: NeuS's 8x256 SDF net
    "neus-8x256": dict(feature_vector_size=256, dims=(256,) * 8, skip_in=(4,), multires=6,
                       use_last_as_f=False, bias=0.5),
}


def _cfg(name):
    return dict(d_in=3, d_out=1, geometric_init=True, weight_norm=True, **NETS[name])


def _jax_nets(name):
    """The JAX net, its parameters and the port's net on them."""
    jnet = JImplicit(**_cfg(name))
    params = jnet.init_params(jax.random.PRNGKey(0))
    return jnet, params, params_from_jax(ImplicitNetwork(**_cfg(name)), flatten_tree(params))


@functools.lru_cache(maxsize=None)
def _net(name):
    """The port's net alone, seeded (built once a name; no test changes it)."""
    net = ImplicitNetwork(**_cfg(name))
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net


def _pts(n=N_POINTS, seed=4):
    return (np.random.RandomState(seed).randn(n, 3) * 0.5).astype(np.float32)


@pytest.mark.parametrize("name", sorted(NETS))
@torch.no_grad()
def test_fp32_sdf_entry_is_the_sdf_column_of_the_hidden_chain(name):
    """On the CPU the fp32 sdf entry runs its plain version, which is
    sdf_column of the plain hidden chain bit for bit (the kernel's epilogue
    sums h . w_last[:, 0] in that order, zero padded to sdf_cols), and
    launches nothing."""
    net = _net(name)
    fw = fm.prepare_weights(net)
    pts = torch.from_numpy(_pts())
    x = fm.embed_padded(pts, fw)
    want = fm.sdf_column(fm.fused_hidden_plain(x, fw)[:, :fw.real_width],
                         fw.w_last[:, 0], fw.b_last[0])
    fm.reset_launch_counts()
    for got in (fm.fused_sdf_value_plain(x, fw), fm.fused_sdf_value(pts, fw)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert all(n == 0 for n in fm.LAUNCHES.values())
    assert fm.sdf_cols(fw.real_width) == fw.real_width <= fw.width
    assert [fm.sdf_cols(k) for k in (1, 2, 3, 255, 256, 257)] == [1, 2, 4, 256, 256, 512]


@pytest.mark.parametrize("name", sorted(NETS))
@torch.no_grad()
def test_fp32_sdf_entry_matches_pallas(name):
    """The fp32 sdf entry and the fp32 sdf closure against JAX's
    build_fused_sdf(dtype=float32) in interpret mode, within 1e-5."""
    jnet, params, net = _jax_nets(name)
    pts = _pts()
    sdf_j = np.asarray(jfm.build_fused_sdf(jnet, params, tile=128, interpret=True,
                                           dtype=jnp.float32)(pts))
    fw = fm.prepare_weights(net)
    pt = torch.from_numpy(pts)
    value = fm.fused_sdf_value(pt, fw).numpy()
    np.testing.assert_allclose(value, sdf_j, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(fm.sdf_closure(fw)(pt).numpy(), sdf_j, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("name", sorted(NETS))
@torch.no_grad()
def test_fp32_sdf_entry_rows_do_not_depend_on_the_batch(name):
    """A row's sdf is the same bit for bit in batches of 7 and 500 rows as in
    the whole batch, and in a batch of 1 row given its hidden state: K3's
    near rays are traced again alone. (The CPU's matrix product takes
    another path for a single row, so the plain hidden chain of a 1-row
    batch may differ in its last bit; the kernel's rows never do, which
    tests/test_torch_port_cuda.py holds on the card at 1, 7 and 500 rows.)"""
    net = _net(name)
    fw = fm.prepare_weights(net)
    pts = torch.from_numpy(_pts(700, seed=6))
    full = fm.fused_sdf_value(pts, fw)
    for rows in (slice(100, 107), slice(150, 650)):
        assert torch.equal(fm.fused_sdf_value(pts[rows].contiguous(), fw), full[rows])
    h = fm.fused_hidden_plain(fm.embed_padded(pts, fw), fw)[:, :fw.real_width]
    for r in (3, 699):
        assert torch.equal(fm.sdf_column(h[r:r + 1], fw.w_last[:, 0], fw.b_last[0]),
                           full[r:r + 1])


@pytest.mark.parametrize("name", sorted(NETS))
@torch.no_grad()
def test_fp32_sdf_closure_on_the_cpu_is_unchanged(name):
    """On the CPU the fp32 sdf closure, which now calls the sdf entry, gives
    what it gave when it summed the hidden entry's h with sdf_column, bit for
    bit, through build_fused_sdf as through sdf_closure."""
    net = _net(name)
    pts = torch.from_numpy(_pts(seed=8))
    fw = fm.prepare_weights(net)
    h = fm.fused_hidden(fm.embed_padded(pts, fw), fw)[:, :fw.real_width].float()
    before = fm.sdf_column(h, fw.w_last[:, 0], fw.b_last[0])
    assert torch.equal(fm.sdf_closure(fw)(pts), before)
    assert torch.equal(fm.build_fused_sdf(net, torch.float32)(pts), before)


def test_wrapper_constants_match_the_kernel_source():
    """fused_mlp.py's figures of K1 fp32 against csrc/sdf_mlp_fma.cuh: the
    threads a block (256 consumers and a producer warpgroup), the embedding
    columns its x tile holds, the 8x16 register tile of each consumer, hence
    its rows a block tile (64 at 512, 128 at 256), and one block an SM."""
    with open(os.path.join(CSRC, "sdf_mlp_fma.cuh")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("FMA_CONSUMERS") + 128 == fm.FMA_THREADS
    assert const("FMA_MAX_XC") == fm.FMA_MAX_XC
    assert "__launch_bounds__(FMA_THREADS, 1)" in src and fm.FMA_BLOCKS_PER_SM == 1
    tm, tn = const("FMA_TM"), const("FMA_TN")
    for w, rows in ((256, 128), (512, 64)):
        assert fm.fma_block_rows(w) == const("FMA_CONSUMERS") // (w // tn) * tm == rows
    # K1 fp32 takes NeuS's and the flagship's embedding (multires 6: 48 columns)
    net = _net("flagship-shaped-8x64")
    assert fm.prepare_weights(net).x_cols == 48 <= fm.FMA_MAX_XC
