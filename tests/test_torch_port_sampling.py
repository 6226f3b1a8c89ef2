"""The port's MC sampling against the JAX package: the pdfs, the SG light and
the MIS power heuristic on the same directions, and the port's own samplers'
contract (unit directions whose pdf is the strategy's pdf function).

Tolerance: 1e-5 relative (fp32 elementwise math and [N,M] matmuls over 16
lobes; the two sides differ only in rounding order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nefii_tpu.ops import sampling as js
from nefii_tpu_torch.ops import sampling as ts

REL = 1e-5
N, M = 400, 16


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def case():
    rs = np.random.RandomState(0)
    normal = _unit(rs.randn(N, 3)).astype(np.float32)
    view = _unit(normal + 0.8 * rs.randn(N, 3)).astype(np.float32)
    wi = _unit(normal + 0.9 * rs.randn(N, 3)).astype(np.float32)
    rough = rs.uniform(0.1, 0.9, (N, 1)).astype(np.float32)
    lgt = np.concatenate([_unit(rs.randn(M, 3)), rs.uniform(5, 80, (M, 1)),
                          np.abs(rs.randn(M, 3))], axis=1).astype(np.float32)
    return dict(wi=wi, normal=normal, view=view, rough=rough, lgt=lgt)


def _both(fn_name, c):
    args = (c["wi"], c["normal"], c["view"], c["rough"], c["lgt"])
    ref = np.asarray(getattr(js, fn_name)(*(jnp.asarray(a) for a in args)))
    out = getattr(ts, fn_name)(*(torch.from_numpy(a) for a in args)).numpy()
    return out, ref


@pytest.mark.parametrize("fn_name", ["pdf_fn_cos", "pdf_fn_brdf_ggx", "pdf_fn_mix_sg_shared"])
def test_pdfs_match_jax(case, fn_name):
    out, ref = _both(fn_name, case)
    assert out.shape == ref.shape == (N, 1)
    np.testing.assert_allclose(out, ref, rtol=REL, atol=1e-12)


def test_sg_light_and_power_heuristic_match_jax(case):
    ref = np.asarray(js.sg_light_eval(jnp.asarray(case["wi"]), jnp.asarray(case["lgt"])))
    out = ts.sg_light_eval(torch.from_numpy(case["wi"]), torch.from_numpy(case["lgt"])).numpy()
    np.testing.assert_allclose(out, ref, rtol=REL, atol=1e-12)

    pdfs = [_both(f, case) for f in ("pdf_fn_cos", "pdf_fn_brdf_ggx", "pdf_fn_mix_sg_shared")]
    for i in range(3):
        w_ref = np.asarray(js.power_heuristic_list([1] * 3, [jnp.asarray(p[1]) for p in pdfs], i))
        w_out = ts.power_heuristic_list([1] * 3, [torch.from_numpy(p[1].copy()) for p in pdfs], i).numpy()
        np.testing.assert_allclose(w_out, w_ref, rtol=REL, atol=1e-12)


def test_port_samplers_return_unit_wi_with_their_own_pdf(case):
    gen = torch.Generator().manual_seed(0)
    n = torch.from_numpy(case["normal"])
    v = torch.from_numpy(case["view"])
    r = torch.from_numpy(case["rough"])
    lgt = torch.from_numpy(case["lgt"])
    draws = {
        "cos": (ts.cos_sampling(gen, n), ts.pdf_fn_cos),
        "brdf": (ts.brdf_sampling(gen, n, r, v), ts.pdf_fn_brdf_ggx),
        "mix_sg": (ts.mix_sg_sampling_shared(gen, n, lgt), ts.pdf_fn_mix_sg_shared),
    }
    for name, ((wi, pdf), pdf_fn) in draws.items():
        assert wi.shape == (N, 3) and pdf.shape == (N, 1), name
        np.testing.assert_allclose(torch.linalg.norm(wi, dim=-1).numpy(), 1.0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(pdf.numpy(), pdf_fn(wi, n, v, r, lgt).numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=name)
    wi_cos = draws["cos"][0][0]
    assert bool(((wi_cos * n).sum(-1) > -1e-6).all())
    # a generator seeded alike draws alike
    a = ts.cos_sampling(torch.Generator().manual_seed(3), n)[0]
    b = ts.cos_sampling(torch.Generator().manual_seed(3), n)[0]
    assert torch.equal(a, b)
