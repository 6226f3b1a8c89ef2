"""Geometry imports from torch checkpoints: the port's import_torch_implicit and
import_torch_idr against the JAX package's on the same state dicts, built and
`torch.save`d here from seeded numpy, and the exp_runner flags that use them.

Cases (every imported parameter bit for bit equal to the JAX package's
import):
  * the reference geometry checkpoint, {"model_state_dict": ...} with
    weight-normed `implicit_network.lin<i>.weight_g/weight_v/bias`;
  * the same with plain `weight` into a conf without weight norm;
  * a NeuS checkpoint's `sdf_network_fine` (no prefix);
  * a whole reference IDRNetwork state dict saved under DDP (`module.`): the
    implicit and rendering `lin<i>` stacks, the material net's Sequential
    Linears (at 0, 2, 4) and its light;
  * `exp_runner --geometry x.pth`, `--pretrain_geometry_path x.pth` and
    `--geometry_neus x.pth` on the CPU, and a `.pth` path that does not exist
    (skipped, as in JAX)."""

import numpy as np
import pytest
import torch

import jax

from nefii_tpu.config import parse_string
from nefii_tpu.models.idr import IDRNetwork as JIDR
from nefii_tpu.utils import checkpoints as jck
from nefii_tpu.utils.checkpoints import flatten_tree
from nefii_tpu_torch.datasets.synthetic import write_sphere_scene
from nefii_tpu_torch.models.idr import IDRNetwork
from nefii_tpu_torch.training import exp_runner
from nefii_tpu_torch.utils import checkpoints as ckpt

from test_idr_forward import SMALL_CONF
from test_torch_port_training import TRAIN_CONF

PLAIN_CONF = SMALL_CONF.replace("skip_in = [2]\n        weight_norm = True",
                                "skip_in = [2]\n        weight_norm = False")


def _models(text):
    conf = parse_string(text).get_config("model")
    jmodel = JIDR.from_conf(conf)
    return jmodel.init_params(jax.random.PRNGKey(0)), IDRNetwork.from_conf(conf, seed=3)


def _linear_state(rs, prefix, layer, weight_norm):
    out, inp = layer.d_out, layer.d_in
    b = torch.from_numpy(rs.randn(out).astype(np.float32))
    if weight_norm:
        return {prefix + "weight_g": torch.from_numpy(rs.rand(out, 1).astype(np.float32) + 0.5),
                prefix + "weight_v": torch.from_numpy(rs.randn(out, inp).astype(np.float32)),
                prefix + "bias": b}
    return {prefix + "weight": torch.from_numpy(rs.randn(out, inp).astype(np.float32)),
            prefix + "bias": b}


def _implicit_state(model, prefix, weight_norm, seed=0):
    rs = np.random.RandomState(seed)
    state = {}
    for i, layer in enumerate(model.implicit_network.layers):
        state.update(_linear_state(rs, f"{prefix}lin{i}.", layer, weight_norm))
    return state


def _assert_same(jparams, model, prefix=""):
    jflat = flatten_tree(jparams)
    port = ckpt.params_to_jax(model)
    keys = [k for k in port if k.startswith(prefix)]
    assert keys and set(keys) == {k for k in jflat if k.startswith(prefix)}
    for k in keys:
        np.testing.assert_array_equal(port[k], np.asarray(jflat[k]), err_msg=k)


@pytest.mark.parametrize("layout", ["weight_norm", "plain", "neus"])
def test_import_torch_implicit_matches_jax(tmp_path, layout):
    params, model = _models(PLAIN_CONF if layout == "plain" else SMALL_CONF)
    prefix, key = ("", "sdf_network_fine") if layout == "neus" else ("implicit_network.",
                                                                   "model_state_dict")
    state = _implicit_state(model, prefix, layout != "plain")
    path = str(tmp_path / "geometry.pth")
    torch.save({key: state, "iter_step": 7}, path)
    before = ckpt.params_to_jax(model)
    jnew = jck.import_torch_implicit(params, path, module_prefix=prefix, state_key=key)
    ckpt.import_torch_implicit(model, path, module_prefix=prefix, state_key=key)
    _assert_same(jnew, model, "implicit_network/")
    for k, v in ckpt.params_to_jax(model).items():  # the rest stays
        if not k.startswith("implicit_network/"):
            np.testing.assert_array_equal(v, before[k], err_msg=k)
    np.testing.assert_array_equal(model.implicit_network.layers[1].b.detach().numpy(),
                                  state[f"{prefix}lin1.bias"].numpy())


def test_import_torch_implicit_refuses_a_layout_the_model_lacks(tmp_path):
    """Plain `weight`s into weight-normed layers: the model's leaves (v, g)
    are missing from the import, which raises."""
    _, model = _models(SMALL_CONF)
    path = str(tmp_path / "plain.pth")
    torch.save({"model_state_dict": _implicit_state(model, "implicit_network.", False)}, path)
    with pytest.raises(KeyError, match="missing"):
        ckpt.import_torch_implicit(model, path)
    torch.save({"model_state_dict": {}}, path)
    with pytest.raises(KeyError, match="lin0"):
        ckpt.import_torch_implicit(model, path)


def test_import_torch_idr_matches_jax():
    """A whole reference IDRNetwork state dict as DDP saves it."""
    params, model = _models(SMALL_CONF)
    rs = np.random.RandomState(1)
    state = _implicit_state(model, "implicit_network.", True)
    for i, layer in enumerate(model.rendering_network.layers):
        state.update(_linear_state(rs, f"rendering_network.lin{i}.", layer, True))
    em = model.envmap_material_network
    for j, layer in enumerate(em.diffuse_albedo_layers):  # Sequential(Linear, ReLU, ...)
        state.update(_linear_state(rs, f"envmap_material_network.diffuse_albedo_layers.{2 * j}.",
                                   layer, False))
    state["envmap_material_network.lgtSGs"] = torch.from_numpy(
        rs.randn(*em.lgtSGs.shape).astype(np.float32))
    state = {"module." + k: v for k, v in state.items()}
    jnew = jck.import_torch_idr(params, state)
    ckpt.import_torch_idr(model, state)
    _assert_same(jnew, model)
    np.testing.assert_array_equal(em.lgtSGs.detach().numpy(),
                                  state["module.envmap_material_network.lgtSGs"].numpy())
    state.pop("module.envmap_material_network.diffuse_albedo_layers.4.weight")
    with pytest.raises(KeyError, match="torch Linears"):
        ckpt.import_torch_idr(model, state)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_imports")
    (d / "train.conf").write_text(TRAIN_CONF)
    return d, write_sphere_scene(str(d / "scene"), n_views=1, res=16)


@pytest.mark.parametrize("flag,prefix,key", [
    ("--geometry", "implicit_network.", "model_state_dict"),
    ("--pretrain_geometry_path", "implicit_network.", "model_state_dict"),
    ("--geometry_neus", "", "sdf_network_fine"),
])
def test_exp_runner_imports_a_torch_geometry(scene, tmp_path, flag, prefix, key):
    d, data = scene
    conf = parse_string(TRAIN_CONF).get_config("model")
    jmodel = JIDR.from_conf(conf)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    path = str(tmp_path / "geometry.pth")
    torch.save({key: _implicit_state(IDRNetwork.from_conf(conf), prefix, True, seed=5)}, path)
    runner = exp_runner.main(["--conf", str(d / "train.conf"), "--data_split_dir", data,
                              "--exps_folder_name", str(tmp_path / "exps"), flag, path,
                              "--max_niter", "-1", "--device", "cpu"])
    assert runner.step_stats == []
    _assert_same(jck.import_torch_implicit(params, path, module_prefix=prefix, state_key=key),
                 runner.model, "implicit_network/")


def test_exp_runner_skips_a_torch_geometry_that_does_not_exist(scene, tmp_path):
    d, data = scene
    argv = ["--conf", str(d / "train.conf"), "--data_split_dir", data, "--max_niter", "-1",
            "--device", "cpu"]
    plain = exp_runner.main(argv + ["--exps_folder_name", str(tmp_path / "a")])
    skipped = exp_runner.main(argv + ["--exps_folder_name", str(tmp_path / "b"), "--geometry",
                                      str(tmp_path / "none.pth"), "--geometry_neus",
                                      str(tmp_path / "none.pth")])
    for (n, p), q in zip(plain.model.named_parameters(), skipped.model.parameters()):
        assert torch.equal(p.detach(), q.detach()), n
