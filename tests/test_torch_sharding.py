"""The port's sharding rules (``repro_torch.models.sharding``) and
production meshes (``repro_torch.launch.mesh``) against the reference's.

``param_spec`` / ``tree_param_specs`` are pure functions of a parameter
tree's names and shapes and a mesh's axis sizes, so the reference's run
here on its abstract (``eval_shape``) parameters and the port's on its
meta ones, for every arch of ``configs/``, both production mesh shapes
and ZeRO-1 off and on: every leaf's spec, entry by entry.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import sharding as jsh
from _torch_threads import one_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import param_structs
from repro_torch.models import sharding as tsh
from repro_torch import tree

#: the production meshes' axis sizes and the reference's MeshAxes
MESHES = {
    "pod1": ({"data": 16, "model": 16}, jsh.MeshAxes(batch=("data",))),
    "pod2": ({"pod": 2, "data": 16, "model": 16},
             jsh.MeshAxes(batch=("pod", "data"))),
}


def _ref_specs(arch, mesh_shape, ax, zero1):
    cfg = j_get_config(arch)
    shapes = jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0)))
    specs = jsh.tree_param_specs(shapes, ax, mesh_shape, zero1=zero1)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(k.key for k in path): spec for path, spec in flat}


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_param_specs_match_reference(arch, mesh, zero1):
    mesh_shape, jax_ax = MESHES[mesh]
    want = _ref_specs(arch, mesh_shape, jax_ax, zero1)
    ax = tsh.MeshAxes(batch=jax_ax.batch)
    params = param_structs(get_config(arch))
    specs = tsh.tree_param_specs(params, ax, mesh_shape, zero1=zero1)
    got = dict(tree.flatten_with_path(specs))
    assert list(got) == list(want)
    for name, spec in got.items():
        assert isinstance(spec, tsh.P)
        assert tuple(spec) == tuple(want[name]), name
        assert repr(spec) == repr(want[name]), name
        # the leaf rule alone agrees too
        shape = tuple(dict(tree.flatten_with_path(params))[name].shape)
        assert tuple(tsh.param_spec(name, shape, ax, mesh_shape, zero1)) == \
            tuple(jsh.param_spec(name, shape, jax_ax, mesh_shape, zero1))


def test_partition_spec_is_a_leaf_with_the_reference_repr():
    spec = tsh.P(("pod", "data"), None, "model")
    assert repr(spec) == repr(jax.sharding.PartitionSpec(("pod", "data"),
                                                         None, "model"))
    assert tree.leaves({"a": spec}) == [spec]
    assert spec == (("pod", "data"), None, "model")
    assert tsh.P("a", None) != tsh.P("a") and len(tsh.P()) == 0


def _cpu_mesh(shape, names):
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [torch.device("cpu")] * arr.size
    return tmesh.DeviceMesh(arr.reshape(shape), names)


@pytest.mark.parametrize("names,want", [
    (("data", "model"), (("data",), "model")),
    (("pod", "data", "model"), (("pod", "data"), "model")),
])
def test_axes_for_mesh_and_ambient_axes(names, want):
    mesh = _cpu_mesh((1,) * len(names), names)
    ax = tsh.axes_for_mesh(mesh)
    assert (ax.batch, ax.model) == want
    assert ax.dp == (want[0] if len(want[0]) > 1 else want[0][0])
    assert tsh.ambient_axes() is None
    with tsh.use_mesh(mesh):
        amb = tsh.ambient_axes()
        assert (amb.batch, amb.model) == want
    assert tsh.ambient_axes() is None
    assert tsh.mesh_shape_dict(mesh) == dict.fromkeys(names, 1)


@pytest.mark.parametrize("names", [("data",), ("model",), ("data_y", "data_z")])
def test_ambient_axes_needs_a_batch_and_a_model_axis(names):
    with _cpu_mesh((1,) * len(names), names):
        assert tsh.ambient_axes() is None


def test_constrain_hints_return_their_input():
    x = torch.arange(12.0).reshape(3, 4)
    with _cpu_mesh((1, 1), ("data", "model")):
        assert tsh.constrain(x, tsh.P("data", None)) is x
        assert tsh.constrain_batch(x, extra_model_dim=1) is x
        assert tsh.constrain_model_dim(x, 1) is x


@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model")),
])
def test_make_production_mesh(multi_pod, shape, names):
    n = int(np.prod(shape))
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                      devices=["meta"] * n)
    assert mesh.devices.shape == shape and mesh.axis_names == names
    assert {d.type for d in mesh.devices.reshape(-1)} == {"meta"}
    assert tsh.mesh_shape_dict(mesh) == dict(zip(names, shape))
    with pytest.raises(ValueError, match="devices?"):
        tmesh.make_production_mesh(multi_pod=multi_pod,
                                   devices=["meta"] * (n - 1))


def test_make_production_mesh_raises_without_enough_cards():
    """Without ``devices=`` it takes visible cards and raises with fewer
    than 256, as ``jax.make_mesh`` raises with too few devices (here there
    is no card at all)."""
    with pytest.raises(ValueError, match="CUDA device"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="CUDA device"):
        tmesh.make_production_mesh(multi_pod=True)
