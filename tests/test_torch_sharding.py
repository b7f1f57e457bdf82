"""The port's sharding rules (``repro_torch.configs.sharding``) against
the reference's ``configs/sharding.py``, on meshes that have only a
shape (no ranks needed: the rules read ``mesh.shape`` and the dim names).

For every architecture at its published size, on the production
meshes, the spec the port gives each of its parameters equals the
reference's ``param_specs`` spec of the counterpart leaf less the
reference's stacked leading dims; and the reference's own tests of the
rules (``tests/test_sharding.py``) run on the port's.
"""
import jax
import pytest

from repro.configs import get_arch as ref_get_arch
from repro.configs import sharding as RSH
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.configs import sharding as SH
from repro_torch.convert import _model


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


POD = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = [(POD, ("data",)), (MULTI, ("pod", "data"))]


def _axsize(mesh, axes):
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _norm(spec) -> tuple:
    """A spec with each one-name tuple as the name (JAX's
    ``PartitionSpec`` keeps ``("data",)`` as ``"data"``)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


_SHAPES: dict = {}


def _ref_shapes(arch):
    if arch not in _SHAPES:
        api = ref_build_model(ref_get_arch(arch))
        _SHAPES[arch] = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
    return _SHAPES[arch]


def _port_specs(arch, mesh, fsdp):
    model = _model(get_arch(arch), "meta")
    return model, SH.param_specs(model, mesh, fsdp=fsdp)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh,fsdp", MESHES, ids=["pod", "multi_pod"])
def test_param_specs_equal_the_reference_leaf_for_leaf(arch, mesh, fsdp):
    """Every parameter's spec equals the reference's for its leaf (the
    name's list indices are the reference's stacked dims, which its spec
    leaves unsharded and the port's tensor does not have)."""
    ref = RSH.param_specs(_ref_shapes(arch), mesh, fsdp=fsdp)
    model, specs = _port_specs(arch, mesh, fsdp)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = ref
        for q in parts:
            if not q.isdigit():
                leaf = leaf[q]
        stacked = sum(q.isdigit() for q in parts)
        want = tuple(leaf) + (None,) * (stacked + p.ndim - len(leaf))
        assert all(a is None for a in want[:stacked]), (name, want)
        assert _norm(specs[name]) == _norm(want[stacked:]), \
            (name, specs[name], want)
        assert isinstance(specs[name], SH.Spec)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh,fsdp", MESHES, ids=["pod", "multi_pod"])
def test_param_specs_divisible(arch, mesh, fsdp):
    model, specs = _port_specs(arch, mesh, fsdp)
    for name, p in model.named_parameters():
        spec = specs[name]
        assert len(spec) == p.ndim, (name, spec)
        for i, axes in enumerate(spec):
            if axes is not None:
                assert p.shape[i] % _axsize(mesh, axes) == 0, \
                    (arch, name, tuple(p.shape), spec)


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v3-671b"])
def test_big_tensors_are_sharded(arch):
    """The big 2D weights must NOT replicate on the pod mesh."""
    model, specs = _port_specs(arch, POD, ("data",))
    for name, p in model.named_parameters():
        if p.numel() < 1_000_000:
            continue
        assert any(a is not None for a in specs[name]), (name, p.shape)


def test_cache_specs_long_context():
    """batch=1 long-context cache shards the sequence axis instead."""
    specs = SH.cache_specs({"k": (32, 1, 524288, 8, 128)}, POD, dp=("data",))
    assert specs["k"][2] in (("data",), "data"), specs["k"]
    specs = SH.cache_specs({"k": (32, 128, 32768, 8, 128)}, POD,
                           dp=("data",))
    assert specs["k"][1] in (("data",), "data")
    want = RSH.cache_specs(
        {"k": jax.ShapeDtypeStruct((32, 1, 524288, 8, 128), "bfloat16")},
        POD, dp=("data",))
    assert _norm(want["k"]) == _norm(SH.cache_specs(
        {"k": (32, 1, 524288, 8, 128)}, POD, dp=("data",))["k"])


@pytest.mark.parametrize("shape", [(8, 16), (3, 16), (16,)])
@pytest.mark.parametrize("mesh,fsdp", MESHES, ids=["pod", "multi_pod"])
def test_batch_specs_equal_the_reference(shape, mesh, fsdp):
    want = RSH.batch_specs({"x": jax.ShapeDtypeStruct(shape, "int32")},
                           mesh, dp=fsdp)["x"]
    got = SH.batch_specs({"x": shape}, mesh, dp=fsdp)["x"]
    assert _norm(got) == _norm(tuple(want)
                               + (None,) * (len(shape) - len(want)))


def test_named_places_pod_major_and_refuses_another_order():
    """``named`` gives each mesh dim ``Shard(d)`` or ``Replicate()``; a
    dim split over ("pod", "data") shards over both, pod-major (the mesh's
    order), and a spec naming them the other way round is refused."""
    from torch.distributed.tensor import Replicate, Shard
    placed = SH.named(MULTI, {"w": SH.Spec(("pod", "data"), "model"),
                              "g": SH.Spec(None)})
    assert placed["w"].placements == (Shard(0), Shard(0), Shard(1))
    assert placed["g"].placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        SH.named(MULTI, SH.Spec(("data", "pod"), None))
