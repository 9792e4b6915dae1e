"""The port's ResNet family (``orienmask_tpu_torch/models/resnet.py``)
against the JAX package's ``orienmask_tpu/models/resnet.py``.

One JAX init of each model reaches the port through
``models/convert.py::resnet_from_jax``; a torchvision-layout state dict
(``tests/torch_ref.py::TorchResNet18``) reaches both packages, through
``load_torchvision`` and JAX ``resnet_from_torch``.  Inputs 64², seeded
with numpy.  Tolerances (worst measured in brackets): eval forward in f32
to 1e-4 of each pyramid level's largest value (resnet18 3.5e-7, resnet50
3.1e-7, resnext50_32x4d 3.2e-7: the same convolutions and the same
BatchNorm formula, another summation order); the train-mode step's running
statistics to 1e-5 of their largest value and the features to 1e-4
(3.1e-6, 6.5e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.models import resnet as jax_resnet
from orienmask_tpu.models.layers import default_ctx
from orienmask_tpu_torch.models import load_torchvision, resnet_from_jax
from orienmask_tpu_torch.models import resnet as port_resnet
from torch_ref import TorchResNet18

FACTORIES = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
             "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2"]
FWD_RTOL, STATS_RTOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def _jax_init(name, seed=0, **kw):
    model = getattr(jax_resnet, name)(**kw)
    params, stats = model.init(jax.random.PRNGKey(seed))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return model, host(params), host(stats)


def _perturbed_stats(stats, seed):
    """Running statistics away from (0, 1), so eval mode tests them."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = path[-1].key
        if key == "mean":
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _port(name, params, stats, **kw):
    model = getattr(port_resnet, name)(**kw)
    model.load_state_dict(resnet_from_jax(params, stats), strict=True)
    return model


def _image(seed=0, b=1, size=64):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnext50_32x4d"])
def test_eval_forward_matches_jax(name):
    jm, params, stats = _jax_init(name)
    stats = _perturbed_stats(stats, 1)
    pm = _port(name, params, stats).eval()
    x = _image()
    want, _ = jm.apply(params, stats, jnp.asarray(x), default_ctx())
    with torch.no_grad():
        got = pm(_nchw(x))
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape, level
        assert _rel_max(g.numpy(), w) < FWD_RTOL, (name, level, _rel_max(g.numpy(), w))


def test_torchvision_state_dict_loads_as_jax_converts_it():
    torch.manual_seed(0)
    ref = TorchResNet18().eval()
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(0.5, 1.5)
    sd = dict(ref.state_dict(), **{"fc.weight": torch.zeros(10, 512),
                                   "fc.bias": torch.zeros(10)})
    jm = jax_resnet.resnet18()
    params, stats = jax_resnet.resnet_from_torch(jm, sd)
    pm = load_torchvision(port_resnet.resnet18(), sd).eval()
    x = _image(2)
    want, _ = jm.apply(params, stats, jnp.asarray(x), default_ctx())
    with torch.no_grad():
        got = pm(_nchw(x))
        direct = ref(_nchw(x))
    for g, w, d in zip(got, want, direct):
        assert _rel_max(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) < FWD_RTOL
        assert _rel_max(g.numpy(), d.numpy()) < FWD_RTOL
    for k, t in pm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, sd[k]), k


def test_torchvision_state_dict_is_checked():
    sd = TorchResNet18().state_dict()
    with pytest.raises(KeyError, match="layer4.1.bn2.running_var"):
        load_torchvision(port_resnet.resnet18(),
                         {k: v for k, v in sd.items() if k != "layer4.1.bn2.running_var"})
    with pytest.raises(ValueError, match="conv1.weight has shape"):
        load_torchvision(port_resnet.resnet18(), dict(sd, **{"conv1.weight": torch.zeros(1)}))


def test_pretrained_file_is_read(tmp_path, capsys):
    torch.manual_seed(1)
    ref = TorchResNet18()
    path = tmp_path / "resnet18.pth"
    torch.save({"state_dict": ref.state_dict()}, path)
    pm = port_resnet.resnet18(pretrained=str(path))
    assert torch.equal(pm.layer3[1].conv2.weight, ref.layer3[1].conv2.weight)
    port_resnet.resnet18(pretrained=str(tmp_path / "missing.pth"))
    assert "pretrained file not found, skipping" in capsys.readouterr().out


@pytest.mark.parametrize("name", FACTORIES)
def test_factories_output_channels_match_jax(name):
    want = getattr(jax_resnet, name)()
    got = getattr(port_resnet, name)()
    assert got.get_output_channels() == want.get_output_channels()
    for i in range(1, 5):
        stage = getattr(got, f"layer{i}")
        assert len(stage) == len(want.stages[i - 1])
        assert stage[-1].bn1.num_features == want.stages[i - 1][-1].conv1.cout


def test_train_step_statistics_and_frozen_stages_match_jax():
    """One train-mode forward with ``frozen_stages=2`` (JAX
    ``tests/test_resnet.py:69-86``): the stem's and layer1's statistics
    held, the others updated as JAX updates them, the features as JAX's;
    ``frozen_stages()`` names what the optimizer's mask holds."""
    jm, params, stats = _jax_init("resnet18", frozen_stages=2)
    pm = _port("resnet18", params, stats, frozen_stages=2).train()
    assert pm.frozen_stages() == jm.frozen_stages() == ["stem", "layer1"]
    assert not pm.bn1.training and not pm.layer1[0].bn2.training
    assert pm.layer2[0].bn1.training and pm.layer4[1].downsample is None
    x = _image(3, b=2)
    want, new_stats = jm.apply(params, stats, jnp.asarray(x), default_ctx(train=True))
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    got = pm(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_max(g.detach().numpy(), np.asarray(w).transpose(0, 3, 1, 2)) < FWD_RTOL
    after = pm.state_dict()
    want_sd = resnet_from_jax(params, jax.tree_util.tree_map(np.asarray, new_stats))
    for k, t in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith(("conv1.", "bn1.", "layer1.")):
            assert torch.equal(t, before[k]), k
        elif "running" in k:
            assert not torch.equal(t, before[k]), k
            assert _rel_max(t.numpy(), want_sd[k].numpy()) < STATS_RTOL, k
    frozen = {id(p) for name in pm.frozen_stages() for p in pm.stage_parameters(name)}
    assert frozen == {id(p) for m in (pm.conv1, pm.bn1, pm.layer1) for p in m.parameters()}


def test_batchnorm_eval_runs_every_batchnorm_on_running_statistics():
    jm, params, stats = _jax_init("resnet18", batchnorm_eval=True)
    stats = _perturbed_stats(stats, 4)
    pm = _port("resnet18", params, stats, batchnorm_eval=True).train()
    assert not any(m.training for m in pm.modules() if isinstance(m, torch.nn.BatchNorm2d))
    x = _image(5)
    want, _ = jm.apply(params, stats, jnp.asarray(x), default_ctx(train=True))
    got = pm(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_max(g.detach().numpy(), np.asarray(w).transpose(0, 3, 1, 2)) < FWD_RTOL
