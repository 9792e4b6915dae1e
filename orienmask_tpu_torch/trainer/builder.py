"""Config-driven construction of the trainer and the tester (counterpart of
``orienmask_tpu/trainer/builder.py``).

A config block's ``type`` names a class of the port (``data``, ``ops``,
``optim``); its other keys are the constructor's arguments.  The
optimizer's ``param_groups`` become per-parameter factors of ``SGD``
(``optim/param_groups.py``) and the model's frozen stages its
``freeze_mask``.  What is not ported is refused with a message, never
trained as if unset: spatial training (ROADMAP Queue 1 item 10).  The
port runs one process a device: the JAX package asserts that the mesh
spans ``n_device`` devices, and here the process group must span
``n_device`` ranks (one process and no group: 1), unless
``ORIENMASK_ANY_DEVICES`` is set (then the ranks train at another scale:
the batch is per device).  Each rank's loaders take its share of the data
(the rank split of ``data/dataloader.py``).
"""

import copy
import functools
import os
import random

import numpy as np

from .. import data as data_module
from .. import models as model_module
from .. import optim as optim_module
from ..device import resolve_device
from ..models import init_random, load_pretrained_backbone
from ..ops import loss as loss_module
from ..ops import postprocess as postprocess_module
from ..utils.envs import get_device_rank, get_local_device_count, get_world_size
from .checkpoint import load_checkpoint, load_state, read_checkpoint
from .tester import Tester
from .trainer import Trainer


def _lookup(module, name):
    if not hasattr(module, name):
        raise ValueError(f"{name!r} is not ported yet ({module.__name__} has no such name)")
    return getattr(module, name)


def build(config, module, **kwargs):
    cfg = copy.deepcopy(config)
    return _lookup(module, cfg.pop("type"))(**cfg, **kwargs)


def build_func_partial(config, module, **kwargs):
    cfg = copy.deepcopy(config)
    return functools.partial(_lookup(module, cfg.pop("type")), **cfg, **kwargs)


def build_model(config, ignore_pretrained=False, seed=0):
    """The model of a config block with seeded weights (``init_random``),
    then the DarkNet-53 ``pretrained`` file's unless ``ignore_pretrained``."""
    model = init_random(model_module.build_model(config), seed)
    if config.get("pretrained") and not ignore_pretrained:
        load_pretrained_backbone(model, config["pretrained"])
    return model


def build_postprocess(config, device=None):
    return build(config, postprocess_module, device=device)


def build_loss(config, device=None):
    return build(config, loss_module, device=device)


def build_transform(config):
    cfg = copy.deepcopy(config)
    name = cfg.pop("type")
    transform_class = _lookup(data_module, name)
    if name == "FastCOCOTransform":
        return transform_class(**cfg)
    pipeline = []
    for item in cfg.pop("pipeline"):
        item = dict(item)
        op = item.pop("type")
        if not hasattr(transform_class, op):
            raise ValueError(f"transform step {op!r} is not ported yet")
        pipeline.append(getattr(transform_class, op)(**item))
    return transform_class(pipeline, **cfg)


def build_dataloader(config, seed=0, rank=0, world_size=1):
    cfg = copy.deepcopy(config)
    dataset_cfg = cfg.pop("dataset")
    transform = build_transform(cfg.pop("transform"))
    dataset = build(dict(dataset_cfg, transform=None), data_module)
    dataset.transform = transform
    collate_cfg = cfg.pop("collate", {"type": "collate"})
    collate_kwargs = {"max_instances": cfg.pop("max_instances", 100),
                      "pack_masks": cfg.pop("pack_masks", True)}
    transport = cfg.pop("image_transport", None)
    if transport is not None:
        if collate_cfg.get("type", "collate") != "collate":
            raise ValueError(f"image_transport={transport!r} requires collate type 'collate' "
                             f"(got {collate_cfg.get('type')!r})")
        if transport == "uint8":
            _check_u8_transport_normalize(transform)
        collate_kwargs["image_transport"] = transport
    collate_fn = build_func_partial(collate_cfg, data_module, **collate_kwargs)
    cfg.pop("pin_memory", None)
    # the block's ``type`` is not read: the JAX builder takes DataLoader too
    return data_module.DataLoader(dataset, collate_fn=collate_fn, seed=seed, rank=rank,
                                  world_size=world_size, **cfg)


def _check_u8_transport_normalize(transform):
    """uint8 transport sends ``round(x * 255)``: valid only after a
    Normalize of mean 0 and std 255."""
    for op in getattr(getattr(transform, "pipeline", None), "transforms", []):
        if type(op).__name__ == "Normalize":
            mean = tuple(float(m) for m in np.ravel(op.mean))
            std = tuple(float(v) for v in np.ravel(op.std))
            if any(m != 0.0 for m in mean) or any(v != 255.0 for v in std):
                raise ValueError("image_transport='uint8' requires Normalize(mean=0, "
                                 f"std=255); got mean={mean} std={std}")


def _freeze_mask(model):
    """One bool a parameter of ``model.parameters()`` (True: in a frozen
    backbone stage), or None when no stage is frozen."""
    backbone = model.backbone
    frozen = {id(p) for name in backbone.frozen_stages()
              for p in getattr(backbone, name).parameters()}
    return [id(p) in frozen for p in model.parameters()] if frozen else None


def build_optimizer(config, model):
    """SGD over ``model.parameters()``; ``param_groups`` (a sub-config of
    ``norm_weight_decay``, ``bias_lr_factor`` and ``bias_weight_decay``, the
    base ``weight_decay`` taken from the optimizer's) gives per-parameter lr
    factors and weight decays, and the model's frozen stages the mask."""
    cfg = copy.deepcopy(config)
    if cfg.pop("type") != "SGD":
        raise ValueError("only SGD is shipped")
    groups = cfg.pop("param_groups", None)
    if groups:
        cfg["lr_factors"], cfg["wd_factors"] = optim_module.param_group_factors(
            model, weight_decay=cfg.get("weight_decay", 0.0), **groups)
    return optim_module.SGD(model.parameters(), freeze_mask=_freeze_mask(model), **cfg)


def build_lr_scheduler(config, base_lr):
    return build(config, optim_module, base_lr=base_lr)


def _n_devices(config):
    return config.get("n_device", config.get("n_gpu", 1))


def _scaled_loader_cfg(loader_cfg, n_local_devices):
    """Per-device batch size -> this process's batch (one device a process
    here: ``n_local_devices`` is 1)."""
    cfg = copy.deepcopy(loader_cfg)
    cfg["batch_size"] = cfg["batch_size"] * n_local_devices
    return cfg


def build_trainer(config, resume=None, weights=None, device=None):
    device = resolve_device(device)
    random.seed(config["seed"])
    np.random.seed(config["seed"])
    if int(config.get("n_space", 1)) > 1:
        raise ValueError("n_space > 1 (spatial training) is not ported yet "
                         "(ROADMAP Queue 1 item 10)")
    rank, world_size = get_device_rank(), get_world_size()
    n_cfg = _n_devices(config)
    if not os.environ.get("ORIENMASK_ANY_DEVICES") and world_size != n_cfg:
        raise ValueError(
            f"config n_device={n_cfg} but the process group spans {world_size} device(s), "
            "one a rank (launch --num-processes N); set ORIENMASK_ANY_DEVICES=1 to train "
            "at a different scale (effective batch = batch_size x devices)")

    n_local = get_local_device_count()
    train_loader = build_dataloader(
        dict(_scaled_loader_cfg(config["train_loader"], n_local), drop_last=True),
        seed=config["seed"], rank=rank, world_size=world_size)
    val_loader = build_dataloader(
        dict(_scaled_loader_cfg(config["val_loader"], n_local), pad_last=True),
        seed=config["seed"], rank=rank, world_size=world_size)
    postprocess = build_postprocess(config["postprocess"], device)
    model = build_model(config["model"], bool(resume or weights), seed=config["seed"])
    loss = build_loss(config["loss"], device)
    optimizer = build_optimizer(config["optimizer"], model)
    lr_scheduler = build_lr_scheduler(config["lr_scheduler"], config["optimizer"]["lr"])
    return Trainer(model, loss, optimizer, lr_scheduler, config, train_loader, val_loader,
                   postprocess, device, resume=resume, weights=weights)


def build_tester(config, checkpoint, device=None):
    """The tester of a test config on ``checkpoint``; a ``.ckpt`` that holds
    its train config rebuilds the model that config trained.  With
    ``n_device > 1`` the process group must span that many ranks; each
    rank's loader takes its stride of the set at ``batch_size / n_device``
    (JAX shards each batch of ``batch_size`` over the mesh)."""
    device = resolve_device(device)
    test_config = copy.deepcopy(config)
    n_cfg, world_size = _n_devices(test_config), get_world_size()
    if world_size != n_cfg:
        raise ValueError(f"config n_device={n_cfg} but the process group spans {world_size} "
                         "device(s), one a rank (launch --num-processes N)")
    loader_cfg = test_config["test_loader"]
    if loader_cfg["batch_size"] % n_cfg:
        raise ValueError(f"test batch_size={loader_cfg['batch_size']} not divisible by "
                         f"{n_cfg} devices")
    checkpoint = str(checkpoint)
    model_cfg = test_config["model"]
    if checkpoint.endswith(".pth"):
        model = model_module.build_model(model_cfg)
        load_checkpoint(checkpoint, model)
    else:
        ckpt = read_checkpoint(checkpoint)
        model_cfg = ckpt.get("config", {}).get("model", model_cfg)
        model = model_module.build_model(model_cfg)
        load_state(model, ckpt)
    # the config's batch is the global one (JAX shards it over the mesh)
    test_loader = build_dataloader(
        dict(loader_cfg, batch_size=loader_cfg["batch_size"] // n_cfg, pad_last=True),
        rank=get_device_rank(), world_size=world_size)
    postprocess = build_postprocess(test_config["postprocess"], device)
    return Tester(model, None, postprocess, test_loader, os.path.dirname(checkpoint) or ".",
                  test_config["gt_file"], test_config.get("compute_dtype", "float32"),
                  device=device)
