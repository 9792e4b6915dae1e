"""Spatial partitioning: an image's rows over a space group of ranks
(counterpart of ``orienmask_tpu/parallel/spatial.py``).

The JAX package shards the rows over the ``space`` axis of a ``(data,
space)`` mesh and GSPMD inserts the halo exchanges.  The port runs one
process a device (``parallel/mesh.py``), so the mesh is ranks: rank
``r = d * n_space + s`` holds space index ``s`` of data index ``d``.  The
``n_space`` consecutive ranks of one data index are its *space group*; the
ranks of one space index are a *data group*.

Each rank holds its own rows of the network input (``row_split``: shard
boundaries on multiples of the coarsest stride, 32, so that every strided
layer stays aligned inside its shard; uneven shards allowed, each rank
with its true rows).  Under ``SpaceGroup.active()`` every convolution of
the models (``models/layers.py::conv2d``) pads its shard's rows with its
neighbours' before it runs: ``padding`` rows from above and
``k - padding - stride`` from below, the convolution's own zeros at the
image's edges (-inf for the max pool).  The exchange is one ``all_gather``
of fixed-size boundary slabs over the space group (gloo with CUDA tensors
and NCCL both take it); its backward sends the halo rows' gradients to
their owners, where they are added.  Nearest upsamples, concatenations,
BatchNorm affines and activations are row-local and run as they are;
train-mode BatchNorm sums over every rank with the ranks' counts
(``models/layers.py::sync_batch_norm``).

* Inference: ``spatial_forward`` (the folded forward on the rank's rows,
  the heads gathered so that every rank holds them whole, as JAX's
  ``out_shardings=rep``), ``run_batch_spatial`` (detect replicated, each
  rank's row block of the orientation upsample and of kernel 2's masks,
  gathered), ``InferencePipeline(..., space=...)``.
* Training: ``shard_spatial_batch`` (the rank's image rows; ground truth
  whole) and ``make_train_step(..., space=...)``: the heads gathered with
  a backward that keeps the rank's own rows, the loss whole on every space
  rank with its divisors and logs summed over the data group, the
  gradients over the world.

This module imports nothing of the models at import time:
``models/layers.py`` reads ``active()`` from here.
"""

import contextlib

import torch
import torch.distributed as dist

from ..utils.envs import get_device_rank, get_world_size, initialized

# the coarsest stride of the models: shard boundaries fall on its multiples
ALIGN = 32

_ACTIVE = []  # the SpaceGroup whose context is entered, innermost last


def active():
    """The space group whose ``active()`` context is entered, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def row_split(h, n_space, align=ALIGN):
    """Rows of each of ``n_space`` shards of ``h`` rows, each a multiple of
    ``align``, the first ``(h / align) % n_space`` shards one block taller
    (544 over 2: 288 + 256).  Raises where ``h`` is not a multiple of
    ``align`` or has fewer blocks than shards."""
    if h % align:
        raise ValueError(f"row_split: height {h} is not a multiple of {align}")
    blocks = h // align
    if blocks < n_space:
        raise ValueError(f"row_split: {h} rows hold {blocks} blocks of {align}, fewer than "
                         f"n_space={n_space} shards")
    return [align * (blocks // n_space + (s < blocks % n_space)) for s in range(n_space)]


def _gather(t, group, n):
    """``all_gather`` of ``t`` (made contiguous) over ``group``: n pieces."""
    t = t.contiguous()
    pieces = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(pieces, t, group=group)
    return pieces


def _like(t, x):
    """``t`` in ``x``'s memory format (channels_last on the card)."""
    if x.dim() == 4 and not x.is_contiguous() \
            and x.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


class _Halo(torch.autograd.Function):
    """cat(``up`` rows from the rank above, own rows, ``down`` rows from the
    rank below) along dim 2; ``fill`` past the image's edges."""

    @staticmethod
    def forward(ctx, x, space, up, down, fill):
        ctx.space, ctx.up, ctx.down = space, up, down
        n = x.shape[2]
        slab = torch.cat([x[:, :, :down], x[:, :, n - up:]], 2)
        pieces = _gather(slab, space.space_group, space.n_space)
        s = space.space_index
        b, c, _, w = x.shape
        top = pieces[s - 1][:, :, down:] if s > 0 else x.new_full((b, c, up, w), fill)
        bottom = pieces[s + 1][:, :, :down] if s < space.n_space - 1 \
            else x.new_full((b, c, down, w), fill)
        return _like(torch.cat([top, x, bottom], 2), x)

    @staticmethod
    def backward(ctx, g):
        space, up, down = ctx.space, ctx.up, ctx.down
        n = g.shape[2] - up - down
        slab = torch.cat([g[:, :, :up], g[:, :, up + n:]], 2)
        pieces = _gather(slab, space.space_group, space.n_space)
        s = space.space_index
        own = g[:, :, up:up + n].clone()
        if s < space.n_space - 1:  # the rank below's top halo: my last rows
            own[:, :, n - up:] += pieces[s + 1][:, :, :up]
        if s > 0:  # the rank above's bottom halo: my first rows
            own[:, :, :down] += pieces[s - 1][:, :, up:]
        return own, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """The space group's shards of ``x`` concatenated along ``dim`` (each
    rank's ``rows[r]`` rows; padded to the largest for the collective).
    The backward returns the rank's own rows of the gradient: the loss is
    whole on every space rank, so a sum over the group would count it
    ``n_space`` times."""

    @staticmethod
    def forward(ctx, x, space, rows, dim):
        s = space.space_index
        ctx.dim, ctx.start, ctx.n = dim, sum(rows[:s]), rows[s]
        most = max(rows)
        if x.shape[dim] < most:
            shape = list(x.shape)
            shape[dim] = most - x.shape[dim]
            x_pad = torch.cat([x, x.new_zeros(shape)], dim)
        else:
            x_pad = x
        pieces = _gather(x_pad, space.space_group, space.n_space)
        return _like(torch.cat([p.narrow(dim, 0, r) for p, r in zip(pieces, rows)], dim), x)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


class SpaceGroup:
    """This rank's place in a ``(data, space)`` grid of ranks and the
    process groups of its space group and data group (``spatial_groups``)."""

    def __init__(self, n_space, n_data, rank, space_group, data_group):
        self.n_space, self.n_data, self.rank = n_space, n_data, rank
        self.data_index, self.space_index = divmod(rank, n_space)
        self.space_group, self.data_group = space_group, data_group

    def rows(self, h):
        """(first row, rows) of this rank's shard of ``h`` rows."""
        split = row_split(h, self.n_space)
        s = self.space_index
        return sum(split[:s]), split[s]

    def shard(self, x, dim=2):
        """This rank's rows of ``x`` along ``dim`` (the whole image's rows)."""
        r0, n = self.rows(x.shape[dim])
        return x.narrow(dim, r0, n)

    @contextlib.contextmanager
    def active(self):
        """While entered, the models' convolutions and max pools take their
        halo rows from this group (``models/layers.py::conv2d``)."""
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.pop()

    def halo(self, x, up, down, fill=0.0):
        """``x`` (B, C, h, W), a row shard, with ``up`` rows from the rank
        above and ``down`` from the rank below (``fill`` at the image's
        edges); ``x`` itself where neither is positive."""
        up, down = max(up, 0), max(down, 0)
        if not up and not down:
            return x
        if x.shape[2] < max(up, down):
            raise ValueError(f"halo: a shard of {x.shape[2]} rows cannot give {up} rows up "
                             f"and {down} down")
        return _Halo.apply(x, self, up, down, fill)

    def gather_rows(self, x, full_h, dim=2):
        """The whole image's rows of ``x``, a row shard along ``dim`` at
        the scale where this rank holds ``x.shape[dim]`` of the input's
        ``full_h`` rows; its gradient keeps this rank's own rows."""
        split = row_split(full_h, self.n_space)
        scale_num, scale_den = x.shape[dim], split[self.space_index]
        rows = [r * scale_num // scale_den for r in split]
        return _GatherRows.apply(x, self, rows, dim)


def spatial_groups(n_space, n_data=None):
    """This rank's ``SpaceGroup`` of a world of ``n_data * n_space`` ranks
    (``n_data`` None: the world over ``n_space``): rank
    ``r = d * n_space + s``.  Every rank creates every group, in the same
    order, as ``dist.new_group`` requires; the groups take the default
    group's backend (``parallel/mesh.py::choose_backend``: gloo with CUDA
    tensors where ranks share one card).  Raises, as JAX's
    ``spatial_mesh`` does, where the world is not ``n_data * n_space``."""
    world = get_world_size()
    if n_data is None:
        n_data = world // n_space if n_space and world % n_space == 0 else 0
    if n_space < 1 or n_data < 1 or world != n_data * n_space:
        raise ValueError(f"spatial_groups: need n_data * n_space = {n_data} * {n_space} ranks, "
                         f"the process group has {world}")
    if not initialized():
        return SpaceGroup(n_space, n_data, 0, None, None)
    rank = get_device_rank()
    space_groups = [dist.new_group([d * n_space + s for s in range(n_space)])
                    for d in range(n_data)]
    data_groups = [dist.new_group([d * n_space + s for d in range(n_data)])
                   for s in range(n_space)]
    d, s = divmod(rank, n_space)
    return SpaceGroup(n_space, n_data, rank, space_groups[d], data_groups[s])


def all_reduce_data(tensor, space):
    """The sum of ``tensor`` over ``space``'s data group (one rank of each
    data index), as a new tensor; ``tensor`` itself where that group is
    this rank alone."""
    if space.n_data == 1:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out, group=space.data_group)
    return out


# ----------------------------------------------------------------- inference

def spatial_forward(model, space, dtype=torch.float32):
    """``fn(folded, x) -> three (bbox, orien) NCHW head pairs``: the folded
    forward on this rank's rows of ``x`` (B, 3, H, W), the whole image on
    every rank, under ``space``'s context; the heads gathered over the
    space group, whole on every rank (JAX ``spatial_forward``)."""

    def fn(folded, x):
        h = x.shape[2]
        with space.active():
            predict = model.apply_folded(folded, space.shard(x), dtype)
        return tuple((space.gather_rows(b, h), space.gather_rows(o, h)) for b, o in predict)

    return fn


def run_batch_spatial(postprocess, space, predict):
    """The postprocess with its image-resolution tail row-sharded over
    ``space`` (JAX ``run_batch_spatial``): detect (kernel 1, twice) stays
    replicated on the whole heads; each rank upsamples only its
    ``H / n_space`` output rows (a row slice of the upsample matrix) and
    runs kernel 2 on them at ``row0 = s * H / n_space``, ``coord_h = H``;
    the packed row blocks are gathered.  ``predict``: the whole heads in
    the JAX layout.  Same output contract as ``_run_batch``."""
    pp = postprocess
    n = space.n_space
    if pp.image_h % n:
        raise ValueError(f"run_batch_spatial: image_h={pp.image_h} not divisible by "
                         f"n_space={n}")
    shard_h = pp.image_h // n
    row0 = space.space_index * shard_h
    det = pp._detect([p[0] for p in predict])
    field = pp._upsample_orientation([p[1] for p in predict], rows=(row0, shard_h))
    masks = pp._assemble_masks(field, det["bbox"][..., :4].contiguous(), det["anchor"],
                               det["valid"], coord_h=pp.image_h, row0=row0)
    pieces = _gather(masks, space.space_group, n)
    return {"bbox": det["bbox"], "cls": det["cls"], "mask": torch.cat(pieces, 2),
            "valid": det["valid"]}


# ------------------------------------------------------------------ training

def shard_spatial_batch(batch, space):
    """This rank's train batch: the image's rows of its shard; masks,
    boxes, classes and the rest whole, as JAX keeps them replicated over
    space.  The rank's loader holds its data index's images already
    (``trainer/builder.py``)."""
    out = dict(batch)
    out["image"] = space.shard(torch.as_tensor(batch["image"]), dim=1)  # NHWC
    return out
