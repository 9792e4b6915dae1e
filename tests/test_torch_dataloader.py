"""The port's DataLoader (orienmask_tpu_torch/data/dataloader.py and the
builder's build_dataloader) against orienmask_tpu's.

* On an in-memory dataset whose transform draws from the loader's
  per-sample seed: the index order, the batches, each sample's draw,
  ``drop_last``, ``pad_last`` with ``info['_pad']``, ``set_epoch`` and the
  rank/world_size split identical to the JAX loader's.
* On the port's mini dataset at 64², through both builders: the train
  loader's batches (published train transform, packed masks) identical
  but for the images, within 1e-6 (the transform's stated figure); the val
  loader's (uint8 transport, ``pad_last``) identical.
* The worker path: one spawn worker gives the inline path's batches, under
  a deadline of the test's own; a worker that dies, a worker that raises
  and the in-flight bound are checked with threads in the workers' place.
"""

import copy
import queue
import threading

import numpy as np
import pytest
import torch

from orienmask_tpu.data.dataloader import AspectRatioGroupedDataloader as JaxGroupedLoader
from orienmask_tpu.data.dataloader import DataLoader as JaxDataLoader
from orienmask_tpu.trainer.builder import build_dataloader as jax_build_dataloader
from orienmask_tpu_torch.data import dataloader
from orienmask_tpu_torch.data.dataloader import AspectRatioGroupedDataloader, DataLoader
from orienmask_tpu_torch.trainer.builder import build_dataloader
from orienmask_tpu_torch.utils.mini_dataset import mini_config, write_mini_dataset

WORKER_DEADLINE_S = 120


class _Draw:
    def __init__(self):
        self.rng = np.random.default_rng()

    def reseed(self, seed):
        self.rng = np.random.default_rng(seed)


class _Toy:
    """Samples ``{'idx', 'draw', 'image', 'info'}``; odd samples portrait."""

    def __init__(self, n):
        self.n = n
        self.transform = _Draw()

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        shape = (3, 2) if idx % 2 else (2, 3)
        return {"idx": idx, "draw": self.transform.rng.random(), "image": np.zeros(shape),
                "info": {"id": idx}}


def _strip(batches):
    return [[{k: v for k, v in s.items() if k != "image"} for s in b] for b in batches]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("epoch", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last,pad_last,world_size,rank", [
    (False, False, False, 1, 0), (True, False, True, 1, 0), (True, True, False, 1, 0),
    (True, False, True, 3, 1), (True, False, False, 3, 2), (False, True, False, 2, 1),
])
def test_batches_match_jax(shuffle, drop_last, pad_last, world_size, rank, epoch):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, pad_last=pad_last,
              seed=5, rank=rank, world_size=world_size)
    got, want = DataLoader(_Toy(11), **kw), JaxDataLoader(_Toy(11), **kw)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got._indices(), want._indices())
    assert _strip(list(got)) == _strip(list(want))


def test_grouped_batches_match_jax():
    kw = dict(batch_size=3, shuffle=True, seed=1)
    got, want = AspectRatioGroupedDataloader(_Toy(10), **kw), JaxGroupedLoader(_Toy(10), **kw)
    assert _strip(list(got)) == _strip(list(want))
    batches = _strip(list(got))  # 5 of each: one full batch each, then the leftovers
    assert [len({s["idx"] % 2 for s in b}) for b in batches] == [1, 1, 2, 1]


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini")
    paths = write_mini_dataset(root, 8, ((48, 64), (43, 61)), seed=0)
    loader = {"batch_size": 3, "num_workers": 0, "max_instances": 6}
    return mini_config(paths, root / "runs", size=64, train_loader=loader,
                       val_loader=dict(loader, image_transport="uint8"))


def _assert_batches_equal(got, want, image_atol):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), b
        for key in g:
            if key == "info":
                assert g[key] == w[key], b
            elif key == "image" and image_atol:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=image_atol)
            else:
                assert g[key].dtype == w[key].dtype, (b, key)
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"batch {b}: {key}")


def test_train_loader_matches_jax(config):
    cfg = dict(config["train_loader"], drop_last=True)
    got, want = build_dataloader(cfg, seed=0), jax_build_dataloader(cfg, seed=0)
    for epoch in (1, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        _assert_batches_equal(list(got), list(want), 1e-6)
    assert got.batch_size == 3 and len(got) == 2


def test_val_loader_matches_jax(config):
    cfg = dict(config["val_loader"], pad_last=True)
    got, want = list(build_dataloader(cfg)), list(jax_build_dataloader(cfg))
    _assert_batches_equal(got, want, 0)
    assert got[0]["image"].dtype == np.uint8 and got[-1]["info"][-1]["_pad"]


def test_uint8_transport_needs_normalize_by_255(config):
    cfg = copy.deepcopy(config["val_loader"])
    cfg["transform"]["pipeline"][-1]["std"] = (1, 1, 1)
    with pytest.raises(ValueError, match="requires Normalize"):
        build_dataloader(cfg)


def test_one_spawn_worker_matches_inline(config):
    """The only test that starts a worker process: one, spawned.  The
    batches go through a thread joined with a deadline; past it the worker
    is killed and the test fails."""
    inline = list(build_dataloader(dict(config["train_loader"], drop_last=True)))
    loader = build_dataloader(dict(config["train_loader"], drop_last=True, num_workers=1))
    out = {}

    def consume():
        try:
            out["batches"] = list(loader)
        except BaseException as e:  # reported below
            out["error"] = e

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    thread.join(WORKER_DEADLINE_S)
    workers = list(loader._workers)
    try:
        if thread.is_alive():
            for p in workers:
                p.kill()
            pytest.fail(f"the worker's epoch took over {WORKER_DEADLINE_S} s")
    finally:
        loader.shutdown()
    assert "error" not in out, out.get("error")
    assert len(workers) == 1 and not any(p.is_alive() for p in workers)
    _assert_batches_equal(out["batches"], inline, 0)


class _ThreadContext:
    """Threads in place of worker processes."""
    Queue = queue.Queue

    class Process(threading.Thread):
        exitcode = None

        def terminate(self):
            pass


class _Dead(_ThreadContext.Process):
    exitcode = -9

    def run(self):
        pass


class _Failing(_Toy):
    def __getitem__(self, idx):
        if idx == 3:
            raise KeyError("no such image")
        return super().__getitem__(idx)


def _thread_loader(monkeypatch, dataset, **kw):
    monkeypatch.setattr(dataloader.mp, "get_context", lambda _: _ThreadContext)
    return DataLoader(dataset, **kw)


def test_workers_keep_the_inflight_bound(monkeypatch):
    loader = _thread_loader(monkeypatch, _Toy(23), batch_size=4, num_workers=2, shuffle=True,
                            prefetch_factor=1)
    try:
        got = _strip(list(loader))
    finally:
        loader.shutdown()
    assert got == _strip(list(DataLoader(_Toy(23), batch_size=4, shuffle=True)))
    assert loader.max_inflight == 6 and 0 < loader.inflight_peak <= 6


def test_a_dead_worker_raises(monkeypatch):
    monkeypatch.setattr(_ThreadContext, "Process", _Dead)
    monkeypatch.setattr(DataLoader, "_RESULT_POLL_S", 0.05)
    loader = _thread_loader(monkeypatch, _Toy(8), batch_size=4, num_workers=1)
    with pytest.raises(RuntimeError, match=r"worker\(s\) died: \[-9\]"):
        list(loader)


def test_a_worker_error_raises(monkeypatch):
    loader = _thread_loader(monkeypatch, _Failing(8), batch_size=4, num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="worker failed: KeyError"):
            list(loader)
    finally:
        loader.shutdown()
