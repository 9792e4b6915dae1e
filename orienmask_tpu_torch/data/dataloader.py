"""Multi-process prefetching data loader (counterpart of
``orienmask_tpu/data/dataloader.py``).

Worker processes take sample indices from a task queue, run
``dataset[idx]`` (load and transform) and send the samples back; the parent
puts them in order and collates batches.  The same as the JAX loader:

* the index order: identity, or ``default_rng(seed * 1_000_003 + epoch)``'s
  permutation when shuffling (``set_epoch``), padded by wrap-around to a
  multiple of ``world_size`` and strided by ``rank``;
* the augmentation seed of each sample, ``(seed * 1_000_003 + epoch * 97 +
  idx) % 2**31``, whichever process loads it;
* ``drop_last``, and ``pad_last``, which wrap-pads the last batch to full
  size and marks the added samples' infos ``_pad``;
* at most ``batch_size + max(1, num_workers) * prefetch_factor`` samples
  dispatched and not yet consumed;
* ``spawn`` workers (the parent holds CUDA and torch thread pools, which a
  ``fork`` would copy mid-flight); a worker that dies makes the next wait
  of ``_RESULT_POLL_S`` raise instead of hanging.

With ``num_workers == 0`` samples load inline.
"""

import multiprocessing as mp
import queue

import numpy as np


def sample_seed(base_seed, epoch, idx):
    return (base_seed * 1_000_003 + epoch * 97 + int(idx)) % (2 ** 31)


def _reseed(dataset, base_seed, epoch, idx):
    transform = getattr(dataset, "transform", None)
    if transform is not None and hasattr(transform, "reseed"):
        transform.reseed(sample_seed(base_seed, epoch, idx))


def _worker_loop(dataset, base_seed, task_q, result_q):
    while True:
        task = task_q.get()
        if task is None:
            break
        gen, job_id, idx, epoch = task
        _reseed(dataset, base_seed, epoch, idx)
        try:
            result_q.put((gen, job_id, dataset[idx], None))
        except Exception as e:  # reported to the parent, which raises it
            result_q.put((gen, job_id, None, repr(e)))


class DataLoader:
    # How long the parent waits for a result before it checks that every
    # worker is alive (a class attribute, so tests can shorten it).
    _RESULT_POLL_S = 30.0

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=0,
                 collate_fn=None, drop_last=False, pad_last=False, seed=0,
                 rank=0, world_size=1, prefetch_factor=2, mp_context="spawn",
                 **unused):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.collate_fn = collate_fn if collate_fn is not None else (lambda b: b)
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.prefetch_factor = prefetch_factor
        self.mp_context = mp_context
        self.max_inflight = batch_size + max(1, num_workers) * prefetch_factor
        self.inflight_peak = 0  # the most samples in flight seen (tests read it)
        self.epoch = 0
        self._workers = []
        self._task_q = None
        self._result_q = None
        # one generation per iteration: results of an iterator abandoned
        # mid-epoch carry an older one and are dropped
        self._gen = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed * 1_000_003 + self.epoch).permutation(n)
        if self.world_size > 1:
            total = int(np.ceil(n / self.world_size)) * self.world_size
            order = np.concatenate([order, order[: total - n]])
            order = order[self.rank::self.world_size]
        return order

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, idx):
        """One sample, inline, with the augmentation seed a worker uses."""
        _reseed(self.dataset, self.seed, self.epoch, idx)
        return self.dataset[int(idx)]

    def _ensure_workers(self):
        if self._workers or self.num_workers == 0:
            return
        ctx = mp.get_context(self.mp_context)
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        for _ in range(self.num_workers):
            p = ctx.Process(target=_worker_loop,
                            args=(self.dataset, self.seed, self._task_q, self._result_q),
                            daemon=True)
            p.start()
            self._workers.append(p)

    def shutdown(self):
        """Stop the workers (each gets a stop task; one still alive after 5 s
        is terminated)."""
        for _ in self._workers:
            self._task_q.put(None)
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._workers = []

    def _sample_stream(self, all_jobs):
        """The samples of ``all_jobs`` (dataset indices), in order."""
        if self.num_workers == 0:
            for idx in all_jobs:
                yield self._fetch(idx)
            return

        self._ensure_workers()
        self._gen += 1
        gen = self._gen
        dispatched = consumed = 0

        def pump():
            nonlocal dispatched
            while dispatched < len(all_jobs) and dispatched - consumed < self.max_inflight:
                self._task_q.put((gen, dispatched, all_jobs[dispatched], self.epoch))
                dispatched += 1
            self.inflight_peak = max(self.inflight_peak, dispatched - consumed)

        pump()
        buf = {}
        for next_job in range(len(all_jobs)):
            while next_job not in buf:
                try:
                    rgen, jid, sample, err = self._result_q.get(timeout=self._RESULT_POLL_S)
                except queue.Empty:
                    dead = [p for p in self._workers if not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"DataLoader worker(s) died: "
                                           f"{[p.exitcode for p in dead]}") from None
                    continue
                if rgen != gen:
                    continue  # left over from an abandoned iterator
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                buf[jid] = sample
            yield buf.pop(next_job)
            consumed += 1
            pump()

    def __iter__(self):
        indices = self._indices()
        batches, pad_counts = [], []
        for i in range(len(self)):
            b = list(indices[i * self.batch_size:(i + 1) * self.batch_size])
            pad = 0
            if self.pad_last and len(b) < self.batch_size:
                pad = self.batch_size - len(b)
                b = b + list(indices[:pad])
            batches.append(b)
            pad_counts.append(pad)

        def finalize(samples, pad):
            if pad:
                for s in samples[len(samples) - pad:]:
                    if "info" in s:
                        s["info"] = dict(s["info"], _pad=True)
            return self.collate_fn(samples)

        stream = self._sample_stream([int(idx) for batch in batches for idx in batch])
        for batch, pad in zip(batches, pad_counts):
            yield finalize([next(stream) for _ in batch], pad)


class AspectRatioGroupedDataloader(DataLoader):
    """Portrait and landscape samples batched apart: each batch holds one
    orientation.  ``len()`` is an upper bound (where the groups close
    depends on the aspect ratios)."""

    def __iter__(self):
        groups = [[], []]
        for sample in self._sample_stream([int(i) for i in self._indices()]):
            h, w = sample["image"].shape[:2]
            groups[0 if h > w else 1].append(sample)
            for g in groups:
                if len(g) >= self.batch_size:
                    yield self.collate_fn(g[: self.batch_size])
                    del g[: self.batch_size]
        leftover = groups[0] + groups[1]
        while leftover and not self.drop_last:
            yield self.collate_fn(leftover[: self.batch_size])
            leftover = leftover[self.batch_size:]
