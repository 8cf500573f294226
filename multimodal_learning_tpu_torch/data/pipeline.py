"""Host input pipeline: decode + crop in worker threads, device prefetch.

Port of ``multimodal_learning_tpu/data/pipeline.py`` (reference
``torch.utils.data.DataLoader(num_workers=4)``, ``data_loaders_MT.py:
47-77``).  ``PathomicDataset`` and ``Loader`` are the JAX package's numpy
code: JPEGs are decoded once and cached as uint8, random crops are numpy
slices drawn from per-item seeds, so the same seed gives byte-identical
batches in both packages.  Flips, colour jitter and normalisation run on
the device inside the train step (``augment.py``).

``PrefetchLoader`` keeps ``depth`` batches ahead on the device.  On CUDA a
producer thread pins each host batch, copies it with ``non_blocking=True``
on a side stream and records an event; the consumer's stream waits on that
event, and each tensor is ``record_stream``-ed to the consumer's stream so
its memory is not reused while the step still reads it.  Pinned buffers
come from PyTorch's caching host allocator, which hands a buffer out again
only after the copy that read it has completed.

Each batch is one request of the recorder (``utils/logging``), drawn by
``Loader`` on the thread that builds it: its spans ``loader.crops`` and
``loader.stack``, the producer's ``prefetch.pin`` and ``prefetch.copy``,
and the consumer's ``prefetch.wait``, which hands the batch's request to
the consumer's thread, so that the step that runs on it shares it; the
consumer counts ``prefetch.gets`` and ``prefetch.ready`` (the batch was
queued before it was asked for).

Batch dict layout (train, mode=pathomic):
    path_views [B, 2, S, S, 3] uint8   two random crops (TransformTwice)
    omic       [B, 80] float32
    e, t       [B] float32,  g [B] int32
    index      [B] int32,  sample_idx [B, P+K] int32

For the masked CLAT teacher (``superpixels > 0``) each ROI's SLIC label
map is computed once on the host (``masking/slic.py``) and cached, the
loader draws 4 views, and the batch also carries
    sp_mask    [B, S, S] int32     the label map cropped as view 0
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import process_slice
from ..utils.logging import bind, bound, count, new_request, span
from .sampling import ContrastSampler


def _decode(entry) -> np.ndarray:
    if isinstance(entry, np.ndarray) and entry.ndim == 3:
        return entry
    if str(entry).lower().endswith((".jpg", ".jpeg")):
        from . import native_loader
        with open(entry, "rb") as fh:
            img = native_loader.decode_jpeg(fh.read())
        if img is not None:
            return img
    from PIL import Image
    with Image.open(entry) as im:
        return np.asarray(im.convert("RGB"))


class PathomicDataset:
    """Array-of-samples view over one split of the CV pickle
    (reference ``PathomicDatasetLoader`` / ``Pathomic_InstanceSample``,
    ``data_loaders_MT.py:83-260``)."""

    def __init__(self, opt, data: Dict, split: str, train: bool,
                 contrast: bool = False, cache_images: bool = True,
                 superpixels: int = 0):
        d = data[split]
        self.X_path = d["x_path"]
        self.X_omic = np.asarray(d["x_omic"], dtype=np.float32)
        self.e = np.asarray(d["e"], dtype=np.float32)
        self.t = np.asarray(d["t"], dtype=np.float32)
        g = np.asarray(d["g"]).astype(np.int64)
        if opt.label_dim == 2:  # binary remap (:99-104)
            g = np.where(g == 1, 0, np.where(g == 2, 1, g))
        self.g = g.astype(np.int32)
        self.mode = opt.mode
        self.train = train
        self.crop = opt.input_size_path
        self.n = len(self.X_omic)
        self.cache_images = cache_images and self.mode != "omic"
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_lock = threading.Lock()
        # SLIC label maps of the masked CLAT teacher, one per ROI
        # (reference data_loaders_MT_SP.py:116-125,296-313)
        self.superpixels = superpixels
        self._slic_cache: Dict[int, np.ndarray] = {}
        self.sampler: Optional[ContrastSampler] = None
        if contrast:
            self.sampler = ContrastSampler(
                self.g, opt.label_dim, opt.task, opt.nce_p, opt.nce_k,
                opt.pos_mode, getattr(opt, "neg_mode", "diff_class"),
                seed=opt.seed, distill=getattr(opt, "distill", "crd"))

    def __len__(self):
        return self.n

    def image(self, i: int) -> np.ndarray:
        if self.cache_images:
            with self._cache_lock:
                img = self._cache.get(i)
            if img is not None:
                return img
        img = _decode(self.X_path[i])
        if self.cache_images:
            with self._cache_lock:
                self._cache[i] = img
        return img

    def slic(self, i: int) -> np.ndarray:
        """The SLIC label map of ROI ``i`` (int32 [H, W]), cached."""
        with self._cache_lock:
            m = self._slic_cache.get(i)
        if m is not None:
            return m
        from ..masking.slic import slic_segment
        m = slic_segment(self.image(i), self.superpixels, 10.0)
        with self._cache_lock:
            self._slic_cache[i] = m
        return m

    def crops(self, i: int, n_views: int, rng: np.random.Generator,
              with_mask: bool = False):
        """n_views random crops [V, S, S, 3] uint8 (RandomCrop(512)); with
        ``with_mask`` also the SLIC label map cropped as view 0."""
        img = self.image(i)
        h, w = img.shape[:2]
        s = self.crop
        pad = None
        if h < s or w < s:  # RandomCrop pads symmetrically when smaller
            ph, pw = max(0, s - h), max(0, s - w)
            pad = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
            img = np.pad(img, (*pad, (0, 0)))
            h, w = img.shape[:2]
        views = np.empty((n_views, s, s, 3), dtype=np.uint8)
        mask = None
        for v in range(n_views):
            top = rng.integers(0, h - s + 1)
            left = rng.integers(0, w - s + 1)
            views[v] = img[top:top + s, left:left + s]
            if with_mask and v == 0:
                # the label map padded as the image (with id 0), so that
                # it stays aligned; the JAX package pads it at the end
                # only (ROADMAP C)
                sp = self.slic(i)
                if pad is not None:
                    sp = np.pad(sp, pad)
                mask = sp[top:top + s, left:left + s]
        if with_mask:
            return views, mask
        return views


class Loader:
    """Iterates batches of host numpy dicts, decoding in a thread pool.
    ``close()`` shuts the pool down.

    With ``world`` > 1 (a data-parallel rank) every rank iterates the same
    global batches of ``batch_size`` in the same order, draws the crop
    seeds and contrast samples for the whole batch (so the generators stay
    in step), and decodes and returns only its rows ``rank`` of
    ``world`` (``parallel.process_slice``): the rows of the world-1 batch."""

    def __init__(self, dataset: PathomicDataset, batch_size: int,
                 shuffle: bool, drop_last: bool, n_views: int = 1,
                 workers: int = 4, seed: int = 0, rank: int = 0,
                 world: int = 1):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.n_views = n_views
        self.pool = ThreadPoolExecutor(max_workers=workers) \
            if dataset.mode != "omic" else None
        self.rng = np.random.default_rng(seed)
        self.epoch = 0
        self.rank, self.world = rank, world

    def __len__(self):
        if self.drop_last:
            return len(self.ds) // self.bs
        return -(-len(self.ds) // self.bs)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown()

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        ds = self.ds
        mine = lambda x: process_slice(x, self.world, self.rank)
        sample_idx = (ds.sampler.draw_batch(idx) if ds.sampler is not None
                      else None)
        seeds = (self.rng.integers(0, 2 ** 63, size=len(idx))
                 if ds.mode != "omic" else None)
        idx = mine(idx)
        batch = {
            "omic": ds.X_omic[idx],
            "e": ds.e[idx], "t": ds.t[idx], "g": ds.g[idx],
            "index": idx.astype(np.int32),
        }
        if seeds is not None:
            seeds = mine(seeds)
            with_mask = ds.superpixels > 0

            def job(args):
                i, s = args
                return ds.crops(int(i), self.n_views,
                                np.random.default_rng(int(s)),
                                with_mask=with_mask)

            with span("loader.crops"):
                out = list(self.pool.map(job, zip(idx, seeds)))
            with span("loader.stack"):
                if with_mask:
                    batch["path_views"] = np.stack([v for v, _ in out])
                    batch["sp_mask"] = np.stack([m for _, m in out]).astype(
                        np.int32)
                else:
                    batch["path_views"] = np.stack(out)  # [B, V, S, S, 3]
        if sample_idx is not None:
            batch["sample_idx"] = mine(sample_idx)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        self.epoch += 1
        for b in range(len(self)):
            idx = order[b * self.bs:(b + 1) * self.bs]
            if len(idx) == 0:
                return
            new_request()
            yield self._make_batch(idx)


_DONE = object()


class PrefetchLoader:
    """Wraps a :class:`Loader`, keeping ``depth`` batches on ``device``
    ahead of the consumer (see the module docstring).  On the CPU the
    producer thread only builds the host batches ahead."""

    def __init__(self, loader: Loader, depth: int = 2,
                 device="cuda"):
        self.loader = loader
        self.depth = max(1, depth)
        self.device = torch.device(device)

    def __len__(self):
        return len(self.loader)

    def _produce(self, q: queue.Queue, stop: threading.Event) -> None:
        """Puts each batch, then ``_DONE``; an exception is put in place of
        the rest and re-raised by the consumer.  Ends early once ``stop``
        is set (the consumer drains the queue until this thread ends)."""
        try:
            side = (torch.cuda.Stream(self.device)
                    if self.device.type == "cuda" else None)
            for host in self.loader:
                if stop.is_set():
                    return
                rid = bound()
                if side is None:
                    q.put(({k: torch.from_numpy(v) for k, v in host.items()},
                           None, rid))
                    continue
                with torch.cuda.device(self.device), torch.cuda.stream(side):
                    with span("prefetch.pin"):
                        pinned = {k: torch.from_numpy(v).pin_memory()
                                  for k, v in host.items()}
                    with span("prefetch.copy"):
                        batch = {k: v.to(self.device, non_blocking=True)
                                 for k, v in pinned.items()}
                        ready = torch.cuda.Event()
                        ready.record(side)
                    del pinned
                q.put((batch, ready, rid))
            q.put(_DONE)
        except Exception as exc:
            q.put(exc)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        th = threading.Thread(target=self._produce, args=(q, stop),
                              daemon=True)
        th.start()
        try:
            while True:
                with span("prefetch.wait"):
                    queued = not q.empty()
                    item = q.get()
                    is_batch = isinstance(item, tuple)
                    bind(item[2] if is_batch else None)
                    if is_batch:
                        count("prefetch.gets")
                        count("prefetch.ready", queued)
                if item is _DONE:
                    return
                if isinstance(item, Exception):
                    raise item
                batch, ready, _ = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for t in batch.values():
                        t.record_stream(stream)
                yield batch
        finally:
            stop.set()
            while th.is_alive():  # unblock a producer waiting to put
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass


def make_loaders(opt, data: Dict, fold: int):
    """reference ``pathomic_dataloader`` (``data_loaders_MT.py:47-63``):
    returns ``(train_loader, test_loader, n_data)``."""
    split = data["cv_splits"][fold]
    train_ds = PathomicDataset(opt, split, "train", train=True, contrast=True)
    test_ds = PathomicDataset(opt, split, "test", train=False)
    train_loader = Loader(train_ds, opt.batch_size, shuffle=True,
                          drop_last=True, n_views=2,
                          workers=opt.host_workers, seed=opt.seed)
    test_loader = Loader(test_ds, opt.batch_size, shuffle=False,
                         drop_last=False, n_views=1,
                         workers=opt.host_workers, seed=opt.seed + 1)
    return train_loader, test_loader, len(train_ds)


def make_patches_loader(opt, data: Dict, fold: int):
    """reference ``pathomic_patches_dataloader``
    (``data_loaders_MT.py:67-77``)."""
    split = data["cv_splits"][fold]
    test_ds = PathomicDataset(opt, split, "test", train=False)
    return Loader(test_ds, opt.batch_size, shuffle=False, drop_last=False,
                  n_views=1, workers=opt.host_workers, seed=opt.seed + 2)
