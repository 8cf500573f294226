"""The port's host-side modules of the CV drivers against the JAX package's.

Splits, contrast draws and loader batches are numpy in both packages, so
the same seed must give exactly equal arrays.  The port's metrics are
numpy and scipy where the JAX package's call scikit-learn: held to 1e-12
on random predictions with many tied scores.  Also: the plateau tracker's
state sequence, the prefetching loader on the CPU, the native JPEG decoder
against PIL, its batch decode-and-crop against the JAX module's, and both
argparse shims on the verbatim reference recipes of
``tests/test_cli_surface.py``.
"""
import ast
import dataclasses
import os
import shlex

import numpy as np
import pytest
import torch

from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.config import parse_args as j_parse_args
from multimodal_learning_tpu.data import pipeline as jpipe
from multimodal_learning_tpu.data.sampling import ContrastSampler as JSampler
from multimodal_learning_tpu.data.splits import \
    make_synthetic_splits as j_make_splits
from multimodal_learning_tpu.eval import metrics as jmetrics
from multimodal_learning_tpu.train.schedules import \
    PlateauTracker as JPlateau
from multimodal_learning_tpu_torch.config import Options, parse_args
from multimodal_learning_tpu_torch.data import pipeline
from multimodal_learning_tpu_torch.data.sampling import ContrastSampler
from multimodal_learning_tpu_torch.data.splits import make_synthetic_splits
from multimodal_learning_tpu_torch.eval import metrics
from multimodal_learning_tpu_torch.train.schedules import PlateauTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("folds,roi", [(1, 64), (2, 40)])
def test_synthetic_splits_equal_jax(folds, roi):
    kw = dict(n_train=12, n_test=6, n_folds=folds, roi_size=roi, seed=5)
    _assert_equal_trees(make_synthetic_splits(**kw), j_make_splits(**kw))


@pytest.mark.parametrize("pos_mode,neg_mode,task", [
    ("exact", "diff_class", "grad"), ("multi_pos", "both_models", "grad"),
    ("relax", "all_others", "grad"), ("exact", "diff_class", "surv")])
def test_contrast_sampler_draws_equal_jax(pos_mode, neg_mode, task):
    labels = np.random.default_rng(0).integers(0, 3, 30)
    args = (labels, 3, task, 4, 7, pos_mode, neg_mode)
    port, jax_side = ContrastSampler(*args, seed=9), JSampler(*args, seed=9)
    for _ in range(3):
        idx = np.random.default_rng(1).permutation(30)[:8]
        np.testing.assert_array_equal(port.draw_batch(idx),
                                      jax_side.draw_batch(idx))


def _loader_opt(**kw):
    base = dict(mode="pathomic", task="grad", input_size_path=24,
                label_dim=3, nce_k=5, nce_p=1, pos_mode="exact", seed=3)
    base.update(kw)
    return Options(**base), JOptions(**base)


def test_loader_batches_equal_jax_for_two_epochs():
    """Random crops (ROIs larger than the crop), shuffling, drop_last and
    the CRD draws, over two epochs of both loaders built alike."""
    data = make_synthetic_splits(n_train=20, n_test=7, roi_size=40, seed=2)
    split = data["cv_splits"][1]
    opt, jopt = _loader_opt()
    for name, train in (("train", True), ("test", False)):
        port = pipeline.Loader(
            pipeline.PathomicDataset(opt, split, name, train, contrast=train),
            6, shuffle=train, drop_last=train, n_views=2 if train else 1,
            workers=3, seed=11)
        ref = jpipe.Loader(
            jpipe.PathomicDataset(jopt, split, name, train, contrast=train),
            6, shuffle=train, drop_last=train, n_views=2 if train else 1,
            workers=3, seed=11)
        assert len(port) == len(ref)
        for _ in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            _assert_equal_trees(got, want)
        port.close()


def test_prefetch_loader_on_cpu_yields_the_loader_batches():
    data = make_synthetic_splits(n_train=10, n_test=4, roi_size=24, seed=1)
    opt, _ = _loader_opt()

    def make():  # a dataset each: the CRD sampler draws from its own rng
        ds = pipeline.PathomicDataset(opt, data["cv_splits"][1], "train",
                                      True, contrast=True)
        return pipeline.Loader(ds, 4, True, True, 2, workers=2, seed=4)

    want = list(make())
    loader = make()
    got = list(pipeline.PrefetchLoader(loader, depth=1, device="cpu"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) for v in g.values())
        _assert_equal_trees({k: v.numpy() for k, v in g.items()}, w)
    # a consumer that stops early ends the producer thread
    it = iter(pipeline.PrefetchLoader(loader, depth=1, device="cpu"))
    next(it)
    it.close()
    loader.close()


def test_prefetch_loader_reraises_the_producer_error():
    class Broken:
        def __iter__(self):
            yield {"x": np.zeros(2)}
            raise OSError("unreadable ROI")

    it = iter(pipeline.PrefetchLoader(Broken(), depth=2, device="cpu"))
    next(it)
    with pytest.raises(OSError, match="unreadable ROI"):
        next(it)


def test_jpeg_decode_matches_pil(tmp_path):
    """The native decoder (built from native/datacore into build/) where
    g++ and libjpeg are present, else the PIL fallback: either way the
    pixels PIL decodes."""
    from PIL import Image

    from multimodal_learning_tpu_torch.data import native_loader
    img = np.random.default_rng(0).integers(0, 256, (33, 21, 3),
                                            dtype=np.uint8)
    path = os.path.join(str(tmp_path), "roi.jpg")
    Image.fromarray(img).save(path, quality=90)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = pipeline._decode(path)
    np.testing.assert_array_equal(got, want)
    if native_loader.available():
        with open(path, "rb") as fh:
            np.testing.assert_array_equal(
                native_loader.decode_jpeg(fh.read()), want)
        assert native_loader.decode_jpeg(b"not a jpeg") is None


@pytest.mark.parametrize("views,crop", [(1, 96), (2, 64), (3, 17)])
def test_decode_crop_batch_matches_jax(tmp_path, views, crop):
    """``native_loader.decode_crop_batch`` (the library's OpenMP loop)
    against the JAX module's on the same files and seeds: equal bytes, each
    window a window of the image PIL decodes; a crop larger than a file's
    image gives None in both."""
    from PIL import Image

    from multimodal_learning_tpu.data import native_loader as jnative
    from multimodal_learning_tpu_torch.data import native_loader
    if not native_loader.available():
        pytest.skip("the native decoder cannot be built here: "
                    f"{native_loader.build_error()}")
    rng = np.random.default_rng(1)
    paths, images = [], []
    for i, (h, w) in enumerate([(96, 96), (120, 100), (96, 130), (97, 96)]):
        path = os.path.join(str(tmp_path), f"roi{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(path, quality=90)
        with Image.open(path) as im:
            images.append(np.asarray(im.convert("RGB")))
        paths.append(path)
    seeds = [1, 2 ** 63 + 5, 0, 12345]
    got = native_loader.decode_crop_batch(paths, views, crop, seeds)
    want = jnative.decode_crop_batch(paths, views, crop, seeds)
    assert want is not None and got.shape == (4, views, crop, crop, 3)
    np.testing.assert_array_equal(got, want)
    for img, windows in zip(images, got):
        h, w = img.shape[:2]
        for win in windows:
            assert any(np.array_equal(img[t:t + crop, l:l + crop], win)
                       for t in range(h - crop + 1)
                       for l in range(w - crop + 1))
    too_big = max(im.shape[0] for im in images) + 1
    assert native_loader.decode_crop_batch(paths, 1, too_big, seeds) is None
    assert jnative.decode_crop_batch(paths, 1, too_big, seeds) is None


def _predictions(seed, n=40, n_classes=3):
    """Labels with every class present and scores on a coarse grid, so that
    many scores tie within and across classes."""
    rng = np.random.default_rng(seed)
    gt = np.r_[np.arange(n_classes), rng.integers(0, n_classes,
                                                  n - n_classes)]
    scores = rng.integers(0, 6, (n, n_classes)) / 5.0
    return metrics.one_hot(gt, n_classes), scores


@pytest.mark.parametrize("seed", range(4))
def test_grading_metrics_match_sklearn(seed):
    y, p = _predictions(seed)
    np.testing.assert_allclose(metrics.grading_metrics(y, p),
                               jmetrics.grading_metrics(y, p), rtol=0,
                               atol=1e-12)
    got = metrics.extended_grading_metrics(y, p)
    want = jmetrics.extended_grading_metrics(y, p)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_survival_metrics_match_jax():
    rng = np.random.default_rng(7)
    t = rng.integers(1, 15, 50).astype(float)   # tied times
    e = rng.integers(0, 2, 50).astype(float)
    h = rng.integers(0, 8, 50) / 7.0             # tied hazards
    groups = rng.integers(0, 3, 50)
    for name, args in (("concordance_index", (t, -h, e)),
                       ("accuracy_cox", (h, e)),
                       ("cox_log_rank", (h, e, t)),
                       ("multivariate_logrank", (groups, e, t))):
        np.testing.assert_allclose(getattr(metrics, name)(*args),
                                   getattr(jmetrics, name)(*args),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_plateau_tracker_sequence_equals_jax():
    losses = [1.0, 0.9, 0.95, 0.91, 0.92, 0.9, 0.93, 0.94, 0.89, 0.9, 0.9,
              0.9, 0.9, 0.9, 0.9, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    port, ref = PlateauTracker(), JPlateau()
    for loss in losses:
        assert port.step(loss) == ref.step(loss)
        assert port.state_dict() == ref.state_dict()
    assert port.scale < 1.0
    fresh = PlateauTracker()
    fresh.load_state_dict(port.state_dict())
    assert fresh.step(0.7) == port.step(0.7)


def _recipes():
    """Every verbatim recipe ``_parse("...")`` of tests/test_cli_surface.py,
    plus the flag this slice wires."""
    tree = ast.parse(open(os.path.join(REPO, "tests",
                                       "test_cli_surface.py")).read())
    found = [ast.literal_eval(node.args[0]) for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "_parse"]
    assert len(found) >= 8
    return found + ["--paired_conv True --mode pathomic --task grad"]


@pytest.mark.parametrize("recipe", _recipes())
def test_both_argparse_shims_parse_the_recipes_alike(recipe):
    got = parse_args(shlex.split(recipe), save=False)
    want = j_parse_args(shlex.split(recipe), save=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if "--paired_conv True" in recipe:
        assert got.paired_conv is True
