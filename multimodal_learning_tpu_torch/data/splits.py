"""CV-split reading + synthetic fabrication.

The port's own copy of ``multimodal_learning_tpu/data/splits.py`` (numpy
only): the same seed gives byte-identical splits in both packages.

The reference distributes TCGA-GBMLGG as pickled 5-fold CV splits
(``MICCAI-2022/train_cv_MT.py:35-51``) with schema::

    {"cv_splits": {k: {"train"/"test": {"x_path": [paths], "x_patname": [...],
                                        "x_omic": [N, 80], "e": [N], "t": [N],
                                        "g": [N]}}},
     "data_pd": <dataframe>}

(key usage at ``data_loaders_MT.py:92-96``, ``core/utils_analysis.py:62-70``).

``make_synthetic_splits`` fabricates a miniature dataset with the same schema
(images written as JPEGs, or kept in memory as uint8 arrays) so tests and the
throughput bench run hermetically.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np


def split_pickle_path(opt, patches: bool = False) -> str:
    """Reference split-pickle naming (``train_cv_MT.py:31-35``):
    ``gbmlgg5cv_<roi_dir>_1_1_<use_vgg_features><_rnaseq>.pkl`` with
    ``roi_dir`` switching to the 512-patch splits under
    ``--use_vgg_features`` (or for the explicit patches loader)."""
    roi_dir = ("all_st_patches_512" if (patches or opt.use_vgg_features)
               else "all_st")
    rnaseq = "_rnaseq" if opt.use_rnaseq else ""
    return os.path.join(
        opt.dataroot, "splits_5cv_2022",
        f"gbmlgg5cv_{roi_dir}_1_1_{int(opt.use_vgg_features)}{rnaseq}.pkl")


def load_cv_splits(pickle_path: str) -> Dict:
    with open(pickle_path, "rb") as fh:
        return pickle.load(fh)


def make_synthetic_splits(
    n_train: int = 48, n_test: int = 24, n_folds: int = 1,
    roi_size: int = 96, omic_dim: int = 80, n_classes: int = 3,
    image_dir: Optional[str] = None, seed: int = 0,
    patches_per_roi: int = 1,
) -> Dict:
    """Fabricate a split dict with the reference schema.

    If ``image_dir`` is given, ROI JPEGs are written there and ``x_path``
    holds file paths; otherwise ``x_path`` holds in-memory uint8 arrays
    (accepted by :class:`PathomicDataset`).  Labels correlate with image/omic
    statistics so a model can actually learn from the synthetic data.
    """
    rng = np.random.default_rng(seed)
    cv_splits = {}
    for k in range(1, n_folds + 1):
        fold = {}
        for split, n in (("train", n_train), ("test", n_test)):
            ppr = patches_per_roi if split == "test" else 1
            n_img = n * ppr
            g = rng.integers(0, n_classes, size=n)
            g = np.repeat(g, ppr)
            x_omic = rng.normal(size=(n_img, omic_dim)).astype(np.float32)
            # inject class signal into the omic vector and image brightness
            x_omic[:, :8] += g[:, None] * 1.5
            imgs = []
            for i in range(n_img):
                base = 60 + 60 * g[i]
                img = rng.normal(base, 30, size=(roi_size, roi_size, 3))
                img = np.clip(img, 0, 255).astype(np.uint8)
                imgs.append(img)
            if image_dir is not None:
                from PIL import Image
                os.makedirs(image_dir, exist_ok=True)
                paths = []
                for i, img in enumerate(imgs):
                    p = os.path.join(image_dir, f"{split}_{k}_{i}.jpg")
                    Image.fromarray(img).save(p, quality=90)
                    paths.append(p)
                x_path = np.array(paths)
            else:
                x_path = imgs
            t = rng.exponential(30, size=n_img) + 1.0
            t = (t / (1.0 + 0.5 * g)).astype(np.float32)  # higher grade: shorter
            e = rng.binomial(1, 0.7, size=n_img).astype(np.float32)
            patnames = np.array(
                [f"TCGA-SYN-{split}{k}-{i // ppr:04d}"
                 for i in range(n_img)])
            fold[split] = {"x_path": x_path, "x_patname": patnames,
                           "x_omic": x_omic, "e": e,
                           "t": t, "g": g.astype(np.float32)}
        cv_splits[k] = fold
    return {"cv_splits": cv_splits, "data_pd": None}


def save_splits(data: Dict, path: str) -> None:
    with open(path, "wb") as fh:
        pickle.dump(data, fh)
