"""Data: CV splits, contrast sampling, the host loaders with device
prefetch, and on-device augmentation."""
from .augment import (augment_view, augment_views, color_jitter_batch,
                      normalize_batch, random_flips)
from .pipeline import (Loader, PathomicDataset, PrefetchLoader, make_loaders,
                       make_patches_loader)
from .sampling import ContrastSampler, omic_transform
from .splits import load_cv_splits, make_synthetic_splits, save_splits
