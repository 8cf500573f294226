"""Data: on-device augmentation (the loaders come with ROADMAP A10)."""
from .augment import (augment_view, augment_views, color_jitter_batch,
                      normalize_batch, random_flips)
