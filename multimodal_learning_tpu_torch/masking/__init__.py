"""CLAT stage-1 superpixel masking: the saliency masks.  SLIC and the
masked augmentation are not ported yet (ROADMAP A13)."""
from .superpixel import (frozen_params, saliency_grads,
                         superpixel_attention_mask)

__all__ = ["frozen_params", "saliency_grads", "superpixel_attention_mask"]
