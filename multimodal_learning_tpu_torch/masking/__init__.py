"""CLAT stage-1 superpixel masking: SLIC label maps (host) and the
saliency masks."""
from .slic import slic_segment
from .superpixel import (frozen_params, saliency_grads,
                         superpixel_attention_mask)

__all__ = ["frozen_params", "saliency_grads", "slic_segment",
           "superpixel_attention_mask"]
