"""Host ms per step in which the loop blocks in ``next()`` on the
``PrefetchLoader``, the mean over every step of the window."""
import numpy as np


def read(run):
    spans = run.spans.get("data_wait")
    if run.kind != "train" or not spans:
        return None
    return float(np.mean(spans) * 1e3)
