"""Host ms inside the ``infer`` call per chunk (the copy in and the
dispatch), the mean over every chunk of the window."""
import numpy as np


def read(run):
    spans = run.spans.get("infer_call")
    if run.kind != "serve" or not spans:
        return None
    return float(np.mean(spans) * 1e3)
