"""Host ms inside the train step's call, the mean over every step of the
window.  The step makes no host synchronisation, so this is dispatch."""
import numpy as np


def read(run):
    spans = run.spans.get("step_call")
    if run.kind != "train" or not spans:
        return None
    return float(np.mean(spans) * 1e3)
