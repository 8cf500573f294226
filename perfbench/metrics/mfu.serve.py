"""Model FLOPs of the window's served chunks (the eval forward, with the
trunk the configuration names) over the window's seconds and the H100's
dense bf16 peak (989 TFLOP/s), in %."""
from perfbench import counts


def read(run):
    if run.kind != "serve" or run.device.type != "cuda":
        return None
    per = counts.serve_flops_per_patch(run.cfg, run.opt)
    rate = run.count * run.batch * per / run.window_s
    return 100.0 * rate / counts.H100_BF16_FLOP_PER_S
