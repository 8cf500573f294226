"""Model FLOPs of the window's served chunks (the eval forward) over the
window's seconds and the H100's dense bf16 peak (989 TFLOP/s), in %."""
from perfbench import counts


def read(run):
    if run.kind != "serve" or run.device.type != "cuda":
        return None
    o = run.opt
    per = counts.serve_flops_per_patch(
        run.cfg["program"]["serve"], o.input_size_path, o.path_dim,
        o.omic_dim, o.mmhid, o.input_size_omic, o.label_dim)
    rate = run.count * run.batch * per / run.window_s
    return 100.0 * rate / counts.H100_BF16_FLOP_PER_S
