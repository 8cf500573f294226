"""Model FLOPs of the window's train steps over the window's seconds and
the H100's dense bf16 peak (989 TFLOP/s), in %.  FLOPs from shapes
(``perfbench/counts.py``): the trained net's forward and backward, the
EMA's and any frozen teacher's forward, no recomputed operation."""
from perfbench import counts


def read(run):
    if run.kind != "train" or run.device.type != "cuda":
        return None
    o = run.opt
    if run.cfg["program"]["train"] == "teacher":
        per = counts.teacher_train_flops_per_patch(
            o.input_size_path, o.path_dim, o.omic_dim, o.mmhid,
            o.input_size_omic, o.label_dim)
    else:
        per = counts.clat_student_train_flops_per_patch(
            o.input_size_path, o.path_dim, o.omic_dim, o.mmhid, o.feat_dim,
            o.n_data, o.nce_k, o.nce_p, o.input_size_omic, o.label_dim)
    rate = run.count * run.batch * per / run.window_s
    return 100.0 * rate / counts.H100_BF16_FLOP_PER_S
