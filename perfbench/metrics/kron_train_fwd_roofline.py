"""B1's share of its roofline: the least time of one
``kron_matmul_dropout`` at the cell's shapes (bytes at 3.35 TB/s or fp32
operations at 67 TFLOP/s, the larger; the fp32 dropout mask counted) over
its profiled device time per launch (its GEMM pass and its reduction
pass), in %."""
from perfbench import counts, trace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    gemm = trace.kernels_named(t, "kron_gemm_kernel<true>")
    if not gemm:
        return None
    spent = sum(k.end - k.start for k in trace.kernels_named(
        t, "kron_gemm_kernel<true>", "kron_reduce_kernel"))
    o = run.opt
    cost = counts.kron_train_fwd_cost(run.batch, o.path_dim + 1,
                                      o.omic_dim + 1, o.mmhid)
    return 100.0 * counts.least_seconds(cost) / (spent / len(gemm))
