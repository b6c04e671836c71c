"""mfu.train: the UNets' forward and backward FLOPs of the steps done in
the window (yardstick.slomo_train_step_flops), over the window's seconds,
as a share of the H100's dense TF32 peak (cuDNN runs the step's float32
convolutions in TF32)."""
from portbench.yardstick import PEAK_TF32_FLOP_S, slomo_train_step_flops


def read(run):
    if "steps" not in run.counts or run.window_s <= 0:
        return None
    h, w = run.counts["crop"]
    flops = run.counts["steps"] * slomo_train_step_flops(
        int(run.counts["batch"]), h, w, int(run.counts["base"]))
    return 100.0 * flops / run.window_s / PEAK_TF32_FLOP_S
