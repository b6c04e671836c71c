"""train_samples_per_s: training samples whose step completed inside the
window (sampler, then step, as train_slomo's loop runs them), over the
window's seconds."""


def read(run):
    if "samples" not in run.counts or run.window_s <= 0:
        return None
    return run.counts["samples"] / run.window_s
