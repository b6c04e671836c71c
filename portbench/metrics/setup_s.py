"""setup_s: seconds from the process's start to the window's start
(loading, weights and inputs, warm-up, and in a fresh checkout the build)."""


def read(run):
    return (run.window_start_ns - run.t_process_ns) / 1e9
