"""The port's CPU lin_log gives the same result on its first call in a
process as on every later one.

On the CPU torch.log runs MKL's vector log on each thread's chunk of the
tensor.  When the process's first log call is a parallel one, in about one
process in ten one thread's chunk came back up to 80 ulp off (3.7e-5 at
5.0, a 1e-5 relative error), every later call exact; that broke the 1e-6
base tolerance of test_torch_scan_clean.py in some runs.  lin_log now makes
the process's first vector log and exp call on a few elements, on the
calling thread alone (ops/core.py, _serial_first_vml_calls).

The situation needs a fresh process, so the test starts CHILDREN of them,
WORKERS at a time, each computing lin_log twice on the frames of
test_torch_scan_clean.py (140x24x40, 8 chunks of 16800 elements on 8
threads) and printing how many elements the two calls disagree on.
Without the serial first call, 3 to 5 of 48 such processes disagreed
(13378-13466 elements each), and this test failed in 4 of 4 runs.
Tolerance: exact equality.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILDREN, WORKERS = 32, 2

CHILD = """
import numpy as np, torch
from v2e_tpu_torch.ops.core import lin_log
torch.set_num_threads(8)
rng = np.random.default_rng(4)
frames = np.clip(128 * np.exp(rng.normal(0, 0.4, (140, 24, 40))), 0, 255)
x = torch.from_numpy(np.round(frames).astype(np.float32))
first, second = lin_log(x), lin_log(x)
print(int((first != second).sum()))
"""


def run_child(_):
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return int(r.stdout.split()[-1])


def test_first_call_equals_later_calls_in_fresh_processes():
    with ThreadPoolExecutor(WORKERS) as pool:
        mismatches = list(pool.map(run_child, range(CHILDREN)))
    assert mismatches == [0] * CHILDREN, mismatches
