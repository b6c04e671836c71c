"""Run one cell of the port's benchmark once (see portbench/bench.py):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object.
"""
import os
import sys

if __name__ == "__main__":
    # the checkout's root holds the port (v2e_tpu_torch) and this package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.bench import main

    sys.exit(main())
