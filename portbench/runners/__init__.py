"""The cells' runners: `run(run)` of each sets up the program, warms up,
measures the window and checks the outputs (bench.py)."""
