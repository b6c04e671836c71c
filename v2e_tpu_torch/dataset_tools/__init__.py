"""The dataset tools of the port (copies of the repository's dataset_tools/
on v2e_tpu_torch): SuperSloMo training (`train_slomo`, on the card), its
synthetic training videos and held-out evaluation, batch conversion of a
video tree through the port's CLI, and the DDD20 tools (extraction,
threshold calibration, real-vs-synthetic conversion and event-count plots;
these need h5py).  Each runs as ``python -m v2e_tpu_torch.dataset_tools.<name>``
with ``main(argv)``.  The tools that use the card (`train_slomo`,
`eval_slomo_ckpt`, `batch_convert`, `ddd_find_thresholds`, `ddd_v2e`) take
``main(argv, device=None)`` and run on "cuda" unless `device` names
another; `make_training_videos`, `ddd_extract_data` and
`ddd_plot_event_counts` run on the host alone."""
