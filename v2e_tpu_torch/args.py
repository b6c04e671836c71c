"""The v2e command-line flags (a copy of v2e_tpu/args.py): the same flag
names, groups and defaults, so conversion recipes run unchanged.

Every flag runs its path.  `log_layout_flags` says what the port runs for
the TPU layout flags (--unet_conv, --warp_precision).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Tuple

from v2e_tpu_torch.models.unet import UNET_CONV

logger = logging.getLogger(__name__)

NO_SLOWDOWN = 1


def expandpath(path: str) -> str:
    return os.path.abspath(os.path.expandvars(os.path.expanduser(path)))


def output_file_check(arg: str):
    return None if arg.lower() == "none" else arg


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {v}")


def none_or_str(value: str):
    return None if value in ("None", "") else value


def tuple_type(strings: str) -> Tuple[int, ...]:
    strings = strings.replace("(", "").replace(")", "")
    return tuple(map(int, strings.split(",")))


class SmartFormatter(argparse.HelpFormatter):
    """Help formatter honoring literal newlines in strings starting 'R|'."""

    def _split_lines(self, text, width):
        if text.startswith("R|"):
            return text[2:].splitlines()
        return argparse.HelpFormatter._split_lines(self, text, width)


def v2e_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Populate the parser with the full v2e flag surface."""

    out_general = parser.add_argument_group("Output: General")
    out_general.add_argument("-o", "--output_folder", type=expandpath,
                             default="v2e-output", help="folder to store outputs")
    out_general.add_argument("--avi_frame_rate", type=int, default=30,
                             help="frame rate of output AVI video files (playback only)")
    out_general.add_argument("--output_in_place", default=False, type=str2bool,
                             const=True, nargs="?",
                             help="store outputs in the same folder as the source")
    out_general.add_argument("--overwrite", action="store_true",
                             help="overwrite files in an existing output folder")
    out_general.add_argument("--unique_output_folder", default=True, type=str2bool,
                             const=True, nargs="?",
                             help="uniquify the output folder name if non-empty")
    out_general.add_argument("--skip_video_output", action="store_true",
                             help="skip producing AVI video outputs")

    ts_group = parser.add_argument_group("DVS timestamp resolution")
    ts_group.add_argument("--auto_timestamp_resolution", default=True, type=str2bool,
                          const=True, nargs="?",
                          help="automatically determine upsampling to limit motion "
                               "to <=1 px between frames (ignored by --disable_slomo)")
    ts_group.add_argument("--timestamp_resolution", type=float,
                          help="desired DVS timestamp resolution in seconds; sets "
                               "the SloMo upsampling factor")

    model_group = parser.add_argument_group("DVS model")
    model_group.add_argument("--dvs_params", type=str, default=None,
                             help="preset DVS model parameters: 'clean' or 'noisy'")
    model_group.add_argument("--pos_thres", type=float, default=0.2,
                             help="ON threshold in log_e intensity change")
    model_group.add_argument("--neg_thres", type=float, default=0.2,
                             help="OFF threshold in log_e intensity change")
    model_group.add_argument("--sigma_thres", type=float, default=0.03,
                             help="1-std threshold mismatch in log_e units")
    model_group.add_argument("--cutoff_hz", type=float, default=300,
                             help="photoreceptor IIR lowpass 3dB cutoff in Hz")
    model_group.add_argument("--leak_rate_hz", type=float, default=0.01,
                             help="leak event rate per pixel in Hz")
    model_group.add_argument("--shot_noise_rate_hz", type=float, default=0.001,
                             help="temporal noise rate (ON+OFF) in darkest parts")
    model_group.add_argument("--photoreceptor_noise", action="store_true",
                             help="model shot noise via Gaussian photoreceptor noise "
                                  "before the lowpass (alternating ON/OFF statistics)")
    model_group.add_argument("--leak_jitter_fraction", type=float, default=0.1,
                             help="jitter of leak noise events relative to the FPN interval")
    model_group.add_argument("--noise_rate_cov_decades", type=float, default=0.1,
                             help="CoV of lognormal noise-rate FPN in decades")
    model_group.add_argument("--refractory_period", type=float, default=0.0005,
                             help="pixel refractory period in seconds (0 disables)")
    model_group.add_argument("--dvs_emulator_seed", type=int, default=0,
                             help="fixed random seed (>0) for reproducible runs")
    model_group.add_argument("--show_dvs_model_state", nargs="+", default=None,
                             help="model state(s) to visualize/save, or 'all'")
    model_group.add_argument("--save_dvs_model_state", action="store_true",
                             help="save shown model states to AVI files")
    model_group.add_argument("--record_single_pixel_states", type=tuple_type,
                             default=None,
                             help="record one pixel's internal states, as (x,y)")

    cam_group = parser.add_argument_group(
        "DVS camera sizes (--dvs346 etc. override --output_width/height)"
    )
    cam_group.add_argument("--output_height", type=int, default=None,
                           help="height of output DVS data in pixels")
    cam_group.add_argument("--output_width", type=int, default=None,
                           help="width of output DVS data in pixels")
    cam_action = cam_group.add_mutually_exclusive_group()
    cam_action.add_argument("--dvs128", action="store_true", help="128x128 DVS")
    cam_action.add_argument("--dvs240", action="store_true", help="240x180 DAVIS240")
    cam_action.add_argument("--dvs346", action="store_true", help="346x260 DAVIS346")
    cam_action.add_argument("--dvs640", action="store_true", help="640x480 DAVIS640")
    cam_action.add_argument("--dvs1024", action="store_true", help="1024x768 DVS")

    slomo_group = parser.add_argument_group(
        'SloMo upsampling (see also "DVS timestamp resolution")'
    )
    slomo_group.add_argument("--disable_slomo", action="store_true",
                             help="disable SloMo interpolation; DVS timestamps at "
                                  "source frame rate")
    slomo_group.add_argument("--slomo_model", type=expandpath,
                             default=os.path.join(
                                 os.path.dirname(__file__), "..", "input",
                                 "SuperSloMo39.ckpt"),
                             help="path of the SuperSloMo checkpoint "
                                  "(.ckpt torch or .npz converted)")
    slomo_group.add_argument("--allow_random_slomo", action="store_true",
                             help="proceed with RANDOM SuperSloMo weights when "
                                  "the checkpoint is missing (benchmarking "
                                  "only; interpolated frames are meaningless). "
                                  "Without this flag a missing --slomo_model "
                                  "is an error, like the reference")
    slomo_group.add_argument("--batch_size", type=int, default=8,
                             help="SloMo batch size in frame pairs")
    slomo_group.add_argument("--vid_orig", type=none_or_str, default="video_orig.avi",
                             help="output original video (or None)")
    slomo_group.add_argument("--vid_slomo", type=none_or_str, default="video_slomo.avi",
                             help="output slomo video (or None)")
    slomo_group.add_argument("--slomo_stats_plot", action="store_true",
                             help="show a plot of slomo statistics")
    slomo_group.add_argument("--warp_precision", type=str, default="1pass",
                             choices=["1pass", "3pass", "highest"],
                             help="matmul precision of the TPU warp kernels; "
                                  "the port's warps compute in float32, so "
                                  "every value gives the same result")
    slomo_group.add_argument("--unet_conv", type=str, default="auto",
                             choices=list(UNET_CONV),
                             help="UNet conv form (the same function in "
                                  "every form): packedz runs the k=3 up-tail "
                                  "layers with 32-64 output channels through "
                                  "the K5 conv kernel; fold, fold45, "
                                  "packedfold and packedfold45 fold each "
                                  "bilinear x2 + conv into one half-res conv "
                                  "(on all up levels, or on up4 and up5); "
                                  "packed, packedup and blocked are TPU "
                                  "layouts that run dense; auto runs dense")
    slomo_group.add_argument("--slomo_use_saved", action="store_true",
                             help="cache the interpolated frame stream and "
                                  "reuse it on later runs with the same "
                                  "input + SloMo settings (e.g. threshold "
                                  "sweeps re-run only the emulator). The "
                                  "cache file lives next to the output "
                                  "folder; keyed by input file, crop/size "
                                  "and SloMo parameters. (The reference "
                                  "left this as a TODO, v2e_args.py:280-285)")

    in_group = parser.add_argument_group("Input file handling")
    in_group.add_argument("-i", "--input", type=expandpath,
                          help="input video file or image folder")
    in_group.add_argument("--input_frame_rate", type=float,
                          help="override/define the input frame rate in Hz")
    in_group.add_argument("--input_slowmotion_factor", type=float, default=1.0,
                          help="R|known slow-motion factor of the input video:"
                               "\nratio of shooting frame rate to playback rate.")
    in_group.add_argument("--start_time", type=float, default=None,
                          help="start at this time in seconds in the video")
    in_group.add_argument("--stop_time", type=float, default=None,
                          help="stop at this time in seconds in the video")
    in_group.add_argument("--crop", type=tuple_type, default=None,
                          help="crop input by (left, right, top, bottom) pixels")
    in_group.add_argument("--hdr", action="store_true",
                          help="treat input as HDR logarithmic gray scale")

    syn_group = parser.add_argument_group("Synthetic input")
    syn_group.add_argument("--synthetic_input", type=str,
                           help="module path of a synthetic input class with "
                                "next_frame() and total_frames() (e.g. "
                                "v2e_tpu.synthetic.moving_dot or scripts.moving_dot)")

    dvs_vid_group = parser.add_argument_group("Output: DVS video")
    dvs_vid_group.add_argument("--dvs_exposure", nargs="+", type=str,
                               default=["duration", "0.01"],
                               help="R|DVS frame exposure mode:"
                                    "\n duration T | count N | area_count M N | source")
    dvs_vid_group.add_argument("--dvs_vid", type=none_or_str, default="dvs-video.avi",
                               help="output DVS events as AVI video")
    dvs_vid_group.add_argument("--dvs_vid_full_scale", type=int, default=2,
                               help="full scale event count for DVS videos")
    dvs_vid_group.add_argument("--no_preview", action="store_true", default=True,
                               help="disable preview windows (always on: headless)")

    dvs_out_group = parser.add_argument_group("Output: DVS events")
    dvs_out_group.add_argument("--ddd_output", action="store_true",
                               help="save frames + event indices in DDD17/20 HDF5 format")
    dvs_out_group.add_argument("--dvs_h5", type=output_file_check, default=None,
                               help="output events as HDF5 database")
    dvs_out_group.add_argument("--dvs_aedat2", type=output_file_check, default=None,
                               help="output events as AEDAT-2.0 for jAER")
    dvs_out_group.add_argument("--dvs_aedat4", type=output_file_check, default=None,
                               help="output events as AEDAT-4.0")
    dvs_out_group.add_argument("--dvs_text", type=output_file_check, default=None,
                               help="output events as text: t x y p per line")
    dvs_out_group.add_argument("--label_signal_noise", action="store_true",
                               help="label signal vs shot-noise events in outputs")

    csdvs_group = parser.add_argument_group("Center-Surround DVS")
    csdvs_group.add_argument("--cs_lambda_pixels", type=float, default=None,
                             help="surround space constant in pixels (None disables)")
    csdvs_group.add_argument("--cs_tau_p_ms", type=float, default=None,
                             help="photoreceptor-center diffuser time constant (ms); "
                                  "0 for 'instantaneous' surround")

    scidvs_group = parser.add_argument_group("SCIDVS pixel")
    scidvs_group.add_argument("--scidvs", action="store_true",
                              help="simulate the SCIDVS adaptive high-gain pixel")

    perf_group = parser.add_argument_group("Device pipeline (v2e_tpu extensions)")
    perf_group.add_argument("--chunk_size", type=int, default=64,
                            help="frames per device chunk (--disable_slomo)")
    perf_group.add_argument("--no_shuffle", action="store_true",
                            help="skip the within-iteration random event shuffle")
    perf_group.add_argument("--profile", action="store_true",
                            help="capture a torch.profiler trace of the "
                                 "conversion into <output_folder>/torch-trace "
                                 "(trace.json), and the program's spans and "
                                 "counters into spans.json beside it: per chunk "
                                 "submit (submit.upload, slomo.resize.upload, "
                                 "slomo.flow_unet, "
                                 "slomo.refine_unet, emulator.precore, "
                                 "emulator.compact), "
                                 "collect.fetch (collect.fetch.wait), "
                                 "collect.finalize (collect.materialize, "
                                 "collect.write) and pipeline.drain; device "
                                 "times from CUDA events "
                                 "(v2e_tpu_torch/tracing.py)")
    perf_group.add_argument("--compaction_capacity", type=int, default=None,
                            help="sparse-compaction capacity hint (events per "
                                 "chunk x2); avoids adaptation recompiles on "
                                 "long runs")
    perf_group.add_argument("--checkpoint_state", default=None,
                            help="save the emulator state to this .npz at the "
                                 "end (resume with --resume_state)")
    perf_group.add_argument("--resume_state", default=None,
                            help="restore emulator state from a .npz written "
                                 "by --checkpoint_state before converting")
    perf_group.add_argument("--devices", type=int, default=1,
                            help="number of CUDA devices for the conversion "
                                 "(clamped to the visible cards; a run on the "
                                 "CPU puts every strip or segment on the CPU)")
    perf_group.add_argument("--parallel_mode", choices=("pixel", "segment"),
                            default="pixel",
                            help="multi-chip strategy with --devices>1: "
                                 "'pixel' shards image rows (bit-exact); "
                                 "'segment' shards time segments (faster for "
                                 "small sensors at high upsampling; events at "
                                 "segment seams may shift by one threshold)")
    perf_group.add_argument("--segment_warmup", type=int, default=8,
                            help="overlap frames replayed to re-seed each "
                                 "time segment in --parallel_mode segment")

    return parser


def write_args_info(args, path: str, other_args=None, command_line: str = "") -> str:
    """Echo all parsed arguments to the log and an args.txt provenance file
    (reference v2e_args.py:465-499)."""
    lines = "\n*** arguments:\n"
    for arg, value in sorted(vars(args).items()):
        lines += f"{arg}:\t{value}\n"
    logger.info(lines)
    extra = None
    if other_args:
        extra = (
            "\n**** extra other arguments (check for misspelled arguments):\n"
            + "".join(f"{a}\n" for a in sorted(other_args))
        )
        logger.warning(extra)
    filepath = os.path.join(path, "v2e-args.txt")
    with open(filepath, "w") as f:
        f.write(lines)
        if extra:
            f.write(extra)
        f.write("\n*** command line:\n" + command_line)
    return filepath


def v2e_check_dvs_exposure_args(args):
    """Parse --dvs_exposure into (mode, value, area_dimension)
    (reference v2e_args.py:502-556)."""
    from v2e_tpu_torch.render import ExposureMode

    dvs_exposure = args.dvs_exposure
    try:
        exposure_mode = ExposureMode[dvs_exposure[0].upper()]
    except Exception:
        raise ValueError(
            f"dvs_exposure first parameter '{dvs_exposure[0]}' must be "
            "'duration', 'count', 'area_count' or 'source'"
        )
    if exposure_mode == ExposureMode.SOURCE:
        return exposure_mode, None, None
    if exposure_mode == ExposureMode.AREA_COUNT:
        if len(dvs_exposure) != 3:
            raise ValueError("area_count needs 'area_count M N'")
        return exposure_mode, int(dvs_exposure[1]), int(dvs_exposure[2])
    if len(dvs_exposure) != 2:
        raise ValueError("duration/count needs two parameters, e.g. 'duration 0.01'")
    return exposure_mode, float(dvs_exposure[1]), None


def log_layout_flags(args) -> None:
    """Say once what the port runs for --unet_conv (the name's note in
    models/unet.py's UNET_CONV) and --warp_precision (the warps compute in
    float32 for every setting)."""
    note = UNET_CONV[args.unet_conv][1]
    if note:
        logger.info(f"--unet_conv {args.unet_conv}: {note}")
    if args.warp_precision != "1pass":
        logger.info(f"--warp_precision {args.warp_precision}: the port's warps "
                    "compute in float32 for every setting")
