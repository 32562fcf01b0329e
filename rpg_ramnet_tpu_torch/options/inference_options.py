"""Argparse option bundles for streaming inference / reconstruction demos.

A copy of ``rpg_ramnet_tpu/options/inference_options.py`` (reference
RAM_Net/options/inference_options.py:1-175: set_inference_options,
set_depth_inference_options) — display, tone mapping, unsharp/bilateral
filtering, hot-pixel, fp16 and --no-recurrent switches for the live
streaming entry point.
"""
from __future__ import annotations

import argparse


def set_inference_options(parser: argparse.ArgumentParser):
    parser.add_argument("-o", "--output_folder", default=None, type=str,
                        help="if None, will not write the images to disk")
    parser.add_argument("--dataset_name", default="reconstruction", type=str)
    parser.add_argument("--use_gpu", dest="use_gpu", action="store_true")
    parser.set_defaults(use_gpu=True)

    # display
    parser.add_argument("--display", dest="display", action="store_true")
    parser.set_defaults(display=False)
    parser.add_argument("--show_events", dest="show_events", action="store_true")
    parser.set_defaults(show_events=False)
    parser.add_argument("--event_display_mode", default="red-blue", type=str,
                        help='"red-blue" or "grayscale"')
    parser.add_argument("--num_bins_to_show", default=-1, type=int,
                        help="-1 means show all the bins")
    parser.add_argument("--display_border_crop", default=0, type=int)
    parser.add_argument("--display_wait_time", default=1, type=int)

    # output
    parser.add_argument("--gpu_id", default=0, type=int)

    # tone mapping / post-processing
    parser.add_argument("--Imin", default=0.0, type=float)
    parser.add_argument("--Imax", default=1.0, type=float)
    parser.add_argument("--auto_hdr", dest="auto_hdr", action="store_true")
    parser.set_defaults(auto_hdr=False)
    parser.add_argument("--auto_hdr_median_filter_size", default=10, type=int)
    parser.add_argument("--color", dest="color", action="store_true")
    parser.set_defaults(color=False)

    # filtering
    parser.add_argument("--unsharp_mask_amount", default=0.3, type=float)
    parser.add_argument("--unsharp_mask_sigma", default=1.0, type=float)
    parser.add_argument("--bilateral_filter_sigma", default=0.0, type=float)
    parser.add_argument("--flip", dest="flip", action="store_true")
    parser.set_defaults(flip=False)

    # hot pixels
    parser.add_argument("--hot_pixels_file", default=None, type=str)

    # precision
    parser.add_argument("--use_fp16", dest="use_fp16", action="store_true",
                        help="bfloat16 compute path on TPU")
    parser.set_defaults(use_fp16=False)

    # recurrency
    parser.add_argument("--no-recurrent", dest="no_recurrent", action="store_true")
    parser.set_defaults(no_recurrent=False)
    return parser


def set_depth_inference_options(parser: argparse.ArgumentParser):
    parser = set_inference_options(parser)
    parser.add_argument("--clip_distance", default=80.0, type=float)
    parser.add_argument("--reg_factor", default=3.70378, type=float)
    parser.add_argument("--save_numpy", dest="save_numpy", action="store_true")
    parser.set_defaults(save_numpy=False)
    parser.add_argument("--save_inv_log", dest="save_inv_log", action="store_true")
    parser.set_defaults(save_inv_log=False)
    parser.add_argument("--save_inv", dest="save_inv", action="store_true")
    parser.set_defaults(save_inv=False)
    parser.add_argument("--save_color_map", dest="save_color_map", action="store_true")
    parser.set_defaults(save_color_map=False)
    return parser
