"""Every option of the model zoo through the port's entry points.

Configurations that between them hold every option (norms BN and IN,
skips concat and no_skip, transposed-conv and fast-upsample decoders,
ConvLSTM encoders, the 'conv' and 'sum' state combinations, and the
UNet's norms, concat skip and decoders), at the tiny size of
tests/test_train.py (2 encoders, base 4) on tiny synthetic splits:
``python -m rpg_ramnet_tpu_torch.train`` (its main) for one epoch, then
resumed for a second with the checkpoint's buffers restored bit for bit;
the exported weights through the eval entry point per package, with
--scan_chunk 2 and with --lanes 2, which give the same maps within atol
1e-5; a recurrent model through the stream entry point.  Parity with the
JAX package is tests/test_torch_zoo_model.py's and
tests/test_torch_zoo_train.py's.
"""
import json
import os

import numpy as np
import pytest
import torch

from rpg_ramnet_tpu_torch import data as tdata
from rpg_ramnet_tpu_torch import stream
from rpg_ramnet_tpu_torch.core import config as tconfig
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.models import build_model
from rpg_ramnet_tpu_torch.train import checkpoint
from rpg_ramnet_tpu_torch.train.__main__ import main as train_main

from test_torch_eval_cli import _event_log
from test_torch_lanes import _one_thread  # noqa: F401
from test_torch_zoo_train import NORMED, _raw
from torch_threads import one_thread  # noqa: F401


ENTRY = {
    # between them every option: norms, skips, decoders, encoders and
    # state combinations of StateNet, and the UNet's norms, concat and
    # decoders
    "BN_concat_transposed": ("ERGB2DepthRecurrent", NORMED["BN"]),
    "IN_convlstm_encoders_no_skip_fast": ("ERGB2DepthRecurrent",
                                          NORMED["IN"]),
    "conv_combination_BN": ("ERGB2DepthRecurrent",
                            dict(state_combination="conv", norm="BN")),
    "sum_combination_IN_concat": ("ERGB2DepthRecurrent", dict(
        state_combination="sum", norm="IN", skip_type="concat")),
    "unet_BN_concat_fast": ("ERGB2Depth", dict(
        norm="BN", skip_type="concat", fast_upsample=True)),
    "unet_IN_transposed": ("ERGB2Depth", dict(
        norm="IN", use_upsample_conv=False)),
}


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """Tiny synthetic train/val/test splits; the raw events also under
    events/voxels, where the no_recurrent recipe reads them."""
    root = tmp_path_factory.mktemp("zoo_data")
    for name, n, seed in (("train", 2, 0), ("val", 1, 5), ("test", 2, 7)):
        tdata.generate_split(str(root / name), n_sequences=n, n_frames=6,
                             height=28, width=26, seed=seed)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith("_events.npy") and d.endswith(os.path.join(
                    "events", "data")):
                dst = os.path.join(os.path.dirname(d), "voxels")
                os.makedirs(dst, exist_ok=True)
                os.link(os.path.join(d, f), os.path.join(dst, f))
    return root


def _entry_config(case, save_dir):
    arch, over = ENTRY[case]
    raw = _raw({"epochs": 1, "save_dir": save_dir, "save_freq": 1,
                "loss_composition": ["image"], "loss_weights": [1]},
               **over)
    raw["arch"] = arch
    if arch == "ERGB2Depth":
        raw["model"].update(baseline="ergb", num_bins_rgb=6)
        dataset = {"dataset_type": "SynchronizedFramesEventsRawDataset",
                   "event_folder": "events/voxels"}
    else:
        dataset = {}
    loader = raw["data_loader"]
    for split, folder in (("train", "train"), ("validation", "val")):
        loader[split] = {**loader["train"], **dataset,
                         "base_folder": folder, "every_x_rgb_frame": 2,
                         "step_size": 1}
    loader.update(batch_size=2, num_workers=1, crop_size=16)
    raw["model"]["every_x_rgb_frame"] = 2
    return raw


@pytest.mark.parametrize("case", sorted(ENTRY))
def test_entry_points_run_the_option(case, splits, tmp_path, monkeypatch):
    """One epoch through ``python -m rpg_ramnet_tpu_torch.train`` (its
    main), resumed for a second; the exported weights through the eval
    entry point per package, with --scan_chunk 2 and with --lanes 2 (the
    same maps), and a recurrent model through the stream entry point."""
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(splits))
    raw = _entry_config(case, str(tmp_path / "runs"))
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    trainer = train_main(["-c", str(tmp_path / "cfg.json"), "--device", "cpu"])
    log = trainer.jsonl.entries[0]
    assert np.isfinite(log["train_loss"]) and np.isfinite(log["val_loss"])
    ckpt = os.path.join(trainer.run_dir, "checkpoint-epoch0")
    trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    raw2 = {**raw, "trainer": {**raw["trainer"], "epochs": 2}}
    (tmp_path / "cfg2.json").write_text(json.dumps(raw2))
    resumed = train_main(["-c", str(tmp_path / "cfg2.json"), "-r", ckpt,
                          "--device", "cpu"])
    assert [e["epoch"] for e in resumed.jsonl.entries.values()] == [1]
    fresh = build_model(tconfig.Config.from_dict(raw),
                        generator=torch.Generator().manual_seed(9))
    checkpoint.restore(ckpt, fresh)
    for k, v in trained.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    model_path = str(tmp_path / "m.pth.tar")
    trainer.export_reference_checkpoint(model_path)
    args = ["--path_to_model", model_path, "--config",
            str(tmp_path / "cfg.json"), "--data_folder", "test", "--crop",
            "16,24", "--device", "cpu"]
    runs = {}
    for extra in ((), ("--scan_chunk", "2"), ("--lanes", "2")):
        got = {}
        eval_main([*args, *extra], on_prediction=got.__setitem__)
        runs[extra] = got
    base = runs[()]
    assert len(base) == 6          # 2 sequences x 3 packages
    for extra, got in runs.items():
        assert sorted(got) == sorted(base)
        for i in base:
            for k in base[i]:
                assert base[i][k].shape == (16, 24, 1)
                assert np.isfinite(base[i][k]).all()
                np.testing.assert_allclose(got[i][k], base[i][k], atol=1e-5,
                                           err_msg=f"{extra} {i} {k}")
    if raw["arch"] == "ERGB2Depth":
        return
    h, w = 14, 22                  # reflection-padded to 16 x 24
    _event_log(str(tmp_path / "events.txt"), 4 * int(h * w * 0.35), h, w)
    depths = {}
    windows = stream.main(["-i", str(tmp_path / "events.txt"),
                           "--path_to_model", model_path, "--config",
                           str(tmp_path / "cfg.json"), "--height", str(h),
                           "--width", str(w), "-o", str(tmp_path / "s"),
                           "--device", "cpu"],
                          on_window=depths.__setitem__)
    assert windows == len(depths) >= 3
    for d in depths.values():
        assert d.shape[-2:] == (h, w) and np.isfinite(d).all()
