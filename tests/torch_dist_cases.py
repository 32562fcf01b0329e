"""The cases of the port's two-process data-parallel check, shared by
tests/torch_dist_worker.py (the ranks, torch only) and
tests/test_torch_distributed.py (the single process and JAX): the tiny
config of tests/test_train.py cut to one encoder and K=1 (JAX's step
compiles in ~4 s instead of ~7 per case), a global batch of B=4 windows
(L=2, 16x16) from a numpy seed.  The optimizer is SGD
at lr 1, so that one step moves every parameter by exactly minus its
gradient: the parameters after the step compare the gradients."""
import numpy as np

B, L, K, H, W = 4, 2, 1, 16, 16
CASES = ("plain", "grad_accum2", "grad_loss", "bn_train", "nan_uneven")


def case_raw(case):
    """The case's reference-schema config dict."""
    model = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
                 recurrent_block_type="conv", state_combination="convgru",
                 num_encoders=1, base_num_channels=4, num_residual_blocks=1,
                 use_upsample_conv=True, norm="BN" if case == "bn_train"
                 else "none")
    raw = {
        "name": "tiny", "arch": "ERGB2DepthRecurrent",
        "use_phased_arch": False,
        "data_loader": {"train": {"every_x_rgb_frame": K, "baseline": False,
                                  "clip_distance": 80.0,
                                  "reg_factor": 3.70378},
                        "batch_size": B},
        "optimizer_type": "SGD", "optimizer": {"lr": 1.0, "weight_decay": 0},
        "loss": {"type": "scale_invariant_loss",
                 "config": {"weight": 1.0, "n_lambda": 1.0}},
        "trainer": {"epochs": 1, "sequence_length": L,
                    "loss_composition": ["image", "events0"],
                    "loss_weights": [1, 1],
                    "grad_accum": 2 if case == "grad_accum2" else 1},
        "model": model,
    }
    if case == "grad_loss":
        raw["grad_loss"] = {"weight": 0.25}
    return raw


def case_config(case):
    from rpg_ramnet_tpu_torch.core.config import Config
    return Config.from_dict(case_raw(case))


def global_batch(case, seed=0):
    """The case's global batch; 'nan_uneven' puts NaN targets in rank 0's
    items only (most of item 0's depth, some of item 1's), so the two
    ranks' valid counts differ."""
    rng = np.random.RandomState(seed)
    batch = {"events": rng.randn(B, L, K, H, W, 5).astype(np.float32),
             "image": rng.rand(B, L, H, W, 1).astype(np.float32),
             "depth_events": rng.rand(B, L, K, H, W, 1).astype(np.float32),
             "depth_image": rng.rand(B, L, H, W, 1).astype(np.float32)}
    if case == "nan_uneven":
        for key in ("depth_events", "depth_image"):
            d = batch[key]
            d[0][rng.rand(*d.shape[1:]) < 0.7] = np.nan
            d[1][rng.rand(*d.shape[1:]) < 0.2] = np.nan
    return batch
