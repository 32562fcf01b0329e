"""The port's offline evaluation against the JAX package's.

``rpg_ramnet_tpu_torch.eval.metrics`` (every metric through get_metric,
C = 1 and 3, NaN targets) and ``rpg_ramnet_tpu_torch.eval.evaluation``
(metrics_keywords, prepare_depth_data, rescale_by_the_median,
add_to_metrics, evaluate_directories) against ``rpg_ramnet_tpu.eval``'s,
on numpy-made inputs and on directories written as
tests/test_eval_extras.py writes them: event masks on and off, offsets,
--rescale and crop_ymax.  The ``python -m`` entry's printout against the
root evaluation.py's, in subprocesses; the entry imports neither JAX nor
cv2 unless masks or down-scaling ask for cv2, and reads the masks with
PIL where cv2 is absent.  Both sides are numpy float math: 1e-6
relative.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from rpg_ramnet_tpu.eval import evaluation as jevaluation
from rpg_ramnet_tpu.eval import metrics as jmetrics

from rpg_ramnet_tpu_torch.eval import evaluation, metrics
from rpg_ramnet_tpu_torch.ops.depth import depth_to_log_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
CLIP, REG = 80.0, 3.70378


def _pair(c, seed=0, n=2, h=20, w=24, nan=True):
    """[n, c, h, w] prediction and target in (0.05, 1), a band of NaN
    target rows."""
    rng = np.random.RandomState(seed)
    pred = rng.uniform(0.05, 1.0, (n, c, h, w))
    targ = np.clip(pred + rng.randn(n, c, h, w) * 0.1, 0.05, 1.0)
    if nan:
        targ[:, :, :3] = np.nan
    return pred, targ


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("name", sorted(metrics.METRICS))
def test_get_metric_matches_jax(name, c):
    pred, targ = _pair(c, seed=c, nan=name != "structural_similarity")
    assert name in jmetrics.METRICS
    got = metrics.get_metric(name)(pred, targ)
    want = jmetrics.get_metric(name)(pred, targ)
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    assert np.isfinite(got)


def test_metric_registry_matches_jax():
    """The same names as the JAX registry, an unknown name a KeyError, and
    eval_metrics' vector as JAX's."""
    assert sorted(metrics.METRICS) == jmetrics.METRICS.names()
    with pytest.raises(KeyError, match="Unknown metric"):
        metrics.get_metric("ssim")
    pred, targ = _pair(1)
    np.testing.assert_allclose(metrics.eval_metrics(pred, targ),
                               jmetrics.eval_metrics(pred, targ), rtol=RTOL)


@pytest.mark.parametrize("win", [3, 7])
def test_ssim_pieces_match_jax(win):
    rng = np.random.RandomState(win)
    x, y = rng.rand(19, 23), rng.rand(19, 23)
    np.testing.assert_allclose(metrics._uniform_filter_valid(x, win),
                               jmetrics._uniform_filter_valid(x, win),
                               rtol=RTOL)
    assert metrics._ssim_single(x, y, win=win) == pytest.approx(
        jmetrics._ssim_single(x, y, win=win), rel=RTOL)
    assert metrics._ssim_single(x, x, win=win) == pytest.approx(1.0)


@pytest.mark.parametrize("prefix", ["_", "event_masked_"])
def test_metrics_keywords_match_jax(prefix):
    got = evaluation.metrics_keywords(prefix)
    assert got == jevaluation.metrics_keywords(prefix)
    assert len(got) == 10 * (1 + len(evaluation.DEPTH_VALUES))
    assert evaluation.DEPTH_VALUES == jevaluation.DEPTH_VALUES


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_prepare_depth_data_matches_jax(scale):
    rng = np.random.RandomState(1)
    target = rng.uniform(0.0, 1.0, (20, 30)).astype(np.float32)
    pred = rng.uniform(-0.2, 1.2, (20, 30)).astype(np.float32)
    got = evaluation.prepare_depth_data(target, pred, CLIP, scale, REG)
    want = jevaluation.prepare_depth_data(target, pred, CLIP, scale, REG)
    assert got[0].shape == want[0].shape == (int(20 * scale), int(30 * scale))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    assert got[1].min() >= np.exp(-REG) * CLIP * (1 - 1e-6)


def test_rescale_by_the_median_matches_jax():
    rng = np.random.RandomState(2)
    for t, p in ((rng.uniform(1, 70, 500), rng.uniform(1, 90, 500)),
                 (rng.uniform(1, 90, 500), rng.uniform(1, 10, 500))):
        for a, b in zip(evaluation.rescale_by_the_median(t, p),
                        jevaluation.rescale_by_the_median(t, p)):
            np.testing.assert_allclose(a, b, rtol=RTOL)


@pytest.mark.parametrize("rescale", [False, True])
def test_add_to_metrics_matches_jax(rescale):
    rng = np.random.RandomState(3)
    target = rng.uniform(2, 70, (16, 20))
    pred = target * (1 + rng.randn(16, 20) * 0.1)
    mask = rng.rand(16, 20) > 0.3
    got, want = {}, {}
    for frame in range(2):
        evaluation.add_to_metrics(got, target + frame, pred, mask,
                                  prefix="_20_", rescale=rescale)
        jevaluation.add_to_metrics(want, target + frame, pred, mask,
                                   prefix="_20_", rescale=rescale)
    assert list(got) == list(want)
    assert set(evaluation.metrics_keywords()) <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def _write_pairs(root, n=4, h=32, w=40, seed=0):
    """Log-depth target and prediction npy files and event-mask PNGs, as
    tests/test_eval_extras.py:11-29 writes them."""
    import cv2
    rng = np.random.RandomState(seed)
    dirs = [root / d for d in ("gt", "pred", "masks")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        depth = rng.uniform(2, 70, (h, w)).astype(np.float32)
        noise = depth * (1 + rng.randn(h, w).astype(np.float32) * 0.05)
        np.save(dirs[0] / f"frame_{i:010d}.npy",
                depth_to_log_np(depth, CLIP, REG)[None])
        np.save(dirs[1] / f"depth_{i:010d}.npy",
                depth_to_log_np(noise, CLIP, REG)[None])
        mask = (rng.rand(h, w, 3) > 0.5).astype(np.uint8) * 255
        cv2.imwrite(str(dirs[2] / f"frame_{i:010d}.png"), mask)
    return [str(d) for d in dirs]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return _write_pairs(tmp_path_factory.mktemp("eval_pairs"))


# crop_ymax cuts the leading axis of the [1, H, W] npy files (a no-op)
# and the rows of the masks, as the reference does: below H with masks
# both packages raise
EVAL_CASES = {
    "plain": dict(),
    "masks": dict(masks=True),
    "masks_rescale": dict(masks=True, rescale=True),
    "rescale": dict(rescale=True),
    "offsets": dict(masks=True, prediction_offset=1, target_offset=1),
    "crop_ymax": dict(crop_ymax=20),
    "crop_ymax_masks": dict(masks=True, crop_ymax=20, raises=IndexError),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_directories_matches_jax(pairs, case):
    gt, pred, masks = pairs
    kw = dict(EVAL_CASES[case], clip_distance=CLIP, reg_factor=REG)
    kw["event_masks"] = masks if kw.pop("masks", False) else ""
    raises = kw.pop("raises", None)
    if raises is not None:
        for fn in (evaluation.evaluate_directories,
                   jevaluation.evaluate_directories):
            with pytest.raises(raises):
                fn(gt, pred, **kw)
        return
    got = evaluation.evaluate_directories(gt, pred, **kw)
    want = jevaluation.evaluate_directories(gt, pred, **kw)
    assert list(got) == list(want)
    assert ("event_masked_30_SILog" in got) == bool(kw["event_masks"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    if not kw.get("rescale"):
        # ~5% multiplicative noise
        assert 0.01 < got["_abs_rel_diff"] < 0.12


def test_masks_read_with_pil_without_cv2(pairs, monkeypatch):
    """With cv2 absent the masks are read through PIL, in cv2.imread's
    channel order: the same metrics."""
    gt, pred, masks = pairs
    want = evaluation.evaluate_directories(gt, pred, clip_distance=CLIP,
                                           reg_factor=REG, event_masks=masks)
    png = os.path.join(masks, sorted(os.listdir(masks))[0])
    with_cv2 = evaluation._read_mask(png)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    np.testing.assert_array_equal(evaluation._read_mask(png), with_cv2)
    got = evaluation.evaluate_directories(gt, pred, clip_distance=CLIP,
                                          reg_factor=REG, event_masks=masks)
    assert got == want


def _run(args, code=None):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable] + (["-c", code] if code else []) + args
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("masks", [False, True], ids=["plain", "masks"])
def test_entry_printout_matches_evaluation_py(pairs, masks):
    """``python -m rpg_ramnet_tpu_torch.eval.evaluation`` prints what the
    root evaluation.py prints, line for line, and loads no JAX module,
    and cv2 only with masks."""
    gt, pred, mask_dir = pairs
    flags = ["--target_dataset", gt, "--predictions_dataset", pred,
             "--clip_distance", str(CLIP), "--reg_factor", str(REG),
             "--rescale"] + (["--event_masks", mask_dir] if masks else [])
    want = _run([os.path.join(REPO, "evaluation.py")] + flags)
    code = ("import runpy, sys\n"
            "sys.argv = ['evaluation'] + sys.argv[1:]\n"
            "runpy.run_module('rpg_ramnet_tpu_torch.eval.evaluation',\n"
            "                 run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'rpg_ramnet_tpu', 'matplotlib'))\n"
            "print('MODULES', bad, 'cv2' in sys.modules)\n")
    out = _run(flags, code).splitlines()
    assert out[-1] == f"MODULES [] {masks}"
    assert out[:-1] == want.splitlines()
    assert _run(["-m", "rpg_ramnet_tpu_torch.eval.evaluation"] + flags) == want
