"""The decoder's opt-in formulations through the port's decoder and
inference engines, and the chunked engines' routes, against the JAX
package.

Tiny flagship-shaped config (2 encoders, base 8, 1 residual block, K=2,
32x32); weights cross with ``compat.params_from_jax``, inputs are made
with numpy.

- ``statenet.forward_decoder_supers`` with fused_decoder='on'
  (allow_fused: the K8 wrapper, its plain version on the CPU) and with
  composed_decoder='on' (allow_composed) against JAX's on the same supers:
  float32 with both packages' K8 gates patched to admit float32 (inside
  the test only, as tests/test_ops.py:538-573 does) at 1e-5; bf16 under
  the real gates, JAX's kernel in interpret mode, at 5e-2 on the sigmoid
  maps.
- The policies: 'auto' never takes K8, 'on' only where ``supports``
  holds, the composed gate's rule, K8 refusing autograd in the decoder.
- Three engines (``run_chunked_streaming``, also with precompute_x,
  ``SequenceScanInference(batched_decode=True)``,
  ``StreamingInference(batched_decode=True)``) with each option on an
  on-disk split of two sequences, against the JAX engines at 1e-5, as
  tests/test_batched_streaming.py:588 does for the composed layers.
- The repair: ``SequenceScanInference``'s default and
  ``run_chunked_streaming(batched_decode=False)`` run forward_sequence,
  bitwise equal to the port's ``StreamingInference`` and within 1e-5 of
  JAX's engines; the three routes chosen as JAX chooses them
  (rpg_ramnet_tpu/eval/inference.py:197-212, 263-274).
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.data import concatenate_subfolders as jconcat
from rpg_ramnet_tpu.eval import inference as jinference
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.models import statenet as jstatenet
from rpg_ramnet_tpu.ops import upsample_conv as jax_upsample_conv

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.data import concatenate_subfolders
from rpg_ramnet_tpu_torch.data.synthetic import generate_eventscape_sequence
from rpg_ramnet_tpu_torch.eval import inference
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, statenet
from rpg_ramnet_tpu_torch.ops import upsample_conv
from rpg_ramnet_tpu_torch.utils.layout import to_nchw

ATOL_F32 = 1e-5
ATOL_BF16 = 5e-2
H = W = 32
K = 2
CFG = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
           state_combination="convgru", num_encoders=2, base_num_channels=8,
           num_residual_blocks=1, recurrent_block_type="conv", norm="none",
           use_upsample_conv=True, every_x_rgb_frame=K, baseline=False)
OPTIONS = {"fused": {"fused_decoder": "on"},
           "composed": {"composed_decoder": "on"}}


def _models(**over):
    d = {**CFG, **over}
    jcfg = JaxModelConfig.from_dict(d)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d))
    params_from_jax(model, params)
    return jcfg, params, model


def _supers(cfg, dtype, B=3, seed=5):
    """Per-scale hidden states as (JAX NHWC arrays, port NCHW-shaped
    channels_last tensors)."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H // 2 ** (i + 1), W // 2 ** (i + 1),
                      cfg.base_num_channels * 2 ** (i + 1)).astype(np.float32)
            for i in range(cfg.num_encoders)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return (tuple(jnp.asarray(a, jdt) for a in arrs),
            tuple(to_nchw(torch.from_numpy(a).to(dtype)) for a in arrs))


def _admit_float32(monkeypatch):
    """Both packages' K8 gates admit float32 (and JAX's kernel runs in
    interpret mode), so the fused legs run in float32 on the CPU."""
    real = upsample_conv.supports
    monkeypatch.setattr(upsample_conv, "supports", lambda x, cout, skip=None: (
        real(x.to(torch.bfloat16), cout,
             None if skip is None else skip.to(torch.bfloat16))
        and x.is_contiguous()))
    monkeypatch.setattr(jax_upsample_conv, "_INTERPRET", True)
    monkeypatch.setattr(jax_upsample_conv, "supports", lambda x, cout: (
        x.ndim == 4 and jax_upsample_conv._pick_tile_h(
            x.shape[1], x.shape[2], x.shape[3], cout, 4) > 0
        and x.shape[2] % 8 == 0))


class _Spy:
    """Counts the port's K8 wrapper calls."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = upsample_conv.upsample_conv_fused

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(upsample_conv, "upsample_conv_fused", spy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_decoder_fused_matches_jax(monkeypatch, dtype):
    bf16 = dtype == torch.bfloat16
    jcfg, params, model = _models(
        fused_decoder="on", compute_dtype="bfloat16" if bf16 else "float32")
    if bf16:
        monkeypatch.setattr(jax_upsample_conv, "_INTERPRET", True)
    else:
        _admit_float32(monkeypatch)
    spy = _Spy(monkeypatch)
    jsup, tsup = _supers(model.cfg, dtype)
    want = jstatenet.forward_decoder_supers(params, jcfg, jsup,
                                            allow_fused=True)
    net = model.statenetphasedrecurrent
    with torch.inference_mode():
        got = statenet.forward_decoder_supers(net, model.cfg, tsup,
                                              allow_fused=True)
        plain = statenet.forward_decoder_supers(net, model.cfg, tsup)
    assert spy.calls == model.cfg.num_encoders      # every layer took K8
    d = np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(want, np.float32))
    assert d.max() <= (ATOL_BF16 if bf16 else ATOL_F32), d.max()
    if not bf16:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL_F32)


def test_decoder_composed_matches_jax():
    jcfg, params, model = _models(composed_decoder="on")
    jsup, tsup = _supers(model.cfg, torch.float32, seed=6)
    want = jstatenet.forward_decoder_supers(params, jcfg, jsup,
                                            allow_composed=True)
    ref = jstatenet.forward_decoder_supers(params, jcfg, jsup)
    net = model.statenetphasedrecurrent
    with torch.inference_mode():
        got = statenet.forward_decoder_supers(net, model.cfg, tsup,
                                              allow_composed=True)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_F32,
                               rtol=ATOL_F32)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_F32,
                               rtol=ATOL_F32)


def test_fused_policy(monkeypatch):
    """'auto' and 'off' never take K8; 'on' takes it per layer only where
    ``supports`` holds (bf16 and channels_last memory); K8 refuses
    autograd inside the decoder."""
    spy = _Spy(monkeypatch)
    _, _, model = _models(compute_dtype="bfloat16")
    net = model.statenetphasedrecurrent
    _, sup = _supers(model.cfg, torch.bfloat16)
    _, sup32 = _supers(model.cfg, torch.float32)
    for mode, supers, calls in (("auto", sup, 0), ("off", sup, 0),
                                ("on", sup, 2), ("on", sup32, 0)):
        cfg = dataclasses.replace(model.cfg, fused_decoder=mode)
        spy.calls = 0
        with torch.no_grad():
            statenet.forward_decoder_supers(net, cfg, supers, allow_fused=True)
            assert spy.calls == calls, mode
            # without allow_fused no mode takes it
            statenet.forward_decoder_supers(net, cfg, supers)
        assert spy.calls == calls, mode
    cfg = dataclasses.replace(model.cfg, fused_decoder="on")
    # an NCHW-contiguous skip: the kernel copies nothing, so layer 1 falls
    # back to the two-stage layer and layer 0 still takes K8
    spy.calls = 0
    with torch.no_grad():
        statenet.forward_decoder_supers(
            net, cfg, (sup[0].contiguous(), sup[1]), allow_fused=True)
    assert spy.calls == 1
    with pytest.raises(RuntimeError, match="no gradient"):
        statenet.forward_decoder_supers(net, cfg, sup, allow_fused=True)


def test_composed_policy():
    """'on' always, 'off' never; 'auto' never on the CPU, and on CUDA as
    the rule re-derived on the H100 says: bf16 decode batches of at least
    24."""
    _, _, model = _models(compute_dtype="bfloat16")
    x = torch.zeros(96, 32, 8, 8, dtype=torch.bfloat16)
    for mode, want in (("on", True), ("off", False), ("auto", False)):
        cfg = dataclasses.replace(model.cfg, composed_decoder=mode)
        assert statenet._use_composed_decoder(cfg, x) is want, mode
    assert statenet.composed_auto("cuda", torch.bfloat16, 96)
    assert statenet.composed_auto("cuda", torch.bfloat16, 24)
    assert not statenet.composed_auto("cuda", torch.bfloat16, 23)
    assert not statenet.composed_auto("cuda", torch.float32, 96)
    assert not statenet.composed_auto("cpu", torch.bfloat16, 96)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """An on-disk test split of two sequences (5 and 4 packages)."""
    root = tmp_path_factory.mktemp("decoder_engines")
    for s, n in enumerate((10, 8)):
        generate_eventscape_sequence(str(root / "test" / f"s{s}"), seed=s,
                                     n_frames=n, height=H, width=W,
                                     events_per_frame=300)
    args = (str(root / "test"), "SequenceSynchronizedFramesEventsDataset",
            "events/voxels", "depth/data", "rgb/data")
    kw = dict(sequence_length=1, every_x_rgb_frame=K, clip_distance=80.0)
    return concatenate_subfolders(*args, **kw), jconcat(*args, **kw)


def _sequences(ds):
    """Per sequence (events [T, K, H, W, 5], image [T, H, W, 1])."""
    out = []
    for sub in ds.datasets:
        items = [sub[i] for i in range(len(sub))]
        out.append((np.stack([it["events"][0] for it in items]),
                    np.stack([it["image"][0] for it in items])))
    return out


def _run(engine, ds, model_or_params, cfg=None, **kw):
    """{global index: {key: [H, W, 1]}} of one engine over the split, the
    port's (cfg None) or the JAX package's."""
    jax_side = cfg is not None
    mod = jinference if jax_side else inference
    args = (model_or_params, cfg) if jax_side else (model_or_params,)
    got = {}
    if engine == "chunked":
        mod.run_chunked_streaming(
            ds, *args, chunk=4, **kw,
            on_prediction=lambda g, p, item, pos: got.__setitem__(
                g, {k: np.asarray(v) for k, v in p.items()}))
        return got
    idx = 0
    for ev, im in _sequences(ds):
        if engine == "scan":
            preds = mod.SequenceScanInference(*args, chunk=4, **kw
                                              ).run_sequence(ev, im)
            for t in range(len(ev)):
                got[idx + t] = {k: np.asarray(v[t]) for k, v in preds.items()}
        else:
            eng = mod.StreamingInference(*args, **kw)
            eng.reset(1, H, W)
            for t in range(len(ev)):
                got[idx + t] = {k: np.asarray(v) for k, v in
                                eng.step({"events": ev[t], "image": im[t]}).items()}
        idx += len(ev)
    return got


ENGINES = {"chunked": ("chunked", {}),
           "chunked_precompute": ("chunked", {"precompute_x": True}),
           "scan_batched_decode": ("scan", {"batched_decode": True}),
           "streaming_batched_decode": ("stream", {"batched_decode": True})}


def _max_diff(a, b):
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[g][k] - b[g][k]).max()) for g in a for k in a[g])


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_option_through_engines_matches_jax(monkeypatch, split, engine,
                                            option):
    jcfg, params, model = _models(**OPTIONS[option])
    port_ds, jds = split
    spy = _Spy(monkeypatch)
    if option == "fused":
        _admit_float32(monkeypatch)
    kind, kw = ENGINES[engine]
    got = _run(kind, port_ds, model, **kw)
    want = _run(kind, jds, params, jcfg, **kw)
    assert len(got) == 9 and set(got[0]) == {"events0", "events1", "image"}
    assert _max_diff(got, want) <= ATOL_F32
    # the option's layers ran: K8 on every decode of the port
    assert (spy.calls > 0) == (option == "fused")
    off = _run(kind, port_ds, _models()[2], **kw)
    assert _max_diff(got, off) <= ATOL_F32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_default_equals_streaming_bitwise(split, dtype):
    """SequenceScanInference's default and run_chunked_streaming's
    batched_decode=False run forward_sequence: the port's per-package
    streaming bit for bit (precomputed x or not), and JAX's engines'
    defaults at 1e-5 (float32) or 5e-2 (bf16)."""
    jcfg, params, model = _models(compute_dtype=dtype)
    port_ds, jds = split
    stream = _run("stream", port_ds, model)
    for kind, kw in (("scan", {}), ("chunked", {"batched_decode": False})):
        got = _run(kind, port_ds, model, **kw)
        assert sorted(got) == sorted(stream)
        for g in stream:
            for k in stream[g]:
                np.testing.assert_array_equal(got[g][k], stream[g][k])
        want = _run(kind, jds, params, jcfg, **kw)
        tol = ATOL_F32 if dtype == "float32" else ATOL_BF16
        assert _max_diff(got, {g: {k: np.asarray(v, np.float32)
                                   for k, v in p.items()}
                               for g, p in want.items()}) <= tol


ROUTES = [(b, dt, p) for b in (True, False) for dt in ("float32", "bfloat16")
          for p in (None, False)]


@pytest.mark.parametrize("batched,dtype,precompute", ROUTES)
def test_chunked_engines_route_as_jax(monkeypatch, batched, dtype,
                                      precompute):
    """batched_decode and _resolve_precompute -> the precomputed path;
    batched_decode otherwise -> forward_sequence_batched_decode with K8
    allowed and the composed layers for 'on' only; else forward_sequence.
    Both chunked engines, JAX's defaults."""
    cfg = ModelConfig.from_dict({**CFG, "compute_dtype": dtype,
                                 "composed_decoder": "on"})
    model = ERGB2DepthRecurrent(cfg)
    seen = []
    for name in ("forward_sequence_precomputed",
                 "forward_sequence_batched_decode", "forward_sequence"):
        monkeypatch.setattr(model, name, lambda s, seq, _n=name, **kw:
                            seen.append((_n, kw)) or (s, {}))
    inference.SequenceScanInference(
        model, chunk=2, batched_decode=batched, precompute_x=precompute
    ).run_sequence(np.zeros((2, K, H, W, 5), np.float32),
                   np.zeros((2, H, W, 1), np.float32))
    zeros = {"events": np.zeros((1, K, H, W, 5), np.float32),
             "image": np.zeros((1, H, W, 1), np.float32)}

    class Data:
        datasets = [[zeros, zeros]]

    inference.run_chunked_streaming(Data(), model, chunk=2,
                                    batched_decode=batched,
                                    precompute_x=precompute)
    pre = batched and precompute is None and dtype == "bfloat16"
    want = ("forward_sequence_precomputed" if pre
            else "forward_sequence_batched_decode" if batched
            else "forward_sequence")
    assert [n for n, _ in seen] == [want, want]
    if want == "forward_sequence_batched_decode":
        assert seen[0][1]["allow_fused_decoder"] is True
        assert seen[0][1]["allow_composed"] is True
        assert seen[0][1]["allow_fused"] is False
    # the engines' defaults, as JAX's
    for port, jax_fn, want in (
            (inference.SequenceScanInference, jinference.SequenceScanInference,
             False),
            (inference.run_chunked_streaming, jinference.run_chunked_streaming,
             True)):
        for fn in (port, jax_fn):
            default = inspect.signature(fn).parameters["batched_decode"].default
            assert default is want, fn
