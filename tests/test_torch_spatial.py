"""Spatial partitioning (``rpg_ramnet_tpu_torch/parallel/spatial.py``) on
CPU meshes (``[torch.device('cpu')] * n``), against the unsharded port and
the JAX package.

- Each row of ``spatial.HALO``: the layer over 2 and 4 row bands of a
  32-row input against the layer on the whole, in float32: 1e-6 for the
  plain layers and for the kernels' plain versions (their gates patched to
  admit float32 inside the test, as tests/test_torch_decoder_engines.py
  does), each kernel's wrapper called once per band; 1e-5 for the
  residual block's instance norm, whose statistics the bands add up.
  The traps: the stride-2 grid, the bilinear clamp, the two chained convs
  of the ConvGRU and the residual block, the phased gate's per-pixel tau
  and phase, the instance norm's statistics.
- The model: ``SpatialModel.forward_package`` on a 2x4 mesh (data 2,
  model 4) against the JAX package's unsharded ``forward_package`` on
  tests/test_parallel.py:37-68's config (2 encoders, base 4, K=2, 32x32,
  B=2) and its IN, concat, transposed-conv and phased variants, two
  packages (the state carried), at JAX's own 1e-5.  JAX's params come
  from the JAX package's reference loader (``state_dict_to_params``) of a
  seeded port model's state dict, and cross back with
  ``compat.params_from_jax``: the same weights on both sides without
  JAX's random init, whose eager compiles cost tens of seconds.
- The kernel routes through the model: bf16, base 8, fused_gru='auto'
  and fused_decoder='on' with allow_fused: the plain versions of K5 and
  K8 (flagship) and of K3 and K4 (phased) per band, against the same
  routes unsharded.
- ``StreamingInference(spatial_mesh=)`` on a 1x8 mesh (bands of one row
  at the deepest scale: halos from two neighbours) over 3 packages, with
  and without batched decode, and ``step_modality``, against the
  unsharded engine; ERGB2Depth's UNet likewise.
- The refusals: a band height that is not a multiple of
  2**num_encoders; the dry run's DP x SP legs (``dryrun_multichip(4)``).
- The kernels' gates and planners at the band shapes of the flagship and
  the phased regime over 2 and 4 bands.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import state_dict_to_params
from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel

from rpg_ramnet_tpu_torch import entry
from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core.config import MeshConfig, ModelConfig
from rpg_ramnet_tpu_torch.eval import inference
from rpg_ramnet_tpu_torch.models import (ERGB2Depth, ERGB2DepthRecurrent,
                                         layers, statenet)
from rpg_ramnet_tpu_torch.ops import gru_hside, upsample_conv
from rpg_ramnet_tpu_torch.parallel import make_mesh, spatial
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
H, W = 32, 24
ATOL_LAYER, ATOL_IN, ATOL_MODEL = 1e-6, 1e-5, 1e-5
ATOL_BF16 = 5e-2    # sigmoid maps after bf16 cells (tests/test_torch_lanes.py)
BASE = {"num_bins_rgb": 1, "num_bins_events": 5,
        "recurrent_block_type": "conv", "state_combination": "convgru",
        "num_encoders": 2, "base_num_channels": 4, "every_x_rgb_frame": 2,
        "baseline": False, "skip_type": "sum", "norm": "none"}
PHASED = {"recurrent_block_type": "convlstm",
          "state_combination": "convlstm", "use_phased_arch": True,
          "spatial_resolution": [32, 32]}


def _mesh(data, model):
    return make_mesh(MeshConfig(data=data, model=model), [CPU] * (data * model))


def _x(*shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).contiguous(
        memory_format=torch.channels_last)


def _spy(monkeypatch, module, name):
    """Count the calls of module.name."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def _admit_float32(monkeypatch):
    """The kernels' gates admit float32, so their plain versions run in
    float32 on the CPU."""
    for name in ("supports_full", "supports_lstm"):
        real = getattr(gru_hside, name)
        monkeypatch.setattr(gru_hside, name,
                            lambda h, real=real: real(h.to(torch.bfloat16)))
    real = upsample_conv.supports
    monkeypatch.setattr(upsample_conv, "supports", lambda x, cout, skip=None:
                        real(x.to(torch.bfloat16), cout,
                             None if skip is None else skip.to(torch.bfloat16)))


def _cfg(**over):
    return ModelConfig.from_dict({**BASE, **over})


# -- the rows of the halo table ----------------------------------------------
#
# A case gives (run: (bands, per-band inputs) -> per-band outputs, whole:
# (*inputs) -> output, inputs, the spied kernel's calls or None, atol).


def _on_bands(kind, fn):
    return lambda bands, cut: bands.run(kind, fn, *cut)


def _combine_case(kind, comb_name, kernel=None, c=16):
    cfg = _cfg(state_combination=comb_name)

    def case(monkeypatch, n):
        comb = (layers.ConvLayer(2 * c, c, 5, 1, 2) if comb_name == "conv"
                else layers.RecurrentConvLayer(c, comb_name))
        h = _x(2, c, H, W, seed=2)
        prev = (h, _x(2, c, H, W, seed=3)) if comb_name == "convlstm" else h
        calls = None
        if kernel:
            _admit_float32(monkeypatch)
            calls = _spy(monkeypatch, gru_hside, kernel)

        def fn(xb, pb):
            return statenet._combine(cfg, comb, xb, pb, kernel is not None,
                                     None)
        return (_on_bands(kind, lambda m, xb, pb: fn(xb, pb)), fn,
                (_x(2, c, H, W, seed=1), prev), calls, ATOL_LAYER)
    return case


def _decoder_case(kind, over, allow_fused=False, allow_composed=False):
    cfg = _cfg(**over)

    def case(monkeypatch, n):
        cin = 32 if cfg.skip_type == "concat" else 16
        dec = statenet.decoder_layer(cfg, cin, 8)
        calls = None
        if allow_fused:
            _admit_float32(monkeypatch)
            calls = _spy(monkeypatch, upsample_conv, "upsample_conv_fused")

        def fn(xb, sb):
            return statenet.decode_layer(cfg, dec, xb, sb, allow_fused,
                                         allow_composed)
        return (_on_bands(kind, lambda m, xb, sb: fn(xb, sb)), fn,
                (_x(2, 16, H, W, seed=4), _x(2, 16, H, W, seed=5)), calls,
                ATOL_LAYER)
    return case


def _phased_case(fused):
    def case(monkeypatch, n):
        cell = layers.PhasedConvLSTM(16, 16, H, W)
        cell.phased_cell.reset_parameters_(torch.Generator().manual_seed(6))
        reps = [copy.deepcopy(cell) for _ in range(n)]
        for m, r in enumerate(reps):
            spatial._narrow_phased_gates(r, m, n)
        calls = _spy(monkeypatch, layers, "conv_lstm_phased") if fused else None
        t = torch.tensor([0.3, 1.7])
        state = (_x(2, 16, H, W, seed=7), _x(2, 16, H, W, seed=8))
        return (_on_bands("phased_cell",
                          lambda m, xb, sb: reps[m](xb, t, sb, fused=fused)),
                lambda xb, sb: cell(xb, t, sb, fused=fused),
                (_x(2, 16, H, W, seed=9), state), calls, ATOL_LAYER)
    return case


def _module_case(kind, make, cin):
    def case(monkeypatch, n):
        mod = make()
        return (_on_bands(kind, lambda m, xb: mod(xb)), mod,
                (_x(2, cin, H, W, seed=10),), None, ATOL_LAYER)
    return case


def _resblock_in_case(monkeypatch, n):
    block = layers.ResidualBlock(16, "IN")
    return ((lambda bands, cut: spatial._resblock(bands, [block] * n, *cut)),
            block, (_x(2, 16, H, W, seed=11),), None, ATOL_IN)


LAYER_CASES = {
    "head": _module_case("head", lambda: layers.ConvLayer(5, 8, 5, 1, 2), 5),
    "strided": _module_case("strided",
                            lambda: layers.ConvLayer(8, 16, 5, 2, 2), 8),
    "convgru": _combine_case("convgru", "convgru"),
    "convgru-K5": _combine_case("convgru", "convgru", "conv_gru_full"),
    "convlstm": _combine_case("convlstm", "convlstm"),
    "convlstm-K3": _combine_case("convlstm", "convlstm", "conv_lstm_hside"),
    "phased_cell": _phased_case(False),
    "phased_cell-K4": _phased_case(True),
    "conv_comb": _combine_case("conv_comb", "conv"),
    "resblock": _module_case("resblock", lambda: layers.ResidualBlock(16), 16),
    "resblock-IN": _resblock_in_case,
    "upsample_conv": _decoder_case("upsample_conv", {}),
    "upsample_conv-composed": _decoder_case(
        "upsample_conv", {"composed_decoder": "on"}, allow_composed=True),
    "upsample_conv-fast": _decoder_case("upsample_conv",
                                        {"fast_upsample": True}),
    "upsample_conv-K8": _decoder_case("upsample_conv",
                                      {"fused_decoder": "on"},
                                      allow_fused=True),
    "upsample_conv-concat": _decoder_case("upsample_conv",
                                          {"skip_type": "concat"}),
    "transposed_conv": _decoder_case("transposed_conv",
                                     {"use_upsample_conv": False}),
    "pointwise": _module_case("pointwise", lambda: layers.ConvLayer(
        8, 1, 1, 1, 0, activation=None), 8),
}


def _cut(x, n):
    """x (or a tuple of tensors) cut into n row bands."""
    if isinstance(x, tuple):
        return [tuple(p) for p in zip(*(_cut(t, n) for t in x))]
    h = x.shape[2] // n
    return [x[:, :, m * h:(m + 1) * h].contiguous(
        memory_format=torch.channels_last) for m in range(n)]


def _join(outs):
    """Per-band outputs (tensors or nested tuples) joined on H."""
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=2)
    return tuple(_join([o[i] for o in outs]) for i in range(len(outs[0])))


def _leaves(t):
    return [t] if isinstance(t, torch.Tensor) else [
        x for s in t for x in _leaves(s)]


def test_halo_table_rows_are_tested():
    assert {c.split("-")[0] for c in LAYER_CASES} == set(spatial.HALO)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_halo_row_matches_unsharded_layer(monkeypatch, case, n):
    run, whole, inputs, calls, atol = LAYER_CASES[case](monkeypatch, n)
    with torch.inference_mode():
        want = whole(*inputs)
        if calls is not None:
            calls.clear()
        got = _join(run(spatial.Bands([CPU] * n), [_cut(x, n) for x in inputs]))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape, case
        d = float((g - w).abs().max())
        assert d <= atol, (case, n, d)
    if calls is not None:
        assert len(calls) == n      # the kernel's wrapper once per band


# -- the model against the JAX package ---------------------------------------

MODEL_CASES = {"flagship": {}, "IN": {"norm": "IN"},
               "concat": {"skip_type": "concat"},
               "transposed": {"use_upsample_conv": False}, "phased": PHASED}


def _packages(cfg, n, batch, seed):
    """n packages [B, ...] (numpy float32), timestamps in the phased
    regime."""
    rng = np.random.RandomState(seed)
    K = cfg.every_x_rgb_frame
    t0 = np.zeros((batch, 1), np.float32)
    out = []
    for _ in range(n):
        pkg = {"events": rng.randn(batch, K, 32, 32, 5).astype(np.float32),
               "image": rng.rand(batch, 32, 32, 1).astype(np.float32)}
        if cfg.use_phased_arch:
            te = (t0 + np.cumsum(rng.uniform(0.01, 0.1, (batch, K)), 1)
                  ).astype(np.float32)
            pkg["times_events"] = te
            pkg["times_image"] = (te[:, -1] + 0.05).astype(np.float32)
            t0 = pkg["times_image"][:, None]
        out.append(pkg)
    return out


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_forward_package_on_2x4_mesh_matches_jax(case):
    d = {**BASE, **MODEL_CASES[case]}
    seeded = ERGB2DepthRecurrent(ModelConfig.from_dict(d),
                                 generator=torch.Generator().manual_seed(2))
    params = state_dict_to_params(
        {k: v.numpy() for k, v in seeded.state_dict().items()})
    model = params_from_jax(ERGB2DepthRecurrent(ModelConfig.from_dict(d)),
                            params).eval()
    jcfg = JaxModelConfig.from_dict(d)
    fwd = jax.jit(lambda p, s, x: JaxModel.forward_package(p, jcfg, s, x))
    jstate = JaxModel.init_state(jcfg, 2, 32, 32)
    mesh = _mesh(2, 4)
    sm = spatial.SpatialModel(model, mesh)
    state = sm.init_state(2, 32, 32)
    for t, pkg in enumerate(_packages(model.cfg, 2, 2, seed=0)):
        jstate, want = fwd(params, jstate,
                           {k: jnp.asarray(v) for k, v in pkg.items()})
        with torch.inference_mode():
            state, got = sm.forward_package(
                state, spatial.shard_package_spatial(pkg, mesh))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=ATOL_MODEL, rtol=ATOL_MODEL,
                                       err_msg=f"{case} package {t} {k}")


@pytest.mark.parametrize("case", ["flagship", "phased"])
def test_kernel_routes_run_per_band(monkeypatch, case):
    """bf16, base 8 (the kernels' C % 16): the plain versions of the
    kernels the fused_gru and fused_decoder policies take, once per band
    and cell, against the same routes unsharded; the state and the maps
    of the batched decode too."""
    cfg = ModelConfig.from_dict({**BASE, **MODEL_CASES[case],
                                 "base_num_channels": 8,
                                 "compute_dtype": "bfloat16",
                                 "fused_decoder": "on"})
    model = ERGB2DepthRecurrent(cfg).eval()
    spies = ({"K5": _spy(monkeypatch, gru_hside, "conv_gru_full"),
              "K8": _spy(monkeypatch, upsample_conv, "upsample_conv_fused")}
             if case == "flagship" else
             {"K3": _spy(monkeypatch, gru_hside, "conv_lstm_hside"),
              "K4": _spy(monkeypatch, layers, "conv_lstm_phased")})
    mesh = _mesh(1, 4)
    sm = spatial.SpatialModel(model, mesh)
    flags = dict(allow_fused=True, allow_fused_decoder=True)
    pkgs = _packages(cfg, 2, 1, seed=3)
    with torch.inference_mode():
        state = model.init_state(1, 32, 32)
        bands = sm.init_state(1, 32, 32)
        for pkg in pkgs:
            state, want = model.forward_package_batched_decode(
                state, {k: torch.from_numpy(v) for k, v in pkg.items()},
                **flags)
            whole = {k: len(v) for k, v in spies.items()}
            bands, got = sm.forward_package_batched_decode(
                bands, spatial.shard_package_spatial(pkg, mesh), **flags)
            for k, v in spies.items():
                assert len(v) == 5 * whole[k] > 0, k   # 4 bands after 1
                v.clear()
            for k in want:
                d = float((got[k].float() - want[k].float()).abs().max())
                assert d <= ATOL_BF16, (k, d)
    joined = spatial.gather_spatial(bands)
    for g, w in zip(_leaves(joined), _leaves(state)):
        assert float((g.float() - w.float()).abs().max()) <= ATOL_BF16


# -- the engine, the refusals, the dry run -----------------------------------

@pytest.mark.parametrize("case", ["flagship", "phased", "unet"])
def test_streaming_engine_on_1x8_mesh_matches_unsharded(case):
    unet = case == "unet"
    cfg = ModelConfig.from_dict({**BASE, **MODEL_CASES.get(case, {})})
    model = (ERGB2Depth if unet else ERGB2DepthRecurrent)(cfg).eval()
    mesh = _mesh(1, 8)
    engines = [(inference.StreamingInference(model, batched_decode=True),
                inference.StreamingInference(model, batched_decode=True,
                                             spatial_mesh=mesh)),
               (inference.StreamingInference(model, decode_keys=("image",)),
                inference.StreamingInference(model, decode_keys=("image",),
                                             spatial_mesh=mesh))]
    for t, pkg in enumerate(_packages(cfg, 3, 1, seed=4)):
        item = {k: v[0] for k, v in pkg.items()}
        for plain, banded in engines:
            want, got = plain.step(item), banded.step(item)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=ATOL_MODEL,
                                           err_msg=f"{case} step {t} {k}")
    if unet:
        return
    # the live path: one modality per call, the state carried on
    plain, banded = engines[0]
    for modality, x in (("events", item["events"][0]),
                        ("image", item["image"])):
        np.testing.assert_allclose(banded.step_modality(x, modality),
                                   plain.step_modality(x, modality),
                                   atol=ATOL_MODEL)


def test_uneven_bands_refused():
    model = ERGB2DepthRecurrent(_cfg())
    sm = spatial.SpatialModel(model, _mesh(1, 4))
    # 36 rows over 4 bands: 9 rows, not a multiple of 2**2
    with pytest.raises(ValueError, match="multiple of 2\\*\\*num_encoders"):
        sm.init_state(1, 36, 32)
    pkg = {"events": np.zeros((1, 2, 40, 32, 5), np.float32),
           "image": np.zeros((1, 40, 32, 1), np.float32)}
    with pytest.raises(ValueError, match="multiple of 2\\*\\*num_encoders"):
        sm.forward_package(sm.init_state(1, 32, 32),
                           spatial.shard_package_spatial(pkg, _mesh(1, 4)))
    # the phased gates fix H: spatial_resolution over the bands
    phased = ERGB2DepthRecurrent(ModelConfig.from_dict(
        {**BASE, **PHASED, "spatial_resolution": [24, 32]}))
    with pytest.raises(ValueError, match="multiple of 2\\*\\*num_encoders"):
        spatial.SpatialModel(phased, _mesh(1, 4))
    # one stream over two data rows
    with pytest.raises(ValueError, match="does not divide"):
        spatial.SpatialModel(model, _mesh(2, 2)).init_state(1, 32, 32)


def test_dryrun_dp_sp_legs():
    out = entry.dryrun_multichip(4, device="cpu")
    assert out["lane_finite"]
    for leg in ("dp_sp", "dp_sp_flagship"):
        assert out[f"{leg}_max_abs_err"] <= ATOL_MODEL, leg


@pytest.mark.parametrize("n", [2, 4])
def test_kernels_take_the_band_shapes(n):
    """At 256x512 (the flagship) and 256x352 (phased) over n bands, every
    band with its halo (an edge band and, over 4, a middle one) is a shape
    the kernels' gates and planners take: K5 and K8 (the flagship's 3
    scales and decoder layers, decode batch 6), K3 and K4 (phased), so
    the band shapes run the kernels as the whole shapes do."""
    flagship = [(1, 128 >> s, 256 >> s, 64 << s) for s in range(3)]
    phased = [(1, 128 >> s, 176 >> s, 64 << s) for s in range(3)]
    layers_ = [(256, 128, 32, 64), (128, 64, 64, 128), (64, 32, 128, 256)]

    def bands(h, kind):
        rows = spatial.HALO[kind][0]
        return {h // n + top + bottom
                for top, bottom in spatial._taken(n, h // n, rows)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    for B, h, w, c in flagship:
        for hb in bands(h, "convgru"):
            assert gru_hside.supports_full(zeros(B, hb, w, c)), (hb, w, c)
    for kind in ("convlstm", "phased_cell"):
        for B, h, w, c in phased:
            for hb in bands(h, kind):
                assert gru_hside.supports_lstm(zeros(B, hb, w, c)), (hb, w, c)
                assert gru_hside.plan_lstm(B, hb, w, c, phased=True)
    for i, (c, cout, h, w) in enumerate(layers_):
        for hb in bands(h, "upsample_conv"):
            x = zeros(6, hb, w, c)
            assert upsample_conv.supports(x, cout, x if i else None), (hb, c)
