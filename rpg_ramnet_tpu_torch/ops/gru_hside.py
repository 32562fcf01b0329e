"""The fused ConvGRU h-side cell: forward (K1), its residual variant for
training (K1-res), its backward (K2), and the autograd.Function over them.

Counterpart of ``rpg_ramnet_tpu/ops/gru_hside.py``: ``conv_gru_hside_fused``
and its custom VJP (``_gru_hside_cell``: Pallas ``_run``/``_kernel`` and
``_kernel_res`` forward, ``_run_bwd``/``_bwd_kernel`` or
``_gru_hside_bwd_xla`` backward).  The CUDA kernels are
``csrc/gru_hside.cu`` (K1, K1-res) and ``csrc/gru_hside_bwd.cu`` (K2); their
headers say what bounds them on an H100 and what the design does about it.

    z, r = sigmoid(conv3x3(h, W_ur) + gx[..., :2C])
    o    = tanh(conv3x3(bf16(r * h), W_o) + gx[..., 2C:])
    h'   = h * (1 - z) + o * z

Tensors are NHWC: h [B, H, W, C], gx [B, H, W, 3C] in (update, reset, out)
order with the biases folded in (``ConvGRU.x_gates``), and the h slices of
the gate weights folded by ``ConvGRU.hside_weights``: w_ur [9, 2C, C]
(update rows, then reset rows) and w_o [9, C, C], indexed (ky*3 + kx, out,
in): the tensor cores' B operand, contiguous along the contraction.  acts
[B, H, W, 3C] = (z, r, o) in h's dtype.

Each kernel has a plain PyTorch version here (``*_plain``), and each wrapper
runs it for a tensor on the CPU and launches the kernel for a CUDA tensor;
on a CUDA tensor it launches or raises.  ``<wrapper>.launches`` counts the
kernel's launches.  The kernels take bf16 and C % 16 == 0 (one mma k-step of
channels); the plain versions any float dtype and C % 8 == 0.

``conv_gru_hside`` is the entry point: without autograd it runs K1; when a
gradient is needed it runs ``ConvGRUHside``, whose forward runs K1-res and
whose backward runs K2 for dh and dgx and two library convolutions for the
weight gradients (the counterpart of ``_dconv_w``, which the JAX package
also leaves to XLA).

``conv_gru_full`` is the whole cell on cat(x, h) with biases, for the
per-package streaming path where no gx exists: kernel K5
(``csrc/gru_full.cu``), the counterpart of ``conv_gru_full_fused``
(``_run_full``/``_full_kernel``).  Inference only, as the JAX kernel (no
VJP).  Its weights are ``ConvGRU.full_weights``: w_ur [9, 2C, 2C] (update
rows, then reset rows; x columns, then h columns), w_o [9, C, 2C], biases
b_ur [2C] and b_o [C] in float32.

``conv_lstm_hside`` is the ConvLSTM h-side cell for the ConvLSTM state
combination: kernel K3 (``csrc/lstm_hside.cu``), the counterpart of
``conv_lstm_hside_fused`` (``_run_lstm``/``_lstm_kernel``).  From the conv
operand h, the cell input c and gx [B, H, W, 4C] in (in, remember, out,
cell) order with the biases folded in (``ConvLSTM.x_gates``):

    i, f, o = sigmoid(conv3x3(h, W4) + gx[i, f, o]);  u = tanh(... + gx[u])
    c' = f * c + i * u;   h' = o * tanh(c')

with w4 [9, 4C, C] = ``ConvLSTM.hside_weights``.  Inference only here: it
raises under autograd (the VJP, ``_lstm_hside_bwd``, comes with training).
The phased cell K4 is the same source with a template flag
(``ops/phased_cell.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.layout import to_nchw, to_nhwc

# H x W output tiles the wrappers choose from, largest first.  A K1 block
# holds the h tile with a 2-pixel halo and a = r*h with a 1-pixel ring in
# shared memory, a K2 block dpre_o with a 2-pixel ring, [dpre_z | dpre_r]
# with a 1-pixel ring and da*r at the tile in f32; smaller tiles recompute
# more of the ring but give more blocks.
_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
_SMEM_MAX = 232448           # bytes a block may use on Hopper
_SMEM_TWO_BLOCKS = 110 * 1024
_MIN_BLOCKS = 128            # about one block per SM of the 132


def smem_bytes(tile_h: int, tile_w: int, C: int) -> int:
    """K1: the h tile with its 2-pixel halo and the a tile with its 1-pixel
    ring, bf16, at the kernel's pixel pitch of C + 8."""
    return ((tile_h + 4) * (tile_w + 4) + (tile_h + 2) * (tile_w + 2)) \
        * (C + 8) * 2


def smem_bytes_bwd(tile_h: int, tile_w: int, C: int) -> int:
    """K2: dpre_o with a 2-pixel ring (pitch C + 8), [dpre_z | dpre_r] with
    a 1-pixel ring (pitch 2C + 8), both bf16, and da*r at the tile in f32."""
    return ((tile_h + 4) * (tile_w + 4) * (C + 8) * 2
            + (tile_h + 2) * (tile_w + 2) * (2 * C + 8) * 2
            + tile_h * tile_w * C * 4)


def smem_bytes_full(tile_h: int, tile_w: int, C: int) -> int:
    """K5: [x | h] with a 2-pixel halo at pitch 2C + 8 and a = r*h with a
    1-pixel ring at pitch C + 8, bf16."""
    return ((tile_h + 4) * (tile_w + 4) * (2 * C + 8)
            + (tile_h + 2) * (tile_w + 2) * (C + 8)) * 2


def smem_bytes_lstm(tile_h: int, tile_w: int, C: int) -> int:
    """K3 and K4: the conv operand's tile with a 1-pixel halo, bf16, at
    pitch C + 8."""
    return (tile_h + 2) * (tile_w + 2) * (C + 8) * 2


def pick_tile(B: int, H: int, W: int, C: int, smem=smem_bytes
              ) -> Optional[Tuple[int, int]]:
    """The largest tile that leaves room for two blocks per SM and still
    gives about one block per SM; else the smallest tile that fits.  None
    when no tile fits in shared memory.  smem: the kernel's footprint."""
    fits = [t for t in _TILES if smem(*t, C) <= _SMEM_MAX]
    if not fits:
        return None
    for th, tw in fits:
        blocks = B * math.ceil(H / th) * math.ceil(W / tw)
        if smem(th, tw, C) <= _SMEM_TWO_BLOCKS and blocks >= _MIN_BLOCKS:
            return th, tw
    return fits[-1]


def supports(h: torch.Tensor) -> bool:
    """Whether the kernels take this NHWC state's dtype and shape: bf16,
    4-D, C a multiple of 16 and a forward and a backward tile that fit in
    shared memory."""
    return (h.dtype == torch.bfloat16 and h.dim() == 4
            and h.shape[-1] % 16 == 0 and pick_tile(*h.shape) is not None
            and pick_tile(*h.shape, smem=smem_bytes_bwd) is not None)


def supports_full(h: torch.Tensor) -> bool:
    """Whether K5 takes this NHWC state (and an x of its shape): bf16,
    4-D, C a multiple of 16 and a tile that fits K5's shared memory."""
    return (h.dtype == torch.bfloat16 and h.dim() == 4
            and h.shape[-1] % 16 == 0
            and pick_tile(*h.shape, smem=smem_bytes_full) is not None)


def supports_lstm(h: torch.Tensor) -> bool:
    """Whether K3 and K4 take this NHWC state: bf16, 4-D, C a multiple of
    16 and a tile that fits their shared memory."""
    return (h.dtype == torch.bfloat16 and h.dim() == 4
            and h.shape[-1] % 16 == 0
            and pick_tile(*h.shape, smem=smem_bytes_lstm) is not None)


# -- plain versions ---------------------------------------------------------


def _work_dtype(h: torch.Tensor) -> torch.dtype:
    """float32 for bf16/f32 states, float64 for float64 (gradcheck)."""
    return torch.promote_types(h.dtype, torch.float32)


def _oihw(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Folded [9, O, C] -> OIHW [O, C, 3, 3]."""
    return w.to(dt).reshape(3, 3, w.shape[1], w.shape[2]).permute(2, 3, 0, 1)


def _cell_plain(h, gx, w_ur, w_o):
    """(h', z, r, o) NCHW: convs and gates in the work dtype on the inputs'
    values (weights rounded to h's dtype), a = r*h rounded to h's dtype
    before the out-gate conv, h' rounded to h's dtype."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    hf = to_nchw(h).to(dt)
    g = to_nchw(gx).to(dt)
    ur = torch.sigmoid(F.conv2d(hf, _oihw(w_ur.to(h.dtype), dt), None, 1, 1)
                       + g[:, :2 * C])
    z, r = ur[:, :C], ur[:, C:]
    a = (r * hf).to(h.dtype).to(dt)
    o = torch.tanh(F.conv2d(a, _oihw(w_o.to(h.dtype), dt), None, 1, 1)
                   + g[:, 2 * C:])
    return (hf * (1.0 - z) + o * z).to(h.dtype), z, r, o


def conv_gru_hside_plain(h: torch.Tensor, gx: torch.Tensor,
                         w_ur: torch.Tensor, w_o: torch.Tensor
                         ) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch (``_cell_plain``): the CPU
    implementation of ``conv_gru_hside`` and the kernel's oracle on the
    card."""
    return to_nhwc(_cell_plain(h, gx, w_ur, w_o)[0]).contiguous()


def conv_gru_hside_res_plain(h: torch.Tensor, gx: torch.Tensor,
                             w_ur: torch.Tensor, w_o: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-res in plain PyTorch: (h', acts = (z, r, o) in h's dtype)."""
    h_new, z, r, o = _cell_plain(h, gx, w_ur, w_o)
    acts = torch.cat([z, r, o], dim=1).to(h.dtype)
    return to_nhwc(h_new).contiguous(), to_nhwc(acts).contiguous()


def conv_gru_hside_bwd_plain(g: torch.Tensor, h: torch.Tensor,
                             acts: torch.Tensor, w_ur: torch.Tensor,
                             w_o: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 in plain PyTorch, the counterpart of ``_gru_hside_bwd_xla``:
    (dh, dgx) in h's dtype from the cotangent g of h', with the gate chain
    in the work dtype and the transposed convs on operands rounded to h's
    dtype."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    a = to_nchw(acts).to(dt)
    z, r, o = a[:, :C], a[:, C:2 * C], a[:, 2 * C:]
    hf = to_nchw(h).to(dt)
    gf = to_nchw(g).to(dt)

    def rounded(x):
        return x.to(h.dtype).to(dt)

    dpre_o = (gf * z) * (1.0 - o * o)
    dpre_z = gf * (o - hf) * z * (1.0 - z)
    da = F.conv_transpose2d(rounded(dpre_o), _oihw(w_o.to(h.dtype), dt),
                            None, 1, 1)
    dpre_r = (da * hf) * r * (1.0 - r)
    dh = gf * (1.0 - z) + da * r
    dh = dh + F.conv_transpose2d(rounded(torch.cat([dpre_z, dpre_r], 1)),
                                 _oihw(w_ur.to(h.dtype), dt), None, 1, 1)
    dgx = torch.cat([dpre_z, dpre_r, dpre_o], 1).to(h.dtype)
    return to_nhwc(dh.to(h.dtype)).contiguous(), to_nhwc(dgx).contiguous()


def conv_gru_full_plain(x: torch.Tensor, h: torch.Tensor,
                        w_ur: torch.Tensor, w_o: torch.Tensor,
                        b_ur: torch.Tensor, b_o: torch.Tensor
                        ) -> torch.Tensor:
    """K5's arithmetic in plain PyTorch: convs and gates in the work dtype
    on x and the weights rounded to h's dtype, float32 biases,
    a = bf16(r*h) before the out gate's conv on cat(x, a), h' rounded to
    h's dtype.  The CPU implementation of ``conv_gru_full`` and the
    kernel's oracle on the card."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    xf = to_nchw(x.to(h.dtype)).to(dt)
    hf = to_nchw(h).to(dt)
    ur = torch.sigmoid(F.conv2d(torch.cat([xf, hf], 1),
                                _oihw(w_ur.to(h.dtype), dt), b_ur.to(dt), 1, 1))
    z, r = ur[:, :C], ur[:, C:]
    a = (r * hf).to(h.dtype).to(dt)
    o = torch.tanh(F.conv2d(torch.cat([xf, a], 1),
                            _oihw(w_o.to(h.dtype), dt), b_o.to(dt), 1, 1))
    return to_nhwc((hf * (1.0 - z) + o * z).to(h.dtype)).contiguous()


def lstm_gates_plain(h: torch.Tensor, gx: torch.Tensor, w4: torch.Tensor):
    """The ConvLSTM gate activations (i, f, o, u), NCHW in the work dtype:
    the conv of h with w4 (rounded to h's dtype) plus gx, then the
    activations (the shared body of K3's and K4's plain versions)."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    g = (F.conv2d(to_nchw(h).to(dt), _oihw(w4.to(h.dtype), dt), None, 1, 1)
         + to_nchw(gx).to(dt))
    return (torch.sigmoid(g[:, :C]), torch.sigmoid(g[:, C:2 * C]),
            torch.sigmoid(g[:, 2 * C:3 * C]), torch.tanh(g[:, 3 * C:]))


def conv_lstm_hside_plain(h: torch.Tensor, c: torch.Tensor, gx: torch.Tensor,
                          w4: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's arithmetic in plain PyTorch: gates and cell in the work dtype,
    (h', c') rounded to h's dtype, h' from the unrounded c'.  The CPU
    implementation of ``conv_lstm_hside`` and the kernel's oracle on the
    card."""
    i, f, o, u = lstm_gates_plain(h, gx, w4)
    cell = f * to_nchw(c).to(i.dtype) + i * u
    hid = o * torch.tanh(cell)
    return (to_nhwc(hid.to(h.dtype)).contiguous(),
            to_nhwc(cell.to(h.dtype)).contiguous())


def hside_weight_grads(h: torch.Tensor, acts: torch.Tensor,
                       dgx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The h-side weight gradients, folded [9, 2C, C] and [9, C, C], as
    library convolutions in h's dtype (f32 accumulation): W_ur's from h and
    dgx's (z, r) part, W_o's from a = bf16(r*h) and dgx's o part.  The
    counterpart of ``_dconv_w`` in ``_gru_hside_bwd_xla``."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    a = (acts[..., C:2 * C].to(dt) * h.to(dt)).to(h.dtype)
    ds = to_nchw(dgx.to(h.dtype))

    def wgrad(x, d, rows):
        w = torch.nn.grad.conv2d_weight(to_nchw(x), (rows, C, 3, 3), d,
                                        padding=1)
        return w.permute(2, 3, 0, 1).reshape(9, rows, C)

    return wgrad(h, ds[:, :2 * C], 2 * C), wgrad(a, ds[:, 2 * C:], C)


# -- the kernels ------------------------------------------------------------


def _check(h, gx, w_ur, w_o) -> None:
    if h.dim() != 4:
        raise ValueError(f"h must be NHWC [B, H, W, C], got {tuple(h.shape)}")
    B, H, W, C = h.shape
    if C % 8:
        raise ValueError(f"C must be a multiple of 8, got {C}")
    for name, t, shape in (("gx", gx, (B, H, W, 3 * C)),
                           ("w_ur", w_ur, (9, 2 * C, C)),
                           ("w_o", w_o, (9, C, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ERR = {"ramnet_cuda_error_string": (ctypes.c_char_p, (_I,))}
_FWD_SIGNATURES = {
    "ramnet_gru_hside_forward": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _L, _I, _I, _P)),
    "ramnet_gru_hside_forward_res": (_I, (_P, _P, _P, _P, _P, _P, _I, _I,
                                          _I, _I, _L, _I, _I, _P)),
    **_ERR,
}
_BWD_SIGNATURES = {
    "ramnet_gru_hside_backward": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _P)),
    **_ERR,
}
_FULL_SIGNATURES = {
    "ramnet_gru_full_forward": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _P)),
    **_ERR,
}
_LSTM_SIGNATURES = {
    "ramnet_lstm_hside_forward": (_I, (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _L, _I, _I, _P)),
    "ramnet_lstm_phased_forward": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _I, _L, _I, _I,
                                        ctypes.c_float, ctypes.c_float, _P)),
    **_ERR,
}
# csrc/<name>.cu; lstm_hside holds K3 and the phased cell K4
SOURCES = ("gru_hside", "gru_hside_bwd", "gru_full", "lstm_hside")


def library():
    """The built and loaded K1/K1-res library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_hside", _FWD_SIGNATURES)


def library_bwd():
    """The built and loaded K2 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_hside_bwd", _BWD_SIGNATURES)


def library_full():
    """The built and loaded K5 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_full", _FULL_SIGNATURES)


def library_lstm():
    """The built and loaded K3/K4 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("lstm_hside", _LSTM_SIGNATURES)


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ramnet_cuda_error_string(err).decode())


def _check_launch(*tensors) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("the CUDA kernels take bf16 tensors; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if tensors[0].shape[-1] % 16:
        raise ValueError("the CUDA kernels take C % 16 == 0, got "
                         f"C={tensors[0].shape[-1]}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernels' tensors must be 16-byte aligned")


def _tile(h, smem) -> Tuple[int, int]:
    tile = pick_tile(*h.shape, smem=smem)
    if tile is None:
        raise ValueError(f"C={h.shape[-1]} does not fit the kernel's shared "
                         "memory")
    return tile


def _gx_bstride(h, gx, gates: int = 3) -> int:
    B, H, W, C = h.shape
    if gx.stride()[1:] != (W * gates * C, gates * C, 1):
        raise ValueError("gx must be contiguous within each batch item "
                         f"(strides {gx.stride()})")
    stride = gx.stride(0) if B > 1 else H * W * gates * C
    if stride % 8:
        raise ValueError("gx's batch stride must keep 16-byte alignment")
    return stride


def _launch(h, gx, w_ur, w_o, residuals: bool):
    _check_launch(h, gx, w_ur, w_o)
    if not (h.is_contiguous() and w_ur.is_contiguous()
            and w_o.is_contiguous()):
        raise ValueError("h, w_ur and w_o must be contiguous")
    B, H, W, C = h.shape
    gx_bstride = _gx_bstride(h, gx)
    th, tw = _tile(h, smem_bytes)
    lib = library()
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if residuals:
        acts = torch.empty((B, H, W, 3 * C), dtype=h.dtype, device=h.device)
        err = lib.ramnet_gru_hside_forward_res(
            h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
            out.data_ptr(), acts.data_ptr(), B, H, W, C, gx_bstride, th, tw,
            stream)
        _raise_on(err, lib, "gru_hside_res")
        conv_gru_hside_res.launches += 1
        return out, acts
    err = lib.ramnet_gru_hside_forward(
        h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
        out.data_ptr(), B, H, W, C, gx_bstride, th, tw, stream)
    _raise_on(err, lib, "gru_hside")
    conv_gru_hside.launches += 1
    return out


def _launch_bwd(g, h, acts, w_ur, w_o):
    B, H, W, C = h.shape
    g, h, acts = g.contiguous(), h.contiguous(), acts.contiguous()
    # convT = correlation with the flipped, in/out-swapped weights
    wb_ur = w_ur.flip(0).transpose(1, 2).contiguous()    # [9, C, 2C]
    wb_o = w_o.flip(0).transpose(1, 2).contiguous()      # [9, C, C]
    _check_launch(h, g, acts, wb_ur, wb_o)
    th, tw = _tile(h, smem_bytes_bwd)
    lib = library_bwd()
    dh = torch.empty_like(h)
    dgx = torch.empty((B, H, W, 3 * C), dtype=h.dtype, device=h.device)
    err = lib.ramnet_gru_hside_backward(
        g.data_ptr(), h.data_ptr(), acts.data_ptr(), wb_ur.data_ptr(),
        wb_o.data_ptr(), dh.data_ptr(), dgx.data_ptr(), B, H, W, C, th, tw,
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(err, lib, "gru_hside_bwd")
    conv_gru_hside_bwd.launches += 1
    return dh, dgx


def _check_full(x, h, w_ur, w_o, b_ur, b_o) -> None:
    if h.dim() != 4:
        raise ValueError(f"h must be NHWC [B, H, W, C], got {tuple(h.shape)}")
    C = h.shape[-1]
    if C % 8:
        raise ValueError(f"C must be a multiple of 8, got {C}")
    for name, t, shape in (("x", x, tuple(h.shape)),
                           ("w_ur", w_ur, (9, 2 * C, 2 * C)),
                           ("w_o", w_o, (9, C, 2 * C)),
                           ("b_ur", b_ur, (2 * C,)), ("b_o", b_o, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")


def _launch_full(x, h, w_ur, w_o, b_ur, b_o):
    x, h = x.to(h.dtype).contiguous(), h.contiguous()
    w_ur, w_o = w_ur.to(h.dtype).contiguous(), w_o.to(h.dtype).contiguous()
    b_ur, b_o = b_ur.float().contiguous(), b_o.float().contiguous()
    _check_launch(h, x, w_ur, w_o)
    if b_ur.data_ptr() % 16 or b_o.data_ptr() % 16:
        raise ValueError("the kernels' tensors must be 16-byte aligned")
    B, H, W, C = h.shape
    th, tw = _tile(h, smem_bytes_full)
    lib = library_full()
    out = torch.empty_like(h)
    err = lib.ramnet_gru_full_forward(
        x.data_ptr(), h.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
        b_ur.data_ptr(), b_o.data_ptr(), out.data_ptr(), B, H, W, C, th, tw,
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(err, lib, "gru_full")
    conv_gru_full.launches += 1
    return out


def check_lstm(h, c, gx, w4) -> None:
    """Shapes and devices of a ConvLSTM cell's operands (K3, K4)."""
    if h.dim() != 4:
        raise ValueError(f"h must be NHWC [B, H, W, C], got {tuple(h.shape)}")
    B, H, W, C = h.shape
    if C % 8:
        raise ValueError(f"C must be a multiple of 8, got {C}")
    for name, t, shape in (("c", c, (B, H, W, C)), ("gx", gx, (B, H, W, 4 * C)),
                           ("w4", w4, (9, 4 * C, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")


def raise_under_autograd(name: str, *tensors) -> None:
    """The inference-only kernels have no gradient: raise when autograd
    would need one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no gradient yet (inference only; its "
                           "backward comes with phased/ConvLSTM training, "
                           "ROADMAP queue 1, item 17): run it under no_grad "
                           "or inference_mode")


def launch_lstm(h, c, gx, w4, phased=None):
    """K3 (phased None: returns (h', c')) or K4 (phased = (tau, phase, t,
    leak, ratio_on): returns (h_t, h_new, c_new)) on h's stream."""
    h, c, w4 = h.contiguous(), c.contiguous(), w4.to(h.dtype).contiguous()
    _check_launch(h, c, gx, w4)
    B, H, W, C = h.shape
    gx_bstride = _gx_bstride(h, gx, gates=4)
    th, tw = _tile(h, smem_bytes_lstm)
    lib = library_lstm()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if phased is None:
        hid, cell = torch.empty_like(h), torch.empty_like(h)
        err = lib.ramnet_lstm_hside_forward(
            h.data_ptr(), c.data_ptr(), gx.data_ptr(), w4.data_ptr(),
            hid.data_ptr(), cell.data_ptr(), B, H, W, C, gx_bstride, th, tw,
            stream)
        _raise_on(err, lib, "lstm_hside")
        return hid, cell
    tau, phase, t, leak, ratio_on = phased
    t = t.contiguous()
    if any(x.dtype != torch.float32 or not x.is_contiguous()
           or x.data_ptr() % 16 for x in (tau, phase)) or t.dtype != torch.float32:
        raise ValueError("tau, phase and t must be float32, tau and phase "
                         "contiguous and 16-byte aligned")
    outs = tuple(torch.empty_like(h) for _ in range(3))
    err = lib.ramnet_lstm_phased_forward(
        h.data_ptr(), c.data_ptr(), gx.data_ptr(), w4.data_ptr(),
        tau.data_ptr(), phase.data_ptr(), t.data_ptr(),
        *(o.data_ptr() for o in outs), B, H, W, C, gx_bstride, th, tw,
        float(leak), float(ratio_on), stream)
    _raise_on(err, lib, "lstm_phased")
    return outs


def _device_of(h: torch.Tensor) -> str:
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no implementation for device {h.device}")
    return h.device.type


def conv_gru_hside_res(h: torch.Tensor, gx: torch.Tensor, w_ur: torch.Tensor,
                       w_o: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', acts): K1-res for CUDA tensors, ``conv_gru_hside_res_plain`` for
    CPU tensors.  ``conv_gru_hside_res.launches`` counts kernel launches."""
    _check(h, gx, w_ur, w_o)
    if _device_of(h) == "cpu":
        return conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    with torch.cuda.device(h.device):
        return _launch(h, gx, w_ur, w_o, residuals=True)


def conv_gru_hside_bwd(g: torch.Tensor, h: torch.Tensor, acts: torch.Tensor,
                       w_ur: torch.Tensor, w_o: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh, dgx): K2 for CUDA tensors, ``conv_gru_hside_bwd_plain`` for CPU
    tensors.  ``conv_gru_hside_bwd.launches`` counts kernel launches."""
    _check(h, acts, w_ur, w_o)
    if tuple(g.shape) != tuple(h.shape):
        raise ValueError(f"g must be {tuple(h.shape)}, got {tuple(g.shape)}")
    if _device_of(h) == "cpu":
        return conv_gru_hside_bwd_plain(g, h, acts, w_ur, w_o)
    with torch.cuda.device(h.device):
        return _launch_bwd(g, h, acts, w_ur, w_o)


class ConvGRUHside(torch.autograd.Function):
    """h' = cell(h, gx, w_ur, w_o) with gradients for all four inputs.
    The forward runs K1-res and saves (h, acts, the weights in h's dtype)
    when a gradient is needed, K1 otherwise; the backward runs K2 for dh
    and dgx and ``hside_weight_grads``.  Weights may be float32 masters:
    they are rounded to h's dtype for the kernels and their gradients are
    returned in their own dtype."""

    @staticmethod
    def forward(ctx, h, gx, w_ur, w_o):
        wk_ur = w_ur.to(h.dtype).contiguous()
        wk_o = w_o.to(h.dtype).contiguous()
        if not any(ctx.needs_input_grad):
            return conv_gru_hside(h, gx, wk_ur, wk_o)
        h_new, acts = conv_gru_hside_res(h, gx, wk_ur, wk_o)
        ctx.save_for_backward(h, acts, wk_ur, wk_o)
        ctx.dtypes = (gx.dtype, w_ur.dtype, w_o.dtype)
        return h_new

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, acts, w_ur, w_o = ctx.saved_tensors
        dh, dgx = conv_gru_hside_bwd(g.to(h.dtype), h, acts, w_ur, w_o)
        gx_dt, wur_dt, wo_dt = ctx.dtypes
        dw_ur = dw_o = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dw_ur, dw_o = hside_weight_grads(h, acts, dgx)
            dw_ur, dw_o = dw_ur.to(wur_dt), dw_o.to(wo_dt)
        return dh, dgx.to(gx_dt), dw_ur, dw_o


def conv_gru_hside(h: torch.Tensor, gx: torch.Tensor, w_ur: torch.Tensor,
                   w_o: torch.Tensor) -> torch.Tensor:
    """h' [B, H, W, C] from NHWC h, gx and the folded weights (rounded to
    h's dtype).  When autograd needs a gradient of any input this is
    ``ConvGRUHside``; otherwise K1 for CUDA tensors and
    ``conv_gru_hside_plain`` for CPU tensors.  ``conv_gru_hside.launches``
    counts K1's launches."""
    _check(h, gx, w_ur, w_o)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, gx, w_ur, w_o)):
        return ConvGRUHside.apply(h, gx, w_ur, w_o)
    w_ur, w_o = w_ur.to(h.dtype), w_o.to(h.dtype)
    if _device_of(h) == "cpu":
        return conv_gru_hside_plain(h, gx, w_ur, w_o)
    with torch.cuda.device(h.device):
        return _launch(h, gx, w_ur, w_o, residuals=False)


def conv_gru_full(x: torch.Tensor, h: torch.Tensor, w_ur: torch.Tensor,
                  w_o: torch.Tensor, b_ur: torch.Tensor, b_o: torch.Tensor
                  ) -> torch.Tensor:
    """h' [B, H, W, C] of the whole ConvGRU cell from NHWC x and h (of one
    shape) and ``ConvGRU.full_weights``: K5 for CUDA tensors,
    ``conv_gru_full_plain`` for CPU tensors.  Inference only: raises when
    autograd would need a gradient.  ``conv_gru_full.launches`` counts
    K5's launches."""
    _check_full(x, h, w_ur, w_o, b_ur, b_o)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h, w_ur, w_o, b_ur, b_o)):
        raise RuntimeError("conv_gru_full has no gradient (inference only, "
                           "as the JAX kernel): run it under no_grad or "
                           "inference_mode")
    if _device_of(h) == "cpu":
        return conv_gru_full_plain(x, h, w_ur, w_o, b_ur, b_o)
    with torch.cuda.device(h.device):
        return _launch_full(x, h, w_ur, w_o, b_ur, b_o)


def conv_lstm_hside(h: torch.Tensor, c: torch.Tensor, gx: torch.Tensor,
                    w4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', c') [B, H, W, C] of the ConvLSTM h-side cell from NHWC h
    (the conv operand), c (the cell input), gx [B, H, W, 4C] and
    ``ConvLSTM.hside_weights`` (rounded to h's dtype): K3 for CUDA
    tensors, ``conv_lstm_hside_plain`` for CPU tensors.  Inference only:
    raises when autograd would need a gradient.
    ``conv_lstm_hside.launches`` counts K3's launches."""
    check_lstm(h, c, gx, w4)
    raise_under_autograd("conv_lstm_hside", h, c, gx, w4)
    if _device_of(h) == "cpu":
        return conv_lstm_hside_plain(h, c, gx, w4)
    with torch.cuda.device(h.device):
        out = launch_lstm(h, c, gx, w4)
    conv_lstm_hside.launches += 1
    return out


conv_gru_hside.launches = 0
conv_gru_hside_res.launches = 0
conv_gru_hside_bwd.launches = 0
conv_gru_full.launches = 0
conv_lstm_hside.launches = 0
