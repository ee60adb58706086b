"""Folded nearest-upsample x2 + Conv3D(3^3, SAME): the generator's hot op.

Nearest upsampling repeats each voxel 2x2x2, so every 3^3 window of the
upsampled tensor reads at most 2 distinct source voxels per axis.  The
composition ``Conv3D(k, SAME)(upsample2(x))`` is therefore exactly 8 "phase"
convolutions with folded 2^3 kernels on the LOW-RES grid, interleaved:

    out[2d+a, 2h+b, 2w+c] = (x_pad * K2[a,b,c])[d, h, w]

with, per axis, K2 rows  phase 0: [k(-1), k(0)+k(+1)]
                         phase 1: [k(-1)+k(0), k(+1)]

That is 64*DHW*Cin*Cout MACs where the direct form needs 216.

Three implementations of one function:

* :func:`upsample2_conv3_reference`, plain PyTorch (8 ``F.conv3d`` calls on
  the 1-padded input, interleaved).  The CPU path and the yardstick of the
  kernel's correctness on the card.
* the CUDA kernels in ``csrc/upsample_conv.cu`` (one implicit GEMM per
  phase, stored straight into the interleaved layout): a tensor-core
  kernel per dtype (bf16 on wgmma; f32 on 3xTF32 wgmma over halo boxes of
  input rows) and a general one for other widths, chosen by shape in
  :func:`k1_plan`, on the folded weights packed K-major by
  :func:`pack_phase_kernels` (for the f32 halo forward, split into TF32
  parts and laid out by :func:`pack_fwd_tf32_cuda`).
* :func:`upsample2_conv3`, the dispatcher: a CPU tensor takes the plain
  version, a CUDA tensor the kernel, anything else raises.  It is an
  ``autograd.Function``, the counterpart of the Pallas op's custom_vjp
  (pallas_upsample_conv.py:90-118), whose backward has the same two forms:
  the plain :func:`upsample2_conv3_backward` (the 8 phase convolutions' own
  input and weight gradients) on the CPU, and on the card
  :func:`upsample2_conv3_backward_cuda`, the hand-written kernels of
  ``csrc/upsample_conv.cu``: dx as one implicit GEMM over the cotangent's
  4^3 windows at stride 2, dkernel as one GEMM per phase over the
  positions, each with a deterministic split of its reduction
  (:func:`k1_backward_plan`).  On the halo kernels (Cin and Cout multiples
  of 64) each CTA copies the rows a block of positions reads into shared
  memory once, sums its split's tile with the other CTAs of its cluster in
  a fixed order, and dkernel's kernel also sums the bias gradient; one pass
  folds the phase-tap gradients onto the 3^3 kernel.  bf16 runs on bf16
  wgmma and reads the forward's packed weights in place.  f32 is bound by
  the card's exact FMA rate (67 TFLOP/s) unless it goes to the TF32 tensor
  cores (495): its halo kernels take each product as three TF32 products
  of the operands' hi and lo parts (:func:`split_tf32`), which keeps f32
  accuracy at 3x the tensor-core work, 0.406 of the FMA bound's time.
  TF32's wgmma reads B only K-major, so dx's weights stay permuted as by
  :func:`pack_backward_kernels` and are split there, once a call, by one
  kernel (:func:`pack_tf32_cuda`; plain :func:`pack_backward_kernels_tf32`),
  and dkernel's kernel transposes the cotangent rows in shared memory.  The
  tensor cores round their f32 sums toward zero, so both kernels start a
  fresh accumulator every few dozen wgmmas and add it to f32 sums kept in
  registers.  At other widths, and on misaligned
  operands, the FMA kernels take permuted weights and sum split partials
  in a fixed order by a second kernel that also rounds (dx) or folds
  (dkernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from prdisagg_torch import _build
from prdisagg_torch.utils.profiling import span

# per-axis folding matrices: K2[phase] = F[phase] @ K3 along that axis
_F0 = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]])  # sources (d-1, d)
_F1 = np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])  # sources (d, d+1)

#: number of CUDA kernel launches made by :func:`upsample2_conv3`
launches = 0
#: number of backward passes taken through :func:`upsample2_conv3`
backward_calls = 0


@functools.lru_cache(maxsize=None)
def _fold_matrices(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(2 phases, 2 taps, 3) folding matrices, made once per dtype and
    device: copying them from the host on every call would synchronise the
    host with the card several times per train step.  Made outside
    inference mode, so that autograd may save them later."""
    with torch.inference_mode(False):
        return torch.tensor(np.stack([_F0, _F1]), dtype=dtype, device=device)


def phase_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Cin,Cout) -> (2,2,2 phases, 2,2,2 taps, Cin, Cout)."""
    f = _fold_matrices(kernel.dtype, kernel.device)
    # fold each spatial axis: k2[a,p, b,q, c,r] = F[a,p,i] F[b,q,j] F[c,r,l] k[i,j,l]
    return torch.einsum("api,bqj,crl,ijlmo->abcpqrmo", f, f, f, kernel)


def _folded(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Phase kernels folded in float32 (exact sums of at most 8 weights),
    then cast once to the compute dtype."""
    return phase_kernels(kernel.float()).to(dtype)


def upsample2_conv3_reference(x: torch.Tensor, kernel: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Exactly Conv3D(kernel, SAME)(nearest_upsample_2x(x)) + bias.

    x: (B, D, H, W, Cin); kernel: (3, 3, 3, Cin, Cout); bias: (Cout,).
    Returns (B, 2D, 2H, 2W, Cout) in x's dtype.
    """
    b, d, h, w, _ = x.shape
    cout = kernel.shape[-1]
    k2 = _folded(kernel, x.dtype)
    xp = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 1, 1))  # NCDHW
    phases = []
    for a in range(2):
        for bb in range(2):
            for c in range(2):
                window = xp[:, :, a:a + d + 1, bb:bb + h + 1, c:c + w + 1]
                weight = k2[a, bb, c].permute(4, 3, 0, 1, 2)  # (Cout,Cin,2,2,2)
                phases.append(F.conv3d(window, weight))
    # (2,2,2, B, Cout, D, H, W) -> (B, D, 2, H, 2, W, 2, Cout)
    out = torch.stack(phases).reshape(2, 2, 2, b, cout, d, h, w)
    out = out.permute(3, 5, 0, 6, 1, 7, 2, 4).reshape(
        b, 2 * d, 2 * h, 2 * w, cout)
    return out + bias.to(x.dtype)


#: streaming multiprocessors of the card the tiles are chosen for (H100 SXM)
SMS = 132
#: fast-kernel tiles (BM rows, BN channels), preferred first; a 64 x 128
#: tile would never be picked, since 128 x 64 makes at least as many CTAs
FAST_TILES = ((128, 128), (128, 64), (64, 64))
#: reduction slice of the bf16 fast kernel: a slice must lie inside one tap
FAST_BK = 64
#: the f32 halo forward (csrc/upsample_conv.cu, tf::k1_f32_halo): its tiles
#: of positions (64 rows a warpgroup, 4, 3 or 2 of them), preferred first;
#: 64 output channels a tile; a phase's sub-box rows at most
HALO_F32_FW_TILES = (256, 192, 128)
HALO_F32_FW_BN, HALO_F32_FW_RMAX = 64, 768
#: halo_block's cost of a forward block beside its sub-box rows: every
#: block does a whole tile's tensor-core work, whatever its positions, so
#: the fewest blocks win and the rows only break ties
HALO_F32_FW_WEIGHT = 1 << 20
#: a work item's least time in rows of a tile's tensor-core work: each
#: unit of 8 input channels streams 32 KB of weights from L2, which takes
#: about as long as this many rows' products, whatever the tile
HALO_F32_FW_COPY_ROWS = 160
VARIANTS = ("fast", "general", "halo_f32")
#: launches of :func:`upsample2_conv3_cuda` by kernel variant (a halo_f32
#: launch is the weight split and the kernel)
launches_by_variant = dict.fromkeys(VARIANTS, 0)


class K1Plan(NamedTuple):
    """Which kernel a shape takes, its tile (BM positions by BN channels)
    and its grid's CTA count (for halo_f32, its work items, and the block
    of positions (tn, td, th, tw) a tile covers)."""
    variant: str
    bm: int
    bn: int
    ctas: int
    block: tuple = ()


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _halo_forward_plan(b: int, d: int, h: int, w: int, cout: int,
                       tiles: tuple = HALO_F32_FW_TILES) -> K1Plan:
    """The f32 halo forward's tile and block: of `tiles`, the one whose
    work items (8 phases x blocks x Cout/64) take the least time in waves
    of SMS (one persistent CTA an SM), an item taking its tile's rows or
    HALO_F32_FW_COPY_ROWS, whichever is more; a smaller tile only where
    it saves more than 1%, since it streams the weights more times."""
    best = None
    for bm in tiles:
        block, grid, _ = halo_block(b, d, h, w, bm, HALO_F32_FW_RMAX,
                                    HALO_F32_FW_WEIGHT)
        items = 8 * grid[0] * grid[1] * grid[2] * grid[3] * (
            cout // HALO_F32_FW_BN)
        cost = _ceil(items, SMS) * max(bm, HALO_F32_FW_COPY_ROWS)
        if best is None or cost < 0.99 * best[0]:
            best = (cost, K1Plan("halo_f32", bm, HALO_F32_FW_BN, items,
                                 block))
    return best[1]


def k1_plan(dtype: torch.dtype, b: int, d: int, h: int, w: int, cin: int,
            cout: int) -> K1Plan:
    """The kernel and tile for x (b, d, h, w, cin) -> cout channels, one
    rule a dtype, the kernel entry's own: f32 with Cin a multiple of 8 (a
    unit of the halo walk) and Cout of 64 takes the halo forward on 3xTF32
    tensor cores (:func:`_halo_forward_plan`); bf16 with Cin a multiple of
    FAST_BK and Cout of 64 the wgmma kernel (:func:`fast_plan`); other
    widths the general kernel (:func:`general_plan`)."""
    if cout % 64 == 0:
        if dtype == torch.float32 and cin % 8 == 0:
            return _halo_forward_plan(b, d, h, w, cout)
        if dtype == torch.bfloat16 and cin % FAST_BK == 0:
            return fast_plan(b, d, h, w, cout)
    return general_plan(b, d, h, w, cout)


def general_plan(b: int, d: int, h: int, w: int, cout: int) -> K1Plan:
    """The general kernel's grid: 128 positions by 64 channels a CTA."""
    return K1Plan("general", 128, 64,
                  8 * _ceil(b * d * h * w, 128) * _ceil(cout, 64))


def fast_plan(b: int, d: int, h: int, w: int, cout: int) -> K1Plan:
    """The bf16 wgmma kernel's tile for Cout a multiple of 64: the largest
    of FAST_TILES whose grid (8 phases x M tiles x N tiles) fills the
    card's SMS SMs, else the smallest."""
    m = b * d * h * w
    plan = None
    for bm, bn in FAST_TILES:
        if cout % bn:
            continue
        plan = K1Plan("fast", bm, bn, 8 * _ceil(m, bm) * (cout // bn))
        if plan.ctas >= SMS:
            break
    return plan


def pack_phase_kernels(kernel: torch.Tensor, dtype: torch.dtype
                       ) -> torch.Tensor:
    """The folded weights as the kernels read them: (8 phases, Cout, 8*Cin),
    K-major with k = tap*Cin + ci, contiguous, in `dtype`."""
    cin, cout = kernel.shape[-2:]
    k2 = _folded(kernel, dtype).reshape(8, 8 * cin, cout)
    return k2.transpose(1, 2).contiguous()


_ENTRY_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def pack_phase_kernels_tf32(kp: torch.Tensor) -> torch.Tensor:
    """The f32 halo forward's weights: float32 kp (8 phases, Cout, 8*Cin)
    split by :func:`split_tf32` and laid out as the kernel copies them,
    (Cout/64, 8 phases, Cin/8 units, 8 taps, 2 parts (hi, lo), 64 rows co,
    8 floats k), a unit's 32 KB contiguous, each 64 x 8 tile in the 32-byte
    swizzle (16-byte chunk kc of row r at kc ^ (r // 4 % 2)).  The plain
    version of the card's ``k1_pack_fwd_tf32`` (:func:`pack_fwd_tf32_cuda`)."""
    cout, cin = kp.shape[1], kp.shape[2] // 8
    parts = torch.stack(split_tf32(kp))  # (part, phase, co, tap * Cin + ci)
    t = parts.view(2, 8, cout // 64, 64, 8, cin // 8, 2, 4)
    # -> (tile, phase, unit, tap, part, r, kc, 4)
    t = t.permute(2, 1, 5, 4, 0, 3, 6, 7)
    swap = ((torch.arange(64, device=kp.device) >> 2) & 1).bool()
    return torch.where(swap.view(64, 1, 1), t.flip(-2), t).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_fn(variant: str, dtype: torch.dtype):
    lib = _build.load("upsample_conv")
    ptrs, tile = 4, []
    if variant == "halo_f32":  # kp and its parts' workspace; bm, the block
        fn = lib.prdisagg_upsample2_conv3_halo_f32
        ptrs, tile = 5, [ctypes.c_int] * 5
    elif variant == "fast":
        fn = lib.prdisagg_upsample2_conv3_fast_bf16
        tile = [ctypes.c_int] * 2
    else:
        fn = getattr(lib, f"prdisagg_upsample2_conv3_general_"
                          f"{_ENTRY_DTYPES[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 6 + tile
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.prdisagg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.prdisagg_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.prdisagg_cuda_error_string


@functools.lru_cache(maxsize=None)
def _pack_fwd_fn():
    fn = _build.load("upsample_conv").prdisagg_k1_pack_fwd_tf32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_fwd_tf32_cuda(kp: torch.Tensor) -> torch.Tensor:
    """:func:`pack_phase_kernels_tf32` on the card in one pass (the kernel
    ``k1_pack_fwd_tf32``): kp (8, Cout, 8*Cin) float32, contiguous and
    16-byte aligned, Cin a multiple of 8 and Cout of 64, on a CUDA device.
    Returns the parts as the f32 halo forward reads them, on the current
    stream."""
    if kp.device.type != "cuda" or kp.dtype != torch.float32 \
            or not kp.is_contiguous() or kp.dim() != 3 or kp.shape[0] != 8 \
            or kp.data_ptr() % 16:
        raise ValueError(f"kp must be a contiguous, 16-byte aligned (8, "
                         f"Cout, 8*Cin) float32 CUDA tensor, got "
                         f"{tuple(kp.shape)} {kp.dtype} on {kp.device}")
    cout, cin = kp.shape[1], kp.shape[2] // 8
    wf = torch.empty((cout // 64, 8, cin // 8, 8, 2, 64, 2, 4),
                     dtype=torch.float32, device=kp.device)
    with torch.cuda.device(kp.device):
        err = _pack_fwd_fn()(kp.data_ptr(), wf.data_ptr(), cin, cout,
                             torch.cuda.current_stream(kp.device).cuda_stream)
    if err != 0:
        err_str = _kernel_fn("general", torch.float32)[1]
        raise RuntimeError(f"upsample2_conv3 k1_pack_fwd_tf32 launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    return wf


def upsample2_conv3_cuda(x: torch.Tensor, kp: torch.Tensor,
                         bias: torch.Tensor, plan: K1Plan = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel that :func:`k1_plan` picks for x's shape (or
    `plan`, one of k1_plan's for this shape and dtype, to measure or test
    another kernel).

    x: (B, D, H, W, Cin) f32 or bf16; kp: (8, Cout, 8*Cin) of x's dtype, from
    :func:`pack_phase_kernels`; bias: (Cout,) f32.  All contiguous on one
    CUDA device.  Returns (B, 2D, 2H, 2W, Cout) in x's dtype, on the current
    stream.  The halo forward first splits kp into its TF32 parts, one
    launch of :func:`pack_fwd_tf32_cuda`'s kernel into a workspace."""
    global launches
    for name, t in (("x", x), ("kp", kp), ("bias", bias)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every operand must "
                             f"be on the CUDA device of x ({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _ENTRY_DTYPES:
        raise TypeError(f"upsample2_conv3 kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, Cin), got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    if kp.dim() != 3 or kp.shape[0] != 8 or kp.shape[2] != 8 * cin:
        raise ValueError(f"kp must be (8, Cout, {8 * cin}), got "
                         f"{tuple(kp.shape)}")
    cout = kp.shape[1]
    if kp.dtype != x.dtype or bias.dtype != torch.float32:
        raise TypeError(f"dtypes: x {x.dtype}, kp {kp.dtype} (must match x), "
                        f"bias {bias.dtype} (must be float32)")
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be ({cout},), got {tuple(bias.shape)}")
    out = torch.empty((b, 2 * d, 2 * h, 2 * w, cout), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = k1_plan(x.dtype, b, d, h, w, cin, cout)
    if plan.variant == ("fast" if x.dtype == torch.float32 else "halo_f32"):
        raise ValueError(f"the {plan.variant} kernel does not take "
                         f"{x.dtype}")
    if plan.variant != "general" and any(
            t.data_ptr() % 16 for t in (x, kp, bias)):
        plan = plan._replace(variant="general")  # 16-byte copies need it
    fn, err_str = _kernel_fn(plan.variant, x.dtype)
    ptrs, tile = (x.data_ptr(), kp.data_ptr()), ()
    if plan.variant == "fast":
        tile = (plan.bm, plan.bn)
    elif plan.variant == "halo_f32":
        wf = torch.empty(2 * kp.numel(), dtype=torch.float32, device=x.device)
        ptrs, tile = ptrs + (wf.data_ptr(),), (plan.bm, *plan.block)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, bias.data_ptr(), out.data_ptr(), b, d, h, w, cin,
                 cout, *tile, stream)
    if err != 0:
        raise RuntimeError(f"upsample2_conv3 {plan.variant} kernel launch "
                           f"failed: {err_str(err).decode()} "
                           f"(cuda error {err})")
    launches += 1
    launches_by_variant[plan.variant] += 1
    return out


# K1's backward on the card

#: the FMA backward kernels' (other widths) tiles and reduction slices
BWD_FMA_TILE, BWD_FMA_BK = 64, 16
#: a split keeps at least this many reduction slices (units)
MIN_SPLIT_SLICES = 2
#: the bf16 halo kernels (csrc/upsample_conv.cu, tc namespace): dx's
#: positions a CTA, its output channels a reduction unit and its sub-box
#: rows; dk's positions a block and sub-box rows; the largest cluster
HALO_BM, HALO_CO, HALO_DX_RMAX = 128, 16, 512
HALO_BP, HALO_DK_RMAX = 128, 256
MAX_CLUSTER = 8
#: the f32 halo kernels' (tf namespace) counterparts: units of 8 channels
#: (a 32-byte row) and blocks of 64 positions keep their rings in 227 KB
HALO_F32_BM, HALO_F32_CO, HALO_F32_DX_RMAX = 128, 8, 256
HALO_F32_BP, HALO_F32_DK_RMAX = 64, 192
#: what a halo block costs beside its sub-box rows, in rows: bf16 dx
#: streams 8 taps x 16 x 128 weights (about 1024 sub-box rows of 32 bytes)
#: a unit, f32 dx 8 taps x 8 x 128 weights in two parts (2048 rows of 32
#: bytes); dk copies as many cotangent rows as positions a block, rows as
#: wide as the sub-box's
HALO_BLOCK_WEIGHT = {("dx", torch.bfloat16): 1024, ("dk", torch.bfloat16):
                     HALO_BP, ("dx", torch.float32): 2048,
                     ("dk", torch.float32): HALO_F32_BP}
#: the halo kernels' limits by dtype: dx's positions, unit channels and
#: sub-box rows, dk's positions and sub-box rows
HALO_LIMITS = {torch.bfloat16: (HALO_BM, HALO_CO, HALO_DX_RMAX, HALO_BP,
                                HALO_DK_RMAX),
               torch.float32: (HALO_F32_BM, HALO_F32_CO, HALO_F32_DX_RMAX,
                               HALO_F32_BP, HALO_F32_DK_RMAX)}
#: the plan variant of the halo kernels by dtype
HALO_VARIANT = {torch.bfloat16: "halo", torch.float32: "halo_f32"}
BACKWARD_KERNELS = ("dx_halo", "dx_halo_f32", "dx_general", "dk_halo",
                    "dk_halo_f32", "dk_general", "dx_reduce", "dk_fold",
                    "pack_tf32")
#: launches of :func:`upsample2_conv3_backward_cuda`'s kernels, by kernel
backward_launches_by_variant = dict.fromkeys(BACKWARD_KERNELS, 0)


def _backward_permuted(kp: torch.Tensor) -> torch.Tensor:
    """kp (8 phases, Cout, 8*Cin) viewed as dx's weights (Cin, 64 offsets,
    Cout), not copied."""
    cout, cin = kp.shape[1], kp.shape[2] // 8
    k8 = kp.view(2, 2, 2, cout, 2, 2, 2, cin)  # (a, b, c, co, p, q, r, ci)
    return k8.permute(7, 4, 0, 5, 1, 6, 2, 3)


def pack_backward_kernels(kp: torch.Tensor) -> torch.Tensor:
    """The FMA dx kernels' weights, (Cin, 64*Cout), K-major with
    k = off*Cout + co, contiguous, from the forward's packing kp (8 phases,
    Cout, 8*Cin) of :func:`pack_phase_kernels` (folded in float32, cast
    once).  Per axis, low-res index d feeds the full-res output 2d + 2 - j,
    j = 2p + a, through K2[phase a, tap p], so offset j holds K2[a, p] and
    off = 16*j_d + 4*j_h + j_w: a permutation of kp, one copy.  The bf16
    halo kernel reads kp itself."""
    cout, cin = kp.shape[1], kp.shape[2] // 8
    return _backward_permuted(kp).reshape(cin, 64 * cout)


def split_tf32(v: torch.Tensor) -> tuple:
    """float32 v as two TF32 values, v = hi + lo to within 2^-22 |v|: hi is
    v rounded to TF32 (10 mantissa bits) to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds, and lo the remainder v - hi (exact
    in float32) rounded the same way; the tensor cores ignore a TF32
    operand's low 13 bits, so lo is rounded here and not left to be
    truncated.  Signs and zeros carry into hi; inf and NaN pass through hi,
    with lo 0.  Returns (hi, lo), float32 tensors of v's shape."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        # the magnitude bits rounded at bit 13 (the carry may reach the
        # exponent: the next binade, or inf past the largest value)
        return bits.add(0x1000).bitwise_and_(-0x2000).view(torch.float32)

    hi = torch.where(torch.isnan(v), v, rna(v))
    lo = torch.where(torch.isfinite(hi), rna(v - hi), 0.0)
    return hi, lo


def pack_backward_kernels_tf32(kp: torch.Tensor) -> torch.Tensor:
    """The f32 halo dx kernel's weights: :func:`pack_backward_kernels` of
    float32 kp split by :func:`split_tf32`, as (2, Cin, 64*Cout), hi then
    lo, contiguous.  The plain version of the card's ``k1_pack_tf32``
    (:func:`pack_tf32_cuda`): the split runs on kp in its own order and
    each part is permuted by one copy."""
    cout, cin = kp.shape[1], kp.shape[2] // 8
    out = torch.empty((2, cin, 2, 2, 2, 2, 2, 2, cout), dtype=torch.float32,
                      device=kp.device)
    for part, t in zip(out, split_tf32(kp)):
        part.copy_(_backward_permuted(t))
    return out.view(2, cin, 64 * cout)


def split_range(kt: int, splits: int, s: int) -> tuple:
    """The reduction slices [begin, end) of split s of `splits`, as the
    kernels compute them: contiguous, disjoint, covering [0, kt)."""
    return kt * s // splits, kt * (s + 1) // splits


class GemmPlan(NamedTuple):
    """One FMA backward GEMM's tile (bm x bn), reduction slice bk, slices
    of the whole reduction kt, splits and CTA count."""
    bm: int
    bn: int
    bk: int
    kt: int
    splits: int
    ctas: int


class HaloPlan(NamedTuple):
    """One halo kernel's launch: the block of positions (tn, td, th, tw),
    the blocks along (n, d, h, w), a phase's sub-box rows, the output tiles
    (CTAs of one split), the reduction units, the splits (the cluster's
    CTAs) and the CTA count."""
    block: tuple
    grid: tuple
    rows: int
    tiles: int
    units: int
    splits: int
    ctas: int


class K1BackwardPlan(NamedTuple):
    """Which kernels a backward takes ("halo": bf16, "halo_f32": f32, or
    "general"), and dx's and dk's launches."""
    variant: str
    dx: tuple
    dk: tuple


def _splits(tiles: int, units: int, most: int) -> int:
    """Splits of the reduction so that the grid fills the card's SMS SMs,
    each split keeping at least MIN_SPLIT_SLICES units, at most `most`."""
    if tiles >= SMS:
        return 1
    return max(1, min(most, _ceil(SMS, tiles), units // MIN_SPLIT_SLICES))


#: CTAs of the f32 halo kernels (one an SM) that run at once, by cluster
#: size: cudaOccupancyMaxActiveClusters times the size on an H100 SXM (a
#: cluster lives in one GPC, so sizes that do not divide its SMs leave
#: some idle)
CLUSTER_CTAS = {1: 132, 2: 132, 3: 117, 4: 120, 5: 110, 6: 102, 7: 105,
                8: 120}


def _splits_by_waves(tiles: int, units: int, most: int) -> int:
    """Splits for kernels that hold one CTA an SM for their whole run (the
    f32 halo kernels): of at most `most`, each split keeping at least
    MIN_SPLIT_SLICES units and the grid at most 3 waves, the count with
    the least time, taken as the waves of CTAs (CLUSTER_CTAS at once) over
    the splits (each CTA does a split's share); one more split must cut it
    by 5% to be taken."""
    def time(s):
        return _ceil(tiles * s, CLUSTER_CTAS[s]) / s

    best = 1
    for s in range(2, max(1, min(most, units // MIN_SPLIT_SLICES)) + 1):
        if tiles * s <= 3 * CLUSTER_CTAS[s] and time(s) < 0.95 * time(best):
            best = s
    return best


def _gemm_plan(bm: int, bn: int, bk: int, tiles: int, kt: int) -> GemmPlan:
    splits = _splits(tiles, kt, kt)
    return GemmPlan(bm, bn, bk, kt, splits, tiles * splits)


@functools.lru_cache(maxsize=None)
def halo_block(b: int, d: int, h: int, w: int, positions: int, rows: int,
               weight: int) -> tuple:
    """The block (tn, td, th, tw) of at most `positions` positions and
    `rows` sub-box rows tn*(td+1)*(th+1)*(tw+1) with the least cost,
    blocks * (weight + rows): the rows a phase copies, beside what every
    block costs alike.  tn > 1 only for whole samples.  Returns (block,
    blocks along (n, d, h, w), sub-box rows)."""
    best = None
    for td in range(1, d + 1):
        for th in range(1, h + 1):
            for tw in range(1, w + 1):
                p = td * th * tw
                if p > positions:
                    break
                whole = (td, th, tw) == (d, h, w)
                for tn in range(1, min(b, positions // p, 255) + 1
                                if whole else 2):
                    r = tn * (td + 1) * (th + 1) * (tw + 1)
                    if r > rows:
                        break
                    grid = (_ceil(b, tn), _ceil(d, td), _ceil(h, th),
                            _ceil(w, tw))
                    blocks = grid[0] * grid[1] * grid[2] * grid[3]
                    key = (blocks * (weight + r), r)
                    if best is None or key < best[0]:
                        best = (key, ((tn, td, th, tw), grid, r))
    return best[1]


def _halo_plan(kind: str, dtype: torch.dtype, b: int, d: int, h: int,
               w: int, cin: int, cout: int) -> HaloPlan:
    bm, co, dx_rmax, bp, dk_rmax = HALO_LIMITS[dtype]
    weight = HALO_BLOCK_WEIGHT[kind, dtype]
    if kind == "dx":
        block, grid, rows = halo_block(b, d, h, w, bm, dx_rmax, weight)
        blocks = grid[0] * grid[1] * grid[2] * grid[3]
        tiles = blocks * (cin // (128 if cin % 128 == 0 else 64))
        units = 8 * cout // co
    else:
        block, grid, rows = halo_block(b, d, h, w, bp, dk_rmax, weight)
        # bf16: a CTA a phase's 8 taps; f32: half of them (p = 0 or 1)
        tiles = (8 if dtype == torch.bfloat16 else 16) * (cin // 64) * (
            cout // 64)
        units = grid[0] * grid[1] * grid[2] * grid[3]
    splits = (_splits(tiles, units, MAX_CLUSTER) if dtype == torch.bfloat16
              else _splits_by_waves(tiles, units, MAX_CLUSTER))
    return HaloPlan(block, grid, rows, tiles, units, splits, tiles * splits)


def k1_backward_plan(dtype: torch.dtype, b: int, d: int, h: int, w: int,
                     cin: int, cout: int, general: bool = False
                     ) -> K1BackwardPlan:
    """The backward kernels and their launches for x (b, d, h, w, cin) ->
    cout channels.

    Cin and Cout multiples of 64 take the halo kernels of their dtype
    (:class:`HaloPlan`): bf16 ("halo") dx on blocks of at most HALO_BM
    positions and 64 or 128 channels of Cin, reduction units of 16
    channels of Cout and one phase, dk on blocks of at most HALO_BP
    positions, one phase, 64 x 64 channels a CTA; f32 ("halo_f32") the
    same with HALO_F32_BM positions, units of HALO_F32_CO channels and dk
    blocks of HALO_F32_BP positions.  Other widths, or `general`, take the
    general FMA kernels (:class:`GemmPlan`, 64 x 64 tiles, slices of 16).
    Each reduction is split (a halo split at most MAX_CLUSTER ways, the
    CTAs of one cluster): until the grid fills the card, or for the f32
    halo kernels by their waves (:func:`_splits_by_waves`)."""
    if cin % 64 == 0 and cout % 64 == 0 and not general:
        return K1BackwardPlan(
            HALO_VARIANT[dtype],
            _halo_plan("dx", dtype, b, d, h, w, cin, cout),
            _halo_plan("dk", dtype, b, d, h, w, cin, cout))
    m = b * d * h * w
    t, bk = BWD_FMA_TILE, BWD_FMA_BK
    dx = _gemm_plan(t, t, bk, _ceil(m, t) * _ceil(cin, t),
                    64 * _ceil(cout, bk))
    dk = _gemm_plan(t, t, bk, 8 * _ceil(8 * cin, t) * _ceil(cout, t),
                    _ceil(m, bk))
    return K1BackwardPlan("general", dx, dk)


@functools.lru_cache(maxsize=None)
def _backward_fns(variant: str, dtype: torch.dtype):
    """The dx, dk, dx-reduce and dk-fold entries of one variant and dtype
    (the halo variants' dx and dk take a block where the general ones take
    a tile and a reduce)."""
    lib = _build.load("upsample_conv")
    tag = _ENTRY_DTYPES[dtype]
    ptr, i = ctypes.c_void_p, ctypes.c_int
    halo = variant.startswith("halo")
    kind = "halo" if halo else variant
    dx = getattr(lib, f"prdisagg_k1_dx_{kind}_{tag}")
    dk = getattr(lib, f"prdisagg_k1_dk_{kind}_{tag}")
    if halo:
        dx.argtypes = [ptr] * 3 + [i] * 11 + [ptr]
        dk.argtypes = [ptr] * 4 + [i] * 11 + [ptr]
    else:
        dx.argtypes = [ptr] * 4 + [i] * 9 + [ptr]
        dk.argtypes = [ptr] * 3 + [i] * 9 + [ptr]
    reduce = getattr(lib, f"prdisagg_k1_dx_reduce_{tag}")
    reduce.argtypes = [ptr, ptr, ctypes.c_longlong, i, ptr]
    fold = lib.prdisagg_k1_dk_fold
    fold.argtypes = [ptr] * 2 + [i] * 3 + [ptr] * 3
    for fn in (dx, dk, reduce, fold):
        fn.restype = ctypes.c_int
    return dx, dk, reduce, fold


@functools.lru_cache(maxsize=None)
def _pack_fn():
    fn = _build.load("upsample_conv").prdisagg_k1_pack_tf32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_tf32_cuda(kp: torch.Tensor) -> torch.Tensor:
    """:func:`pack_backward_kernels_tf32` on the card in one pass (the
    kernel ``k1_pack_tf32``): kp (8, Cout, 8*Cin) float32, contiguous, Cin
    and Cout multiples of 32, on a CUDA device.  Returns (2, Cin, 64*Cout)
    float32 on the current stream."""
    if kp.device.type != "cuda" or kp.dtype != torch.float32 \
            or not kp.is_contiguous() or kp.dim() != 3 or kp.shape[0] != 8:
        raise ValueError(f"kp must be a contiguous (8, Cout, 8*Cin) float32 "
                         f"CUDA tensor, got {tuple(kp.shape)} {kp.dtype} on "
                         f"{kp.device}")
    cout, cin = kp.shape[1], kp.shape[2] // 8
    wt = torch.empty((2, cin, 64 * cout), dtype=torch.float32,
                     device=kp.device)
    with torch.cuda.device(kp.device):
        _launched("pack_tf32", _pack_fn()(
            kp.data_ptr(), wt.data_ptr(), cin, cout,
            torch.cuda.current_stream(kp.device).cuda_stream))
    return wt


def _launched(name: str, err: int) -> None:
    """Raise if a backward launch failed, else count it."""
    if err != 0:
        err_str = _kernel_fn("general", torch.float32)[1]
        raise RuntimeError(f"upsample2_conv3 backward {name} kernel launch "
                           f"failed: {err_str(err).decode()} (cuda error "
                           f"{err})")
    backward_launches_by_variant[name] += 1


def upsample2_conv3_backward_cuda(x: torch.Tensor, kernel: torch.Tensor,
                                  g: torch.Tensor, need_dx: bool = True,
                                  need_dk: bool = True, kp=None,
                                  need_db: bool = False):
    """:func:`upsample2_conv3_backward` on the card's hand-written kernels,
    and the bias gradient.

    x: (B, D, H, W, Cin) f32 or bf16; kernel: (3, 3, 3, Cin, Cout), any
    float dtype; g: (B, 2D, 2H, 2W, Cout), cast to x's dtype.  All on one
    CUDA device.  dx accumulates in float32 and rounds once to x's dtype;
    dkernel accumulates and folds in float32 and comes back in kernel's
    dtype; db, the float32 sum of g over all but its channels, comes from
    the dk kernel on the halo path (with need_dk), else from one reduction
    that accumulates in float32 (no float32 copy of g).  kp, the forward's
    :func:`pack_phase_kernels` of kernel in x's dtype, spares packing the
    weights again; the bf16 halo kernels read it as it is, the f32 ones its
    permutation split into TF32 parts (:func:`pack_tf32_cuda`).
    Split sums are taken in a fixed order (in a cluster's shared memory on
    the halo kernels, through workspaces allocated here otherwise, which a
    graph capture takes from its pool), so two calls give the same bits.
    Runs on the current stream.  Returns (dx or None, dkernel or None, db
    or None)."""
    for name, t in (("x", x), ("kernel", kernel), ("g", g)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every operand must "
                             f"be on the CUDA device of x ({x.device})")
    if x.dtype not in _ENTRY_DTYPES:
        raise TypeError(f"upsample2_conv3 backward takes float32 or bfloat16 "
                        f"x, got {x.dtype}")
    if x.dim() != 5 or kernel.dim() != 5 or kernel.shape[:3] != (3, 3, 3) \
            or kernel.shape[3] != x.shape[4]:
        raise ValueError(f"x must be (B, D, H, W, Cin) and kernel (3, 3, 3, "
                         f"Cin, Cout), got {tuple(x.shape)}, "
                         f"{tuple(kernel.shape)}")
    b, d, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if tuple(g.shape) != (b, 2 * d, 2 * h, 2 * w, cout):
        raise ValueError(f"g must be {(b, 2 * d, 2 * h, 2 * w, cout)}, got "
                         f"{tuple(g.shape)}")
    if kp is not None and (kp.dtype != x.dtype
                           or tuple(kp.shape) != (8, cout, 8 * cin)):
        raise ValueError(f"kp must be (8, {cout}, {8 * cin}) of {x.dtype}, "
                         f"got {tuple(kp.shape)} of {kp.dtype}")
    if g.numel() // max(cout, 1) >= 2 ** 31:
        raise ValueError(f"{g.numel() // cout} cotangent rows: the kernels "
                         f"index rows in 32 bits")
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    dx = torch.empty_like(x) if need_dx else None
    dk = torch.empty(kernel.shape, dtype=torch.float32, device=x.device) \
        if need_dk else None
    if x.numel() == 0 or kernel.numel() == 0:
        if need_dx:
            dx.zero_()
        if need_dk:
            dk.zero_()
        db = torch.zeros((cout,), dtype=torch.float32, device=x.device) \
            if need_db else None
        return dx, None if dk is None else dk.to(kernel.dtype), db
    plan = k1_backward_plan(x.dtype, b, d, h, w, cin, cout)
    if need_dx and kp is None:
        kp = pack_phase_kernels(kernel, x.dtype)
    if plan.variant == "general" or any(t is not None and t.data_ptr() % 16
                                        for t in (x, g, kp)):
        # other widths, or operands off the 16-byte alignment TMA needs
        return _backward_fma(x, kernel, g, need_dx, need_dk, kp, need_db,
                             dx, dk)
    v = plan.variant
    # dx's B: the bf16 kernel reads kp in place, the f32 one its TF32 parts
    wt = kp if not need_dx or v == "halo" else pack_tf32_cuda(kp)
    fdx, fdk, _, ffold = _backward_fns(v, x.dtype)
    db = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if need_dx:
            p = plan.dx
            _launched(f"dx_{v}", fdx(
                g.data_ptr(), wt.data_ptr(), dx.data_ptr(), b, d, h, w, cin,
                cout, *p.block, p.splits, stream))
        if need_dk:
            p = plan.dk
            # the summed phase-tap tiles, then the 8 phases' bias sums
            part = torch.empty(64 * cin * cout + 8 * cout,
                               dtype=torch.float32, device=x.device)
            dbp = part[64 * cin * cout:] if need_db else None
            db = torch.empty((cout,), dtype=torch.float32, device=x.device) \
                if need_db else None
            _launched(f"dk_{v}", fdk(
                x.data_ptr(), g.data_ptr(), part.data_ptr(),
                None if dbp is None else dbp.data_ptr(), b, d, h, w, cin,
                cout, *p.block, p.splits, stream))
            _launched("dk_fold", ffold(
                part.data_ptr(), dk.data_ptr(), cin, cout, 1,
                None if dbp is None else dbp.data_ptr(),
                None if db is None else db.data_ptr(), stream))
    if need_db and db is None:
        db = g.sum(dim=(0, 1, 2, 3), dtype=torch.float32)
    return dx, None if dk is None else dk.to(kernel.dtype), db


def _backward_fma(x, kernel, g, need_dx, need_dk, kp, need_db, dx, dk):
    """upsample2_conv3_backward_cuda on the general FMA kernels: other
    widths, or operands off the 16-byte alignment the halo kernels' TMA
    needs."""
    b, d, h, w, cin = x.shape
    cout = kernel.shape[-1]
    plan = k1_backward_plan(x.dtype, b, d, h, w, cin, cout, general=True)
    wb = pack_backward_kernels(kp) if need_dx else None
    fdx, fdk, freduce, ffold = _backward_fns("general", x.dtype)
    m = b * d * h * w
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if need_dx:
            p = plan.dx
            part = torch.empty((p.splits, m, cin), dtype=torch.float32,
                               device=x.device) if p.splits > 1 else dx
            _launched("dx_general", fdx(
                g.data_ptr(), wb.data_ptr(), dx.data_ptr(), part.data_ptr(),
                b, d, h, w, cin, cout, p.bm, p.bn, p.splits, stream))
            if p.splits > 1:
                _launched("dx_reduce", freduce(part.data_ptr(), dx.data_ptr(),
                                               m * cin, p.splits, stream))
        if need_dk:
            p = plan.dk
            part = torch.empty((p.splits, 8, 8 * cin, cout),
                               dtype=torch.float32, device=x.device)
            _launched("dk_general", fdk(
                x.data_ptr(), g.data_ptr(), part.data_ptr(), b, d, h, w, cin,
                cout, p.bm, p.bn, p.splits, stream))
            _launched("dk_fold", ffold(part.data_ptr(), dk.data_ptr(), cin,
                                       cout, p.splits, None, None, stream))
    db = g.sum(dim=(0, 1, 2, 3), dtype=torch.float32) if need_db else None
    return dx, None if dk is None else dk.to(kernel.dtype), db


def _fold_transpose(dk2: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`phase_kernels`: (2,2,2, 2,2,2, Cin, Cout) phase-tap
    gradients -> the (3,3,3, Cin, Cout) kernel's gradient."""
    f = _fold_matrices(dk2.dtype, dk2.device)
    return torch.einsum("api,bqj,crl,abcpqrmo->ijlmo", f, f, f, dk2)


def upsample2_conv3_backward(x: torch.Tensor, kernel: torch.Tensor,
                             g: torch.Tensor, need_dx: bool = True,
                             need_dk: bool = True):
    """Gradients of :func:`upsample2_conv3_reference` with respect to x and
    kernel for the output cotangent g (B, 2D, 2H, 2W, Cout), without
    recomputing the forward: each phase's convolution gives its input and
    weight gradients (``aten.convolution_backward``, what autograd runs for
    ``F.conv3d``); input gradients are summed over the overlapping windows
    in float32 and the phase-tap gradients folded back onto the 3^3 kernel.
    Returns (dx in x's dtype or None, dkernel in kernel's dtype or None)."""
    b, d, h, w, cin = x.shape
    cout = kernel.shape[-1]
    k2 = _folded(kernel, x.dtype)
    xp = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 1, 1))  # NCDHW
    g8 = g.to(x.dtype).reshape(b, d, 2, h, 2, w, 2, cout)
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device) \
        if need_dx else None
    dk2 = torch.empty((2, 2, 2, 2, 2, 2, cin, cout), dtype=torch.float32,
                      device=x.device) if need_dk else None
    for a in range(2):
        for bb in range(2):
            for c in range(2):
                window = xp[:, :, a:a + d + 1, bb:bb + h + 1, c:c + w + 1]
                weight = k2[a, bb, c].permute(4, 3, 0, 1, 2)
                gph = g8[:, :, a, :, bb, :, c].permute(0, 4, 1, 2, 3)
                gi, gw, _ = torch.ops.aten.convolution_backward(
                    gph, window, weight, None, [1, 1, 1], [0, 0, 0],
                    [1, 1, 1], False, [0, 0, 0], 1, [need_dx, need_dk, False])
                if need_dx:
                    dxp[:, :, a:a + d + 1, bb:bb + h + 1, c:c + w + 1] += gi
                if need_dk:
                    dk2[a, bb, c] = gw.permute(2, 3, 4, 1, 0)
    dx = dk = None
    if need_dx:
        dx = dxp[:, :, 1:-1, 1:-1, 1:-1].permute(0, 2, 3, 4, 1).to(
            x.dtype).contiguous()
    if need_dk:
        dk = _fold_transpose(dk2).to(kernel.dtype)
    return dx, dk


class _UpsampleConv3(torch.autograd.Function):
    """The kernels forward and backward on the card, the plain versions on
    the CPU.  Differentiable once: the gradient
    penalty's second order runs through the critic only, since the fakes
    it sees are detached from the generator."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.bias_dtype = bias.dtype
        cpu = x.device.type == "cpu"
        kp = None
        if not cpu:  # the packed weights serve the card's backward too
            with span("prdisagg.k1.pack"):
                kp = pack_phase_kernels(kernel, x.dtype)
        ctx.save_for_backward(x, kernel, kp)
        if cpu:
            return upsample2_conv3_reference(x, kernel, bias)
        return upsample2_conv3_cuda(x, kp, bias.to(torch.float32).contiguous())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        global backward_calls
        x, kernel, kp = ctx.saved_tensors
        need_dx, need_dk, need_db = ctx.needs_input_grad
        if x.device.type == "cpu":
            dx, dk = upsample2_conv3_backward(x, kernel, g, need_dx, need_dk)
            db = g.float().sum(dim=(0, 1, 2, 3)) if need_db else None
        else:
            dx, dk, db = upsample2_conv3_backward_cuda(
                x, kernel, g, need_dx, need_dk, kp=kp, need_db=need_db)
        backward_calls += 1
        return dx, dk, None if db is None else db.to(ctx.bias_dtype)


def upsample2_conv3(x: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Conv3D(kernel, SAME)(nearest_upsample_2x(x)) + bias, NDHWC, with a
    gradient for x, kernel and bias.

    x: (B, D, H, W, Cin) in the compute dtype; kernel: (3, 3, 3, Cin, Cout)
    and bias: (Cout,), normally the float32 parameters.  A CPU tensor runs
    the plain version; a CUDA tensor runs the kernel (f32 or bf16) or
    raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"upsample2_conv3 runs on cpu or cuda, got {x.device}")
    with span("prdisagg.k1"):
        return _UpsampleConv3.apply(x, kernel, bias)
