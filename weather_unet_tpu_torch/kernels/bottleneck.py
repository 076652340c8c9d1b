"""K4: fused eval-mode ResNet identity bottleneck (``csrc/bottleneck.cu``,
``csrc/bottleneck_tc.cuh``),
the port of ``weather_unet_tpu/kernels/bottleneck_pallas.py``.

``fused_bottleneck_eval(x, w1, b1, w2, b2, w3, b3)`` computes
``relu(conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3 + x)`` for
NCHW ``x`` in one launch, the two ``P``-channel intermediates staying on
chip.  The weights come from ``fold_bottleneck``, which folds each eval-mode
BatchNorm into the conv before it; products run in ``x``'s type, biases and
accumulators in float32, and the intermediates are rounded to ``x``'s type
before the next product.  ``bottleneck_eval_reference`` is the plain version:
the same arithmetic, rounding at the same points, in PyTorch ops.

On CUDA tensors one of two kernels runs, by a rule on dtype and shape alone
(``takes_tensor_cores``): with ``C`` and ``P`` multiples of 16 and a tile
that fits shared memory, the tensor-core kernel (``mma.sync``, weights
packed by ``pack_bottleneck`` and streamed through shared memory, the tile
chosen by ``plan_bottleneck``); other shapes go to the CUDA-core kernel.
bfloat16 runs bf16 operands.  float32 runs split float32 ("3xTF32"): each
operand is ``hi + lo`` with ``hi, lo = split_tf32(a)`` (10 explicit mantissa
bits each), and a product is ``lo.hi + hi.lo + hi.hi``, three TF32 mmas,
which is within ~2^-21 of the float32 product: a single TF32 product (2^-11)
could not meet float32's bar of 1e-5 * max|y|, the split one does.  The
weights are split once, at pack time (``pack_bottleneck(..., split=True)``);
the activations in registers, once a fragment.

``fused_resnet_eval(model)`` runs a whole frozen ResNet with every identity
block through the kernel and the stem, the four stride/projection blocks
and the head on folded convs (cuDNN), as the JAX package leaves them to
XLA.  Forward only: the frozen estimator takes no gradients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from weather_unet_tpu_torch.kernels import _build
from weather_unet_tpu_torch.ops.convs import conv2d, max_pool

launches = 0   # kernel launches so far (plain-version calls do not count)
tensor_core_launches = 0   # those of them that ran the tensor-core kernel
f32_tensor_core_launches = 0   # ... and of those, the float32 (3xTF32) form

SMEM_LIMIT = 232_448   # bytes of shared memory a block can opt in to (sm_90)
_WARPS = 8             # csrc/bottleneck_tc.cuh: kWarps, warps a block
_MI = 6                # ... kMI, m-tiles (16 rows) a warp holds at most
_MI32 = 4              # ... kMI32, the same in float32
# reduction chunks a plan may take, by element size: bf16 32 or 64 values,
# float32 16 (csrc/bottleneck_{tc32,tc64,f32tc16}{,c}.cu)
_CHUNKS = {2: (32, 64), 4: (16,)}
# the products' cost per reduction value against bf16's: float32 runs three
# TF32 mmas (each m16n8k8 takes as long as a bf16 m16n8k16) for half the k
_MMA_COST = {2: 1.0, 4: 6.0}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` does, by integer operations on
    the float32 bits; inf and NaN pass through, subnormals round as the bits
    say."""
    bits = t.float().contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    # + half a TF32 step on the magnitude (the sign bit never changes), then
    # drop the 13 low bits
    rounded = (bits + 0x1000) & -0x2000
    return torch.where(special, bits, rounded).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """``(hi, lo)`` with ``hi = tf32_round(t)``, ``lo = tf32_round(t - hi)``
    (``t - hi`` is exact in float32), so ``|t - hi - lo| <= 2^-22 |t|``
    roughly; ``lo`` is 0 where ``t`` is not finite.  The split float32
    operand of the tensor-core kernels."""
    t = t.float()
    hi = tf32_round(t)
    lo = torch.where(torch.isfinite(t), tf32_round(t - hi),
                     torch.zeros_like(t))
    return hi, lo


def fold_bn(weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval-mode BatchNorm as per-channel ``(scale, bias)``, float32:
    ``bn(z) = z * s + t`` with ``s = gamma / sqrt(var + eps)``,
    ``t = beta - mean * s``."""
    s = weight.float() / torch.sqrt(running_var.float() + eps)
    return s, bias.float() - running_mean.float() * s


def _fold_bn_of(sd: Mapping[str, torch.Tensor], name: str, eps: float):
    return fold_bn(sd[f"{name}.weight"], sd[f"{name}.bias"],
                   sd[f"{name}.running_mean"], sd[f"{name}.running_var"], eps)


def fold_bottleneck(sd: Mapping[str, torch.Tensor], eps: float = 1e-5):
    """State dict of one identity ``Bottleneck`` (keys ``conv{1,2,3}.weight``,
    ``bn{1,2,3}.{weight,bias,running_mean,running_var}``) -> the kernel's
    float32 weights ``(w1 (C, P), b1 (P,), w2 (9, P, P) as [tap][in][out],
    b2 (P,), w3 (P, C), b3 (C,))`` with each BN folded into the conv before
    it."""
    s1, t1 = _fold_bn_of(sd, "bn1", eps)
    s2, t2 = _fold_bn_of(sd, "bn2", eps)
    s3, t3 = _fold_bn_of(sd, "bn3", eps)
    k1 = sd["conv1.weight"].float()                 # (P, C, 1, 1) OIHW
    k2 = sd["conv2.weight"].float()                 # (P, P, 3, 3)
    k3 = sd["conv3.weight"].float()                 # (C, P, 1, 1)
    p = k2.shape[0]
    w1 = (k1[:, :, 0, 0] * s1[:, None]).t().contiguous()
    w2 = (k2 * s2[:, None, None, None]).permute(2, 3, 1, 0).reshape(9, p, p)
    w3 = (k3[:, :, 0, 0] * s3[:, None]).t().contiguous()
    return w1, t1, w2.contiguous(), t2, w3, t3


def bottleneck_eval_reference(x, w1, b1, w2, b2, w3, b3):
    """Plain version of the kernel: float32 products of operands rounded to
    ``x``'s type, the intermediates rounded to ``x``'s type, zero padding of
    ``t1``."""
    dt = x.dtype
    p = w1.shape[1]

    def rounded(w):
        return w.to(dt).float()

    def bias(b):
        return b.float()[None, :, None, None]

    k1 = rounded(w1).t()[:, :, None, None]                    # (P, C, 1, 1)
    k2 = rounded(w2).reshape(3, 3, p, p).permute(3, 2, 0, 1)  # (P, P, 3, 3)
    k3 = rounded(w3).t()[:, :, None, None]                    # (C, P, 1, 1)
    xf = x.float()
    t1 = F.relu(conv2d(xf, k1, padding=0) + bias(b1)).to(dt)
    t2 = F.relu(conv2d(t1.float(), k2, padding=1) + bias(b2)).to(dt)
    y = conv2d(t2.float(), k3, padding=0) + bias(b3) + xf
    return F.relu(y).to(dt)


class PackedBottleneck(NamedTuple):
    """The tensor-core kernel's weights: every product's B operand as
    ``[column][k]`` with the reduction index ``k`` contiguous; split float32
    weights carry a leading axis of 2, their ``(hi, lo)`` parts."""
    w1: torch.Tensor   # (P, C)     [out][in]
    b1: torch.Tensor   # (P,) float32
    w2: torch.Tensor   # (9, P, P)  [tap][out][in]
    b2: torch.Tensor   # (P,) float32
    w3: torch.Tensor   # (C, P)     [out][in]
    b3: torch.Tensor   # (C,) float32

    @property
    def split(self) -> bool:
        return self.w1.dim() == 3


def pack_bottleneck(w1, b1, w2, b2, w3, b3, dtype=torch.bfloat16,
                    split: bool = False) -> PackedBottleneck:
    """``fold_bottleneck``'s weights (``w1 (C, P)``, ``w2 (9, P, P)`` as
    [tap][in][out], ``w3 (P, C)``) in the tensor-core kernel's layout, cast
    to ``dtype``: a permutation, nothing else.  With ``split`` (float32
    only) each permuted weight becomes ``stack(split_tf32(w))``, its hi and
    lo parts, which the float32 tensor-core kernel streams."""
    if split and dtype != torch.float32:
        raise ValueError(f"split weights are float32, not {dtype}")

    def arrange(w):
        w = w.contiguous().to(dtype)
        return torch.stack(split_tf32(w)) if split else w

    return PackedBottleneck(
        arrange(w1.t()), b1.float(), arrange(w2.transpose(1, 2)), b2.float(),
        arrange(w3.t()), b3.float())


def unpack_bottleneck(packed: PackedBottleneck):
    """Inverse of ``pack_bottleneck`` (the dtype stays the packed one):
    split weights come back as ``hi + lo``."""
    def whole(w):
        return w[0] + w[1] if packed.split else w

    return (whole(packed.w1).t().contiguous(), packed.b1,
            whole(packed.w2).transpose(1, 2).contiguous(), packed.b2,
            whole(packed.w3).t().contiguous(), packed.b3)


def _esize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


# float32 takes the tensor cores from this many mid channels on: at every
# identity block of ResNet-101 (P = 64 .. 512, 224x224 input, B=16 and 8)
# the 3xTF32 form measured faster than the CUDA-core kernel on an H100, at
# the odd site (2, 64, 5, 7) with P = 16 slower (0.0705 against 0.0668 ms;
# tools/compare_tc_kernels.py, PERF.md)
F32_MIN_P = 64


def takes_tensor_cores(dtype, c: int, p: int, h: Optional[int] = None,
                       w: Optional[int] = None) -> bool:
    """The rule that picks the CUDA kernel, on dtype and shape alone:
    bfloat16 with ``C`` and ``P`` multiples of 16, and float32 with them
    multiples of 16 and ``P >= F32_MIN_P``, run on the tensor cores, other
    shapes on the CUDA cores.  With the image's ``h`` and ``w`` given, the
    image must also have a tile that fits shared memory
    (``bottleneck_plans``): a row of more than 256 pixels, or a row too wide
    for its channels, goes to the CUDA cores too."""
    if dtype not in (torch.bfloat16, torch.float32) or c % 16 or p % 16:
        return False
    if dtype == torch.float32 and p < F32_MIN_P:
        return False
    return h is None or bool(bottleneck_plans(1, c, p, h, w,
                                              esize=_esize(dtype)))


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def _warps_along_n(n: int, mtiles: int, mi: int) -> int:
    """Warps (of ``_WARPS``) laid along N, 32 columns each; the rest lie
    along M with ``mi`` m-tiles each.  The widest split that still covers
    ``mtiles`` in one pass, so that the weights are streamed once; failing
    that the narrowest."""
    fits = [wgn for wgn in (8, 4, 2, 1)
            if wgn == 1 or 32 * wgn <= _round_up(n, 32)]
    for wgn in fits:
        if (_WARPS // wgn) * mi >= mtiles:
            return wgn
    return fits[-1]


def _tile_plan(c, p, w, th, cs, kc, smem_limit, mi=_MI,
               esize=2) -> Optional[dict]:
    """Shared-memory layout of the tensor-core kernel for a tile of ``th``
    full rows shared by a cluster of ``cs`` blocks (each computes ``1 / cs``
    of every product's columns), stepping through the reductions in chunks
    of ``kc`` values of ``esize`` bytes (2: bf16; 4: float32, whose weight
    ring holds each weight's hi and lo parts), or None where it does not
    fit.  Mirrors csrc/bottleneck_tc.cuh."""
    piece = 16 // esize                 # elements of 16 bytes: a row's pad
    parts = 2 if esize == 4 else 1      # weight copies in the ring
    nh, nt = (th + 2) * (w + 2), th * w
    # a staged channel of x: its rows of the halo region as they lie, from
    # the 16-byte boundary before them
    rs = _round_up((th + 2) * w + piece - 1, piece)
    if nt > 256 or rs // piece > 128:             # kMaxNT, 32 * kPieces
        return None
    if cs > 1 and (c % (32 * cs) or p % (32 * cs)):
        return None
    smallest = _CHUNKS[esize][0]
    if kc > smallest and min(c, p) <= smallest:   # a chunk no reduction fills
        return None
    mh, mt = _round_up(nh, 16), _round_up(nt, 16)
    ld1, ldk = (p + piece) * esize, (kc + piece) * esize     # bytes a row
    wgn12 = _warps_along_n(p // cs, mh // 16, mi)
    widest3 = _warps_along_n(c // cs, mt // 16, mi)
    # region A: t1, then the float32 output stage; B: t2, in phase 1 the
    # repacked and the staged x; W: the weight ring; T: the position table.
    # The widest phase 3 first (fewest passes over t2), with 4 stages, then
    # 3; a narrower one needs a smaller ring and a smaller output stage.
    for wgn3, stages in [(wg, st) for wg in (8, 4, 2, 1) if wg <= widest3
                         for st in (4, 3)]:
        region_a = _round_up(max(mh * ld1, 32 * wgn3 * nt * 4), 128)
        x_stage = 2 * mh * ldk + stages * kc * rs * esize
        region_b = _round_up(max(mt * ld1, x_stage), 128)
        ring = stages * parts * 32 * max(wgn12, wgn3) * ldk
        smem = region_a + region_b + ring + mh * 4
        if smem <= smem_limit:
            break
    else:
        return None
    name = f"{th}x{w}" + (f"/{cs}" if cs > 1 else "") + (
        f"k{kc}" if kc != smallest else "")
    return {"name": name, "th": th, "cs": cs, "kc": kc, "mi": mi,
            "esize": esize, "stages": stages, "rs": rs, "wgn12": wgn12,
            "wgn3": wgn3, "off_b": region_a, "off_w": region_a + region_b,
            "off_t": region_a + region_b + ring, "smem": smem,
            "m_halo": mh, "m_tile": mt}


# candidate tile heights, cut to the image; the whole image is always one
_TILE_ROWS = (16, 14, 8, 7, 4, 2, 1)
# candidate cluster sizes: blocks that share a tile and split its columns
_CLUSTERS = (1, 2, 4)


def _plan_cost(plan, b, c, p, h, w, sms) -> float:
    """Rough seconds of one launch under ``plan``, fitted to times measured
    on an H100 (``chip_smoke.py`` runs every plan): blocks run in waves of one
    per SM; a block steps through its three products in chunks of ``kc``
    reduction values, and a chunk costs a fixed time (a barrier, a wait for
    the copies, the operand loads) plus its copies from L2 (weights, in
    phase 1 also x, with the repack) plus its mma; then the residual read
    and the store.  Clusters pay for their barriers and for writing the
    intermediates into every block, and fewer of their blocks fit the card
    at once (clusters of 4 leave SMs of a GPC unused).  The whole launch is
    no faster than L2 delivers the weights.  float32 moves twice the bytes
    of x and four times those of the weights (hi and lo) a value, and its
    products cost ``_MMA_COST`` times bf16's a value."""
    th, mi, cs, kc = plan["th"], plan["mi"], plan["cs"], plan["kc"]
    esize = plan["esize"]
    x_bytes = esize / 2                           # against bf16
    w_bytes = x_bytes * (2 if esize == 4 else 1)
    mma = _MMA_COST[esize]
    mh, mt = plan["m_halo"], plan["m_tile"]
    blocks = b * -(-h // th) * cs
    slots = sms if cs == 1 else (sms // 16) * 16 * (1.0 if cs == 2 else 0.75)

    def phase(mtiles, wgn, n_slice, k_chunks, x_rows):
        along_m = _WARPS // wgn
        passes_m = -(-mtiles // (along_m * mi))
        per_warp = -(-mtiles // (along_m * passes_m))
        passes_n = -(-n_slice // (32 * wgn))
        chunk = 0.7e-6 + (kc / 32) * ((32 * wgn * w_bytes + x_rows * x_bytes)
                                      * 1.2e-9 + per_warp * 0.07e-6 * mma)
        return passes_n * passes_m * k_chunks * chunk, passes_m

    t1, pm12 = phase(mh // 16, plan["wgn12"], p // cs, -(-c // kc), mh)
    t2, _ = phase(mt // 16, plan["wgn12"], p // cs, 9 * -(-p // kc), 0)
    t3, pm3 = phase(mt // 16, plan["wgn3"], c // cs, -(-p // kc), 0)
    per_block = t1 + t2 + t3 + th * w * (c // cs) / 4096 * 1e-6 * x_bytes
    if cs > 1:
        per_block *= 1.25
    weights = (2.0 * w_bytes * (pm12 * (c * p + 9 * p * p) + pm3 * p * c)
               / cs)
    return max(-(-blocks // int(slots)) * per_block, blocks * weights / 4e12)


@functools.lru_cache(maxsize=512)
def bottleneck_plans(b, c, p, h, w, sms: int = 132,
                     smem_limit: int = SMEM_LIMIT, esize: int = 2) -> tuple:
    """Every plan of the tensor-core kernel that fits ``smem_limit`` for
    x (b, c, h, w) of ``esize``-byte elements (2: bf16, 4: float32) with p
    mid channels, the cheapest (``_plan_cost``) first; plans whose tile is
    the whole image come before all others.  A tile is a number of full rows
    of the image; a cluster of 1, 2 or 4 blocks shares it; the reductions go
    in chunks of 32 or 64 values (bf16) or 16 (float32)."""
    rows = sorted({min(th, h) for th in _TILE_ROWS + (h,)})
    mi = _MI if esize == 2 else _MI32
    plans = [pl for th in rows for cs in _CLUSTERS for kc in _CHUNKS[esize]
             if (pl := _tile_plan(c, p, w, th, cs, kc, smem_limit, mi,
                                  esize))]
    return tuple(sorted(plans, key=lambda pl: (
        pl["th"] < h, _plan_cost(pl, b, c, p, h, w, sms))))


def plan_bottleneck(b, c, p, h, w, sms: int = 132,
                    smem_limit: int = SMEM_LIMIT, esize: int = 2) -> dict:
    """The tensor-core kernel's plan for x (b, c, h, w) of ``esize``-byte
    elements with p mid channels on a card with ``sms`` SMs: tile rows,
    blocks a cluster, m-tiles a warp, ring stages, the staged rows' stride,
    warps along N, shared-memory offsets and bytes.  The whole image where
    one block can hold it (a 7x7 image has then no recomputed halo at all),
    else the cheapest number of full rows: fewer, larger tiles, so that the
    weights streamed for a tile serve many pixels.  Where that leaves SMs
    idle, a cluster of 2 or 4 blocks shares the tile: each computes a slice
    of every product's columns from its own slice of the weights and hands
    its slice of the intermediates to the others through distributed shared
    memory."""
    plans = bottleneck_plans(b, c, p, h, w, sms, smem_limit, esize)
    if not plans:
        raise ValueError(f"no tile of the bottleneck kernel fits "
                         f"{smem_limit} bytes of shared memory at C={c}, "
                         f"P={p}, W={w}")
    return plans[0]


@functools.cache
def _entry():
    lib = _build.library("bottleneck")
    fn = lib.wut_bottleneck
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # (element size, reduction chunk, cluster?) -> the tensor-core kernel
    # built for it
    tc = {}
    for esize, chunks in _CHUNKS.items():
        stem = "bottleneck_tc" if esize == 2 else "bottleneck_f32tc"
        for kc in chunks:
            for cluster in (False, True):
                entry = _build.library(
                    f"{stem}{kc}" + "c" * cluster).wut_bottleneck_tc
                entry.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
                                  + [ctypes.c_void_p])
                entry.restype = ctypes.c_int
                tc[esize, kc, cluster] = entry
    return lib, fn, tc


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_inputs(x, checks):
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)},"
                             f" got {tuple(t.shape)} {t.dtype}")
    for name, t, _, _ in checks:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("bottleneck kernel inputs must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"bottleneck kernel input {name} must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"bottleneck kernel input {name} must be "
                             f"16-byte aligned")


def bottleneck_kernel(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Launch the CUDA-core K4 on CUDA tensors: x (B, C, H, W)
    float32/bfloat16; w1 (C, P), w2 (9, P, P), w3 (P, C) of x's type; b1, b2
    (P,), b3 (C,) float32; all contiguous; P and C multiples of 4."""
    global launches
    if x.dim() != 4 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"bottleneck kernel takes a 4-D float32/bfloat16 x, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    p = w1.shape[-1]
    if p % 4 or c % 4:
        raise ValueError(f"bottleneck kernel needs C and P to be multiples "
                         f"of 4, got C={c}, P={p}")
    _check_inputs(x, [
        ("x", x, x.shape, x.dtype), ("w1", w1, (c, p), x.dtype),
        ("b1", b1, (p,), torch.float32), ("w2", w2, (9, p, p), x.dtype),
        ("b2", b2, (p,), torch.float32), ("w3", w3, (p, c), x.dtype),
        ("b3", b3, (c,), torch.float32)])
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib, fn, _ = _entry()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
             b3.data_ptr(), out.data_ptr(), b, c, p, h, w, x.device.index,
             _build.stream_of(x))
    _build.check_launch(lib, err, "bottleneck")
    with _build.COUNT_LOCK:
        launches += 1
    return out


def bottleneck_tc_kernel(x, packed: PackedBottleneck,
                         plan: Optional[dict] = None) -> torch.Tensor:
    """Launch the tensor-core K4 on CUDA tensors: x (B, C, H, W) bfloat16
    with ``packed`` from ``pack_bottleneck`` in bfloat16, or float32 with
    ``packed`` from ``pack_bottleneck(..., torch.float32, split=True)`` (the
    3xTF32 form); contiguous; C and P multiples of 16.  ``plan`` (one of
    ``bottleneck_plans`` at x's element size) forces a tile; by default
    ``plan_bottleneck`` picks it for this card."""
    global launches, tensor_core_launches, f32_tensor_core_launches
    f32 = x.dtype == torch.float32
    if x.dim() != 4 or not (x.dtype == torch.bfloat16
                            or (f32 and packed.split)):
        raise ValueError(f"tensor-core bottleneck kernel takes a 4-D "
                         f"bfloat16 x with bfloat16 weights, or a float32 x "
                         f"with split float32 weights (pack_bottleneck(..., "
                         f"split=True)), got {tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    p = packed.w1.shape[-2]
    if c % 16 or p % 16:      # what the kernel takes; the rule may say more
        raise ValueError(f"tensor-core bottleneck kernel needs C and P to be "
                         f"multiples of 16, got C={c}, P={p}")
    parts = (2,) if f32 else ()
    _check_inputs(x, [
        ("x", x, x.shape, x.dtype),
        ("w1", packed.w1, parts + (p, c), x.dtype),
        ("b1", packed.b1, (p,), torch.float32),
        ("w2", packed.w2, parts + (9, p, p), x.dtype),
        ("b2", packed.b2, (p,), torch.float32),
        ("w3", packed.w3, parts + (c, p), x.dtype),
        ("b3", packed.b3, (c,), torch.float32)])
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    esize = _esize(x.dtype)
    if plan is None:
        plan = plan_bottleneck(b, c, p, h, w, _sm_count(x.device.index),
                               esize=esize)
    if plan["esize"] != esize:
        raise ValueError(f"plan {plan['name']} is for {plan['esize']}-byte "
                         f"elements, x has {esize}")
    lib, _, tc = _entry()
    err = tc[esize, plan["kc"], plan["cs"] > 1](
             x.data_ptr(), packed.w1.data_ptr(), packed.b1.data_ptr(),
             packed.w2.data_ptr(), packed.b2.data_ptr(), packed.w3.data_ptr(),
             packed.b3.data_ptr(), out.data_ptr(), b, c, p, h, w,
             plan["th"], plan["cs"], plan["kc"], plan["stages"], plan["rs"],
             plan["wgn12"], plan["wgn3"], plan["off_b"], plan["off_w"],
             plan["off_t"], plan["smem"], x.device.index,
             _build.stream_of(x))
    _build.check_launch(lib, err, "bottleneck (tensor cores)")
    with _build.COUNT_LOCK:
        launches += 1
        tensor_core_launches += 1
        f32_tensor_core_launches += f32
    return out


def fused_bottleneck_eval(x, w1, b1=None, w2=None, b2=None, w3=None, b3=None):
    """``relu(bn3(conv3(relu(bn2(conv2(relu(bn1(conv1(x)))))))) + x)`` with
    all BNs folded (eval mode), NCHW.  The weights are ``fold_bottleneck``'s
    six tensors, cast to ``x``'s type here if they are not yet, or one
    ``PackedBottleneck`` in place of ``w1`` (packed once per model, which
    saves the packing a tensor-core call would otherwise do; float32 packs
    split).  On CUDA tensors K4 runs (``takes_tensor_cores`` says which
    kernel), on CPU tensors the plain version."""
    packed = w1 if isinstance(w1, PackedBottleneck) else None
    dt = x.dtype
    if not _build.is_cuda(x):
        if packed is not None:
            w1, b1, w2, b2, w3, b3 = unpack_bottleneck(packed)
        return bottleneck_eval_reference(x, w1, b1, w2, b2, w3, b3)
    _, c, h, w = x.shape
    p = packed.w1.shape[-2] if packed is not None else w1.shape[-1]
    if takes_tensor_cores(dt, c, p, h, w):
        split = dt == torch.float32
        if packed is not None and packed.split != split:
            w1, b1, w2, b2, w3, b3 = unpack_bottleneck(packed)
            packed = None
        if packed is None:
            packed = pack_bottleneck(w1, b1, w2, b2, w3, b3, dt, split)
        return bottleneck_tc_kernel(x.contiguous(), packed)
    if packed is not None:
        w1, b1, w2, b2, w3, b3 = unpack_bottleneck(packed)
    return bottleneck_kernel(
        x.contiguous(), w1.to(dt), b1.float(), w2.to(dt), b2.float(),
        w3.to(dt), b3.float())


def _folded_conv(x, weight, bias, *, stride=1, padding=0, relu=True):
    """Conv with the eval BN folded into its weight (x's type) and a float32
    bias added to the result."""
    y = conv2d(x, weight, None, stride=stride, padding=padding).float()
    y = y + bias[None, :, None, None]
    return (F.relu(y) if relu else y).to(x.dtype)


class _FoldedBottleneck:
    """A stride/projection (or unfused identity) block on folded convs."""

    def __init__(self, block, dtype):
        sd = block.state_dict()

        def fold(conv, bn):
            s, t = _fold_bn_of(sd, bn, 1e-5)
            k = sd[f"{conv}.weight"].float() * s[:, None, None, None]
            return k.to(dtype), t

        self.stride = block.conv2.stride[0]
        self.convs = [fold(f"conv{i}", f"bn{i}") for i in (1, 2, 3)]
        self.down = (fold("downsample.0", "downsample.1")
                     if block.downsample is not None else None)

    def __call__(self, x):
        (k1, t1), (k2, t2), (k3, t3) = self.convs
        out = _folded_conv(x, k1, t1)
        out = _folded_conv(out, k2, t2, stride=self.stride, padding=1)
        out = _folded_conv(out, k3, t3, relu=False)
        idn = x
        if self.down is not None:
            idn = _folded_conv(x, *self.down, stride=self.stride, relu=False)
        return F.relu(out.float() + idn.float()).to(x.dtype)


class _FusedBottleneck:
    """An identity block through ``fused_bottleneck_eval``."""

    def __init__(self, block, dtype):
        folded = fold_bottleneck(block.state_dict())
        c, p = folded[0].shape
        if takes_tensor_cores(dtype, c, p):   # packed once, not per call
            # float32 split for the 3xTF32 kernel where it can run (on the
            # CPU the plain version takes the weights as they are)
            split = dtype == torch.float32 and folded[0].is_cuda
            self.weights = (pack_bottleneck(*folded, dtype, split),)
        else:
            self.weights = tuple(a.to(dtype) if a.dim() > 1 else a
                                 for a in folded)

    def __call__(self, x):
        return fused_bottleneck_eval(x, *self.weights)


def fused_resnet_eval(model, fuse_layers: Sequence[int] = (1, 2, 3, 4)):
    """Frozen (eval-mode) ResNet forward with every identity bottleneck of
    the layers in ``fuse_layers`` running the fused kernel, and the stem,
    the stride/projection blocks and the head on folded convs.

    The weights are folded here, once, from ``model``'s current parameters
    and running statistics, on the device they lie on.  Returns
    ``apply(images) -> logits`` for NCHW images; it matches
    ``model.eval()(images)``.  K4 has no backward, so ``apply`` runs under
    ``torch.no_grad()``: its logits are ordinary tensors without a graph,
    which a later differentiated computation may take as inputs (an
    inference-mode tensor could not be saved for backward)."""
    dt = model.dtype
    sd = model.state_dict()
    s, t = _fold_bn_of(sd, "bn1", 1e-5)
    stem = ((sd["conv1.weight"].float() * s[:, None, None, None]).to(dt), t)
    blocks = []
    for li, layer in enumerate(model.layers):
        for block in layer:
            fuse = block.downsample is None and li + 1 in fuse_layers
            blocks.append((_FusedBottleneck if fuse else _FoldedBottleneck)(
                block, dt))
    fc_w, fc_b = model.fc.weight.detach(), model.fc.bias.detach()

    @torch.no_grad()
    def apply(images):
        x = _folded_conv(images.to(dt), *stem, stride=2, padding=3)
        x = max_pool(x, window=3, stride=2, padding=1)
        for block in blocks:
            x = block(x)
        return F.linear(x.mean(dim=(2, 3)), fc_w, fc_b)

    return apply
