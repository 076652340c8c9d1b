"""The Python around K1 (AdaIN) and K2 (2x upsample) on the CPU
(weather_unet_tpu_torch.kernels.adain / upsample): their plan functions over
every decoder site of the cUNet at batch 1 and 16 and inputs of 224, 256
and 512 pixels, odd and degenerate shapes; the mirror of K2's staged rows;
and the argument checks of K1's one-launch interface.  The kernels
themselves run in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from tests.torch_port_util import no_thread_left  # noqa: F401
from weather_unet_tpu_torch.kernels import adain as k1, upsample as k2
from weather_unet_tpu_torch.ops.resize import _x2_taps

SMEM = 227 * 1024
DTYPES = (torch.float32, torch.bfloat16)


def decoder_sites(batch):
    """(B, C, H, W) of the three AdaIN / upsample sites at each input size,
    then odd and degenerate shapes."""
    sites = [(batch, c, s // f, s // f) for s in (224, 256, 512)
             for c, f in ((512, 8), (256, 4), (128, 2))]
    return sites + [(2, 8, 5, 7), (1, 3, 1, 6), (1, 3, 6, 1), (1, 1, 1, 1),
                    (1, 2, 17, 130), (16, 128, 128, 127), (2, 8, 256, 256)]


@pytest.mark.parametrize("batch", [1, 16])
def test_upsample_plans_fit_and_align(batch):
    for b, c, h, w in decoder_sites(batch):
        for dt in DTYPES:
            esize = 4 if dt == torch.float32 else 2
            plans = k2.upsample_plans(b, c, h, w, dt)
            assert plans[0] == k2.plan_upsample(b, c, h, w, dt)
            assert len({(p["rows"], p["pb"], p["vec"])
                        for p in plans}) == len(plans)
            aligned = (2 * w * esize) % 16 == 0
            assert (plans[0]["vec"] > 1) == aligned
            for p in plans:
                assert p["smem"] <= SMEM
                assert p["vec"] in (1, 16 // esize)
                # the vector path only where output rows are 16-byte aligned
                assert p["vec"] == 1 or aligned
                assert 1 <= p["rows"] <= 2 * h and p["pb"] >= 1
                assert p["pb"] == 1 or p["rows"] == 2 * h
                assert p["strips"] * p["rows"] >= 2 * h
                assert p["grid"] == -(-(b * c) // p["pb"]) * p["strips"]
                assert p["grid"] < 2 ** 31
                # regions in order: the staged run (plus a 16-byte piece of
                # misalignment), float32 rows of 2W, 3 words a row's taps
                assert p["off_hb"] % 16 == 0
                assert p["off_hb"] >= p["staged"] * w * esize + 16 - esize
                assert p["off_taps"] == p["off_hb"] + p["staged"] * 2 * w * 4
                assert p["smem"] == p["off_taps"] + 12 * p["rows"]


def test_upsample_staged_rows_hold_every_output_row():
    """Every output row's i0 / i1 lies inside its block's staged rows, and
    the staged count fits the plan's room, under every plan."""
    shapes = {s for batch in (1, 16) for s in decoder_sites(batch)}
    for b, c, h, w in sorted(shapes):
        i0, i1, _ = _x2_taps(h)
        for dt in DTYPES:
            for p in k2.upsample_plans(b, c, h, w, dt):
                strips = k2.staged_rows(h, p["rows"])
                assert len(strips) == p["strips"]
                for s, (ra, rz) in enumerate(strips):
                    rows = range(s * p["rows"], min((s + 1) * p["rows"],
                                                    2 * h))
                    assert all(ra <= i0[r] <= i1[r] <= rz for r in rows)
                    assert rz - ra + 1 <= p["staged"]
                if p["pb"] > 1:
                    assert strips == [(0, h - 1)]
                    assert p["staged"] == p["pb"] * h


def test_upsample_plan_refuses_rows_beyond_shared_memory():
    # one float32 output row of 2 x 20000 columns and its two staged rows
    # need more than 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        k2.plan_upsample(1, 1, 4, 20000, torch.float32)
    assert k2.plan_upsample(1, 1, 4, 4000, torch.float32)["smem"] <= SMEM


@pytest.mark.parametrize("batch", [1, 16])
def test_adain_plans_fit_and_hold_the_plane(batch):
    for b, c, h, w in decoder_sites(batch):
        for dt in DTYPES:
            esize = 4 if dt == torch.float32 else 2
            hw = h * w
            plans = k1.adain_plans(b, c, h, w, dt)
            assert plans[0] == k1.plan_adain(b, c, h, w, dt)
            assert len({p["name"] for p in plans}) == len(plans)
            # on chip exactly where 16 warps of 32 lanes hold the plane
            assert plans[0]["on_chip"] == (hw <= 16 * 32 * k1.PER_THREAD)
            assert (plans[0]["vec"] > 1) == (hw * esize % 16 == 0)
            assert any(not p["on_chip"] for p in plans)
            for p in plans:
                assert p["vec"] in (1, 16 // esize)
                assert p["vec"] == 1 or hw % p["vec"] == 0
                assert 32 <= p["threads"] <= 512 and p["threads"] % 32 == 0
                assert p["threads"] == 32 * p["wp"] * p["ppb"]
                assert p["smem"] <= SMEM
                assert p["grid"] == -(-(b * c) // p["ppb"])
                if p["on_chip"]:
                    assert p["wp"] * 32 * k1.PER_THREAD >= hw
                else:
                    assert p["ppb"] == 1 and p["wp"] == 16
    # the cUNet's 32x32 site: one warp a plane, several planes a block;
    # its 128x128 site: a block of 16 warps a plane, on chip
    assert (k1.plan_adain(16, 512, 32, 32, torch.bfloat16)["wp"],
            k1.plan_adain(16, 512, 32, 32, torch.bfloat16)["ppb"]) == (1, 8)
    big = k1.plan_adain(16, 128, 128, 128, torch.float32)
    assert (big["wp"], big["ppb"], big["on_chip"]) == (16, 1, True)


def test_adain_kernel_checks_its_one_launch_interface(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4, 3, 3)).astype(np.float32))
    y = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        k1.adain_kernel(x, y, 1e-5)                  # CPU tensors
    for bad in (torch.zeros(2, 4), torch.zeros(2, 4, 4), torch.zeros(1, 16),
                y.double(), y.half()):
        with pytest.raises(ValueError, match="y_proj"):
            k1.adain_kernel(x, bad, 1e-5)
    # the non-contiguity check needs CUDA tensors (it follows the device
    # check); the CPU path of adain_fused takes any layout and runs plain
    xt = x.transpose(2, 3)
    before = k1.launches
    assert torch.equal(k1.adain_fused(xt, y.bfloat16()),
                       k1.adain_fused_ref(xt, y.bfloat16()))
    assert k1.launches == before
