"""The port's ``convert_checkpoint`` CLI against the JAX package's on the
same input files: ``from-torch`` writes the same msgpack bytes, ``to-torch``
the same state dicts (keys, dtypes and values bit for bit), for ``--kind
gan`` (the cUNet and SNDisc bundle) and ``--kind resnet`` (a depth-(1, 1,
1, 1) ResNet with its BatchNorm statistics); ``--output`` is the file
written."""

import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.cli import convert_checkpoint as jax_cli
from weather_unet_tpu.train import checkpoint as jax_ckpt
from weather_unet_tpu_torch.cli import convert_checkpoint
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.models import ConditionalUNet, ResNet, SNDisc


def inputs(root, kind):
    """(reference .pt, JAX-written msgpack) of seeded weights."""
    gen = torch.Generator().manual_seed(7)
    pt, mp = str(root / f"{kind}.pt"), str(root / f"{kind}.msgpack")
    if kind == "gan":
        g = ConditionalUNet(5, generator=gen).state_dict()
        d = SNDisc(5, generator=gen).state_dict()
        torch.save({"inference": g, "discriminator": d, "epoch": 3,
                    "global_step": 1200}, pt)
        dj = torch_io.sndisc_state_dict_to_jax(d)
        tree = {"gen": {"params": torch_io.cunet_state_dict_to_jax(g)[
                    "params"], "step": 600},
                "disc": {"params": dj["params"], "step": 1200},
                "spectral": dj["spectral"], "epoch": 3, "global_step": 1200}
    else:
        model = ResNet((1, 1, 1, 1), 5, generator=gen)
        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.normal_(0.0, 0.1, generator=gen)
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 2.0, generator=gen)
        torch.save(model.state_dict(), pt)
        tree = {**torch_io.resnet_state_dict_to_jax(model.state_dict()),
                "epoch": 2, "global_step": 40, "epoch_step": 0}
    jax_ckpt.save_checkpoint_file(mp, tree)
    return pt, mp


@pytest.mark.parametrize("kind", ["gan", "resnet"])
def test_from_torch_writes_the_jax_bytes(kind, tmp_path, capsys):
    pt, _ = inputs(tmp_path, kind)
    ours, theirs = str(tmp_path / "ours.msgpack"), str(tmp_path / "x.bin")
    jax_cli.main(["from-torch", "--kind", kind, "--input", pt,
                  "--output", theirs])
    convert_checkpoint.main(["from-torch", "--kind", kind, "--input", pt,
                             "--output", ours])
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {ours}"
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kind", ["gan", "resnet"])
def test_to_torch_writes_the_jax_state_dicts(kind, tmp_path):
    pt, mp = inputs(tmp_path, kind)
    ours, theirs = str(tmp_path / "ours.pt"), str(tmp_path / "theirs.bin")
    jax_cli.main(["to-torch", "--kind", kind, "--input", mp,
                  "--output", theirs])
    convert_checkpoint.main(["to-torch", "--kind", kind, "--input", mp,
                             "--output", ours])
    got = torch.load(ours, weights_only=True)
    want = torch.load(theirs, weights_only=True)
    pairs = [(got, want)]
    if kind == "gan":
        assert got.keys() == want.keys()
        assert (got["epoch"], got["global_step"]) == (3, 1200)
        assert (want["epoch"], want["global_step"]) == (3, 1200)
        pairs = [(got[k], want[k]) for k in ("inference", "discriminator")]
        # the bundle loads into the port's modules
        ConditionalUNet(5).load_state_dict(got["inference"])
        SNDisc(5).load_state_dict(got["discriminator"])
    else:
        ResNet((1, 1, 1, 1), 5).load_state_dict(got)
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k, v in b.items():
            assert a[k].dtype == v.dtype and torch.equal(a[k], v), k
    # the weights crossed both ways unchanged
    src = torch.load(pt, weights_only=True)
    key = "conv_last.weight" if kind == "gan" else "fc.weight"
    if kind == "gan":
        src, got = src["inference"], got["inference"]
    assert torch.equal(got[key], src[key])
