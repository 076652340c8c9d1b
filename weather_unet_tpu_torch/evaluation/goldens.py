"""Registry of the numeric goldens that wait for real Inception weights --
the port's copy of ``weather_unet_tpu/evaluation/goldens.py``: the same
paths under ``configs/``, environment variables, sha256 prefixes and
status records.

Two checks need pretrained checkpoints that are not in the repository:

* FID against the TF-ported ``pt_inception-2015-12-05`` checkpoint the
  reference downloads at run time (``eval/inception.py:13``);
* the Inception Score against stock torchvision
  ``inception_v3(pretrained=True)`` (``eval/inception_score.py:29,64-76``).

This module says where those files go, what their sha256 must start with,
and which skipped tests they activate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

REPO_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "configs")

#: First 8 hex digits of torchvision's canonical ``inception_v3``
#: checkpoint's sha256, from its torch-hub file name
#: (``inception_v3_google-0cc3c7bd.pth``, reference
#: eval/inception_score.py:29).
IS_WEIGHTS_SHA256_PREFIX = "0cc3c7bd"


@dataclass(frozen=True)
class Golden:
    name: str
    env_var: str
    default_path: str
    sha256_prefix: str
    source_url: str
    activates: str          # the skipped test(s) this file enables
    note: str

    def path(self) -> str:
        return os.environ.get(self.env_var, self.default_path)

    def status(self) -> dict:
        """Presence and fingerprint of this golden on this host."""
        from weather_unet_tpu_torch.evaluation.fid import (
            fingerprint_weights_file)

        p = self.path()
        out = {"name": self.name, "env_var": self.env_var, "path": p,
               "expected_sha256_prefix": self.sha256_prefix,
               "source_url": self.source_url, "activates": self.activates,
               "present": os.path.exists(p), "sha256": None,
               "certified": False, "note": self.note}
        if out["present"]:
            out["sha256"] = fingerprint_weights_file(p)
            out["certified"] = out["sha256"].startswith(self.sha256_prefix)
        return out


def goldens() -> list:
    from weather_unet_tpu_torch.evaluation.fid import (
        FID_WEIGHTS_SHA256_PREFIX)

    return [
        Golden(
            name="fid_inception",
            env_var="FID_INCEPTION_PTH",
            default_path=os.path.join(REPO_CONFIGS, "pt_inception.pth"),
            sha256_prefix=FID_WEIGHTS_SHA256_PREFIX,
            source_url=("https://github.com/mseitzer/pytorch-fid/releases/"
                        "download/fid_weights/"
                        "pt_inception-2015-12-05-6726825d.pth"),
            activates=("tests/test_fid_weights.py::"
                       "test_real_checkpoint_golden_activations"),
            note=("TF-ported FID InceptionV3 the reference downloads at run "
                  "time (eval/inception.py:13). An untouched download keeps "
                  "the certified sha256; a torch.load/torch.save re-save "
                  "still passes the structural check ('converted')."),
        ),
        Golden(
            name="is_inception",
            env_var="IS_INCEPTION_PTH",
            default_path=os.path.join(REPO_CONFIGS, "inception_v3_tv.pth"),
            sha256_prefix=IS_WEIGHTS_SHA256_PREFIX,
            source_url=("https://download.pytorch.org/models/"
                        "inception_v3_google-0cc3c7bd.pth"),
            activates=("tests/test_eval.py::"
                       "test_real_torchvision_checkpoint_golden_is"),
            note=("Stock torchvision inception_v3(pretrained=True), the "
                  "reference Inception Score's network "
                  "(eval/inception_score.py:29,64-76)."),
        ),
    ]


def golden_status() -> list:
    return [g.status() for g in goldens()]


def find_golden(name: str) -> Optional[Golden]:
    for g in goldens():
        if g.name == name:
            return g
    return None
