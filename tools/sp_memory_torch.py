"""Peak device memory and exchanges of a spatial rank's GAN step, this tree
against an older one, on one card.

Runs ``tools/dp_train_torch.py --spatial 2`` of each tree as two gloo
ranks sharing ``cuda:0`` -- the est-mode combined step at 224x224, B=8,
float32 (TF32 off, cuDNN deterministic), dropout 0.3, the K4-routed
ResNet-101 estimator (``chip_smoke.make_estimator_checkpoint``), ``--steps``
steps with ``--timing`` -- in the order old, new, new, old, each rank in a
wrapper that records ``torch.cuda.max_memory_allocated`` at its end.  This
tree's ranks take no evaluation step (``--eval_refs 0``), so both trees'
peaks are their train steps'.

    git archive <commit> | tar -x -C _chip_tmp/old
    python3 tools/sp_memory_torch.py --old _chip_tmp/old    # on the card

Prints one JSON line (and writes it to ``chiprun_out/sp_memory.json``): per
run and rank the peak MiB, the median step ms and exchange ms after the
first step, the exchanges a step, the rows the new tree's estimator input
kept, and for each estimator forward under autograd the MiB it kept for
its backward, the MiB allocated before it and the peak before it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# one rank: the tree's worker run as __main__, then its peak memory; the
# estimator's forwards under autograd (the one whose gradient reaches G)
# are watched: the memory allocated before and after each (what the
# forward keeps for its backward) and the peak so far at its start
WRAPPER = ("import json, runpy, sys, torch\n"
           "from weather_unet_tpu_torch.models import resnet\n"
           "peak_path, worker = sys.argv[1], sys.argv[2]\n"
           "sys.argv = sys.argv[2:]\n"
           "seen, forward = [], resnet.ResNet.forward\n"
           "def watched(self, *a, **k):\n"
           "    if not torch.is_grad_enabled():\n"
           "        return forward(self, *a, **k)\n"
           "    m = 2 ** 20\n"
           "    before = torch.cuda.memory_allocated()\n"
           "    peak = torch.cuda.max_memory_allocated()\n"
           "    out = forward(self, *a, **k)\n"
           "    seen.append({'kept_mib': (torch.cuda.memory_allocated()\n"
           "                              - before) / m,\n"
           "                 'allocated_before_mib': before / m,\n"
           "                 'peak_before_mib': peak / m})\n"
           "    return out\n"
           "resnet.ResNet.forward = watched\n"
           "try:\n"
           "    runpy.run_path(worker, run_name='__main__')\n"
           "except SystemExit as e:\n"
           "    if e.code:\n"
           "        raise\n"
           "rank = int(__import__('os').environ.get('WUT_PROCESS_ID', 0))\n"
           "with open(f'{peak_path}.{rank}', 'w') as f:\n"
           "    json.dump({'peak_mib': torch.cuda.max_memory_allocated()\n"
           "               / 2 ** 20, 'estimator_grad_forwards': seen}, f)\n")


def run(tree, new, tmp, name, est, init, steps):
    """Two ranks of ``tree``'s worker; each rank's record with its peak."""
    import numpy as np

    from weather_unet_tpu_torch.parallel.launch import launch_local

    out = os.path.join(tmp, name)
    peak = os.path.join(tmp, f"{name}.peak")
    argv = [sys.executable, "-c", WRAPPER, peak,
            os.path.join(tree, "tools", "dp_train_torch.py"), "--out", out,
            "--mode", "gan", "--spatial", "2", "--size", "224", "--batch",
            "8", "--steps", str(steps), "--dropout", "0.3",
            "--estimator_path", est, "--route", "k4", "--dtype", "f32",
            "--init", init, "--deterministic", "--timing"]
    if new:
        argv += ["--eval_refs", "0"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("WUT_")}
    env["PYTHONPATH"] = tree
    env["WUT_BARRIER_TIMEOUT_S"] = "300"
    rc = launch_local(2, argv, backend="gloo", env=env, timeout=600,
                      rank_logs=os.path.join(tmp, "logs", name))
    if rc != 0:
        raise SystemExit(f"{name}: rc {rc} (logs {tmp}/logs/{name})")
    recs = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            rec = json.load(f)
        with open(f"{peak}.{r}") as f:
            pk = json.load(f)
        recs.append({**pk,
                     "step_ms": float(np.median(rec["step_ms"][1:])),
                     "exchange_ms": float(np.median(rec["tp_sum_ms"][1:])),
                     "exchanges_a_step": rec["tp_sums"],
                     "estimator_input_rows": rec.get("estimator_input_rows"),
                     "metrics": rec["metrics"]})
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", required=True,
                   help="an older tree (git archive) to hold this one to")
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import GanConfig, build_gan_state

    old = os.path.abspath(args.old)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        est = os.path.join(tmp, "est.pt")
        cs.make_estimator_checkpoint(est)
        _, _, state = build_gan_state(GanConfig(input_size=224, batch_size=8,
                                                num_epoch=1), 0, "cuda",
                                      use_pallas=True)
        init = os.path.join(tmp, "init.pt")
        with open(init, "wb") as f:
            f.write(ckpt.serialize(ckpt._to_host(ckpt.gan_tree(state, 0))))
        del state
        torch.cuda.empty_cache()
        runs = []
        for k, (tree, new) in enumerate(((old, False), (REPO, True),
                                         (REPO, True), (old, False))):
            name = f"{k}_{'new' if new else 'old'}"
            runs.append({"run": name, "ranks": run(
                tree, new, tmp, name, est, init, args.steps)})
    line = {"tool": "sp_memory_torch", "card": smi, "runs": runs}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "sp_memory.json"), "w") as f:
        json.dump(line, f)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
