"""Is the one-process float32 GAN step reproducible on the card?

Runs the reference step of ``chip_smoke.py``'s phase ``tensor_parallel``
(b) -- the est-mode combined step at 224x224, B=8, ``use_pallas`` G, the
K4-routed ResNet-101 estimator, TF32 off, cuDNN deterministic, dropout 0.3
from a seeded generator -- from one saved start state and one set of
inputs, in several child processes that differ in one thing each, and
compares the states they write bit for bit:

* ``fresh_a``, ``fresh_b``: two fresh processes;
* ``twice``: a fresh process that takes the step, restores the start and
  takes it again (the second state is written);
* ``det_algos``: ``torch.use_deterministic_algorithms(True, warn_only=True)``
  (with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), whose warnings name every op
  of the step that has no deterministic implementation;
* ``tight``: the card's free memory held down to the fresh step's peak plus
  ``--margin_mib`` before the step (cuDNN workspaces that cannot be
  allocated make PyTorch try the next engine);
* ``capped``, ``tight_capped``: a fresh process and a ``tight`` one with
  ``--margin_mib`` above ``--cap_mib``, both with cuDNN's workspace cap
  ``CUDNN_CONV_WSCAP_DBG=--cap_mib``, and ``tight_wide``: that margin
  without the cap;
* with ``--log``, ``fresh_a`` and ``tight`` again under
  ``CUDNN_LOGLEVEL_DBG=3``: the engine id of every execution plan the log
  shows, in order, and the first where the two runs part (the filtered
  log is written beside the record, gzipped).

    python3 tools/f1_repro_torch.py --out OUT --log   # on the card
    python3 tools/f1_repro_torch.py --runs fresh_a capped tight_capped

Prints one JSON line: each child's state digest, peak memory and the
tensors that differ from ``fresh_a`` (first 5), and, with ``--log``, the
sequence of cuDNN engines of each logged run and where they part.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SIZE, BATCH = 224, 8


def make_world(tmp):
    """The start state, the estimator and the inputs, written to ``tmp``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import GanConfig, build_gan_state

    est = os.path.join(tmp, "est.pt")
    cs.make_estimator_checkpoint(est)
    cfg = GanConfig(input_size=SIZE, batch_size=BATCH, num_epoch=1)
    _, _, state = build_gan_state(cfg, 0, "cuda", use_pallas=True)
    with open(os.path.join(tmp, "init.pt"), "wb") as f:
        f.write(ckpt.serialize(ckpt._to_host(ckpt.gan_tree(state, 0))))
    rng = np.random.default_rng(7)
    x, r = (torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, SIZE, SIZE))
                             .astype(np.float32)) for _ in range(2))
    zeros = torch.zeros(BATCH, dtype=torch.int64)
    torch.save((x, zeros, r, zeros), os.path.join(tmp, "inputs.pt"))


def child(args):
    import warnings

    import torch

    import chip_smoke as cs
    from weather_unet_tpu_torch._device import refused_allocations
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_gan_step)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    caught = []
    if args.det_algos:
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("always")
        warnings.showwarning = (lambda m, *a, **k: caught.append(str(m)))
    cfg = GanConfig(input_size=SIZE, batch_size=BATCH, num_epoch=1)
    gen, disc, state = build_gan_state(cfg, 0, "cuda", use_pallas=True)
    est = cs.estimators(os.path.join(args.tmp, "est.pt"), torch.float32,
                        "k4", {})
    step = make_gan_step(gen, disc, est, cfg)
    x, c_d, r, c_r = (t.cuda() for t in torch.load(
        os.path.join(args.tmp, "inputs.pt"), weights_only=True))
    g = torch.Generator(device="cuda")
    hog = None
    if args.peak_mib:
        # leave the step what the fresh step's peak needs, and no more
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        need = int((args.peak_mib + args.margin_mib) * 2 ** 20
                   - torch.cuda.memory_allocated())
        if free > need:
            hog = torch.empty(free - need, dtype=torch.uint8, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2 if args.twice else 1):
        ckpt.restore_checkpoint(os.path.join(args.tmp, "init.pt"), state)
        g.manual_seed(fold_seed(1, 1))
        st, m = step(state, x, c_d, r, c_r, g, do_g=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    free_after = torch.cuda.mem_get_info()[0] / 2 ** 20
    del hog
    tree = ckpt._to_host(ckpt.gan_tree(st, 0))
    torch.save(tree, args.child)
    with open(args.child + ".json", "w") as f:
        json.dump({"metrics": {k: float(v) for k, v in m.items()},
                   "refused_allocations": refused_allocations(),
                   "peak_mib": peak, "free_mib_after": free_after,
                   "warnings": sorted(set(caught)),
                   "digest": hashlib.sha256(ckpt.serialize(tree))
                   .hexdigest()[:16]}, f)


def flat(tree, prefix=""):
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {}


def differ(a, b):
    """The tensors of two states that are not bit-equal: (name, max abs
    difference, share of elements that differ), largest first."""
    fa, fb = flat(a), flat(b)
    out = []
    for k, t in fa.items():
        u = fb.get(k)
        if u is None or u.shape != t.shape or not t.equal(u):
            if u is None or u.shape != t.shape:
                out.append((k, None, None))
                continue
            d = (t.double() - u.double()).abs()
            out.append((k, float(d.max()), float((d > 0).double().mean())))
    return sorted(out, key=lambda e: -(e[1] or 0))


ENGINE = re.compile(r'"engineId":(\d+)')
DIMS = re.compile(r'"dim":\[([0-9,]*)\]')


def engines(log_path, keep_path):
    """The engines of the execution plans a cuDNN debug log finalizes, in
    order: ``(engine id, the op graph's tensor dims)`` of each
    ``cudnnBackendFinalize`` call on an execution plan.  The function
    header lines and the lines naming an engine or a plan are written to
    ``keep_path`` (gzipped)."""
    import gzip

    if not os.path.exists(log_path):
        return []
    out, func, in_plan = [], "", False
    with open(log_path, errors="replace") as f, gzip.open(
            keep_path, "wt") as keep:
        for line in f:
            if line.startswith("I! CuDNN"):
                func = line.split("function ")[-1].strip()
                in_plan = False
                keep.write(line)
                continue
            if "EXECUTION_PLAN" in line:
                in_plan = True
                keep.write(line)
            m = ENGINE.search(line)
            if m:
                keep.write(line[:4000])
                if func.startswith("cudnnBackendFinalize()") and in_plan:
                    dims = ";".join(DIMS.findall(line))
                    out.append((int(m.group(1)), dims))
    return out


def run_child(name, tmp, extra, env_extra=None):
    path = os.path.join(tmp, name + ".pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child", path, "--tmp", tmp] + extra, env=env,
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise SystemExit(f"{name}: rc {res.returncode}\n{res.stderr[-4000:]}")
    with open(path + ".json") as f:
        rec = json.load(f)
    rec["seconds"] = time.perf_counter() - t0
    return path, rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="f1_out")
    p.add_argument("--margin_mib", type=float, default=64.0)
    p.add_argument("--log", action="store_true")
    p.add_argument("--cap_mib", type=int, default=512)
    p.add_argument("--runs", nargs="*", default=None,
                   help="the runs to make (default: all)")
    p.add_argument("--child", default=None)
    p.add_argument("--tmp", default=None)
    p.add_argument("--twice", action="store_true")
    p.add_argument("--det_algos", action="store_true")
    p.add_argument("--peak_mib", type=float, default=0.0)
    args = p.parse_args(argv)
    if args.child:
        return child(args)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("f1_repro_torch: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    rec = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn": torch.backends.cudnn.version(),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    with tempfile.TemporaryDirectory() as tmp:
        from weather_unet_tpu_torch.kernels import _build

        _build.build_all()
        make_world(tmp)
        torch.cuda.empty_cache()
        runs = collections.OrderedDict()
        want = set(args.runs or ["fresh_a", "fresh_b", "twice", "det_algos",
                                 "tight", "capped", "tight_capped",
                                 "tight_wide"])
        want.add("fresh_a")
        cap = {"CUDNN_CONV_WSCAP_DBG": str(args.cap_mib)}
        runs["fresh_a"] = run_child("fresh_a", tmp, [])
        peak = str(runs["fresh_a"][1]["peak_mib"])

        def tight(margin):
            return ["--peak_mib", peak, "--margin_mib", str(margin)]

        wide = args.cap_mib + args.margin_mib
        plan = [("fresh_b", [], None), ("twice", ["--twice"], None),
                ("det_algos", ["--det_algos"],
                 {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}),
                ("tight", tight(args.margin_mib), None),
                ("capped", [], cap), ("tight_capped", tight(wide), cap),
                ("tight_wide", tight(wide), None)]
        for name, extra, env in plan:
            if name in want:
                runs[name] = run_child(name, tmp, extra, env)
        logs = {}
        if args.log:
            for name, extra in (("fresh_log", []),
                                ("tight_log", tight(args.margin_mib))):
                log = os.path.join(tmp, name + ".log")
                runs[name] = run_child(name, tmp, extra, {
                    "CUDNN_LOGLEVEL_DBG": "3", "CUDNN_LOGDEST_DBG": log})
                logs[name] = engines(log, os.path.join(
                    args.out, name + ".filtered.log.gz"))
        base = torch.load(runs["fresh_a"][0], weights_only=True)
        out = {}
        for name, (path, r) in runs.items():
            d = differ(torch.load(path, weights_only=True), base)
            r.update(n_tensors_differ=len(d), first_differ=d[:5])
            out[name] = r
        rec["runs"] = out
        if logs:
            a, b = logs["fresh_log"], logs["tight_log"]
            part = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v),
                        None)
            rec["engines"] = {
                "fresh": collections.Counter(e for e, _ in a).most_common(),
                "tight": collections.Counter(e for e, _ in b).most_common(),
                "n": [len(a), len(b)], "first_part": part,
                "parted": [(u, v) for u, v in zip(a, b) if u != v][:20]}
    print(json.dumps(rec))
    with open(os.path.join(args.out, "f1.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
