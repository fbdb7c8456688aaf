"""The planning dry-run: every (arch, input shape) step planned on the host,
and run once on the card: the port of ``repro/launch/dryrun.py``.

The plan needs no device: the params, optimizer state, inputs and caches
are meta tensors (``launch/specs``), and ``launch/step_cost`` gives the
step's FLOPs as the reference's ``hlo_analysis`` counts them, a lower bound
on its HBM bytes, its planned memory, the microbatch count of the
reference's doubling rule against the card's budget, and its roofline on
one H100.  A pair the reference skips is ``skipped`` with its reason.

The step on the card is the counterpart of ``.lower().compile()``: it
proves the step runs at this shape.  The resolved config gets seeded
random weights, and its step runs once after one warm-up, at the shape's
own ``seq_len`` and one microbatch of ``rows`` rows: its wall and device
milliseconds (device time from ``torch.profiler``), its peak GiB, and its
FLOPs over the device time.  Where one card cannot hold the step, the
caller cuts ``num_layers`` and ``rows``, and the row lists each cut under
``reduced``; the plan stays the full step's.  Nothing catches an
out-of-memory error to retry smaller.

``--mesh 16x16`` and ``--multi-pod`` (``--mesh 2x16x16``) plan each step
over the reference's production meshes instead (``launch.mesh``), per
device, with ``step_cost.analyze_mesh``: the argument bytes exact from the
sharding specs, the rest analytic.  Those rows are plans only.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k \
      [--run [--device cuda:0] [--num-layers N] [--rows R]] [--out f.json]
  python -m repro_torch.launch.dryrun --all [--reduced] [--out f.json]
  python -m repro_torch.launch.dryrun --all --multi-pod [--out f.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig, shape_applicable
from repro_torch import kernels
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import specs as S
from repro_torch.launch import step_cost as C
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.training.optimizer import adamw_init


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg.reduced()``, a pure-SSM stack kept pure (``reduced()`` gives
    every SSM config zamba2's shared attention)."""
    small = cfg.reduced()
    if cfg.has_ssm() and cfg.shared_attn_every == 0:
        small = dataclasses.replace(small, shared_attn_every=0)
    return small


def _config(arch: str, reduced: bool) -> ModelConfig:
    base = get_config(arch)
    return reduce_config(base) if reduced else base


MESHES = ("1", "16x16", "2x16x16")


def plan(arch: str, shape_name: str, *, reduced: bool = False,
         mesh: str = "1") -> Dict[str, Any]:
    """The host plan of one (arch, shape) pair on one H100 or, per device,
    over a production ``mesh``, with the reference's field names: nothing
    is allocated."""
    shape = INPUT_SHAPES[shape_name]
    base = _config(arch, reduced)
    row: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh,
                           "mode": shape.mode}
    ok, reason = shape_applicable(base, shape)
    if not ok:
        row.update(status="skipped", reason=reason)
        return row
    t0 = time.perf_counter()
    cfg = S.resolved_config(base, shape)
    params = S.abstract_params(cfg)
    n_params = S.num_params(params)
    inputs = S.input_specs(cfg, shape)
    if mesh == "1":
        sizes = dict(param_bytes=C.tree_bytes(params), n_params=n_params,
                     cache_bytes=C.tree_bytes(inputs.get("caches", ())))
        m = C.fit_microbatches(cfg, shape, **sizes)
        ana = C.analyze(cfg, shape, m, **sizes)
        mem = C.plan_memory(cfg, shape, m, **sizes)
        ana.update(microbatches=m, memory=mem, num_devices=1,
                   argument_bytes=sizes["param_bytes"] + mem["adam"]
                   + C.tree_bytes(inputs),
                   roofline=C.roofline(ana["flops"], ana["hbm_bytes"],
                                       cfg.dtype))
    else:
        ana = C.analyze_mesh(cfg, shape, make_production_mesh(
            multi_pod=mesh == "2x16x16"), params, inputs)
    mem = ana["memory"]
    row.update({
        "status": "ok",
        "microbatches": ana["microbatches"],
        "plan_s": round(time.perf_counter() - t0, 3),
        "num_params": n_params,
        "hlo_flops_per_device": ana["flops"],
        "hlo_hbm_bytes_per_device": ana["hbm_bytes"],
        "collectives": {"bytes_per_op": ana["collective_bytes"],
                        "total_bytes": ana["collective_total_bytes"],
                        "op_counts": ana["collective_op_counts"]},
        "memory_analysis": {
            "argument_size_in_bytes": int(ana["argument_bytes"]),
            "output_size_in_bytes": int(mem["logits"]),
            "temp_size_in_bytes": int(mem["temp"]),
            "plan": mem,
            "fits": mem["total"] <= C.CARD_BYTES},
        "roofline": ana["roofline"],
        "num_devices": ana["num_devices"],
    })
    return row


# the port's CUDA kernels, by the namespaces of csrc/*.cu
_PORT_KERNEL = re.compile(r"\brepro(_ssd\w*)?::")


# idle seconds the profiler runs before and after the call, by attempt: a
# retry widens the window, whose idle time holds no device event
_PROFILE_PADS_S = (0.0, 0.5, 2.0)


def _device_ms(fn, pads=_PROFILE_PADS_S):
    """(result, device ms summed over every kernel the profiler saw, or
    None when it saw no device activity).  A profile holding fewer than
    95 % of the events of the port's kernels that the call launched has
    lost events (on the H100 a profile has missed one in 48, once four in
    five, and late in a long run one of two, three times running).  The
    profiler keeps a device event only where its time, converted to the
    host's clock, falls inside the profile's window, so the call is
    profiled again inside a wider window: ``pads`` seconds of idle before
    and after it, which add no event to the sum.  After ``len(pads)``
    such profiles this raises."""
    from torch.profiler import ProfilerActivity, profile
    for pad in pads:
        before = sum(kernels.launch_counts().values())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            out = fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        launched = sum(kernels.launch_counts().values()) - before
        events = prof.key_averages()
        seen = sum(e.count for e in events if _PORT_KERNEL.search(e.key))
        if seen >= 0.95 * launched:
            us = sum(e.self_device_time_total for e in events)
            return out, (us / 1e3 if us > 0 else None)
        del out
    raise RuntimeError(f"{len(pads)} profiles saw {seen} events of the "
                       f"port's kernels for {launched} launches: events lost")


def run_step(cfg: ModelConfig, shape: InputShape, *, rows: int,
             device: DeviceLike = None, seed: int = 0) -> Dict[str, Any]:
    """One warm-up and one measured step of ``shape.mode`` at its
    ``seq_len`` on ``rows`` rows of seeded inputs, on ``cfg``'s seeded
    random weights."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    step_shape = dataclasses.replace(shape, global_batch=rows)
    params = M.init_params(cfg, seed=seed, device=dev)
    data = S.materialize(cfg, S.input_specs(cfg, step_shape), rows=rows,
                         seed=seed + 1, device=dev)
    if shape.mode == "train":
        state = {"opt": adamw_init(params)}
        step = S.make_train_step(cfg)

        def call():
            p, state["opt"], loss = step(params, state["opt"], data["batch"])
            return loss
    elif shape.mode == "prefill":
        step = S.make_prefill_step(cfg)

        def call():
            return step(params, data["batch"])
    else:
        step = S.make_serve_step(cfg)

        def call():
            return step(params, data["token"], data["caches"])[0]
    out = call()                                       # warm-up
    del out
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cuda:
        out, dev_ms = _device_ms(call)
    else:
        out, dev_ms = call(), None
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    # in slices: a bool copy of gemma2's 33.5 GB of logits would not fit
    finite = all(bool(torch.isfinite(part).all())
                 for part in out.reshape(-1).split(1 << 28))
    flops = C.step_flops(cfg, step_shape, 1)
    result = {"device": (torch.cuda.get_device_name(dev) if cuda
                         else str(dev)),
              "seq_len": shape.seq_len, "rows": rows,
              "num_layers": cfg.num_layers, "num_params": S.num_params(
                  params),
              "output_shape": list(out.shape), "finite": finite,
              "wall_ms": wall_ms, "device_ms": dev_ms, "peak_gib": peak,
              "flops": flops,
              "tflops": (flops / dev_ms / 1e9 if dev_ms else None)}
    if shape.mode == "decode":
        result["pos"] = S._cache_capacity(data["caches"]) - 1
    del params, data, out
    return result


def run_one(arch: str, shape_name: str, *, device: DeviceLike = None,
            num_layers: Optional[int] = None, rows: Optional[int] = None,
            run: bool = True, reduced: bool = False,
            verbose: bool = True, mesh: str = "1") -> Dict[str, Any]:
    """The plan of (arch, shape) and, with ``run``, its step once on
    ``device`` (the card by default) at ``num_layers`` layers and ``rows``
    rows (default: the config's depth and the shape's batch), each cut
    listed under ``reduced``."""
    if run and mesh != "1":
        raise ValueError(f"a run takes one card: the {mesh} mesh is a plan")
    row = plan(arch, shape_name, reduced=reduced, mesh=mesh)
    if row["status"] != "ok" or not run:
        if verbose:
            print_row(row)
        return row
    shape = INPUT_SHAPES[shape_name]
    cfg = S.resolved_config(_config(arch, reduced), shape)
    cuts = {}
    if num_layers is not None and num_layers != cfg.num_layers:
        cuts["num_layers"] = [num_layers, cfg.num_layers]
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    rows = shape.global_batch if rows is None else rows
    if rows != shape.global_batch:
        cuts["rows"] = [rows, shape.global_batch]
    row["run"] = run_step(cfg, shape, rows=rows, device=device)
    row["reduced"] = cuts
    if verbose:
        print_row(row)
    return row


def print_row(row: Dict[str, Any]) -> None:
    tag = f"[{row['arch']} x {row['shape']} x {row['mesh']}]"
    if row["status"] != "ok":
        print(f"{tag} {row['status'].upper()}: {row.get('reason', '')}"
              f"{row.get('error', '')}")
        return
    t = row["roofline"]
    line = (f"{tag} OK flops/dev={row['hlo_flops_per_device']:.3e} "
            f"hbm/dev={row['hlo_hbm_bytes_per_device']:.3e}B "
            f"temp={row['memory_analysis']['temp_size_in_bytes'] / 1e9:.1f}GB "
            f"mb={row['microbatches']} bottleneck={t['bottleneck']}")
    r = row.get("run")
    if r:
        dev_ms = (f"{r['device_ms']:.2f}" if r["device_ms"] is not None
                  else "n/a")
        line += (f" | run: {r['rows']} rows x {r['seq_len']} at "
                 f"{r['num_layers']} layers, wall {r['wall_ms']:.1f} ms, "
                 f"device {dev_ms} ms")
        if r["tflops"]:
            line += f", {r['tflops']:.1f} TFLOP/s"
        if r["peak_gib"] is not None:
            line += f", peak {r['peak_gib']:.2f} GiB"
        if row["reduced"]:
            line += f", cuts {row['reduced']}"
    print(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Plan every (arch, input shape) step on the host; with "
                    "--run, also run each step once on --device.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="1", choices=MESHES,
                    help="plan on one H100 (1) or per device of a "
                         "production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 (pod, data, model) mesh: --mesh "
                         "2x16x16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--run", action="store_true",
                    help="run each planned step once (default: plan only)")
    ap.add_argument("--device", default=None,
                    help="the device --run uses (default: the card, cuda:0; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut each run to this many layers")
    ap.add_argument("--rows", type=int, default=None,
                    help="cut each run to this many rows")
    ap.add_argument("--reduced", action="store_true",
                    help="plan (and run) each arch's reduced() config")
    args = ap.parse_args(argv)
    mesh = "2x16x16" if args.multi_pod else args.mesh
    if args.run and mesh != "1":
        ap.error(f"--run takes one card: the {mesh} mesh is a plan")
    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    results = []
    for arch, shape in combos:
        try:
            results.append(run_one(arch, shape, device=args.device,
                                   num_layers=args.num_layers,
                                   rows=args.rows, run=args.run,
                                   reduced=args.reduced, mesh=mesh))
        except Exception as e:  # noqa: BLE001 -- a failed pair is a row
            print(f"[{arch} x {shape}] FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
            results.append({"arch": arch, "shape": shape, "status": "failed",
                            "error": f"{type(e).__name__}: {str(e)[:500]}"})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    bad = [r for r in results if r["status"] == "failed"]
    print(f"dry-run: {len(results)} combos, "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{len(bad)} failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
