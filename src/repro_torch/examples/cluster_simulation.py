"""Reproduce the paper's Table 1 / 2 / 3 (reduced scale by default).

Run:  PYTHONPATH=src python -m repro_torch.examples.cluster_simulation
          [--jobs 8192] [--workloads 2] [--full]
          [--engine reference|torch] [--device cpu]

By default the job sets run through the PyTorch engine on ``--device``
(the current CUDA device; it raises without one): its fused schedule
pass is the CUDA kernel on the card. ``--engine reference`` runs the
host numpy engine, as the JAX example does, and takes no ``--device``.
The torch engine keeps each job's last preemption-to-resume interval,
as the JAX engine's summary does, where the reference engine records
every interval (Table 2); RAND draws from another generator on each
engine.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import api
from repro_torch import device as _device
from repro_torch.configs.cluster import SimConfig, WorkloadSpec
from repro_torch.core import metrics, workload

POLICIES = ("fifo", "lrtp", "rand", "fitgpp")


def _torch_pool(r) -> dict:
    """A torch run's per-job arrays in ``metrics.merge_results``'s
    form; its intervals are each job's last one."""
    jobs, st = r.raw.jobs, r.raw.state
    finish, submit, exec_total = (x.cpu().numpy() for x in (
        st.finish, jobs.submit, jobs.exec_total))
    last_resume = st.last_resume.cpu().numpy()
    signal = st.last_signal.cpu().numpy()
    return {"slowdown": 1.0 + (finish - submit - exec_total) / exec_total,
            "is_te": jobs.is_te.cpu().numpy(),
            "preempt_count": st.preempt_count.cpu().numpy(),
            "intervals": (last_resume - signal)[last_resume >= 0]
            .astype(np.float64)}


def pooled(cfg: SimConfig, jobsets, engine: str, device=None) -> dict:
    """policy -> ``metrics.pooled_tables`` over the job sets' runs."""
    out = {}
    for pol in POLICIES:
        pcfg = dataclasses.replace(cfg, policy=pol)
        if engine == "reference":
            results = [api.run_experiment(cfg=pcfg, jobs=js,
                                          engine="reference").raw
                       for js in jobsets]
            pool = metrics.merge_results(results)
        else:
            pools = [_torch_pool(api.run_experiment(
                cfg=pcfg, jobs=js, engine="torch", device=device))
                for js in jobsets]
            pool = {k: np.concatenate([p[k] for p in pools])
                    for k in pools[0]}
        out[pol] = metrics.pooled_tables(pool)
    return out


def report(pooled_by_policy: dict, n: int, n_workloads: int) -> str:
    rows = {pol: {"TE": p["TE"], "BE": p["BE"]}
            for pol, p in pooled_by_policy.items()}
    lines = [metrics.format_table(rows, f"Table 1 — slowdown percentiles "
                                        f"({n} jobs x {n_workloads})"),
             "", "Table 2 — preemption->reschedule intervals [min]"]
    for pol in ("lrtp", "rand", "fitgpp"):
        iv = pooled_by_policy[pol]["intervals"]
        lines.append(f"  {pol:8s} p50={iv['p50']:.1f} p75={iv['p75']:.1f} "
                     f"p95={iv['p95']:.1f} p99={iv['p99']:.1f}")
    lines += ["", "Table 3 — proportion of preempted jobs (P=1)"]
    for pol in ("lrtp", "rand", "fitgpp"):
        lines.append(f"  {pol:8s} "
                     f"{pooled_by_policy[pol]['preempted_frac'] * 100:6.2f}%")
    drop = 1 - rows["fitgpp"]["TE"]["p95"] / rows["fifo"]["TE"]["p95"]
    lines += ["", f"fifo -> fitgpp TE p95 drop: {drop * 100:.2f}%",
              "paper claims: FitGpp cuts TE p95 by 96.6% vs FIFO, halves "
              "the",
              "re-scheduling intervals, and preempts ~15x fewer jobs than "
              "LRTP."]
    return "\n".join(lines)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", type=int, default=4096)
    ap.add_argument("--full", action="store_true",
                    help="paper scale: 2^16 jobs")
    ap.add_argument("--workloads", type=int, default=2)
    ap.add_argument("--engine", default="torch", choices=api.ENGINES)
    ap.add_argument("--device", default=None,
                    help="the torch engine's device (default: the current "
                         "CUDA device)")
    args = ap.parse_args(argv)
    if args.engine == "reference" and args.device is not None:
        ap.error("--engine reference runs on the host; it takes no "
                 "--device")
    device = _device.resolve(args.device) if args.engine == "torch" \
        else None
    n = 2 ** 16 if args.full else args.jobs

    cfg = SimConfig(workload=WorkloadSpec(n_jobs=n), s=4.0,
                    max_preemptions=1)
    jobsets = [workload.generate(cfg, seed=1000 * i)
               for i in range(args.workloads)]
    text = report(pooled(cfg, jobsets, args.engine, device), n,
                  args.workloads)
    print(text)
    return text


if __name__ == "__main__":
    main()
