"""The port's seven examples (``repro_torch.examples``) on the CPU, each
at its smallest size: the tables of ``cluster_simulation`` and
``trace_replay`` against the JAX package's ``simulator``, ``metrics``,
``scenarios`` and ``obs`` on the same inputs, bit for bit;
``distributed_sweep``'s grid against ``repro.core.sweep`` (exact on
draw-free trials, as ``test_torch_sweep.py`` holds it); the training
examples make progress. Without ``--device`` every example refuses to
run where there is no card."""
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.configs.cluster import ClusterSpec as JClusterSpec
from repro.configs.cluster import SimConfig as JSimConfig
from repro.configs.cluster import WorkloadSpec as JWorkloadSpec
from repro.core import metrics as jmetrics
from repro.core import simulator as jsimulator
from repro.core import sweep as jsweep
from repro.core import workload as jworkload
from repro.obs import timeseries as jtimeseries
from repro_torch.examples import (cluster_simulation, distributed_sweep,
                                  preemptible_training, quickstart,
                                  stream_replay, trace_replay, train_100m)
from repro_torch.obs import export
from torch_threads import one_thread  # noqa: F401

CPU = ["--device", "cpu"]

EXAMPLES = ("cluster_simulation", "trace_replay", "stream_replay",
            "distributed_sweep", "quickstart", "preemptible_training",
            "train_100m")


def _jax_pooled(n_jobs, n_workloads):
    cfg = JSimConfig(workload=JWorkloadSpec(n_jobs=n_jobs), s=4.0,
                     max_preemptions=1)
    jobsets = [jworkload.generate(cfg, seed=1000 * i)
               for i in range(n_workloads)]
    return {pol: jmetrics.pooled_tables(jmetrics.merge_results(
        [jsimulator.simulate(dataclasses.replace(cfg, policy=pol), js)
         for js in jobsets])) for pol in cluster_simulation.POLICIES}


def test_cluster_simulation_tables_equal_jax():
    """Tables 1–3 of ``--engine reference`` at 1,024 jobs x 2 workloads:
    the pooled numbers and the printed text are the JAX package's."""
    text = cluster_simulation.main(["--jobs", "1024", "--workloads", "2",
                                    "--engine", "reference"])
    want = _jax_pooled(1024, 2)
    assert text == cluster_simulation.report(want, 1024, 2)
    assert "Table 3" in text and "fifo -> fitgpp TE p95 drop" in text
    assert want["lrtp"]["preempted_frac"] > 0


def test_cluster_simulation_torch_engine_on_cpu(monkeypatch):
    """The default torch engine: the text reports its runs; on a
    contended 8-node cluster (256 jobs, lrtp preempts) the draw-free
    policies' slowdown tables and preempted fractions equal the
    reference engine's on the same job set (their schedules are equal
    job for job)."""
    from repro_torch.configs.cluster import (ClusterSpec, SimConfig,
                                             WorkloadSpec)
    from repro_torch.core import workload
    seen, pooled = [], cluster_simulation.pooled

    def spy(*a, **k):
        seen.append(pooled(*a, **k))
        return seen[-1]

    monkeypatch.setattr(cluster_simulation, "pooled", spy)
    text = cluster_simulation.main(["--jobs", "128", "--workloads", "1"]
                                   + CPU)
    assert text == cluster_simulation.report(seen[0], 128, 1)
    cfg = SimConfig(cluster=ClusterSpec(n_nodes=8),
                    workload=WorkloadSpec(n_jobs=256), s=4.0,
                    max_preemptions=1)
    js = [workload.generate(cfg, seed=0)]
    got = pooled(cfg, js, "torch", "cpu")
    ref = pooled(cfg, js, "reference")
    assert ref["lrtp"]["preempted_frac"] > 0
    for pol in ("fifo", "lrtp"):
        for k in ("TE", "BE", "preempted_frac"):
            assert got[pol][k] == ref[pol][k], (pol, k)
    with pytest.raises(SystemExit):
        cluster_simulation.main(["--engine", "reference", "--device", "cpu"])


def test_trace_replay_tables_equal_jax():
    """Both fixtures through every policy: each slowdown table of
    ``replay(..., engine="reference")`` is the JAX package's bit for bit,
    the torch engine's (``main``, float32 slowdowns) to float32 rounding
    where no draw decides, and the printed fitgpp run's time series and
    decomposition are JAX's."""
    from repro_torch import scenarios
    from repro_torch.configs.cluster import ClusterSpec, SimConfig
    text = trace_replay.main(CPU)
    jcfg = JSimConfig(cluster=JClusterSpec(n_nodes=8), seed=0)
    tcfg = SimConfig(cluster=ClusterSpec(n_nodes=8), seed=0)
    for jload, tload, path in (
            (jscenarios.load_philly_csv, scenarios.load_philly_csv,
             jscenarios.traces.PHILLY_SAMPLE),
            (jscenarios.load_pai_csv, scenarios.load_pai_csv,
             jscenarios.traces.PAI_SAMPLE)):
        js = jload(path, jcfg, time_scale=1.0)
        _, rows = trace_replay.replay("x", tload, path, tcfg, 1.0,
                                      engine="reference")
        _, trows = trace_replay.replay("x", tload, path, tcfg, 1.0,
                                       device="cpu")
        for pol in trace_replay.POLICIES:
            res = jsimulator.simulate(dataclasses.replace(jcfg, policy=pol),
                                      js, trace=True)
            want = jmetrics.slowdown_table(res)
            assert rows[pol] == want, pol
            if pol != "rand":
                for cls in ("TE", "BE"):
                    for q, v in want[cls].items():
                        assert trows[pol][cls][q] == pytest.approx(
                            v, rel=1e-6), (pol, cls, q)
        ts = jtimeseries.compute_timeseries(
            res.trace, n_nodes=8, is_te=js.is_te)
        assert jtimeseries.format_timeseries(ts, max_rows=12) in text
        dec = jtimeseries.slowdown_decomposition(res.trace)
        wait = sum(d.initial_wait for d in dec.values())
        assert f"initial wait  {int(wait):7d} min" in text


def test_trace_replay_torch_engine_writes_its_trace(tmp_path):
    """The torch engine traces the fitgpp run through the ring; the CSV
    it writes reads back as that run's events."""
    from repro_torch import api, scenarios
    from repro_torch.configs.cluster import ClusterSpec, SimConfig
    out = tmp_path / "pai.csv"
    text = trace_replay.main(CPU + ["--trace", str(out),
                                    "--trace-format", "csv"])
    cfg = SimConfig(cluster=ClusterSpec(n_nodes=8), seed=0,
                    policy="fitgpp")
    js = scenarios.load_pai_csv(scenarios.traces.PAI_SAMPLE, cfg)
    r = api.run_experiment(cfg=cfg, jobs=js, trace=True, device="cpu")
    assert export.read_csv(out.read_text()) == r.events
    assert f"{len(r.events)} events -> {out} [csv]" in text


def test_stream_replay_parity_and_incremental_trace(tmp_path):
    out = tmp_path / "stream.csv"
    text = stream_replay.main(
        ["--n-jobs", "600", "--chunk", "128", "--capacity", "160",
         "--parity", "--trace", str(out)] + CPU, parity_jobs=200)
    assert "parity window ok: 200-job" in text
    assert "600 jobs through 160 slots" in text
    n = int(text.split(" events -> ")[0].split()[-1])
    assert len(export.read_csv(out.read_text())) == n > 0
    assert "peak device none (CPU run)" in text


def test_distributed_sweep_equals_jax():
    """A 2 x 2 grid at 512 jobs (fitgpp preempts there, no draw
    decides): every array of the grid equals the JAX
    ``sensitivity_grid``'s; the printed line names the devices."""
    s_vals, seeds = (0.0, 4.0), (0, 1)
    got, n_dev = distributed_sweep.grid(512, s_vals, seeds, device="cpu")
    cfg = JSimConfig(workload=JWorkloadSpec(n_jobs=512, gp_scale=2.0),
                     policy="fitgpp", max_preemptions=1)
    want = jsweep.sensitivity_grid(cfg, 512, s_vals, seeds, devices=1)
    assert n_dev == 1 and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    assert np.asarray(want["preempted_frac"]).max() > 0
    with pytest.warns(RuntimeWarning):       # no interval at s = 0
        text = distributed_sweep.main(CPU, n_jobs=64, s_vals=(0.0,),
                                      seeds=(0,))
    assert "(1 trials on 1/" in text


def test_quickstart_small():
    text = quickstart.main(CPU, n_jobs=256, train_steps=2, be_steps=6)
    assert "TE p95 slowdown cut by" in text
    assert "step 0: loss" in text
    assert "-> BE job preempted 1x" in text and "done     debug-te" in text


def test_preemptible_training_small():
    text = preemptible_training.main(CPU, be_steps=6, te_steps=1)
    assert text.count(" done ") == 4 and "preempt  be-mamba" in text
    for name in ("te-debug-1", "te-debug-2"):
        line = next(x for x in text.splitlines()
                    if x.strip().startswith(name))
        assert "slowdown=1.00" in line


def test_train_100m_reduced_width_makes_progress():
    text = train_100m.main(
        ["--steps", "20", "--batch", "2", "--seq-len", "32"] + CPU,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)
    first, last = (float(x) for x in
                   text.splitlines()[-1].split()[1:4:2])
    assert last < first and "over 20 steps" in text


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_run_on_the_card_by_default(monkeypatch, name):
    """Without CUDA and without flags an example raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_importing_the_examples_runs_nothing():
    code = ("import importlib, sys\n"
            "for n in sys.argv[1:]:\n"
            "    importlib.import_module('repro_torch.examples.' + n)\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code, *EXAMPLES],
                         capture_output=True, text=True, timeout=120,
                         cwd=root, env={"PYTHONPATH": str(root / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout == "" and out.stderr == ""
