"""The port's live preemption controller against the JAX package's, on
the CPU at smoke size.

Both controllers drive real train jobs on their package's
``SchedulerCore``: the dense smoke config, and the JAX suite's
preempt/resume case on its own config, internvl2-2b's smoke (vlm: its
batches carry patch embeddings beside the tokens); the JAX suite's two
cases that train the mamba2 smoke config run on the port as they are.
Their event logs (without the checkpoint paths), preemption counts,
finish times and slowdowns must be equal: the grace periods estimated
from the live train state agree because the two states count the same
bytes. The losses are not compared across the packages (each draws its
own initial parameters); the port's are finite, and be0's across its
preemption equal its uninterrupted run's bit for bit. Also the port's
versions of the JAX suite's three ``TestController`` cases and of its
check that the controller owns no queue logic."""
import inspect

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import trainer as jtrainer
from repro.core import controller as jcontroller
from repro_torch import configs as tconfigs
from repro_torch import trainer as ttrainer
from repro_torch.core import controller as tcontroller
from repro_torch.data import make_batch
from torch_threads import one_thread  # noqa: F401

ARCH = "stablelm-12b"


def drop_ckpt(events):
    return [{k: v for k, v in e.items() if k != "ckpt"} for e in events]


def be_te_case(mod, cfg, **ctl):
    """The JAX suite's preempt/resume case: one node, BE be0 for 16
    steps, TE te0 for 2 steps submitted at tick 2."""
    c = mod.Controller(n_nodes=1, node_cap=(32., 256., 8.),
                       steps_per_tick=2, **ctl)
    be = c.submit(mod.JobSpec("be0", cfg, False, np.array([8., 32., 8.]),
                              total_steps=16))
    te = c.submit(mod.JobSpec("te0", cfg, True, np.array([4., 16., 8.]),
                              total_steps=2, submit_tick=2))
    c.run()
    return c, be, te


def fleet_case(mod, cfg, **ctl):
    """Like ``examples/preemptible_training.py``: 2 nodes, s = 4, two BE
    jobs with given grace periods (5 and 1 ticks), a TE at tick 1 and
    another, with an estimated grace period, at tick 6."""
    c = mod.Controller(n_nodes=2, node_cap=(32., 256., 8.), policy="fitgpp",
                       s=4.0, steps_per_tick=2, **ctl)
    jobs = [c.submit(mod.JobSpec("be_long_gp", cfg, False,
                                 np.array([8., 32., 8.]), total_steps=12,
                                 gp_ticks=5)),
            c.submit(mod.JobSpec("be_short_gp", cfg, False,
                                 np.array([8., 32., 8.]), total_steps=12,
                                 gp_ticks=1)),
            c.submit(mod.JobSpec("te", cfg, True, np.array([4., 16., 4.]),
                                 total_steps=2, submit_tick=1)),
            c.submit(mod.JobSpec("te2", cfg, True, np.array([4., 16., 8.]),
                                 total_steps=2, submit_tick=6))]
    c.run()
    return c, jobs


def outcome(c):
    return (drop_ckpt(c.events),
            [(j.spec.name, j.preempt_count, j.finish_time, j.steps_done,
              j.run_ticks, c.slowdown(j)) for j in c.jobs])


# the JAX suite's preempt/resume case trains this config
VLM_ARCH = "internvl2-2b"


@pytest.mark.parametrize("case", ["be_te", "fleet", "be_te_vlm"])
def test_controller_matches_jax(case, tmp_path):
    arch = VLM_ARCH if case == "be_te_vlm" else ARCH
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    run = fleet_case if case == "fleet" else be_te_case
    jc = run(jcontroller, jcfg, workdir=str(tmp_path / "jax"))[0]
    tc = run(tcontroller, tcfg, workdir=str(tmp_path / "port"),
             device="cpu")[0]
    assert outcome(tc) == outcome(jc)
    assert any(e["ev"] == "preempt" for e in tc.events)
    assert all(len(j.losses) == j.spec.total_steps for j in tc.jobs)
    assert all(np.isfinite(j.losses).all() for j in tc.jobs)
    # the vacated jobs flushed their state and were restored
    vacated = [e["job"] for e in tc.events if e["ev"] == "vacate"]
    assert vacated and all(
        len(j.flush_s) == vacated.count(j.spec.name) for j in tc.jobs)


def test_estimated_grace_period_matches_jax():
    """Both controllers size an estimated grace period from the live
    state's bytes; at a slow storage rate the estimate exceeds one tick
    and still agrees."""
    import dataclasses
    from repro.checkpoint import estimate_grace_period as jgrace
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro_torch.checkpoint import estimate_grace_period as tgrace
    opt = tcontroller.JobSpec("j", None, False, None, 1).opt
    st = ttrainer.init_train_state(tconfigs.get_smoke_config(ARCH), opt, 0,
                                   device="cpu")
    js = jtrainer.init_train_state(jconfigs.get_smoke_config(ARCH),
                                   JAdamWConfig(**dataclasses.asdict(opt)),
                                   jax.random.key(0))
    for bw in (2e9, 1e4):
        assert tgrace(st, storage_bw_bytes_per_s=bw) == \
            jgrace(js, storage_bw_bytes_per_s=bw)
    assert tgrace(st, storage_bw_bytes_per_s=1e4) > 1


# -- the JAX suite's TestController cases, on the port -----------------------

@pytest.mark.parametrize("arch", [ARCH, VLM_ARCH])
def test_preempt_resume_bit_exact(tmp_path, arch):
    cfg = tconfigs.get_smoke_config(arch)
    c, be, te = be_te_case(tcontroller, cfg, workdir=str(tmp_path),
                           device="cpu")
    # uninterrupted baseline from the same seed and data cursor
    st = ttrainer.init_train_state(cfg, be.spec.opt,
                                   tcontroller.job_seed("be0"), device="cpu")
    step = ttrainer.make_train_step(cfg, be.spec.opt)
    base = []
    for i in range(16):
        st, m = step(st, make_batch(cfg, 4, 32, seed=1, step=i,
                                    device="cpu"))
        base.append(float(m["loss"]))
    assert be.preempt_count == 1
    assert be.losses == base
    assert te.preempt_count == 0 and c.slowdown(te) == 1.0


def test_te_latency_beats_fifo(tmp_path):
    cfg = tconfigs.get_smoke_config(ARCH)

    def run(policy):
        c = tcontroller.Controller(n_nodes=1, node_cap=(32., 256., 8.),
                                   policy=policy, steps_per_tick=2,
                                   workdir=str(tmp_path / policy),
                                   device="cpu")
        c.submit(tcontroller.JobSpec("be0", cfg, False,
                                     np.array([8., 32., 8.]),
                                     total_steps=12))
        te = c.submit(tcontroller.JobSpec("te0", cfg, True,
                                          np.array([4., 16., 4.]),
                                          total_steps=2, submit_tick=1))
        c.run()
        return c.slowdown(te)

    assert run("fitgpp") < run("fifo")


def test_victim_selection_prefers_short_gp(tmp_path):
    cfg = tconfigs.get_smoke_config(ARCH)
    c, jobs = fleet_case(tcontroller, cfg, workdir=str(tmp_path),
                         device="cpu")
    long_gp, short_gp = jobs[:2]
    assert short_gp.preempt_count >= 1 and long_gp.preempt_count == 0
    first = next(e for e in c.events if e["ev"] == "preempt")
    assert first["job"] == "be_short_gp" and first["gp"] == 1


def test_te_latency_beats_fifo_on_the_ssm(tmp_path):
    """The JAX suite's case on mamba2's smoke config, be0 cut from its 30
    steps to 12 (6 ticks, still running when te0 arrives at tick 1)."""
    cfg = tconfigs.get_smoke_config("mamba2-1.3b")

    def run(policy):
        c = tcontroller.Controller(n_nodes=1, node_cap=(32., 256., 8.),
                                   policy=policy, steps_per_tick=2,
                                   workdir=str(tmp_path / policy),
                                   device="cpu")
        c.submit(tcontroller.JobSpec("be0", cfg, False,
                                     np.array([8., 32., 8.]),
                                     total_steps=12))
        te = c.submit(tcontroller.JobSpec("te0", cfg, True,
                                          np.array([4., 16., 4.]),
                                          total_steps=2, submit_tick=1))
        c.run()
        assert all(np.isfinite(j.losses).all() for j in c.jobs)
        return c.slowdown(te)

    assert run("fitgpp") < run("fifo")


def test_victim_selection_prefers_short_gp_on_the_ssm(tmp_path):
    """The JAX suite's case on mamba2's smoke config, its two BE jobs cut
    from 40 steps to 16: grace periods of 5 and 1 ticks on 2 nodes, s =
    4, a TE at tick 1: only the short-grace-period job is preempted."""
    cfg = tconfigs.get_smoke_config("mamba2-1.3b")
    c = tcontroller.Controller(n_nodes=2, node_cap=(32., 256., 8.),
                               policy="fitgpp", s=4.0,
                               workdir=str(tmp_path), device="cpu")
    b1 = c.submit(tcontroller.JobSpec("be_long_gp", cfg, False,
                                      np.array([8., 32., 8.]),
                                      total_steps=16, gp_ticks=5))
    b2 = c.submit(tcontroller.JobSpec("be_short_gp", cfg, False,
                                      np.array([8., 32., 8.]),
                                      total_steps=16, gp_ticks=1))
    c.submit(tcontroller.JobSpec("te", cfg, True, np.array([4., 16., 4.]),
                                 total_steps=2, submit_tick=1))
    c.run()
    assert b2.preempt_count == 1 and b1.preempt_count == 0


def test_controller_uses_shared_core():
    """The controller must not duplicate the queue / preemption
    machinery: its scheduling state is a ``SchedulerCore``."""
    src_attrs = dir(tcontroller.Controller)
    for dup in ("_first_fit", "_try_preempt", "_queued", "_signal",
                "_vacate", "_start"):
        assert dup not in src_attrs, \
            f"controller re-implements {dup}; use the engine core"
    assert "SchedulerCore" in inspect.getsource(tcontroller)


def test_job_seed_is_stable():
    """The port seeds a job from a digest of its name, the same in every
    process (JAX's ``hash`` changes with ``PYTHONHASHSEED``)."""
    assert tcontroller.job_seed("be0") == 172058898
    assert tcontroller.job_seed("be0") != tcontroller.job_seed("be1")


def test_vacated_state_is_freed_and_restored(tmp_path):
    cfg = tconfigs.get_smoke_config(ARCH)
    c, be, _ = be_te_case(tcontroller, cfg, workdir=str(tmp_path),
                          device="cpu")
    assert be.state is not None and be.ckpt_path.startswith(str(tmp_path))
    assert isinstance(be.state["params"], torch.nn.Module)
    assert int(be.state["opt"]["step"]) == 16
