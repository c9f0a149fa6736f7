"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``, and the port's
entry points refuse to fall back to the CPU on their own."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises


class _NoRepro(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port imported the JAX package: {name}")
        return None


sys.meta_path.insert(0, _NoRepro())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
assert not leaked, leaked
print(len(names))
"""

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s+as\b)"
    r"|from\s+repro(\.|\s+import\b))", re.MULTILINE)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_with_jax_and_repro_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_modules = len(list(pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")))
    assert int(out.stdout.strip()) == n_modules >= 15


def test_module_walk_covers_obs_and_reference_engine():
    """The blocked-import walk above reaches the event-schema package and
    the numpy reference engine's modules."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.obs", "repro_torch.obs.schema",
            "repro_torch.obs.ring", "repro_torch.obs.export",
            "repro_torch.obs.timeseries", "repro_torch.core.engine.core",
            "repro_torch.core.engine.queues",
            "repro_torch.core.engine.preemption",
            "repro_torch.core.engine.placement",
            "repro_torch.core.simulator", "repro_torch.core.metrics",
            "repro_torch.core.sim_torch"} <= names


def test_module_walk_covers_the_sweep_layer():
    """The blocked-import walk reaches the batched engine, the sweep
    fabric and its wrappers, the sweep's device choice and the
    scenarios CLI."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.core.sim_batch", "repro_torch.core.sweep_fabric",
            "repro_torch.core.sweep", "repro_torch.launch.mesh",
            "repro_torch.scenarios.__main__"} <= names


def test_module_walk_covers_the_stream_engine():
    """The blocked-import walk reaches the stream engine, its closed-loop
    admission and its sources."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.core.stream", "repro_torch.core.stream.engine",
            "repro_torch.core.stream.admission",
            "repro_torch.core.stream.source"} <= names


def test_module_walk_covers_the_training_slice():
    """The blocked-import walk reaches the optimizer, the trainer, the
    checkpoint, the train launcher and the live controller."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.trainer", "repro_torch.tree",
            "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
            "repro_torch.launch.train",
            "repro_torch.core.controller"} <= names


def test_source_scan_finds_no_jax_or_repro_import():
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in _sources()
                 for m in _FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


def test_scan_pattern_catches_what_it_should():
    bad = ("import jax\n", "import jax.numpy as jnp\n", "from jax import lax\n",
           "from repro.core import sim_jax\n", "import repro.api\n",
           "from repro import api\n", "    import repro\n")
    good = ("from repro_torch.core import sim_torch\n",
            "import repro_torch\n", "# the JAX package repro is the reference\n")
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in good)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import api
    from repro_torch.core import sim_torch, types
    import numpy as np
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run_experiment(n_jobs=8, n_nodes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.compare_policies(["fifo", "fitgpp"], n_jobs=8, n_nodes=2)
    js = types.JobSet(submit=np.zeros(1, np.int64),
                      exec_total=np.ones(1, np.int64),
                      demand=np.ones((1, 3)), is_te=np.zeros(1, bool),
                      gp=np.zeros(1, np.int64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim_torch.jobs_from_jobset(js)
    cfg = api.make_config("fitgpp", n_jobs=8, n_nodes=2)
    table = api.build_table([js, js], 4.0, 1, [0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run_table(cfg, table)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run_sweep(cfg, table.jobs, 4.0, 1, [0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.scenario_sweep(cfg, ["burst-storm"], [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.sensitivity_grid(cfg, 8, [4.0], [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.mesh_for_sweep(2)
    from repro_torch import configs, models
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "stablelm-12b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.init(configs.get_smoke_config("stablelm-12b"))
    from repro_torch import trainer
    from repro_torch.core import controller
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.init_train_state(configs.get_smoke_config("stablelm-12b"),
                                 AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "stablelm-12b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        controller.Controller()
