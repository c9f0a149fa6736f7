"""The port's scenarios CLI (``python -m repro_torch.scenarios``)
against the JAX package's (``python -m repro.scenarios``), on the CPU.

``list`` and ``describe`` print the same registry; ``run`` prints the
same table on the reference engine, and on the torch engine the JAX
engine's (the header names the engine); ``sweep --device cpu`` prints
the JAX sweep's table. The compared runs use lrtp, which draws nothing,
so the two engines take the same decisions. ``run --trace`` writes the
stream through the port's ``obs.export``, equal to the JAX CLI's CSV;
``run --stream`` prints the JAX CLI's streamed table, and ``describe``
its one-pass stream statistics."""
import pytest
import torch

from repro.scenarios import __main__ as jcli
from repro_torch.obs import export
from repro_torch.scenarios import __main__ as tcli

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*shard_map.*:DeprecationWarning")

SMALL = ["--n-jobs", "96", "--nodes", "8", "--policy", "lrtp"]


def _out(capsys, main, argv) -> str:
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [["list"], ["list", "--kind", "trace"],
                                  ["describe", "burst-storm"],
                                  ["describe", "te-flood"]])
def test_registry_commands_print_the_jax_tables(capsys, argv):
    assert _out(capsys, tcli.main, argv) == _out(capsys, jcli.main, argv)


def _knobs(text):
    return text[text.index("knobs:"):].split("\n\n")[0].rstrip() \
        if "knobs:" in text else ""


def test_describe_every_scenario(capsys):
    """Every scenario: the name, kind and summary line and the knobs
    table are the JAX CLI's (the port's longer docstrings speak of the
    port's engines)."""
    for name in tcli.scenarios.scenario_names():
        want = _out(capsys, jcli.main, ["describe", name])
        got = _out(capsys, tcli.main, ["describe", name])
        assert got.splitlines()[:2] == want.splitlines()[:2], name
        assert _knobs(got) == _knobs(want), name


def _stream_stats(text):
    return text[text.index("stream (one pass"):] \
        if "stream (one pass" in text else ""


def test_describe_without_stream_stats(capsys):
    """A scenario without a streaming source prints no stream
    statistics, as the JAX CLI does; one with a source prints the JAX
    CLI's one-pass statistics (drop counts included)."""
    got = _out(capsys, tcli.main, ["describe", "burst-storm"])
    assert _stream_stats(got) == "" == _stream_stats(
        _out(capsys, jcli.main, ["describe", "burst-storm"]))
    for argv in (["describe", "philly-sample"],
                 ["describe", "stream-closed-loop", "--n-jobs", "300"]):
        want = _stream_stats(_out(capsys, jcli.main, argv))
        assert want and _stream_stats(_out(capsys, tcli.main, argv)) \
            == want


def test_run_reference_engine(capsys):
    argv = ["run", "burst-storm", "--engine", "reference"] + SMALL
    want = _out(capsys, jcli.main, argv)
    assert _out(capsys, tcli.main, argv) == want
    assert "slowdown percentiles" in want
    # the reference engine runs on the host: a device is refused
    with pytest.raises(SystemExit):
        tcli.main(argv + ["--device", "cpu"])


def test_run_torch_engine_prints_the_jax_engine_table(capsys, tmp_path):
    """``run --engine torch --device cpu`` against ``--engine jax``:
    the same table and counters, and the same trace as CSV."""
    jpath, tpath = tmp_path / "jax.csv", tmp_path / "torch.csv"
    trace = ["--trace-format", "csv", "--trace"]
    want = _out(capsys, jcli.main, ["run", "burst-storm", "--engine",
                                    "jax"] + SMALL + trace + [str(jpath)])
    got = _out(capsys, tcli.main, ["run", "burst-storm", "--engine", "torch",
                                   "--device", "cpu"] + SMALL + trace
               + [str(tpath)])
    assert got.replace("engine=torch", "engine=jax").replace(
        str(tpath), str(jpath)) == want
    assert "fallback_count=" in got and "events ->" in got
    events = export.read_csv(tpath.read_text())
    assert events and tpath.read_text() == jpath.read_text()


@pytest.mark.parametrize("argv", [["run", "burst-storm"],
                                  ["sweep", "burst-storm", "--seeds", "0"]])
def test_default_device_is_the_card(monkeypatch, argv):
    """``run`` takes the torch engine and, like ``sweep``, the current
    CUDA device unless told otherwise: without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv + SMALL)


def test_run_stream_raises():
    """The stream engine runs on the torch engine: ``--stream`` with
    ``--engine reference`` is refused."""
    with pytest.raises(SystemExit):
        tcli.main(["run", "burst-storm", "--stream", "--engine",
                   "reference"])


@pytest.mark.parametrize("extra", [[], ["--closed-loop", "--capacity",
                                        "160", "--mode", "tick"]])
def test_run_stream_prints_the_jax_table(capsys, tmp_path, extra):
    """``run --stream --device cpu`` against the JAX CLI's ``run
    --stream``: the same header, table and counters, and the same
    remapped trace as CSV."""
    jpath, tpath = tmp_path / "jax.csv", tmp_path / "torch.csv"
    argv = ["run", "philly-tiled", "--stream"] + SMALL + extra \
        + ["--trace-format", "csv", "--trace"]
    want = _out(capsys, jcli.main, argv + [str(jpath)])
    got = _out(capsys, tcli.main, argv + [str(tpath), "--device", "cpu"])
    assert got.replace(str(tpath), str(jpath)) == want
    assert "engine=stream" in got and "events ->" in got
    assert tpath.read_text() == jpath.read_text()


@pytest.mark.parametrize("mode", ["event", "tick"])
def test_sweep_prints_the_jax_table(capsys, mode):
    argv = ["sweep", "te-flood", "burst-storm", "gang-heavy", "--seeds",
            "0,1", "--mode", mode] + SMALL
    want = _out(capsys, jcli.main, argv)
    got = _out(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want
    assert "ragged sweep: 3 scenarios x 2 seeds" in got
