"""The port's sanitizer CLI (``python -m repro_torch.analysis``) against the
JAX package's: mirrors of `test_cli_exit_codes` and `test_cli_list_rules`
(tests/test_analysis.py). Each package saves its own artifacts of the same
graph — clean, corrupted, waived, junk, a serving bundle — and both CLIs
must give the same exit codes and the same findings on them."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro
import repro.core.cnn as jcnn
import repro.hw as JH
import repro.serve as JS
import repro_torch
import repro_torch.core.cnn as tcnn
import repro_torch.hw as TH
import repro_torch.serve as TS
from repro.analysis.__main__ import main as jmain
from repro_torch.analysis.__main__ import main as tmain

ROOT = Path(__file__).resolve().parent.parent

SIDES = {
    "jax": (repro, jcnn, JH, JS, jmain, {}),
    "port": (repro_torch, tcnn, TH, TS, tmain, {"device": "cpu"}),
}


def _mutated_schedule(dep, *, compute):
    return dataclasses.replace(dep.schedule, dma=list(dep.schedule.dma),
                               compute=compute)


def _artifacts(side, tmp_path):
    pkg, cnn, hw, serve, _, dev = SIDES[side]
    d = tmp_path / side
    d.mkdir()
    dep = pkg.compile(cnn.small_cnn(), hw.PAPER_RISCV, backend="numpy",
                      num_cores=4, use_cache=False, **dev)
    good = str(d / "good.rtdep")
    dep.save(good)
    bad = dataclasses.replace(dep, schedule=_mutated_schedule(
        dep, compute=list(dep.schedule.compute)[:-1]))
    bad_path = str(d / "bad.rtdep")
    bad.save(bad_path, force=True)
    junk = d / "junk.rtdep"
    junk.write_bytes(b"not an artifact")
    srv = serve.Server(hw.scaled_paper_machine(4), backend="numpy",
                       num_cores=4, **dev)
    srv.register("cnn", cnn.small_cnn(), period_s=1 / 50, slots=2)
    bundle = srv.save(str(d / "bundle"))
    return {"good": good, "bad": bad_path, "junk": str(junk),
            "bundle": bundle}


def _lines(out, paths):
    """The CLI's report lines with the package-specific paths and the
    analysis times removed."""
    for p in paths:
        out = out.replace(p, "<path>")
    return re.sub(r" in [0-9.]+ ms", "", out)


@pytest.fixture
def artifacts(tmp_path):
    return {side: _artifacts(side, tmp_path) for side in SIDES}


def test_cli_exit_codes(artifacts, capsys):
    runs = {}
    for side, arts in artifacts.items():
        main = SIDES[side][4]
        got = []
        for argv in ([arts["good"]], [arts["bad"]],
                     [arts["bad"], "--suppress", "SCHED003"],
                     [arts["junk"]], [arts["bundle"]],
                     [arts["good"], "--strict"]):
            rc = main(argv)
            cap = capsys.readouterr()
            got.append((rc, _lines(cap.out, arts.values()),
                        bool(cap.err.strip())))
        runs[side] = got
    assert runs["port"] == runs["jax"]
    (good, bad, waived, junk, bundle, strict) = runs["port"]
    assert good[0] == 0 and "0 diagnostics" in good[1]
    assert bad[0] == 1 and "SCHED003" in bad[1]
    assert waived[0] == 0               # waived on the command line
    assert junk[0] == 2 and junk[2]     # "error:" on stderr
    assert bundle[0] == 0 and strict[0] == 0


def test_cli_runs_as_a_module(artifacts):
    """``python -m repro_torch.analysis`` in a fresh process, without a GPU:
    linting loads artifacts for the host and runs nothing."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    arts = artifacts["port"]
    res = [subprocess.run([sys.executable, "-m", "repro_torch.analysis", p],
                          env=env, capture_output=True, text=True,
                          timeout=120)
           for p in (arts["good"], arts["bad"])]
    assert [r.returncode for r in res] == [0, 1], [r.stderr for r in res]
    assert "0 diagnostics" in res[0].stdout and "SCHED003" in res[1].stdout


def test_cli_list_rules(capsys):
    assert tmain(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("RACE001", "SPM002", "WCET003", "ANL001"):
        assert rid in out
    assert jmain(["--list-rules"]) == 0
    assert capsys.readouterr().out == out


def test_cli_cluster_artifact_waits_for_the_cluster_port(tmp_path):
    """A directory with a cluster manifest is recognised as the JAX
    package recognises it; linting it raises, naming its ROADMAP item
    (the CLI does not catch it)."""
    from repro_torch.analysis.runner import is_cluster_artifact
    assert not is_cluster_artifact(str(tmp_path))
    (tmp_path / "cluster.json").write_text("{}")
    assert is_cluster_artifact(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 13"):
        tmain([str(tmp_path)])
