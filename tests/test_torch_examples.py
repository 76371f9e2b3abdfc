"""The port's example scripts (examples/*_torch.py) run on the CPU in a
subprocess, as a user runs them: the serving demo over 2 gloo ranks at a
tiny size, the class-aware demo at its own size, whose metric lines must
be those that the JAX package's examples/class_aware_mot.py prints when
it runs beside it; without --device cpu and without a card, each refuses
to start."""

import os
import subprocess
import sys

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def start(script, *args, **env):
    """The example in a subprocess with one intra-op thread (torch reads
    OMP_NUM_THREADS at start): the suite's workers share the host's cores,
    and oversubscribed OpenMP threads slow every process on it."""
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               OMP_NUM_THREADS="1", **env)
    return subprocess.Popen(
        [sys.executable, os.path.join(_REPO, "examples", script), *args],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(p, timeout=300) -> subprocess.CompletedProcess:
    out, err = p.communicate(timeout=timeout)
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def run(script, *args, timeout=300):
    return finish(start(script, *args), timeout)


def test_multi_stream_serve_example_on_two_ranks():
    p = run("multi_stream_serve_torch.py", "--device", "cpu", "--world", "2",
            "--streams", "4", "--frames", "6")
    assert p.returncode == 0, p.stdout + p.stderr
    out = p.stdout
    for r, streams in ((0, "0-1"), (1, "2-3")):
        tag = f"[rank {r}/2, cpu, streams {streams}]"
        assert f"{tag} backend gloo" in out
        assert f"{tag} frame 6: alive per stream" in out
        assert f"{tag} shared-detector step ok" in out
        assert f"{tag} scheduler-fed serving ok" in out
    assert out.rstrip().endswith("done")


def test_class_aware_example_prints_the_jax_examples_metrics():
    """Both demos run at once on the CPU (the JAX one on JAX's CPU
    platform): class-blind, the class gate, the gate with
    assoc_box="best", one metric line each, equal but for the port's
    device tag."""
    jax_run = start("class_aware_mot.py", JAX_PLATFORMS="cpu")
    p = run("class_aware_mot_torch.py", "--device", "cpu")
    want = finish(jax_run)
    assert want.returncode == 0, want.stdout + want.stderr
    assert p.returncode == 0, p.stdout + p.stderr
    lines = [ln.rsplit("  (cpu)", 1)[0] for ln in p.stdout.splitlines()]
    assert len(lines) == 3
    assert lines == want.stdout.splitlines()


@pytest.mark.parametrize("script", ["multi_stream_serve_torch.py",
                                    "class_aware_mot_torch.py"])
def test_examples_default_to_the_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = run(script, timeout=120)
    assert p.returncode != 0
    assert "no CUDA card" in p.stderr
