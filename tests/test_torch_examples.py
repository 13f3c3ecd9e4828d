"""The port's examples (``examples/torch/``): each runs its main path on
the CPU without a warning, shrunk as tests/test_examples.py shrinks the
reference's (module-level ``BASE``/``SPEC`` request counts; the examples
that run a model take ``--device cpu``), and an example whose output is
analytic prints the reference example's standard output byte for byte,
but for replay_trace's spec hash: the spec names the fixture by its path
as written, and the port's example sits one directory deeper. (The
three examples that run a model are held against the reference's in
test_torch_examples_models.py.) The examples run in a temporary working
directory, so a sweep's cache never lands in the checkout."""
import re
import warnings

import pytest

pytest.importorskip("torch")

from _torch_examples import (EXAMPLES, MODEL_EXAMPLES, PORT_DIR,  # noqa: E402
                             REF_DIR, TRAIN_EXAMPLE, run_example)
from _torch_parity import two_threads  # noqa: E402

ANALYTIC = [s for s in EXAMPLES
            if s not in MODEL_EXAMPLES and s != TRAIN_EXAMPLE]
# the training example shrunk to a few steps on the CPU
TRAIN_ARGV = ["--device", "cpu", "--steps", "3"]


def test_every_reference_example_but_training_is_ported():
    """Every reference example has its port, training's too (since
    ROADMAP A2)."""
    want = sorted(p.stem for p in REF_DIR.glob("*.py"))
    assert EXAMPLES == want


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_main_runs_warning_free(stem, tmp_path, monkeypatch,
                                        capsys):
    monkeypatch.chdir(tmp_path)
    argv = (["--device", "cpu"] if stem in MODEL_EXAMPLES
            else TRAIN_ARGV if stem == TRAIN_EXAMPLE else [])
    with warnings.catch_warnings(), two_threads():
        warnings.simplefilter("error")
        out = run_example(PORT_DIR, stem, "torch", argv, monkeypatch,
                          capsys)
    assert out.strip()


@pytest.mark.parametrize("stem", ANALYTIC)
def test_analytic_example_prints_the_reference_output(stem, tmp_path,
                                                      monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    got = run_example(PORT_DIR, stem, "torch", [], monkeypatch, capsys)
    want = run_example(REF_DIR, stem, "jax", [], monkeypatch, capsys)
    if stem == "replay_trace":
        got, want = (re.sub(r"\[spec [0-9a-f]{12}\]", "[spec]", out)
                     for out in (got, want))
    assert got == want


def test_train_example_saves_a_reference_checkpoint(tmp_path, monkeypatch,
                                                    capsys):
    """The training example at 3 steps on the CPU logs the reference's
    lines (steps 0 and 2) and saves a checkpoint that the reference's
    ``load_checkpoint`` reads: params, AdamW moments and the step."""
    from repro.training.checkpoint import load_checkpoint
    monkeypatch.chdir(tmp_path)
    with two_threads():
        out = run_example(PORT_DIR, TRAIN_EXAMPLE, "torch",
                          TRAIN_ARGV + ["--out", "ck.npz"], monkeypatch,
                          capsys)
    steps = [ln.split()[1] for ln in out.splitlines()
             if ln.startswith("step ")]
    assert steps == ["0", "2"]
    assert "checkpoint saved to ck.npz" in out
    params, opt, step = load_checkpoint(str(tmp_path / "ck.npz"))
    assert step == 3 and int(opt["step"]) == 3
    assert sorted(opt["m"]) == sorted(params)
