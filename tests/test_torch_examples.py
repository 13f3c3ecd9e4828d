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
                             REF_DIR, run_example)

ANALYTIC = [s for s in EXAMPLES if s not in MODEL_EXAMPLES]


def test_every_reference_example_but_training_is_ported():
    want = sorted(p.stem for p in REF_DIR.glob("*.py")
                  if p.stem != "train_small")    # training: ROADMAP A2
    assert EXAMPLES == want


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_main_runs_warning_free(stem, tmp_path, monkeypatch,
                                        capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu"] if stem in MODEL_EXAMPLES else []
    with warnings.catch_warnings():
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
