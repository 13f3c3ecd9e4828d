"""The port's examples that run a model (quickstart, quantization_study,
serve_batched, with ``--device cpu``) print the analytic lines of the
reference's examples of the same name, shrunk alike. The lines left out
are those of the model itself (its random weights come from torch, not
jax.random: generated token ids and logit drift), serve_batched's host
wall time, the device each names, and quantization_study's
fused-dequant rows, which the reference prices for a TPU and the port
for the H100 (the port's registry holds the H100 only)."""
import pytest

pytest.importorskip("torch")

from _torch_examples import (MODEL_EXAMPLES, PORT_DIR, REF_DIR,  # noqa: E402
                             run_example)


def _analytic_lines(stem: str, out: str) -> list:
    lines = out.splitlines()
    if stem == "quickstart":           # the full config's phase profile
        return [ln for ln in lines if "prefill=" in ln]
    if stem == "quantization_study":   # the H100 eager decode rows
        return [ln for ln in lines if "H100 eager" in ln]
    # serve_batched: the modeled metrics of both runs
    return [ln for ln in lines
            if ln.startswith(("modeled serving", "sequential baseline"))]


@pytest.mark.parametrize("stem", MODEL_EXAMPLES)
def test_model_example_prints_the_reference_analytic_lines(
        stem, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    got = _analytic_lines(stem, run_example(
        PORT_DIR, stem, "torch", ["--device", "cpu"], monkeypatch, capsys))
    want = _analytic_lines(stem, run_example(
        REF_DIR, stem, "jax", [], monkeypatch, capsys))
    assert got and got == want
