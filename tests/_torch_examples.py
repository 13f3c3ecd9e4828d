"""Running an example's main() in-process, for the port's example tests:
the port's ``examples/torch/`` and the reference's ``examples/`` side by
side, each shrunk as tests/test_examples.py shrinks the reference's."""
import importlib.util
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "examples" / "torch"
REF_DIR = ROOT / "examples"
EXAMPLES = sorted(p.stem for p in PORT_DIR.glob("*.py"))
#: the examples that run a model; they take ``--device``
MODEL_EXAMPLES = ("quickstart", "quantization_study", "serve_batched")
#: the training example, which takes ``--device`` too
TRAIN_EXAMPLE = "train_small"


def _load(path: pathlib.Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"_{tag}_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(directory, stem, tag, argv, monkeypatch, capsys) -> str:
    """Run one example's main() with ``argv``, its module-level
    ``BASE``/``SPEC`` request counts shrunk as tests/test_examples.py
    shrinks them; returns its standard output."""
    monkeypatch.setattr(sys, "argv", [f"{stem}.py"] + list(argv))
    capsys.readouterr()
    mod = _load(directory / f"{stem}.py", tag)
    if hasattr(mod, "BASE"):
        mod.BASE = mod.BASE.derive(n_requests=min(8, mod.BASE.n_requests))
    if hasattr(mod, "SPEC"):
        mod.SPEC = mod.SPEC.derive(n_requests=min(16, mod.SPEC.n_requests))
    mod.main()
    return capsys.readouterr().out
