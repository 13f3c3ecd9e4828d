"""One f32 train step of each dense config of ARCH_IDS (reduced), the
twin of tests/test_arch_smoke.py's ``test_one_train_step``: on weights
carried from the reference, the port's ``lm_loss`` within 1e-5 relative
of the reference's, its metrics' keys the reference's, and each gradient
leaf within 1e-4 of that leaf's max |g| against ``jax.grad`` of the
reference's ``lm_loss`` (``tests/_torch_training.py``). Then the port's
whole step moves the params. The MoE configs are in
test_torch_training_moe.py, the vlm, audio, SSM and hybrid configs in
test_torch_training_families.py."""
import pytest

torch = pytest.importorskip("torch")

from _torch_training import few_threads, step_parity  # noqa: E402,F401

ARCHS = ["stablelm-1.6b", "minitron-8b", "h2o-danube-3-4b",
         "command-r-35b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch, tmp_path, monkeypatch):
    step_parity(arch, tmp_path, monkeypatch)
